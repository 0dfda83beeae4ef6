"""Port parity: the tensor-parallel (tp) ops and layout against the JAX
package's.

K2 and K1 per tp shard run here through their plain versions (the
wrappers take them only because the tensors lie on the CPU) against the
JAX functions under ``shard_map`` on the conftest's CPU devices, the
Pallas paged kernel in interpret mode (``default_interpret()``); the
port's mesh is its CPU device repeated.  Then the Megatron split of the
weights, KV storage and the adapter pool on heads against the JAX
shardings, the mesh's row-major layout, and the forwards on the split
weights against JAX's."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpushare.models import transformer as jtf
from tpushare.ops import quant as jq
from tpushare.parallel import mesh as jmesh
from tpushare_torch.models import transformer as ttf
from tpushare_torch.models.bridge import params_from_numpy
from tpushare_torch.ops import attention as tattn
from tpushare_torch.ops import lora as tlora
from tpushare_torch.ops import quant as tq
from tpushare_torch.parallel import mesh as tmesh
from tpushare_torch.serving.paged import PagedContinuousBatcher

torch.set_num_threads(1)

# the JAX package's ops/__init__ re-exports a function named attention
jattn = importlib.import_module("tpushare.ops.attention")

#: the plain versions per shard against the interpreted kernel (and the
#: jnp reference) per shard, f32: reassociated sums only
ATOL = 2e-5
#: logits of a forward on the split weights against JAX's, f32
LOGIT_ATOL = 1e-4

CPU = torch.device("cpu")


def port_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return tmesh.make_mesh(axes, devices=[CPU] * n)


def _table(rng, contexts, n_pages, page, n_tbl, sp=1):
    """A table as the batcher lays it out: distinct pages, never a
    stripe's trash page, range j of a row from stripe j % sp."""
    per = n_pages // sp
    free = [list(rng.permutation(np.arange(s * per + 1, (s + 1) * per)))
            for s in range(sp)]
    table = np.zeros((len(contexts), n_tbl), np.int32)
    for i, c in enumerate(contexts):
        for j in range(-(-c // page)):
            table[i, j] = free[j % sp].pop()
    return table


def _pool(rng, int8, n_pages, hkv, page, d):
    """(jax store, port store) pairs of K and V."""
    out = []
    for _ in range(2):
        x = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
        if int8:
            out.append((jq.quantize_kv(jnp.asarray(x)),
                        tq.quantize_kv(torch.from_numpy(x))))
        else:
            out.append((jnp.asarray(x), torch.from_numpy(x)))
    return out


def _stacked(store):
    return ({k: v[None] for k, v in store.items()}
            if isinstance(store, dict) else store[None])


def _layer0(shards):
    return ([ttf._kv_layer(k, 0) for k, _ in shards],
            [ttf._kv_layer(v, 0) for _, v in shards])


# ---------------------------------------------------------------------------
# K2 and K1 per tp shard
# ---------------------------------------------------------------------------
#: (s, window, int8): decode and 4-row prefill windows, with and without a
#: sliding window, on both stores
CASES = [(1, None, False), (1, 16, True), (4, None, True), (4, 8, False)]


@pytest.mark.parametrize("s,window,int8", CASES)
def test_sharded_paged_read_matches_jax(s, window, int8):
    """``sharded_paged_decode_attention`` over the pool split on 2 tp
    shards within 2e-5 of JAX's under ``shard_map`` (the interpreted
    kernel on each shard's heads), and of the whole pool's read."""
    b, hkv, n_rep, d, page, n_pages, n_tbl = 3, 4, 2, 32, 8, 20, 8
    rng = np.random.default_rng(s * 10 + (window or 0) + int8)
    contexts = [5, 30, 61]
    table = _table(rng, contexts, n_pages, page, n_tbl)
    pos = np.stack([np.arange(c - s, c) for c in contexts]).astype(np.int32)
    q = rng.standard_normal((b, hkv * n_rep, s, d)).astype(np.float32)
    (jk, tk), (jv, tv) = _pool(rng, int8, n_pages, hkv, page, d)
    want = jattn.sharded_paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(pos),
        jmesh.make_mesh({"tp": 2}), window=window,
        interpret=jattn.default_interpret())
    mesh = port_mesh(tp=2)
    shards = tmesh.shard_kv_storage((_stacked(tk), _stacked(tv)), mesh)
    assert [ttf._kv_leaf(k).shape[2] for k, _ in shards] == [2, 2]
    got = tattn.sharded_paged_decode_attention(
        torch.from_numpy(q), *_layer0(shards), torch.from_numpy(table),
        torch.from_numpy(pos), mesh, window=window)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    whole = tattn.paged_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table),
        torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 6),
                                           (False, None)])
def test_sharded_attention_matches_jax(causal, window):
    """``sharded_attention`` (and ``attention(mesh=)``, which routes to it
    at tp 2) within 2e-5 of JAX's under ``shard_map``."""
    rng = np.random.default_rng(3 + (window or 0) + causal)
    q = rng.standard_normal((2, 8, 16, 16)).astype(np.float32)
    k = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    v = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    want = jattn.sharded_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jmesh.make_mesh({"tp": 2}), causal=causal, window=window)
    mesh = port_mesh(tp=2)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    got = tattn.sharded_attention(*args, mesh, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    routed = tattn.attention(*args, causal=causal, window=window, mesh=mesh)
    assert torch.equal(routed, got)


def test_attention_tp_heads_gate_runs_as_tp_1():
    """Where tp does not divide a head count, ``attention(mesh=)`` runs as
    tp = 1, all heads in one call: the unsharded result, bit for bit."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((1, 6, 8, 16), (1, 3, 8, 16), (1, 3, 8, 16)))
    got = tattn.attention(q, k, v, mesh=port_mesh(tp=2))
    assert torch.equal(got, tattn.attention(q, k, v))


@pytest.mark.parametrize("s,int8", [(1, False), (4, True)])
def test_tp_sp_striped_read_matches_jax(s, int8):
    """The tp x sp striped read on a 2 x 2 mesh of 4 shards within 2e-5 of
    JAX's under ``shard_map`` (each (tp, sp) shard its heads' stripe, the
    merge over sp only), and of the unstriped whole read."""
    b, hkv, n_rep, d, page, n_pages, n_tbl = 3, 2, 2, 32, 8, 20, 8
    rng = np.random.default_rng(40 + s + int8)
    contexts = [5, 30, 61]
    table = _table(rng, contexts, n_pages, page, n_tbl, sp=2)
    pos = np.stack([np.arange(c - s, c) for c in contexts]).astype(np.int32)
    q = rng.standard_normal((b, hkv * n_rep, s, d)).astype(np.float32)
    (jk, tk), (jv, tv) = _pool(rng, int8, n_pages, hkv, page, d)
    want = jattn.sp_striped_paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(pos),
        jmesh.make_mesh({"tp": 2, "sp": 2}),
        interpret=jattn.default_interpret())
    mesh = port_mesh(tp=2, sp=2)
    shards = tmesh.shard_kv_storage((_stacked(tk), _stacked(tv)), mesh)
    assert len(shards) == 4
    for t in range(2):
        for sp in range(2):
            got_k = ttf._kv_leaf(shards[t * 2 + sp][0])[0]
            want_k = ttf._kv_leaf(tk)[sp * 10:(sp + 1) * 10, t:t + 1]
            assert torch.equal(got_k, want_k)
    got = tattn.sp_striped_paged_decode_attention(
        torch.from_numpy(q), *_layer0(shards), torch.from_numpy(table),
        torch.from_numpy(pos), mesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    whole = tattn.paged_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table),
        torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["tp4_heads", "int4_half_group"])
def test_tp_heads_gate_runs_the_model_as_tp_1(case):
    """Where tp does not divide both head counts (tp 4 over tiny()'s 2 kv
    heads) or an int4 row leaf's packed rows (groups of 2: one packed row
    a group, which tp 2 cannot split), the batcher runs the model as
    tp = 1 on the mesh's first device: the serving mesh drops the tp
    axis, the params stay whole and the pool holds every kv head there
    (K2 over all heads in one launch on the card); the streams equal a
    batcher's without a mesh."""
    cfg = ttf.tiny(max_seq=96)
    params = ttf.init_params(cfg, seed=2, device="cpu")
    if case == "int4_half_group":
        params = tq.quantize_params(params, bits=4, group=2)
    tp = 4 if case == "tp4_heads" else 2
    b = PagedContinuousBatcher(params, cfg, n_slots=2, page_size=16,
                               mesh=port_mesh(tp=tp))
    assert b.mesh is None and isinstance(b.params["layers"], dict)
    assert ttf._kv_leaf(b.pools[0]).shape[2] == cfg.n_kv_heads
    ref = PagedContinuousBatcher(params, cfg, n_slots=2, page_size=16,
                                 device="cpu")
    outs = []
    for batcher in (b, ref):
        rids = [batcher.admit(p, 6) for p in ([5, 9, 2], [11, 3, 4, 1])]
        batcher.run_until_drained()
        outs.append([batcher.completed[r] for r in rids])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the Megatron split and the layouts
# ---------------------------------------------------------------------------
def test_make_mesh_lays_shards_out_row_major():
    mesh = port_mesh(tp=2, sp=2)
    assert mesh.shape == {"tp": 2, "sp": 2}
    devs = [torch.device("cpu", i) for i in range(4)]
    grid = tmesh.Mesh(("tp", "sp"), {"tp": 2, "sp": 2}, tuple(devs))
    assert [grid.device(tp=t, sp=s) for t in range(2) for s in range(2)] \
        == devs
    assert grid.device() == devs[0] and grid.device(tp=1) == devs[2]
    sub = grid.submesh(tp=1)
    assert sub.axis_names == ("sp",) and sub.devices == tuple(devs[2:])
    assert grid.submesh(sp=1).devices == (devs[1], devs[3])
    assert grid.submesh(tp=0, sp=1).axis_names == ()
    # the JAX package lays its grid out the same way
    jgrid = jmesh.make_mesh({"tp": 2, "sp": 2}).devices
    ids = [d.id for d in jax.devices()[:4]]
    assert [[d.id for d in row] for row in jgrid] == [ids[:2], ids[2:]]
    # dp and fsdp (sharded training) and ep (expert-parallel serving) are
    # ported: beside tp, laid out row-major as the reference's grid
    for axis in ("dp", "fsdp", "ep"):
        assert tmesh.make_mesh({axis: 2, "tp": 2}, devices=[CPU] * 4
                               ).shape == {axis: 2, "tp": 2}
        grid2 = tmesh.Mesh((axis, "tp"), {axis: 2, "tp": 2}, tuple(devs))
        assert [grid2.device(**{axis: a}, tp=t) for a in range(2)
                for t in range(2)] == devs
        jgrid2 = jmesh.make_mesh({axis: 2, "tp": 2}).devices
        assert [[d.id for d in row] for row in jgrid2] == [ids[:2], ids[2:]]
    # pipeline stages are ported: pp is a mesh axis like tp and sp
    assert tmesh.make_mesh({"pp": 2}, devices=[CPU] * 2).shape == {"pp": 2}
    assert tattn.tp_degree(port_mesh(tp=2)) == 2


@pytest.fixture(scope="module")
def bridged():
    cfg = jtf.tiny(max_seq=96)
    jp = jtf.init_params(jax.random.PRNGKey(7), cfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def test_shard_params_is_the_megatron_split_of_jax(bridged):
    """Each tp shard's leaf has the shard shape of the JAX package's
    ``shard_params`` on a tp mesh, column leaves split on their output
    dim and row leaves on their input dim; the shards concatenated give
    the whole leaf back; embed, lm_head and the norms stay whole on the
    first device, in tree 0."""
    jp, tparams = bridged
    cfg, tp = ttf.tiny(max_seq=96), 2
    jsharded = jmesh.shard_params(jp, jmesh.make_mesh({"tp": tp}))
    got = tmesh.shard_params(tparams, port_mesh(tp=tp), cfg)
    trees = got["layers"]
    assert isinstance(trees, tuple) and len(trees) == tp
    for name in ttf.TP_COL_LEAVES + ttf.TP_ROW_LEAVES:
        leaf = jsharded["layers"][name]
        want = leaf.sharding.shard_shape(leaf.shape)
        for tree in trees:
            assert tuple(tree[name].shape) == tuple(want), name
        dim = -1 if name in ttf.TP_COL_LEAVES else -2
        assert torch.equal(torch.cat([t[name] for t in trees], dim=dim),
                           tparams["layers"][name])
    assert set(trees[1]) == set(ttf.TP_COL_LEAVES + ttf.TP_ROW_LEAVES)
    for name in ("attn_scale", "ffn_scale"):
        assert torch.equal(trees[0][name], tparams["layers"][name])
    for name in ("embed", "lm_head", "final_scale"):
        assert torch.equal(got[name], tparams[name])


def test_shard_params_keeps_whole_leaves_where_the_split_does_not_fit():
    """tp 8 divides neither tiny()'s 4 q heads nor its 2 kv heads, and tp
    2 does not divide the one packed row a group of an int4 tree in
    groups of 2: every shard keeps the full-width weights, and the
    serving mesh drops the tp axis.  An int8 tree splits."""
    cfg = ttf.tiny()
    whole = ttf.init_params(cfg, seed=1, device="cpu")
    got = tmesh.shard_params(whole, port_mesh(tp=8), cfg)
    for tree in got["layers"]:
        for name in ttf.TP_COL_LEAVES + ttf.TP_ROW_LEAVES:
            assert torch.equal(tree[name], whole["layers"][name])
    assert ttf.serving_mesh(port_mesh(tp=8), cfg, got["layers"]) is None
    q4 = tq.quantize_params(whole, bits=4, group=2)
    assert not ttf.tp_splits(q4["layers"], cfg, 2)
    got4 = tmesh.shard_params(q4, port_mesh(tp=2), cfg)
    for tree in got4["layers"]:
        for name in ttf.TP_COL_LEAVES + ttf.TP_ROW_LEAVES:
            for k in ("q4", "s"):
                assert torch.equal(tree[name][k], q4["layers"][name][k])
    sub = ttf.serving_mesh(port_mesh(tp=2, sp=2), cfg, q4["layers"])
    assert sub.axis_names == ("sp",) and len(sub.devices) == 2
    q8 = ttf.init_params(cfg, seed=1, device="cpu", quantize_bits=8)
    assert ttf.tp_splits(q8["layers"], cfg, 2)
    assert ttf.serving_mesh(port_mesh(tp=2), cfg, q8["layers"]).shape \
        == {"tp": 2}
    # a MoE layer's experts never split; its attention does
    moe = dataclasses.replace(cfg, n_experts=4, moe_top_k=2)
    pm = ttf.init_params(moe, seed=1, device="cpu")
    trees = tmesh.shard_params(pm, port_mesh(tp=2), moe)["layers"]
    assert trees[0]["wq"].shape[-1] == cfg.d_model // 2
    assert "moe_gate" in trees[0] and "moe_gate" not in trees[1]
    assert torch.equal(trees[0]["moe_gate"], pm["layers"]["moe_gate"])


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_shard_kv_storage_splits_heads_like_jax(paged, kv_dtype):
    """At tp 2 each shard holds its block of the kv heads, int8 scales
    beside their values, in the JAX sharding's shard shape; at tp 8,
    which does not divide 2 kv heads, every shard holds the whole
    storage (JAX's legalization replicates it).  The batchers' own
    allocation per shard has the tp 2 layout."""
    cfg = ttf.tiny(kv_dtype=kv_dtype)
    jcfg = dataclasses.replace(jtf.tiny(), kv_dtype=kv_dtype)
    whole = (ttf.init_paged_kv(cfg, 6, 4, device="cpu") if paged
             else ttf.init_kv_caches(cfg, 3, device="cpu"))
    jwhole = (jtf.init_paged_kv(jcfg, 6, 4) if paged
              else jtf.init_kv_caches(jcfg, 3))
    for leaf in ttf.kv_tree_leaves(whole):
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape))
    for tp in (2, 8):
        jsh = jmesh.shard_kv_storage(jwhole, jmesh.make_mesh({"tp": tp}))
        jleaves = jax.tree_util.tree_leaves(jsh)
        shards = tmesh.shard_kv_storage(whole, port_mesh(tp=tp))
        assert len(shards) == tp
        for t, pair in enumerate(shards):
            for got, full, jl in zip(ttf.kv_tree_leaves(pair),
                                     ttf.kv_tree_leaves(whole), jleaves):
                assert tuple(got.shape) == tuple(
                    jl.sharding.shard_shape(jl.shape))
                h = got.shape[2]
                assert torch.equal(got, full[:, :, t * h:(t + 1) * h]
                                   if tp == 2 else full)
    fresh = (ttf.init_paged_kv(cfg, 6, 4, mesh=port_mesh(tp=2)) if paged
             else ttf.init_kv_caches(cfg, 3, mesh=port_mesh(tp=2)))
    assert [l.shape for l in ttf.kv_tree_leaves(fresh)] == \
        [l.shape for l in ttf.kv_tree_leaves(
            tmesh.shard_kv_storage(whole, port_mesh(tp=2)))]
    with pytest.raises(ValueError, match="whole GQA groups"):
        ttf.init_paged_kv(cfg, 6, 4, mesh=port_mesh(tp=8))


def test_shard_adapter_pool_splits_like_jax():
    """A column target's ``b`` splits its d_out, a row target's ``a`` its
    d_in, everything else (the rank, the pool axis, ``scale``) stays
    whole: each shard's leaf has the JAX sharding's shard shape, and the
    shards concatenated give the pool back."""
    from tpushare.ops import lora as jlora

    cfg = ttf.tiny()
    pool = tlora.init_adapter_pool_arrays(cfg, 4, 3, device="cpu")
    for name, leaves in pool.items():
        if name != "scale":
            for x in leaves.values():
                x.copy_(torch.randn(x.shape))
    pool["scale"].copy_(torch.tensor([0.0, 2.0, 4.0]))
    jpool = jlora.init_adapter_pool_arrays(jtf.tiny(), 4, 3)
    jsh = jmesh.shard_adapter_pool(jpool, jmesh.make_mesh({"tp": 2}))
    shards = tmesh.shard_adapter_pool(pool, port_mesh(tp=2))
    assert len(shards) == 2
    for name, leaves in pool.items():
        if name == "scale":
            assert all(torch.equal(s["scale"], leaves) for s in shards)
            continue
        for k, x in leaves.items():
            jl = jsh[name][k]
            want = tuple(jl.sharding.shard_shape(jl.shape))
            assert all(tuple(s[name][k].shape) == want for s in shards)
            dim = tmesh.adapter_split_dim(name, k)
            if dim is None:
                assert all(torch.equal(s[name][k], x) for s in shards)
            else:
                assert torch.equal(torch.cat([s[name][k] for s in shards],
                                             dim=dim), x)


# ---------------------------------------------------------------------------
# forwards on the split weights
# ---------------------------------------------------------------------------
def test_no_cache_forward_on_the_split_matches_jax(bridged):
    """``forward(mesh=)`` on ``shard_params``' tp 2 split (K1 per shard on
    the card; the reference per shard here) against the JAX ``forward``
    under a tp mesh and its sharded params: logits within 1e-4, and
    within 1e-5 of the port's unsplit forward."""
    jp, tparams = bridged
    cfg = ttf.tiny(max_seq=96)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
    jm = jmesh.make_mesh({"tp": 2})
    want = jtf.forward(jmesh.shard_params(jp, jm), jnp.asarray(tokens),
                       jtf.tiny(max_seq=96), mesh=jm)
    split = tmesh.shard_params(tparams, port_mesh(tp=2), cfg)
    got = ttf.forward(split, torch.from_numpy(tokens), cfg,
                      mesh=port_mesh(tp=2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    whole = ttf.forward(tparams, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="shard_params"):
        ttf.forward(tparams, torch.from_numpy(tokens), cfg,
                    mesh=port_mesh(tp=2))
