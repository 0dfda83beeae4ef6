"""Port parity: pipeline parallelism (``tpushare_torch/parallel/pipeline.py``
and the staged forwards of ``models/transformer.py``) against the JAX
package's.

The schedule, its bubble and the stage ranges equal the reference's;
``pipeline_apply`` equals ``tpushare.parallel.pipeline.pipeline_apply`` on
the reference test's MLP layer (1e-5); ``forward_pipelined`` equals JAX's
(f32 logits 1e-4, gradients 2e-4); and the staged decode steps
``forward_pp_decode`` / ``forward_paged_decode_pp`` equal JAX's step by
step at pp = 2 with 1, 2 and 4 microbatches on bf16-kind and int8 storage
(logits 1e-4, caches and pools equal).  The JAX side runs on the
conftest's 8-device CPU mesh, the port's on ``make_mesh(..., devices=
["cpu"] * n)``; weights cross by ``models.bridge``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpushare.models import transformer as jtf
from tpushare.parallel import make_mesh as jax_mesh
from tpushare.parallel import mesh as jmesh
from tpushare.parallel import pipeline as jpipe
from tpushare_torch.models import transformer as ttf
from tpushare_torch.models.bridge import params_from_numpy
from tpushare_torch.parallel import mesh as tmesh
from tpushare_torch.parallel import pipeline as tpipe

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: f32 logits: the two frameworks' sums through 4 layers
LOGIT_ATOL = 1e-4
#: gradients of the pipelined loss
GRAD_ATOL = 2e-4
#: cached K/V: one f32 projection and RoPE apart
CACHE_ATOL = 1e-5
MAX_SEQ = 64
PAGE = 8

# the JAX staged programs, traced once a configuration (eagerly, each call
# retraces its shard_map)
_JAX_STATIC = ("cfg", "mesh", "n_micro")
jax_pp_decode = jax.jit(jtf.forward_pp_decode, static_argnames=_JAX_STATIC)
jax_paged_pp_decode = jax.jit(jtf.forward_paged_decode_pp,
                              static_argnames=_JAX_STATIC)
jax_pipelined = jax.jit(jtf.forward_pipelined, static_argnames=_JAX_STATIC)
jax_forward = jax.jit(jtf.forward, static_argnames=("cfg",))
jax_paged_prefill = jax.jit(jtf.forward_paged_prefill_batch,
                            static_argnames=("cfg",))


def pp_mesh(pp=2, **extra):
    axes = {**extra, "pp": pp}
    n = int(np.prod(list(axes.values())))
    return tmesh.make_mesh(axes, devices=[CPU] * n)


def _cfgs(kv_dtype="bf16", n_layers=4):
    jcfg = dataclasses.replace(jtf.tiny(max_seq=MAX_SEQ, n_layers=n_layers),
                               kv_dtype=kv_dtype)
    tcfg = ttf.tiny(max_seq=MAX_SEQ, n_layers=n_layers, kv_dtype=kv_dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jp = jtf.init_params(jax.random.PRNGKey(3), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


# ---------------------------------------------------------------------------
# the schedule, the bubble, the stage ranges and the mesh axis
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_stages", [1, 2, 3, 4])
def test_schedule_and_bubble_equal_the_reference(n_stages):
    for n_micro in range(1, 9):
        assert tpipe.pp_stage_schedule(n_stages, n_micro) == \
            jpipe.pp_stage_schedule(n_stages, n_micro)
        assert tpipe.pp_bubble_fraction(n_stages, n_micro) == \
            jpipe.pp_bubble_fraction(n_stages, n_micro)
    for bad in ((0, 2), (n_stages, 0)):
        with pytest.raises(ValueError) as te:
            tpipe.pp_stage_schedule(*bad)
        with pytest.raises(ValueError) as je:
            jpipe.pp_stage_schedule(*bad)
        assert str(te.value) == str(je.value)


def test_stage_layer_ranges_equal_the_reference():
    for n_layers in range(1, 10):
        for pp in range(1, 5):
            assert tmesh.stage_layer_ranges(n_layers, pp) == \
                jmesh.stage_layer_ranges(n_layers, pp)
    with pytest.raises(ValueError):
        tmesh.stage_layer_ranges(4, 0)


def test_make_mesh_takes_pp_and_cites_the_axes_to_come():
    m = tmesh.make_mesh({"tp": 2, "sp": 2, "pp": 2}, devices=[CPU] * 8)
    assert m.shape == {"tp": 2, "sp": 2, "pp": 2}
    assert m.submesh(pp=1).axis_names == ("tp", "sp")
    assert "pp" in tmesh.PORTED_AXES
    with pytest.raises(NotImplementedError, match="A.12.4"):
        tmesh.make_mesh({"ep": 2}, devices=[CPU] * 2)
    # dp and fsdp are ported (sharded training): beside pp, the mesh is
    # the reference's
    for axis in ("dp", "fsdp"):
        got = tmesh.make_mesh({axis: 2, "pp": 2}, devices=[CPU] * 4)
        want = jmesh.make_mesh({axis: 2, "pp": 2})
        assert got.axis_names == tuple(want.axis_names)
        assert got.shape == dict(want.shape)


# ---------------------------------------------------------------------------
# pipeline_apply and forward_pipelined
# ---------------------------------------------------------------------------
def _mlp_layer_jax(p, x):
    return jax.nn.relu(x @ p["w"]) + p["b"]


def _mlp_layer_torch(p, x):
    return torch.relu(x @ p["w"]) + p["b"]


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 8), (2, 2)])
def test_pipeline_apply_equals_jax(n_stages, n_micro):
    """The reference test's 8-layer MLP through both pipelines."""
    rng = np.random.default_rng(n_stages * 10 + n_micro)
    d, mb = 16, 4
    params = {"w": (rng.standard_normal((8, d, d)) / np.sqrt(d)
                    ).astype(np.float32),
              "b": (0.01 * rng.standard_normal((8, d))).astype(np.float32)}
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    want = jpipe.pipeline_apply(_mlp_layer_jax,
                                jax.tree_util.tree_map(jnp.asarray, params),
                                jnp.asarray(x), jax_mesh({"pp": n_stages}))
    got = tpipe.pipeline_apply(
        _mlp_layer_torch, {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), pp_mesh(n_stages))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_stage_slabs_are_views_on_the_params_device():
    w = torch.randn(8, 4, 4)
    slabs = tpipe.stage_slabs({"w": w}, pp_mesh(4))
    assert [s["w"].shape[0] for s in slabs] == [2, 2, 2, 2]
    assert all(s["w"].untyped_storage().data_ptr()
               == w.untyped_storage().data_ptr() for s in slabs)


@pytest.mark.parametrize("n_stages,n_micro", [(2, None), (4, 2), (2, 4)])
def test_forward_pipelined_equals_jax(weights, n_stages, n_micro):
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (8, 16))
    want = jax_pipelined(jp, jnp.asarray(tokens), jcfg,
                         jax_mesh({"pp": n_stages}), n_micro=n_micro)
    got = ttf.forward_pipelined(tp, torch.from_numpy(tokens), tcfg,
                                pp_mesh(n_stages), n_micro=n_micro)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


def test_forward_pipelined_gradients_equal_jax(weights):
    """Loss and every leaf's gradient through the pipelined forward (the
    microbatch schedule differentiated by autograd) against
    ``jax.value_and_grad`` of the JAX pipelined loss."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (4, 17))

    def jloss(p):
        logits = jtf.forward_pipelined(p, jnp.asarray(tokens[:, :-1]), jcfg,
                                       jax_mesh({"pp": 2}))
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(
            logp, jnp.asarray(tokens[:, 1:])[..., None], -1).mean()

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    leaves = {k: (v.clone().requires_grad_(True) if k != "layers" else
                  {n: x.clone().requires_grad_(True) for n, x in v.items()})
              for k, v in tp.items()}
    logits = ttf.forward_pipelined(leaves, torch.from_numpy(tokens[:, :-1]),
                                   tcfg, pp_mesh(2))
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.from_numpy(tokens[:, 1:]).reshape(-1))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) < 1e-5
    for k in ("embed", "final_scale", "lm_head"):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=GRAD_ATOL, rtol=0)
    for n, x in leaves["layers"].items():
        np.testing.assert_allclose(x.grad.numpy(),
                                   np.asarray(jg["layers"][n]),
                                   atol=GRAD_ATOL, rtol=0)


def test_forward_pipelined_refuses_an_indivisible_batch(weights):
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    tokens = np.zeros((3, 8), np.int64)
    with pytest.raises(ValueError, match="not divisible") as te:
        ttf.forward_pipelined(tp, torch.from_numpy(tokens), tcfg, pp_mesh(2))
    with pytest.raises(ValueError) as je:
        jtf.forward_pipelined(jp, jnp.asarray(tokens), jcfg,
                              jax_mesh({"pp": 2}))
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the staged decode steps
# ---------------------------------------------------------------------------
def _leaves(store):
    if isinstance(store, dict):
        return [np.asarray(store["q"]), np.asarray(store["s"])]
    return [np.asarray(store)]


def _joined(staged):
    """A Staged (k, v) storage as one whole (k, v) pair of numpy leaves."""
    def cat(i):
        parts = [s[i] for s in staged]
        if isinstance(parts[0], dict):
            return {k: torch.cat([p[k] for p in parts]).numpy()
                    for k in parts[0]}
        return torch.cat(parts).numpy()
    return cat(0), cat(1)


def _assert_storage_equal(jstore, tstore, first=0):
    """The storages equal from dim-1 index ``first`` on: 1 on a paged pool,
    whose trash page 0 the reference's bubble ticks write garbage to and
    the port's (which run no bubble) do not."""
    for js, ts in zip(jstore, _joined(tstore)):
        for jl, tl in zip(_leaves(js), _leaves(ts)):
            jl, tl = jl[:, first:], tl[:, first:]
            assert jl.shape == tl.shape and jl.dtype == tl.dtype
            if jl.dtype == np.int8:
                # a code on a rounding edge of the two frameworks' scales
                diff = np.abs(jl.astype(np.int32) - tl.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            else:
                np.testing.assert_allclose(tl, jl, atol=CACHE_ATOL, rtol=0)


def _sync(jstore, tstore):
    """Write the JAX storage into the port's, stage by stage: each step
    then starts from the same bytes, so an int8 code that sat on a
    rounding edge of the two frameworks' f32 scales one step ago does not
    carry into the next step's comparison."""
    for js, ts in zip(jstore, zip(*tstore)):
        start = 0
        for stage in ts:
            for jl, tl in zip(_leaves(js), (
                    [stage["q"], stage["s"]] if isinstance(stage, dict)
                    else [stage])):
                n = tl.shape[0]
                tl.copy_(torch.from_numpy(jl[start:start + n].copy()))
            start += n


PROMPT_LENS = [5, 9, 3, 12]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_forward_pp_decode_equals_jax(weights, kv_dtype, n_micro):
    """Dense full-size rows: four rows prefilled in one forward (a row's
    padded tail lands past its length, masked until rewritten), then
    three staged decode steps on both sides (JAX's ``forward_pp_decode``
    at pp = 2), each from the same cache bytes (:func:`_sync`): logits
    within 1e-4 and the caches equal after each."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(kv_dtype)
    rng = np.random.default_rng(n_micro)
    b = len(PROMPT_LENS)
    tokens = rng.integers(0, jcfg.vocab, (b, max(PROMPT_LENS)))
    jcaches = jtf.init_kv_caches(jcfg, b)
    mesh = pp_mesh(2)
    placed = tmesh.shard_params(tp, mesh, tcfg)
    tcaches = ttf.init_kv_caches(tcfg, b, device="cpu", mesh=mesh)
    assert isinstance(tcaches, tmesh.Staged)
    lengths = np.array(PROMPT_LENS)
    _, jcaches = jax_forward(jp, jnp.asarray(tokens), jcfg,
                             kv_caches=jcaches, cache_len=0)
    ttf.forward_cached(placed, torch.from_numpy(tokens), tcfg, tcaches, 0,
                       mesh=mesh)
    _assert_storage_equal(jcaches, tcaches)
    step = rng.integers(0, jcfg.vocab, (b, 1))
    for _ in range(3):
        _sync(jcaches, tcaches)
        jl, jcaches = jax_pp_decode(
            jp, jnp.asarray(step), jcfg, jcaches, jnp.asarray(lengths),
            jax_mesh({"pp": 2}), n_micro=n_micro)
        tl, _ = ttf.forward_pp_decode(
            placed, torch.from_numpy(step), tcfg, tcaches,
            torch.from_numpy(lengths), mesh, n_micro=n_micro)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        _assert_storage_equal(jcaches, tcaches)
        step = np.asarray(jl).argmax(-1)
        lengths = lengths + 1


def _page_table(b):
    pages = MAX_SEQ // PAGE
    return (1 + np.arange(b * pages).reshape(b, pages)).astype(np.int32)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_forward_paged_decode_pp_equals_jax(weights, kv_dtype, n_micro):
    """The paged pool: four rows prefilled through their pages in one
    forward (a row's padded tail past its length, masked), then three
    staged decode steps on both sides (JAX's ``forward_paged_decode_pp``
    at pp = 2), each from the same pool bytes (:func:`_sync`): logits
    within 1e-4 and the pools equal after each."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(kv_dtype)
    rng = np.random.default_rng(10 + n_micro)
    b = len(PROMPT_LENS)
    table = _page_table(b)
    n_pages = int(table.max()) + 1
    tokens = rng.integers(0, jcfg.vocab, (b, 16))
    mesh = pp_mesh(2)
    placed = tmesh.shard_params(tp, mesh, tcfg)
    jpools = jtf.init_paged_kv(jcfg, n_pages, PAGE)
    tpools = ttf.init_paged_kv(tcfg, n_pages, PAGE, device="cpu", mesh=mesh)
    assert isinstance(tpools, tmesh.Staged)
    assert [ttf._kv_leaf(k).shape[0] for k, _ in tpools] == [2, 2]
    pos, last = np.zeros(b, np.int32), np.array(PROMPT_LENS) - 1
    _, jpools = jax_paged_prefill(jp, jnp.asarray(tokens), jcfg, jpools,
                                  jnp.asarray(table), jnp.asarray(pos),
                                  jnp.asarray(last))
    ttf.forward_paged_prefill_batch(
        placed, torch.from_numpy(tokens), tcfg, tpools,
        torch.from_numpy(table), torch.from_numpy(pos),
        torch.from_numpy(last), mesh=mesh)
    _assert_storage_equal(jpools, tpools, first=1)
    lengths = np.array(PROMPT_LENS, np.int32)
    step = rng.integers(0, jcfg.vocab, (b, 1))
    for _ in range(3):
        _sync(jpools, tpools)
        jl, jpools = jax_paged_pp_decode(
            jp, jnp.asarray(step), jcfg, jpools, jnp.asarray(table),
            jnp.asarray(lengths), jax_mesh({"pp": 2}), n_micro=n_micro)
        tl, _ = ttf.forward_paged_decode_pp(
            placed, torch.from_numpy(step), tcfg, tpools,
            torch.from_numpy(table), torch.from_numpy(lengths), mesh,
            n_micro=n_micro)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        _assert_storage_equal(jpools, tpools, first=1)
        step = np.asarray(jl).argmax(-1)
        lengths = lengths + 1


@pytest.mark.parametrize("pp,n_micro", [(2, 2), (4, 2), (2, 4)])
def test_paged_wavefront_reads_once_a_stage_microbatch_and_layer(
        weights, monkeypatch, pp, n_micro):
    """No bubble cell runs: the paged read (K2 on the card) is called
    n_layers x n_micro times a staged step, at B / n_micro rows each, and
    the staged step's logits equal the flat step's on the same pool."""
    _, tp = weights
    _, tcfg = _cfgs()
    b = 4
    table = torch.from_numpy(_page_table(b))
    mesh = pp_mesh(pp)
    placed = tmesh.shard_params(tp, mesh, tcfg)
    pools = ttf.init_paged_kv(tcfg, int(table.max()) + 1, PAGE,
                              device="cpu", mesh=mesh)
    lengths = torch.tensor([3, 5, 1, 7], dtype=torch.int32)
    step = torch.tensor([[4], [9], [2], [7]])
    flat, _ = ttf.forward_paged_decode(
        placed, step, tcfg, ttf.kv_tree_map(torch.clone, pools), table,
        lengths, mesh=mesh)
    rows = []
    real = ttf.paged_attention

    def counted(q, *a, **k):
        rows.append(q.shape[0])
        return real(q, *a, **k)

    monkeypatch.setattr(ttf, "paged_attention", counted)
    got, _ = ttf.forward_paged_decode_pp(placed, step, tcfg, pools, table,
                                         lengths, mesh, n_micro=n_micro)
    assert rows == [b // n_micro] * (tcfg.n_layers * n_micro)
    # the same sums but for the microbatches' smaller products' rounding
    np.testing.assert_allclose(got.numpy(), flat.numpy(), atol=LOGIT_ATOL,
                               rtol=0)


def test_staged_layouts(weights):
    """Stage slabs of the params are views of the stacked leaves (one
    card holds the model once); KV storage and the adapter pool split
    their layer dim by stage, composed with the tp heads and sp stripes,
    each stage's parts on its own devices."""
    from tpushare_torch.ops import lora

    _, tp = weights
    _, tcfg = _cfgs()
    mesh = pp_mesh(2, tp=2, sp=2)
    placed = tmesh.shard_params(tp, mesh, tcfg)
    stage1 = placed["layers"][1]
    assert len(stage1) == 2                        # tp shards of stage 1
    assert stage1[0]["wq"].shape == (2, 64, 32)
    assert (stage1[0]["wq"].untyped_storage().data_ptr()
            == tp["layers"]["wq"].untyped_storage().data_ptr())
    pools = ttf.init_paged_kv(tcfg, 8, PAGE, device="cpu", mesh=mesh)
    assert len(pools) == 2 and all(len(p) == 4 for p in pools)
    assert ttf._kv_leaf(pools[1][3][0]).shape == (2, 4, 1, PAGE, 16)
    whole = ttf.init_paged_kv(tcfg, 8, PAGE, device="cpu")
    split = tmesh.shard_kv_storage(whole, mesh)
    assert [[tuple(ttf._kv_leaf(k).shape) for k, _ in s] for s in split] == \
        [[tuple(ttf._kv_leaf(k).shape) for k, _ in s] for s in pools]
    pool = lora.init_adapter_pool_arrays(tcfg, 4, 3, device="cpu")
    staged = tmesh.shard_adapter_pool(pool, mesh)
    assert len(staged) == 2 and len(staged[0]) == 2
    assert staged[1][1]["wq"]["b"].shape == (2, 3, 4, 32)
    flat = tmesh.shard_adapter_pool(pool, tmesh.make_mesh(
        {"pp": 2}, devices=[CPU] * 2))
    assert isinstance(flat[0], dict) and flat[0]["wo"]["a"].shape[0] == 2
