"""Port parity: quantized weights split over tp (int8 and grouped int4
Megatron blocks) against the JAX package's sharded layout and programs.

``tiny()`` f32 with the reference's params, int8 per channel or int4 in
groups of 32, carried over through ``models/bridge.py``:

* ``shard_params`` on ``{"tp": 2}`` and ``{"fsdp": 2, "tp": 2}`` lays
  every quantized projection out as the reference's ``shard_params``
  does, shard by shard: int8 ``q`` on d_out (column) or d_in (row),
  int4 ``q4`` on d_out (column) or its packed-row dim ``group/2`` (row),
  ``s`` whole; each tp tree holds half of the codes' bytes.
* ``forward(mesh=)`` without a cache, with dense rows and a paged decode
  step on ``{"tp": 2}`` (and the paged read striped on ``{"tp": 2, "sp":
  2}``): logits within 1e-4 of the JAX package's forward on its sharded
  params and within 1e-5 of the port's tp = 1.
* The dense and paged batchers on ``{"tp": 2}`` and ``{"tp": 2, "pp":
  2}``: greedy streams token-equal to the live JAX batcher on its own
  mesh.
* An int4 model whose ``group/2`` tp does not divide runs as tp = 1.
* The LoRA step on an int8 and an int4 base on both meshes: adapter
  gradients within 1e-6 of the undivided step's, three AdamW steps
  within 1e-5 of three undivided steps and 2e-4 of the reference's
  ``make_lora_train_step`` on its shardings, the base bit-unchanged.
* ``--tp 2 --int8`` and ``--tp 2 --int4`` on the command line, on the
  CPU.
"""

import functools
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import transformer as jtf
from tpushare.ops import lora as jlora
from tpushare.ops import quant as jquant
from tpushare.parallel import mesh as jmesh
from tpushare.parallel import train as jtrain
from tpushare.serving.continuous import ContinuousBatcher as JaxDense
from tpushare.serving.paged import PagedContinuousBatcher as JaxPaged
from tpushare_torch.models import transformer as ttf
from tpushare_torch.models.bridge import params_from_numpy
from tpushare_torch.ops import lora
from tpushare_torch.ops.attention import tp_degree
from tpushare_torch.parallel import mesh as tmesh
from tpushare_torch.parallel import train as ttrain
from tpushare_torch.parallel.trainer import Trainer
from tpushare_torch.serving.continuous import ContinuousBatcher
from tpushare_torch.serving.llm import build_model, parse_args, start_server
from tpushare_torch.serving.paged import PagedContinuousBatcher

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: logits of the split forwards against the JAX package's, f32
LOGIT_ATOL = 1e-4
#: logits of the split forwards against the port's tp = 1
SPLIT_ATOL = 1e-5
#: LoRA: adapter gradients, three steps against undivided, against JAX
GRAD_ATOL = 1e-6
PARAM_ATOL = 1e-5
JAX_ATOL = 2e-4
LOSS_RTOL = 1e-5
RANK = 4
#: the int4 group: tiny()'s wo (d_in 64) and w_down (d_in 128) in groups
#: of 32, 16 packed rows each, which tp 2 divides
GROUP = 32
KINDS = ("int8", "int4")
PROMPTS = [[5, 9, 2], [11, 3], [1, 2, 3, 4, 5], [7, 7, 1, 2, 7, 7, 1, 2]]
GEN = 8


def _id(axes):
    return "x".join(f"{k}{v}" for k, v in axes.items())


def port_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return tmesh.make_mesh(axes, devices=[CPU] * n)


def _cfgs(n_layers=2):
    return (jtf.tiny(max_seq=96, n_layers=n_layers),
            ttf.tiny(max_seq=96, n_layers=n_layers))


def _quantize(jp, kind, group=GROUP):
    if kind == "int8":
        return jquant.quantize_params(jp)
    return jquant.quantize_params(jp, bits=4, group=group)


def _bridge(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")


@functools.lru_cache(maxsize=None)
def _weights(kind, n_layers=2, group=GROUP):
    """The reference's quantized tiny tree and its bridge."""
    jcfg, _ = _cfgs(n_layers)
    jp = _quantize(jtf.init_params(jax.random.PRNGKey(7), jcfg), kind, group)
    return jp, _bridge(jp)


def _jax_shard(arr, device):
    for shard in arr.addressable_shards:
        if shard.device == device:
            return np.asarray(shard.data)
    raise AssertionError("no shard on that device")


def _codes(leaf):
    return leaf["q4"] if "q4" in leaf else leaf["q"]


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("axes", [{"tp": 2}, {"fsdp": 2, "tp": 2}], ids=_id)
def test_quantized_layout_is_the_reference_shard_by_shard(kind, axes):
    jp, tparams = _weights(kind)
    _, cfg = _cfgs()
    assert ttf.tp_splits(tparams["layers"], cfg, 2)
    jm = jmesh.make_mesh(axes)
    jsharded = jmesh.shard_params(jp, jm)
    placed = tmesh.shard_params(tparams, port_mesh(**axes), cfg)
    assert ttf.tp_splits(placed["layers"], cfg, 2)
    grid = np.asarray(jm.devices).reshape([axes.get("fsdp", 1), 2])
    for name in ttf.TP_COL_LEAVES + ttf.TP_ROW_LEAVES:
        jleaf = jsharded["layers"][name]
        assert set(placed["layers"][0][name]) == set(jleaf)
        for key in jleaf:
            for t in range(2):
                member = placed["layers"][t][name][key]
                assert not isinstance(member, tmesh.TpBlocks)
                for f in range(axes.get("fsdp", 1)):
                    block = (member[f] if isinstance(member,
                                                     tmesh.FsdpBlocks)
                             else member)
                    np.testing.assert_array_equal(
                        block.numpy(), _jax_shard(jleaf[key], grid[f, t]),
                        err_msg=f"{name}/{key} f{f} t{t}")
        # each tp tree holds half of the codes, the scales whole
        whole = _codes(tparams["layers"][name])
        for t in range(2):
            tree = tmesh.gather_fsdp(placed["layers"][t][name])
            assert _codes(tree).numel() * 2 == whole.numel()
            assert torch.equal(tree["s"], tparams["layers"][name]["s"])
    # the whole tree back, bit for bit
    back = tmesh.gather_params(placed, cfg)
    for x, y in zip(ttrain.tree_leaves(back), ttrain.tree_leaves(tparams)):
        assert torch.equal(x, y)


def test_tp_views_share_the_params_storage():
    """On the params' own device a tp block is a view of the whole leaf,
    as a plain leaf's is; the forward's shard tree takes a column
    block's scale columns as a view too."""
    _, tparams = _weights("int4")
    _, cfg = _cfgs()
    placed = tmesh.shard_params(tparams, port_mesh(tp=2), cfg)
    for name in ("wq", "wo"):
        whole = tparams["layers"][name]
        for t in range(2):
            leaf = placed["layers"][t][name]
            assert (leaf["q4"].untyped_storage().data_ptr()
                    == whole["q4"].untyped_storage().data_ptr())
            assert (leaf["s"].untyped_storage().data_ptr()
                    == whole["s"].untyped_storage().data_ptr())
            assert leaf["s"].shape == whole["s"].shape
    tree = tmesh.tp_compute_tree(placed["layers"][1], 1)
    s = tree["wq"]["s"]
    assert s.shape[-1] == cfg.d_model // 2
    assert s.untyped_storage().data_ptr() == \
        tparams["layers"]["wq"]["s"].untyped_storage().data_ptr()
    assert torch.equal(s, tparams["layers"]["wq"]["s"][..., cfg.d_model // 2:])
    assert tree["wo"]["s"].shape == tparams["layers"]["wo"]["s"].shape


def test_int4_rows_tp_does_not_divide_run_as_tp_1():
    """Groups of 2 leave one packed row a group, which tp 2 cannot
    split: the model takes no split, the serving mesh drops tp, the
    layout keeps every weight whole and the batcher's streams equal a
    batcher's without a mesh."""
    jp, tparams = _weights("int4", group=2)
    _, cfg = _cfgs()
    assert not ttf.tp_splits(tparams["layers"], cfg, 2)
    assert ttf.serving_mesh(port_mesh(tp=2), cfg, tparams["layers"]) is None
    placed = tmesh.shard_params(tparams, port_mesh(tp=2), cfg)
    for tree in placed["layers"]:
        for name in ttf.TP_COL_LEAVES + ttf.TP_ROW_LEAVES:
            for k in ("q4", "s"):
                assert torch.equal(tree[name][k], tparams["layers"][name][k])
    b = PagedContinuousBatcher(tparams, cfg, n_slots=4, page_size=16,
                               mesh=port_mesh(tp=2))
    assert b.mesh is None and isinstance(b.params["layers"], dict)
    ref = PagedContinuousBatcher(tparams, cfg, n_slots=4, page_size=16,
                                 device="cpu")
    assert _drain(b) == _drain(ref)


# ---------------------------------------------------------------------------
# the forwards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("axes", [{"tp": 2}, {"tp": 2, "sp": 2}], ids=_id)
def test_no_cache_forward_matches_jax(kind, axes):
    jp, tparams = _weights(kind)
    jcfg, cfg = _cfgs()
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
    jm = jmesh.make_mesh(axes)
    want = jtf.forward(jmesh.shard_params(jp, jm), jnp.asarray(tokens),
                       jcfg, mesh=jm)
    mesh = port_mesh(**axes)
    split = tmesh.shard_params(tparams, mesh, cfg)
    got = ttf.forward(split, torch.from_numpy(tokens), cfg, mesh=mesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    whole = ttf.forward(tparams, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=SPLIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_dense_rows_forward_matches_jax(kind):
    """A 13-token prefill and three decode steps on dense rows split over
    tp 2 (dense rows take no sp axis) against the reference's forward on
    its sharded params and the port's tp = 1, step by step."""
    jp, tparams = _weights(kind)
    jcfg, cfg = _cfgs()
    jm = jmesh.make_mesh({"tp": 2})
    jsharded = jmesh.shard_params(jp, jm)
    mesh = port_mesh(tp=2)
    split = tmesh.shard_params(tparams, mesh, cfg)
    jc = jtf.init_kv_caches(jcfg, 2)
    tc = ttf.init_kv_caches(cfg, 2, mesh=mesh)
    assert len(tc) == 2 and ttf._kv_leaf(tc[0][0]).shape[2] == 1
    oc = ttf.init_kv_caches(cfg, 2, device="cpu")
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab, (2, 13))
    cl = 0
    for _ in range(4):
        jl, jc = jtf.forward(jsharded, jnp.asarray(tok), jcfg, kv_caches=jc,
                             cache_len=jnp.asarray(cl, jnp.int32))
        tl, tc = ttf.forward(split, torch.from_numpy(tok), cfg,
                             kv_caches=tc, cache_len=cl, mesh=mesh)
        ol, oc = ttf.forward(tparams, torch.from_numpy(tok), cfg,
                             kv_caches=oc, cache_len=cl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_allclose(tl.numpy(), ol.numpy(), atol=SPLIT_ATOL,
                                   rtol=0)
        cl += tok.shape[1]
        tok = np.asarray(jl)[:, -1:].argmax(-1)


def _table(rng, contexts, n_pages, page, n_tbl, sp):
    """Distinct pages, never a stripe's trash page, range j of a row from
    stripe j % sp, as the batcher lays a table out."""
    per = n_pages // sp
    free = [list(rng.permutation(np.arange(s * per + 1, (s + 1) * per)))
            for s in range(sp)]
    table = np.zeros((len(contexts), n_tbl), np.int32)
    for i, c in enumerate(contexts):
        for j in range(c // page + 1):
            table[i, j] = free[j % sp].pop()
    return table


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("axes", [{"tp": 2}, {"tp": 2, "sp": 2}], ids=_id)
def test_paged_decode_matches_jax(kind, axes):
    """One decode step of three rows over a pool of random keys and
    values, split over the mesh (striped under sp), against the
    reference's ``forward_paged_decode`` on its sharded params and pool,
    and the port's tp = 1 step on the whole pool."""
    jp, tparams = _weights(kind)
    jcfg, cfg = _cfgs()
    sp = axes.get("sp", 1)
    page, n_pages, n_tbl = 8, 32, cfg.max_seq // 8
    rng = np.random.default_rng(5)
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page, cfg.head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    lengths = np.asarray([17, 5, 30], np.int32)
    table = _table(rng, lengths, n_pages, page, n_tbl, sp)
    tok = rng.integers(0, cfg.vocab, (3, 1))
    jm = jmesh.make_mesh(axes)
    jpools = jmesh.shard_kv_storage(
        (jnp.asarray(kp), jnp.asarray(vp)), jm,
        page_axis="sp" if sp > 1 else None)
    want, _ = jtf.forward_paged_decode(
        jmesh.shard_params(jp, jm), jnp.asarray(tok), jcfg, jpools,
        jnp.asarray(table), jnp.asarray(lengths), mesh=jm)
    mesh = port_mesh(**axes)
    pools = tmesh.shard_kv_storage(
        (torch.from_numpy(kp), torch.from_numpy(vp)), mesh)
    got, _ = ttf.forward_paged_decode(
        tmesh.shard_params(tparams, mesh, cfg), torch.from_numpy(tok), cfg,
        pools, torch.from_numpy(table), torch.from_numpy(lengths),
        mesh=mesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    whole, _ = ttf.forward_paged_decode(
        tparams, torch.from_numpy(tok), cfg,
        (torch.from_numpy(kp), torch.from_numpy(vp)),
        torch.from_numpy(table), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=SPLIT_ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# the batchers against the live JAX batchers on their meshes
# ---------------------------------------------------------------------------
def _drain(b, prompts=PROMPTS, gen=GEN):
    rids = [b.admit(list(p), gen) for p in prompts]
    assert all(r is not None for r in rids)
    b.run_until_drained()
    return [[int(t) for t in b.completed[r]] for r in rids]


BATCHERS = [("paged", {"tp": 2}), ("dense", {"tp": 2}),
            ("paged", {"tp": 2, "pp": 2}), ("dense", {"tp": 2, "pp": 2})]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("storage,axes", BATCHERS,
                         ids=[f"{s}-{_id(a)}" for s, a in BATCHERS])
def test_batcher_streams_equal_the_jax_batcher_on_its_mesh(kind, storage,
                                                           axes):
    pp = axes.get("pp", 1)
    jp, tparams = _weights(kind, n_layers=2 * pp)
    jcfg, cfg = _cfgs(2 * pp)
    kw = dict(pp=pp) if pp > 1 else {}
    if storage == "paged":
        kw["page_size"] = 16
    jcls = JaxPaged if storage == "paged" else JaxDense
    jb = jcls(jp, jcfg, n_slots=4, mesh=jmesh.make_mesh(axes), **kw)
    cls = PagedContinuousBatcher if storage == "paged" else ContinuousBatcher
    b = cls(tparams, cfg, n_slots=4, mesh=port_mesh(**axes), **kw)
    assert tp_degree(b.mesh) == 2
    layers = b.params["layers"]
    trees = layers[0] if pp > 1 else layers
    assert len(trees) == 2
    assert _codes(trees[1]["wq"]).shape[-1] == cfg.d_model // 2
    assert _drain(b) == _drain(jb)


@pytest.mark.parametrize("kind", KINDS)
def test_mixed_adapter_batch_on_a_split_quantized_base(kind):
    """A batch mixing two serving adapters and the base at tp = 2 over a
    quantized base (each shard's delta added to its block's product
    before the sum), through mixed rounds: streams equal the JAX
    batcher's with the same adapters."""
    from tpushare.serving import adapters as jadapters
    from tpushare_torch.models.bridge import adapter_from_numpy

    jp, tparams = _weights(kind)
    jcfg, cfg = _cfgs()

    def loader(name):
        return adapter_from_numpy(jax.tree_util.tree_map(
            np.asarray, jlora.make_adapter(
                jcfg, RANK, seed=jadapters._name_seed(name))), device="cpu")

    reqs = list(zip(PROMPTS, ["alice", None, "bob", "alice"]))
    outs = []
    for b in (JaxPaged(jp, jcfg, n_slots=4, page_size=8, adapter_slots=2,
                       adapter_rank=RANK),
              PagedContinuousBatcher(tparams, cfg, n_slots=4, page_size=8,
                                     mesh=port_mesh(tp=2), adapter_slots=2,
                                     adapter_rank=RANK,
                                     adapter_loader=loader)):
        rids = [b.admit_chunked(p, GEN, chunk=8, adapter=a)
                for p, a in reqs]
        while b.slots or b.prefilling:
            b.tick_mixed(2, chunk=8, budget=16)
        outs.append([[int(t) for t in b.completed[r]] for r in rids])
    assert tp_degree(b.mesh) == 2 and len(b.params["layers"]) == 2
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# QLoRA on tp
# ---------------------------------------------------------------------------
def _jax_lora(kind):
    """The reference's loraized quantized tiny tree, ``b`` drawn nonzero
    (a zero ``b`` gives ``a`` no gradient)."""
    cfg = jtf.tiny()
    p = _quantize(jtf.init_params(jax.random.PRNGKey(0), cfg), kind)
    lp = jlora.loraize_params(p, rank=RANK, adapter_dtype=jnp.float32)
    key = [jax.random.PRNGKey(7)]

    def nonzero_b(path, leaf):
        if jax.tree_util.keystr(path).endswith("['b']"):
            key[0], sub = jax.random.split(key[0])
            return (0.05 * jax.random.normal(sub, leaf.shape)).astype(
                leaf.dtype)
        return leaf

    return cfg, jax.tree_util.tree_map_with_path(nonzero_b, lp)


def _tokens(seed, shape=(4, 17)):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _base_leaves(params):
    out = []
    lora._map_tensors(
        lambda path, t: out.append(t) if not lora._is_adapter(path) else t,
        params)
    return out


LORA_MESHES = [{"tp": 2}, {"fsdp": 2, "tp": 2}]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("axes", LORA_MESHES, ids=_id)
def test_qlora_grads_equal_the_undivided_step(kind, axes):
    _, jp = _jax_lora(kind)
    one = _bridge(jp)
    ad = lora.partition(one)[0]
    for t in ad.values():
        t.requires_grad_(True)
    want_loss = ttrain.lm_loss(one, torch.from_numpy(_tokens(1)), ttf.tiny())
    want = dict(zip(ad, torch.autograd.grad(want_loss, list(ad.values()))))
    mesh = port_mesh(**axes)
    placed = tmesh.shard_params(_bridge(jp), mesh, ttf.tiny())
    assert ttf.tp_splits(placed["layers"], ttf.tiny(), 2)
    loss, grads = ttrain.sharded_loss_and_grads(
        ttrain.make_loss_fn(ttf.tiny()), placed,
        torch.from_numpy(_tokens(1)), mesh,
        trained=lambda tree: lora.partition(tree)[0])
    np.testing.assert_allclose(float(loss), float(want_loss.detach()),
                               rtol=LOSS_RTOL)
    it = iter(grads)
    got = lora.whole_adapters(ttrain.tree_map(
        lambda _: next(it), lora.placed_adapters(placed)))
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("axes", LORA_MESHES, ids=_id)
def test_qlora_three_steps_equal_undivided_and_jax(kind, axes):
    jcfg, jp = _jax_lora(kind)
    opt = ttrain.make_optimizer(lr=1e-3)
    one = _bridge(jp)
    ostate = opt.init(lora.partition(one)[0])
    ostep = lora.make_lora_train_step(ttf.tiny(), opt)
    mesh = port_mesh(**axes)
    placed = tmesh.shard_params(_bridge(jp), mesh, ttf.tiny())
    base_before = [t.clone() for t in _base_leaves(placed)]
    mopt = ttrain.make_optimizer(lr=1e-3)
    mstate = mopt.init(lora.placed_adapters(placed))
    mstep = lora.make_lora_train_step(ttf.tiny(), mopt, mesh=mesh)
    jm = jmesh.make_mesh(axes)
    jopt = jtrain.make_optimizer(lr=1e-3)
    jpp = jmesh.shard_params(jax.tree_util.tree_map(jnp.copy, jp), jm)
    jstate = jopt.init(jlora.partition(jpp)[0])
    jstep = jlora.make_lora_train_step(jcfg, jopt)
    for i in range(3):
        tok = _tokens(10 + i)
        one, ostate, ol = ostep(one, ostate, torch.from_numpy(tok))
        placed, mstate, ml = mstep(placed, mstate, torch.from_numpy(tok))
        jpp, jstate, jl = jstep(jpp, jstate, jnp.asarray(tok, jnp.int32))
        np.testing.assert_allclose(float(ml), float(ol), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(ml), float(jl), rtol=LOSS_RTOL)
    assert mstate["count"] == 3
    got = lora.whole_adapters(lora.placed_adapters(placed))
    want = lora.partition(one)[0]
    jwant = jlora.partition(jpp)[0]
    assert set(got) == set(want) == set(jwant)
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[name].detach().numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
        np.testing.assert_allclose(t.numpy(), np.asarray(jwant[name]),
                                   rtol=0, atol=JAX_ATOL, err_msg=name)
    for before, after in zip(base_before, _base_leaves(placed)):
        assert torch.equal(before, after)
        assert not after.requires_grad


def test_qlora_trainer_on_tp():
    """``Trainer(lora_rank=, mesh=)`` on an int8 base over ``{"tp": 2}``:
    the first loss is the base forward's (``b`` starts at zero), the
    losses fall, the base stays."""
    cfg = ttf.tiny(d_model=32, n_heads=2, n_kv_heads=2, n_layers=2,
                   vocab=64, max_seq=32)
    mesh = port_mesh(tp=2)
    tr = Trainer(cfg, lora_rank=4, mesh=mesh, quantize_bits=8, lr=1e-2,
                 seed=3)
    assert ttf.tp_splits(tr.params["layers"], cfg, 2)
    assert "q" in tr.params["layers"][1]["wq"]
    before = [t.clone() for t in _base_leaves(tr.params)]
    data = np.random.default_rng(2).integers(0, 64, (2, 17))
    losses = []
    tr.run(iter([data] * 4), 4, on_step=lambda i, l: losses.append(l))
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
    with pytest.raises(ValueError, match="lora_rank"):
        Trainer(cfg, mesh=mesh, quantize_bits=8)
    for x, y in zip(before, _base_leaves(tr.params)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flag", ["--int8", "--int4"])
def test_tp_with_quantized_weights_on_the_command_line(flag):
    """``--tp 2`` beside ``--int8`` / ``--int4`` on the CPU: the server
    keeps the tp axis, its batcher holds half of every projection's codes
    a shard, and its greedy streams equal an unsharded batcher's on the
    same weights."""
    args = parse_args(["--model", "tiny", "--tp", "2", flag, "--device",
                       "cpu", "--port", "0", "--addr", "127.0.0.1"])
    srv = start_server(args, env={}).start()
    try:
        assert srv.mesh.shape == {"tp": 2}
        trees = srv._service._batcher.params["layers"]
        assert len(trees) == 2
        body = json.dumps({"tokens": PROMPTS[:2],
                           "max_new_tokens": GEN}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate", data=body,
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())["tokens"]
    finally:
        srv.stop()
    cfg, params = build_model("tiny", quantize_int8=flag == "--int8",
                              quantize_int4=flag == "--int4", device="cpu")
    for name in ttf.TP_COL_LEAVES + ttf.TP_ROW_LEAVES:
        assert _codes(trees[1][name]).numel() * 2 == \
            _codes(params["layers"][name]).numel()
    ref = PagedContinuousBatcher(params, cfg, n_slots=4, page_size=16,
                                 device="cpu")
    assert out == _drain(ref, PROMPTS[:2])
