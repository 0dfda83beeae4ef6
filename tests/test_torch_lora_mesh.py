"""Port parity: LoRA fine-tuning on ``tp`` and ``fsdp`` meshes
(``parallel.mesh.shard_params`` of a loraized tree,
``ops.lora.make_lora_train_step(mesh=)``, ``Trainer(lora_rank=, mesh=)``)
against the undivided LoRA step and the JAX package.

* ``shard_params`` lays a loraized tree (plain, int8 and int4 bases) out
  as the reference's ``shard_params`` does, shard by shard, on
  ``{"tp": 2}`` and ``{"fsdp": 2, "tp": 2}``: every member of a loraized
  leaf holds at tp shard t (and fsdp shard f) exactly the reference's
  shard there; the adapter dims the rule does not divide stay whole.
* On ``{"tp": 2}``, ``{"fsdp": 2}``, ``{"dp": 2, "tp": 2}`` and ``{"fsdp":
  2, "tp": 2}``, ``tiny()`` f32 with the reference's loraized tree (``b``
  drawn nonzero): the loss within 1e-5 relative and every adapter
  gradient within 1e-6 of the undivided step's (an int8 base too, in
  its tp blocks), the frozen base without a gradient;
  three AdamW steps at lr 1e-3 leave the adapters within 1e-5 of three
  undivided steps and the base bit-unchanged; and within 2e-4 of three
  of the reference's ``make_lora_train_step`` steps on its own shardings.
* ``make_lora_train_step`` trains an int8 or int4 base on a tp mesh in
  its blocks, its first step equal to the undivided step's, and on fsdp
  alone; it refuses a base whose int4 packed rows tp does not divide
  (its forward would join the base whole each step), and a pp mesh.
* A rank-8 ``Trainer`` on ``{"fsdp": 2, "tp": 2}``: its first loss is the
  base forward's (``b`` is zero), the losses fall, the base stays, a
  checkpoint holds the whole adapter dict and resumes bit-identically.
"""

import itertools

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
from tpushare_torch.models import transformer as ttf
from tpushare_torch.models.bridge import params_from_numpy
from tpushare_torch.ops import lora
from tpushare_torch.parallel import mesh as tmesh
from tpushare_torch.parallel import train as ttrain
from tpushare_torch.parallel.trainer import Trainer

torch.set_num_threads(1)

CPU = torch.device("cpu")
RANK = 4
LOSS_RTOL = 1e-5
#: adapter gradients on a mesh against the undivided step's
GRAD_ATOL = 1e-6
#: adapters after three AdamW steps against three undivided steps
PARAM_ATOL = 1e-5
#: adapters after three steps against the reference's steps on its own
#: shardings
JAX_ATOL = 2e-4

MESHES = [{"tp": 2}, {"fsdp": 2}, {"dp": 2, "tp": 2}, {"fsdp": 2, "tp": 2}]


def _id(axes):
    return "x".join(f"{k}{v}" for k, v in axes.items())


def port_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return tmesh.make_mesh(axes, devices=[CPU] * n)


def _tokens(seed, shape=(4, 17)):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _jax_lora(base="plain", rank=RANK):
    """The reference's loraized tiny tree, ``b`` drawn nonzero (a zero
    ``b`` gives ``a`` no gradient)."""
    cfg = jtf.tiny()
    p = jtf.init_params(jax.random.PRNGKey(0), cfg)
    if base == "int8":
        p = jquant.quantize_params(p)
    elif base == "int4":
        p = jquant.quantize_params(p, bits=4, group=32)
    lp = jlora.loraize_params(p, rank=rank, adapter_dtype=jnp.float32)
    key = [jax.random.PRNGKey(7)]

    def nonzero_b(path, leaf):
        if jax.tree_util.keystr(path).endswith("['b']"):
            key[0], sub = jax.random.split(key[0])
            return (0.05 * jax.random.normal(sub, leaf.shape)).astype(
                leaf.dtype)
        return leaf

    return cfg, jax.tree_util.tree_map_with_path(nonzero_b, lp)


def _bridge(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------
def _jax_shard(arr, device):
    for shard in arr.addressable_shards:
        if shard.device == device:
            return np.asarray(shard.data)
    raise AssertionError("no shard on that device")


@pytest.mark.parametrize("base", ["plain", "int8", "int4"])
@pytest.mark.parametrize("axes", [{"tp": 2}, {"fsdp": 2, "tp": 2}], ids=_id)
def test_loraized_layout_is_the_reference_shard_by_shard(base, axes):
    jcfg, jp = _jax_lora(base)
    jm = jmesh.make_mesh(axes)
    jsharded = jmesh.shard_params(jp, jm)
    placed = tmesh.shard_params(_bridge(jp), port_mesh(**axes), ttf.tiny())
    grid = np.asarray(jm.devices).reshape(
        [axes.get("fsdp", 1), axes["tp"]])
    n_tp_blocks = 0
    for name in lora.LORA_SUFFIXES:
        jleaf = jsharded["layers"][name]
        for key in jleaf:
            for t in range(axes["tp"]):
                member = placed["layers"][t][name][key]
                if isinstance(member, tmesh.TpBlocks):
                    n_tp_blocks += 1
                    assert member is placed["layers"][0][name][key]
                    member = member[t]
                for f in range(axes.get("fsdp", 1)):
                    block = (member[f] if isinstance(member,
                                                     tmesh.FsdpBlocks)
                             else member)
                    want = _jax_shard(jleaf[key], grid[f, t])
                    np.testing.assert_array_equal(
                        block.numpy(), want, err_msg=f"{name}/{key} f{f} t{t}")
            if key in tmesh.LORA_WHOLE_MEMBERS:
                assert isinstance(placed["layers"][0][name][key],
                                  torch.Tensor)
    assert n_tp_blocks
    # the whole tree back, bit for bit
    whole = tmesh.gather_params(placed, ttf.tiny())
    want = _bridge(jp)
    for x, y in zip(ttrain.tree_leaves(whole), ttrain.tree_leaves(want)):
        assert torch.equal(x, y)


def test_indivisible_adapter_dims_stay_whole():
    """Rank 3 on tp 2: the rank dim splits no way, as the reference's
    legalization leaves it; the base still splits."""
    jcfg, jp = _jax_lora(rank=3)
    placed = tmesh.shard_params(_bridge(jp), port_mesh(tp=2), ttf.tiny())
    wq, wo = placed["layers"][0]["wq"], placed["layers"][0]["wo"]
    assert isinstance(wq["w"], tmesh.TpBlocksLast)
    assert isinstance(wo["w"], tmesh.TpBlocks)
    assert isinstance(wq["a"], torch.Tensor) and wq["a"].shape[-1] == 3
    assert isinstance(wo["b"], torch.Tensor) and wo["b"].shape[-2] == 3
    jsharded = jmesh.shard_params(jp, jmesh.make_mesh({"tp": 2}))
    spec = jsharded["layers"]["wq"]["a"].sharding.spec
    assert "tp" not in str(spec)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def _adapters_of(tree):
    return lora.partition(tree)[0]


def _whole_grads(placed, grads):
    it = iter(grads)
    tree = ttrain.tree_map(lambda _: next(it), lora.placed_adapters(placed))
    return lora.whole_adapters(tree)


@pytest.fixture(scope="module")
def undivided():
    out = {}
    for base in ("plain", "int8"):
        _, jp = _jax_lora(base)
        tp = _bridge(jp)
        ad = _adapters_of(tp)
        for t in ad.values():
            t.requires_grad_(True)
        loss = ttrain.lm_loss(tp, torch.from_numpy(_tokens(1)), ttf.tiny())
        grads = torch.autograd.grad(loss, list(ad.values()))
        out[base] = (float(loss), dict(zip(ad, grads)))
    return out


@pytest.mark.parametrize("base,axes", [("plain", a) for a in MESHES]
                         + [("int8", {"fsdp": 2, "tp": 2})],
                         ids=lambda v: v if isinstance(v, str) else _id(v))
def test_adapter_grads_equal_the_undivided_step(undivided, base, axes):
    _, jp = _jax_lora(base)
    mesh = port_mesh(**axes)
    placed = tmesh.shard_params(_bridge(jp), mesh, ttf.tiny())
    loss, grads = ttrain.sharded_loss_and_grads(
        ttrain.make_loss_fn(ttf.tiny()), placed,
        torch.from_numpy(_tokens(1)), mesh, trained=_adapters_of)
    want_loss, want = undivided[base]
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    got = _whole_grads(placed, grads)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)


def _base_leaves(params):
    out = []
    lora._map_tensors(
        lambda path, t: out.append(t) if not lora._is_adapter(path) else t,
        params)
    return out


@pytest.mark.parametrize("axes", MESHES, ids=_id)
def test_three_steps_equal_undivided_and_jax(axes):
    jcfg, jp = _jax_lora()
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
        placed, mstate, ml = mstep(placed, mstate,
                                   tmesh.shard_batch(torch.from_numpy(tok),
                                                     mesh))
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


@pytest.mark.parametrize("base", ["int8", "int4"])
@pytest.mark.parametrize("axes", [{"tp": 2}, {"fsdp": 2, "tp": 2}], ids=_id)
def test_lora_step_refuses_a_quantized_base_on_tp(base, axes):
    """A quantized base takes the tp split: the step trains it in its
    blocks, its loss and adapters equal to the undivided step's, and on
    fsdp alone.  It refuses, before it computes anything, only a base
    whose int4 packed rows tp does not divide (groups of 2), which would
    join its whole base on tp shard 0 each step."""
    _, jp = _jax_lora(base)
    opt = ttrain.make_optimizer(lr=1e-3)
    one = _bridge(jp)
    ostate = opt.init(lora.partition(one)[0])
    one, _, want = lora.make_lora_train_step(ttf.tiny(), opt)(
        one, ostate, torch.from_numpy(_tokens(3)))
    for axes_ in (axes, {"fsdp": 2}):
        mesh = port_mesh(**axes_)
        placed = tmesh.shard_params(_bridge(jp), mesh, ttf.tiny())
        mopt = ttrain.make_optimizer(lr=1e-3)
        state = mopt.init(lora.placed_adapters(placed))
        step = lora.make_lora_train_step(ttf.tiny(), mopt, mesh=mesh)
        placed, state, loss = step(placed, state,
                                   torch.from_numpy(_tokens(3)))
        assert state["count"] == 1
        np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
        got = lora.whole_adapters(lora.placed_adapters(placed))
        for name, t in lora.partition(one)[0].items():
            np.testing.assert_allclose(got[name].numpy(),
                                       t.detach().numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)
    cfg = jtf.tiny()
    p = jquant.quantize_params(jtf.init_params(jax.random.PRNGKey(0), cfg),
                               bits=4, group=2)
    odd = _bridge(jlora.loraize_params(p, rank=RANK,
                                       adapter_dtype=jnp.float32))
    mesh = port_mesh(**axes)
    placed = tmesh.shard_params(odd, mesh, ttf.tiny())
    state = opt.init(lora.placed_adapters(placed))
    step = lora.make_lora_train_step(ttf.tiny(), opt, mesh=mesh)
    with pytest.raises(NotImplementedError, match="does not take the tp"):
        step(placed, state, tmesh.shard_batch(torch.from_numpy(_tokens(3)),
                                              mesh))
    assert state["count"] == 0


def test_lora_step_refuses_a_pp_mesh():
    with pytest.raises(ValueError, match="pp mesh"):
        lora.make_lora_train_step(ttf.tiny(), ttrain.make_optimizer(),
                                  mesh=port_mesh(pp=2))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _cfg():
    return ttf.tiny(d_model=32, n_heads=2, n_kv_heads=2, n_layers=2,
                    vocab=64, max_seq=32)


def test_trainer_on_fsdp_tp_trains_adapters_and_resumes(tmp_path):
    fixed = np.random.default_rng(7).integers(0, 64, (4, 9))
    mesh = port_mesh(fsdp=2, tp=2)
    t = Trainer(_cfg(), mesh=mesh, lora_rank=8, lr=1e-2,
                ckpt_dir=str(tmp_path), save_every=2)
    base = ttf.init_params(_cfg(), seed=0, device="cpu")
    want0 = float(ttrain.lm_loss(base, torch.from_numpy(fixed), _cfg()))
    base_before = [x.clone() for x in _base_leaves(t.params)]
    losses = []
    t.run(itertools.repeat(fixed), 3, on_step=lambda s, l: losses.append(l))
    np.testing.assert_allclose(losses[0], want0, rtol=LOSS_RTOL)
    assert losses[2] < losses[1] < losses[0]
    for before, after in zip(base_before, _base_leaves(t.params)):
        assert torch.equal(before, after)
    t.run(itertools.repeat(fixed), 1)
    r = Trainer(_cfg(), mesh=mesh, lora_rank=8, lr=1e-2,
                ckpt_dir=str(tmp_path), save_every=100)
    assert r.step == 4
    for k, v in lora.whole_adapters(lora.placed_adapters(t.params)).items():
        assert torch.equal(
            v, lora.whole_adapters(lora.placed_adapters(r.params))[k])
    a, b = [], []
    t.run(itertools.repeat(fixed), 2, on_step=lambda s, l: a.append(l))
    r.run(itertools.repeat(fixed), 2, on_step=lambda s, l: b.append(l))
    assert a == b
