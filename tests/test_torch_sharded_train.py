"""Port parity: sharded training (``dp`` and ``fsdp`` on the port's mesh,
``make_train_step(mesh=)``, ``Trainer(mesh=)``, the optimizer over placed
trees, ``save_train_state`` / ``load_train_state``) against the JAX
package.

The mesh takes ``dp`` and ``fsdp`` as the reference's ``make_mesh`` does;
``shard_params`` puts the fsdp blocks where the reference's
``SHARDING_RULES`` put theirs (``embed`` and ``lm_head`` included) and
degenerates without an fsdp axis; ``shard_batch`` cuts the rows the
reference's does.  On ``tiny()`` f32 with the JAX package's own weights
(``models.bridge``), the sharded step's loss and gradients on dp, fsdp,
tp and their products equal ``jax.value_and_grad`` of the reference's
undivided loss: loss 1e-5 relative, gradients 1e-6 absolute (the two
frameworks sum in other orders, ~2e-7 measured); after one AdamW step at
lr 1e-4 the params are the port's flat step's within 1e-5.  Train states
round-trip bit-equal, across meshes too.  The JAX side runs on the
conftest's 8-device CPU mesh, the port's on ``make_mesh(..., devices=
["cpu"] * n)``.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpushare.models import transformer as jtf
from tpushare.parallel import mesh as jmesh
from tpushare.parallel import train as jtrain
from tpushare_torch.models import transformer as ttf
from tpushare_torch.models.bridge import params_from_numpy
from tpushare_torch.ops import lora
from tpushare_torch.parallel import mesh as tmesh
from tpushare_torch.parallel import train as ttrain
from tpushare_torch.parallel.trainer import Trainer
from tpushare_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-6
#: params after one AdamW step at lr 1e-4 against the flat step's
PARAM_ATOL = 1e-5
#: a trainer resumed without its mesh against the meshed run it left:
#: the losses of the same params on the same batch, summed in other
#: orders
RESUME_RTOL = 1e-5

MESHES = [{"dp": 2}, {"dp": 4}, {"fsdp": 4}, {"tp": 2}, {"fsdp": 2, "tp": 2},
          {"fsdp": 4, "tp": 2}, {"dp": 2, "fsdp": 2, "tp": 2},
          {"dp": 2, "tp": 2}]


def port_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return tmesh.make_mesh(axes, devices=[CPU] * n)


def _cfgs():
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, vocab=128)
    return jtf.tiny(**kw), ttf.tiny(**kw)


def _by_path(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_by_path(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (8, 17))
    loss, grads = jax.value_and_grad(jtrain.lm_loss)(
        jp, jnp.asarray(tokens, jnp.int32), jcfg)
    return jcfg, tcfg, jp, tokens, float(loss), _by_path(
        jax.tree_util.tree_map(np.asarray, grads))


def _tparams(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")


def _placed_state(opt, whole, mesh, cfg):
    state = opt.init(whole)
    return {**state, "mu": tmesh.shard_params(state["mu"], mesh, cfg),
            "nu": tmesh.shard_params(state["nu"], mesh, cfg)}


# ---------------------------------------------------------------------------
# the mesh, the fsdp layout, the batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axes", [{"dp": 2}, {"fsdp": 4, "tp": 2},
                                  {"dp": 2, "pp": 4}, {"dp": -1, "tp": 2}])
def test_make_mesh_takes_dp_and_fsdp_as_the_reference(axes):
    got = tmesh.make_mesh(axes, devices=[CPU] * 8)
    want = jmesh.make_mesh(axes)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert {"dp", "fsdp"} <= set(tmesh.PORTED_AXES)
    assert tmesh.AXES_TO_COME == {"ep": "A.12.4"}
    with pytest.raises(NotImplementedError, match="A.12.4"):
        tmesh.make_mesh({**axes, "ep": 1}, devices=[CPU] * 8)


def _jax_block(arr, grid, f, t):
    """The data of the JAX shard at mesh position (fsdp f, tp t)."""
    for shard in arr.addressable_shards:
        if shard.device == grid[f, t]:
            return np.asarray(shard.data), shard.index
    raise AssertionError("no shard at that position")


def test_fsdp_layout_is_the_reference_rules(model):
    """On ``{"fsdp": 4, "tp": 2}`` every leaf the reference's rules split
    over fsdp is an ``FsdpBlocks`` on the rule's dim; a tp-split layer
    leaf's block (f, t) is the reference's shard at (f, t) element for
    element; ``embed`` and ``lm_head`` (whole over tp in the port) are
    the reference's fsdp row ranges; the norm scales stay whole."""
    jcfg, tcfg, jp, *_ = model
    jm = jmesh.make_mesh({"fsdp": 4, "tp": 2})
    jsharded = jmesh.shard_params(jp, jm)
    assert jsharded["layers"]["wq"].sharding.spec == \
        jmesh.P(None, "fsdp", "tp")
    got = tmesh.shard_params(_tparams(jp), port_mesh(fsdp=4, tp=2), tcfg)
    grid = jm.devices
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        for t in range(2):
            blocks = got["layers"][t][name]
            assert isinstance(blocks, tmesh.FsdpBlocks) and len(blocks) == 4
            assert blocks.dim == tmesh.FSDP_DIMS[name]
            for f in range(4):
                want, _ = _jax_block(jsharded["layers"][name], grid, f, t)
                np.testing.assert_array_equal(blocks[f].numpy(), want)
    for name in ("embed", "lm_head"):
        blocks = got[name]
        assert isinstance(blocks, tmesh.FsdpBlocks) and blocks.dim == -2
        whole = np.asarray(jp[name])
        for f in range(4):
            _, index = _jax_block(jsharded[name], grid, f, 0)
            np.testing.assert_array_equal(blocks[f].numpy(),
                                          whole[index[0]])
    for name in ("attn_scale", "ffn_scale"):
        assert isinstance(got["layers"][0][name], torch.Tensor)
        assert name not in got["layers"][1]
    assert isinstance(got["final_scale"], torch.Tensor)


def test_fsdp_rules_degenerate_without_fsdp_axis(model):
    jcfg, tcfg, jp, *_ = model
    jm = jmesh.make_mesh({"dp": -1, "tp": 2})
    jsharded = jmesh.shard_params(jp, jm)
    assert jsharded["layers"]["wq"].sharding.spec == jmesh.P(None, None,
                                                             "tp")
    got = tmesh.shard_params(_tparams(jp), port_mesh(dp=4, tp=2), tcfg)
    assert isinstance(got, tmesh.Replicas) and len(got) == 4
    assert all(r is got[0] for r in got)      # one card: one replica
    assert not any(isinstance(x, tmesh.FsdpBlocks)
                   for x in _walk_tuples(got[0]))
    assert got[0]["layers"][0]["wq"].shape == (2, 64, 32)


def _walk_tuples(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk_tuples(v)
    elif isinstance(tree, tuple):
        yield tree
        for v in tree:
            yield from _walk_tuples(v)


def test_fsdp_legalizes_an_indivisible_dim(model):
    """fsdp 3 divides none of tiny()'s split dims (64, 128): every leaf
    stays whole, as the reference's shardings replicate them."""
    jcfg, tcfg, jp, *_ = model
    jsharded = jmesh.shard_params(jp, jmesh.make_mesh({"fsdp": 3}))
    for name in ("embed", "lm_head"):
        assert jsharded[name].sharding.shard_shape(jsharded[name].shape) \
            == jsharded[name].shape
    got = tmesh.shard_params(_tparams(jp), port_mesh(fsdp=3), tcfg)
    assert not any(isinstance(x, tmesh.FsdpBlocks)
                   for x in _walk_tuples(got))


def test_shard_batch_cuts_row_blocks():
    """Block i is rows [2i, 2i + 2) on ``mesh.device(dp=i)``, together the
    reference's global batch (whose right-aligned legalization of
    ``P("dp")`` lands on the [B, S+1] batch's last dim, 17, and so splits
    nothing); a batch dp does not divide, or a mesh without dp, leaves
    the batch whole."""
    tokens = np.arange(8 * 17).reshape(8, 17)
    want = jmesh.shard_batch(jnp.asarray(tokens), jmesh.make_mesh({"dp": 4}))
    mesh = port_mesh(dp=4)
    got = tmesh.shard_batch(torch.from_numpy(tokens), mesh)
    assert isinstance(got, tuple) and len(got) == 4
    for i, block in enumerate(got):
        assert block.device == mesh.device(dp=i)
        np.testing.assert_array_equal(block.numpy(), tokens[2 * i:2 * i + 2])
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(want))
    six = torch.from_numpy(tokens[:6])
    assert tmesh.shard_batch(six, mesh) is six
    assert tmesh.shard_batch(six, port_mesh(tp=2)) is six


@pytest.mark.parametrize("axes", [{"tp": 2, "pp": 2}, {"fsdp": 2, "tp": 2},
                                  {"dp": 2, "pp": 2}, {"dp": 2, "fsdp": 4},
                                  {"fsdp": 2, "pp": 2}])
def test_gather_params_inverts_shard_params(model, axes):
    jcfg, tcfg, jp, *_ = model
    whole = _tparams(jp)
    back = tmesh.gather_params(tmesh.shard_params(whole, port_mesh(**axes),
                                                  tcfg), tcfg)
    got, want = _by_path(back), _by_path(whole)
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype
        assert torch.equal(got[name], w), name


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axes", MESHES)
def test_sharded_loss_and_grads_equal_jax(model, axes):
    jcfg, tcfg, jp, tokens, jloss, jgrads = model
    mesh = port_mesh(**axes)
    placed = tmesh.shard_params(_tparams(jp), mesh, tcfg)
    loss, grads = ttrain.sharded_loss_and_grads(
        ttrain.make_loss_fn(tcfg), placed,
        tmesh.shard_batch(torch.from_numpy(tokens), mesh), mesh)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    it = iter(grads)
    tree = ttrain.tree_map(lambda _: next(it), placed)
    got = _by_path(tmesh.gather_params(tree, tcfg))
    assert set(got) == set(jgrads)
    for name, w in jgrads.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("axes", [{"dp": 2}, {"fsdp": 2, "tp": 2},
                                  {"dp": 2, "fsdp": 2, "tp": 2}])
def test_sharded_step_equals_the_flat_step(model, axes):
    jcfg, tcfg, jp, tokens, *_ = model
    opt = ttrain.make_optimizer(lr=1e-4)
    flat = _tparams(jp)
    flat, _, floss = ttrain.make_train_step(tcfg, opt)(
        flat, opt.init(flat), torch.from_numpy(tokens))
    mesh = port_mesh(**axes)
    whole = _tparams(jp)
    state = _placed_state(opt, whole, mesh, tcfg)
    placed = tmesh.shard_params(whole, mesh, tcfg)
    step = ttrain.make_train_step(tcfg, opt, mesh=mesh)
    placed, state, loss = step(placed, state,
                               tmesh.shard_batch(torch.from_numpy(tokens),
                                                 mesh))
    np.testing.assert_allclose(float(loss), float(floss), rtol=LOSS_RTOL)
    got = _by_path(tmesh.gather_params(placed, tcfg))
    for name, w in _by_path(flat).items():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   w.detach().numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    assert state["count"] == 1


def test_dp_replicas_of_distinct_tensors_stay_bit_equal(model):
    """Replicas that do not share a card (here: clones) are stepped with
    the one summed gradient, so they stay bit-equal, and the step equals
    the shared-card layout's."""
    jcfg, tcfg, jp, tokens, *_ = model
    mesh = port_mesh(dp=2)
    opt = ttrain.make_optimizer(lr=1e-3)
    shared = tmesh.shard_params(_tparams(jp), mesh, tcfg)
    sstate = opt.init(shared)
    rep = tmesh.shard_params(_tparams(jp), mesh, tcfg)[0]
    distinct = tmesh.Replicas((rep, ttrain.tree_map(torch.clone, rep)))
    dstate = opt.init(distinct)
    step = ttrain.make_train_step(tcfg, opt, mesh=mesh)
    rng = np.random.default_rng(3)
    for _ in range(3):
        batch = torch.from_numpy(rng.integers(0, tcfg.vocab, (8, 17)))
        shared, sstate, sl = step(shared, sstate, batch)
        distinct, dstate, dl = step(distinct, dstate, batch)
        np.testing.assert_allclose(float(dl), float(sl), rtol=LOSS_RTOL)
    for a, b in zip(ttrain.tree_leaves(distinct[0]),
                    ttrain.tree_leaves(distinct[1])):
        assert a is not b and torch.equal(a, b)
    for a, b in zip(ttrain.tree_leaves(distinct[0]),
                    ttrain.tree_leaves(shared[0])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=PARAM_ATOL)


def test_dp_step_runs_an_indivisible_batch_whole(model):
    jcfg, tcfg, jp, tokens, jloss, _ = model
    mesh = port_mesh(dp=4)
    opt = ttrain.make_optimizer(lr=1e-4)
    whole = _tparams(jp)
    state = _placed_state(opt, whole, mesh, tcfg)
    placed = tmesh.shard_params(whole, mesh, tcfg)
    six = torch.from_numpy(tokens[:6])
    want = float(ttrain.lm_loss(_tparams(jp), six, tcfg))
    _, _, loss = ttrain.make_train_step(tcfg, opt, mesh=mesh)(
        placed, state, tmesh.shard_batch(six, mesh))
    np.testing.assert_allclose(float(loss), want, rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# the optimizer over placed trees
# ---------------------------------------------------------------------------
def test_adamw_steps_a_shared_tensor_and_a_view_once():
    """A tree naming one tensor twice, and one strided view twice (two
    objects), steps each once: the same values as a tree naming each
    once; the base's other columns are untouched by the strided step.
    The clip's norm counts each once too."""
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    base = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    g_t = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    g_v = torch.from_numpy(rng.standard_normal((5, 4)).astype(np.float32))
    for clip in (0.0, 0.5):
        opt = ttrain.AdamW(1e-1, grad_clip_norm=clip)
        once_t, once_base = t.clone(), base.clone()
        once = {"t": once_t, "v": once_base[:, 2:6]}
        ostate = opt.init(once)
        opt.update(once, [g_t.clone(), g_v.clone()], ostate)
        twice_t, twice_base = t.clone(), base.clone()
        twice = {"a": twice_t, "b": (twice_t, twice_base[:, 2:6]),
                 "c": twice_base[:, 2:6]}
        tstate = opt.init(twice)
        assert tstate["mu"]["a"] is tstate["mu"]["b"][0]
        opt.update(twice, [g_t.clone(), g_t.clone(), g_v.clone(),
                           g_v.clone()], tstate)
        assert torch.equal(twice_t, once_t)
        assert torch.equal(twice_base, once_base)
        assert torch.equal(twice_base[:, :2], base[:, :2])
        assert torch.equal(twice_base[:, 6:], base[:, 6:])
        assert not torch.equal(twice_base[:, 2:6], base[:, 2:6])
        # the strided view stepped as a contiguous tensor would be
        flat = base[:, 2:6].clone()
        fstate = opt.init({"v": flat, "t": t.clone()})
        opt.update({"v": flat, "t": fstate["mu"]["t"].clone() + t},
                   [g_v.clone(), g_t.clone()], fstate)
        if clip == 0.0:
            assert torch.equal(flat, once_base[:, 2:6])


def test_tree_walks_keep_tuple_kinds():
    tree = {"a": tmesh.Staged(({"w": torch.ones(2)}, {"w": torch.zeros(2)})),
            "b": tmesh.FsdpBlocksLast((torch.ones(1), torch.ones(1))),
            "c": (torch.ones(3),)}
    out = ttrain.tree_map(lambda x: x + 1, tree)
    assert isinstance(out["a"], tmesh.Staged)
    assert type(out["b"]) is tmesh.FsdpBlocksLast and out["b"].dim == -1
    assert type(out["c"]) is tuple
    assert [x.tolist() for x in ttrain.tree_leaves(out)] == [
        [2.0, 2.0], [1.0, 1.0], [2.0], [2.0], [2.0, 2.0, 2.0]]


# ---------------------------------------------------------------------------
# the one-shot train state
# ---------------------------------------------------------------------------
def test_train_state_roundtrip(tmp_path, model):
    """Params (plain, int8 and int4 leaves) + the optimizer state + the
    count survive a save / load bit-equal; training continues
    bit-identically from the restored state; an existing directory is
    refused."""
    jcfg, tcfg, jp, tokens, *_ = model
    opt = ttrain.make_optimizer(lr=1e-2)
    params = _tparams(jp)
    state = opt.init(params)
    step = ttrain.make_train_step(tcfg, opt)
    params, state, _ = step(params, state, torch.from_numpy(tokens))
    q8 = ttf.init_params(tcfg, seed=1, device="cpu", quantize_bits=8)
    q4 = ttf.init_params(tcfg, seed=2, device="cpu", quantize_bits=4)
    saved = {"params": params, "opt_state": state, "step": 1,
             "int8": q8["layers"]["wq"], "int4": q4["layers"]["w_up"]}
    ckpt = str(tmp_path / "ckpt")
    tckpt.save_train_state(ckpt, saved)
    back = tckpt.load_train_state(ckpt)
    assert back["step"] == 1 and back["opt_state"]["count"] == 1
    assert set(back["int8"]) == {"q", "s"} and set(back["int4"]) == {"q4",
                                                                      "s"}
    a, b = ttrain.tree_leaves(saved), ttrain.tree_leaves(back)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x.detach(), y)
        else:
            assert x == y
    copy = ttrain.tree_map(lambda x: x.detach().clone(), saved["params"])
    cstate = {**state, "mu": ttrain.tree_map(torch.clone, state["mu"]),
              "nu": ttrain.tree_map(torch.clone, state["nu"])}
    _, _, l1 = step(copy, cstate, torch.from_numpy(tokens))
    _, _, l2 = step(back["params"], back["opt_state"],
                    torch.from_numpy(tokens))
    assert float(l1) == float(l2)
    with pytest.raises(FileExistsError, match="make_checkpoint_manager"):
        tckpt.save_train_state(ckpt, saved)


def test_load_train_state_takes_like_s_layout(tmp_path, model):
    jcfg, tcfg, jp, *_ = model
    mesh = port_mesh(dp=2, fsdp=2, tp=2)
    placed = tmesh.shard_params(_tparams(jp), mesh, tcfg)
    ckpt = str(tmp_path / "placed")
    tckpt.save_train_state(ckpt, {"params": placed, "count": 3})
    plain = tckpt.load_train_state(ckpt)
    assert type(plain["params"]) is tuple
    back = tckpt.load_train_state(ckpt, like={"params": placed, "count": 0})
    assert back["count"] == 3
    assert isinstance(back["params"], tmesh.Replicas)
    assert isinstance(back["params"][0]["layers"][1]["wo"],
                      tmesh.FsdpBlocksLast)
    for x, y in zip(ttrain.tree_leaves(back["params"]),
                    ttrain.tree_leaves(placed)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="keys"):
        tckpt.load_train_state(ckpt, like={"params": placed})


# ---------------------------------------------------------------------------
# the Trainer on a mesh
# ---------------------------------------------------------------------------
def _small_cfg():
    return ttf.tiny(d_model=32, n_heads=2, n_kv_heads=2, n_layers=2,
                    vocab=64, max_seq=32)


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(0, 64, (4, 9))


@pytest.mark.parametrize("axes", [{"pp": 2}, {"dp": 2, "pp": 2}, {"dp": 2},
                                  {"fsdp": 2}, {"tp": 2},
                                  {"fsdp": 2, "tp": 2}])
def test_trainer_descends_on_each_mesh(axes):
    t = Trainer(_small_cfg(), mesh=port_mesh(**axes), lr=1e-2)
    fixed = next(_batches(7))
    losses = []
    t.run(itertools.repeat(fixed), 4, on_step=lambda s, l: losses.append(l))
    assert losses[-1] < losses[0] and t.step == 4
    assert t.opt_state["count"] == 4
    assert all(torch.isfinite(p).all() for p in ttrain.tree_leaves(t.params))


@pytest.mark.parametrize("axes", [{"dp": 2, "pp": 2}, {"fsdp": 2, "tp": 2}])
def test_trainer_on_a_mesh_resumes_bit_identically(tmp_path, axes):
    """A meshed trainer that saves at step 3 and dies: a fresh one on the
    same mesh continues bit-identically; one without a mesh resumes the
    same state bit for bit and continues within float reassociation."""
    ckpt = str(tmp_path / "ckpt")
    fixed = list(itertools.islice(_batches(), 5))
    a = Trainer(_small_cfg(), mesh=port_mesh(**axes), ckpt_dir=ckpt,
                save_every=3, lr=1e-2)
    a_losses = []
    a.run(iter(fixed), 5, on_step=lambda s, l: a_losses.append(l))
    _, saved = tckpt.restore_latest(tckpt.make_checkpoint_manager(ckpt))
    b = Trainer(_small_cfg(), mesh=port_mesh(**axes), ckpt_dir=ckpt,
                save_every=1000, lr=1e-2, seed=123)
    assert b.step == 3
    b_losses = []
    b.run(iter(fixed[3:]), 2, on_step=lambda s, l: b_losses.append(l))
    assert a_losses[3:] == b_losses
    cfg = _small_cfg()
    for x, y in zip(ttrain.tree_leaves(tmesh.gather_params(a.params, cfg)),
                    ttrain.tree_leaves(tmesh.gather_params(b.params, cfg))):
        assert torch.equal(x, y)
    assert b.opt_state["count"] == a.opt_state["count"] == 5
    c = Trainer(cfg, ckpt_dir=ckpt, save_every=1000, lr=1e-2, seed=123,
                device="cpu")
    assert c.step == 3
    for x, y in zip(ttrain.tree_leaves(c.params),
                    ttrain.tree_leaves(saved["params"])):
        assert torch.equal(x.detach(), y.detach())
    c_losses = []
    c.run(iter(fixed[3:]), 2, on_step=lambda s, l: c_losses.append(l))
    np.testing.assert_allclose(c_losses, a_losses[3:], rtol=RESUME_RTOL)


def test_trainer_lora_over_dp():
    """Adapters train over a dp mesh: the first loss is the one-device
    LoRA trainer's, the loss descends, the replicas share the card, and
    a checkpoint holds the whole adapter dict."""
    fixed = next(_batches(7))
    one = Trainer(_small_cfg(), lora_rank=4, lr=1e-2, device="cpu")
    dp = Trainer(_small_cfg(), mesh=port_mesh(dp=2), lora_rank=4, lr=1e-2)
    lo, ld = [], []
    one.run(itertools.repeat(fixed), 4, on_step=lambda s, l: lo.append(l))
    dp.run(itertools.repeat(fixed), 4, on_step=lambda s, l: ld.append(l))
    np.testing.assert_allclose(ld[0], lo[0], rtol=LOSS_RTOL)
    assert ld[-1] < ld[0]
    assert isinstance(dp.params, tmesh.Replicas)
    assert dp.params[0] is dp.params[1]
    adapters = lora.partition(dp.params[0])[0]
    assert set(dp.opt_state["mu"][0]) == set(adapters)


def test_trainer_mesh_refusals():
    with pytest.raises(ValueError, match="parallel.mesh.Mesh"):
        Trainer(_small_cfg(), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="lora_rank with a pp mesh"):
        Trainer(_small_cfg(), mesh=port_mesh(pp=2), lora_rank=4)
    for axes in ({"tp": 2}, {"fsdp": 2}, {"dp": 2, "tp": 2}):
        with pytest.raises(NotImplementedError, match="A.17"):
            Trainer(_small_cfg(), mesh=port_mesh(**axes), lora_rank=4)
