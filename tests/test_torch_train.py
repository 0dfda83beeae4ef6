"""Port parity of the training slice: ``tpushare_torch.parallel`` (loss,
AdamW, remat, train step, Trainer) and ``tpushare_torch.utils`` against
the JAX package, on ``tiny()`` f32 with the JAX package's own
``init_params(PRNGKey(0))`` weights carried over by the bridge.

The train step runs twice: through ``attention()``'s reference path (what
the CPU takes), and with the port's flash gate opened for CPU tensors, so
that the autograd Function's plain forward and backward (K1's and K3 +
K4's plain versions) are what the step differentiates.  The JAX step runs
its reference attention on the CPU.  All compute is f32; the two
frameworks sum in other orders, so losses are held within 1e-5 relative,
every gradient within 1e-6 absolute (measured: ~2e-7), and params after
three AdamW steps within 1e-5.  The steps take lr 1e-4: AdamW divides
each gradient by its own magnitude, so the gradients' ~2e-7 disagreement
moves a param by about lr * 2e-7 / |g|, and at lr 1e-2 one element in
1e4 of this model (|g| near 1e-7) lands up to 2 * lr apart.  AdamW's own
arithmetic is held to optax's on identical gradients at lr 0.1.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import transformer as jtf
from tpushare.parallel import train as jtrain
from tpushare.utils import checkpoint as jckpt
from tpushare.utils import data as jdata
from tpushare_torch.models import transformer as ttf
from tpushare_torch.models.bridge import params_from_numpy
from tpushare_torch.ops import attention as tattn
from tpushare_torch.parallel import train as ttrain
from tpushare_torch.parallel.mesh import make_mesh
from tpushare_torch.parallel.trainer import Trainer
from tpushare_torch.utils import checkpoint as tckpt
from tpushare_torch.utils import data as tdata

# tiny shapes: one intra-op thread, so this file does not crowd the
# wall-clock tests that other workers run beside it
torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-6
PARAM_ATOL = 1e-5
#: the same port computation arranged differently (chunked vs monolithic
#: loss, remat modes): f32 reassociation only
SELF_ATOL = 1e-6


def _jparams(cfg=None):
    return jtf.init_params(jax.random.PRNGKey(0), cfg or jtf.tiny())


def _bridge(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.fixture
def flash_on_cpu(monkeypatch):
    """Open the flash gate for CPU tensors and count the plain versions'
    calls: [K1 forwards, K3 + K4 backwards]."""
    calls = [0, 0]
    fwd, bwd = tattn._flash_plain, tattn._flash_bwd_plain

    def counted_fwd(*a):
        calls[0] += 1
        return fwd(*a)

    def counted_bwd(*a):
        calls[1] += 1
        return bwd(*a)

    monkeypatch.setattr(tattn, "use_flash", lambda q, k: True)
    monkeypatch.setattr(tattn, "_flash_plain", counted_fwd)
    monkeypatch.setattr(tattn, "_flash_bwd_plain", counted_bwd)
    return calls


@pytest.mark.parametrize("path,remat,head_chunk,opt", [
    ("reference", "none", 0, {"lr": 1e-4}),
    ("flash", "layer", 8, {"lr": 1e-4, "schedule": "cosine",
                           "warmup_steps": 1, "total_steps": 10,
                           "grad_clip_norm": 1.0}),
])
def test_train_steps_match_jax(request, path, remat, head_chunk, opt):
    calls = request.getfixturevalue("flash_on_cpu") if path == "flash" \
        else None
    jcfg, tcfg = jtf.tiny(), ttf.tiny()
    jparams = _jparams(jcfg)
    tparams = _bridge(jparams)
    jopt, topt = jtrain.make_optimizer(**opt), ttrain.make_optimizer(**opt)
    jstep = jtrain.make_train_step(jcfg, jopt, remat=remat,
                                   head_chunk=head_chunk)
    tstep = ttrain.make_train_step(tcfg, topt, remat=remat,
                                   head_chunk=head_chunk)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    steps = 3
    for i in range(steps):
        tokens = _tokens(i, (2, 25))
        jparams, jstate, jloss = jstep(jparams, jstate,
                                       jnp.asarray(tokens, jnp.int32))
        tparams, tstate, tloss = tstep(tparams, tstate,
                                       torch.from_numpy(tokens))
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=LOSS_RTOL)
    if calls is not None:
        # K1 once per layer and step (the remat policy keeps its out and
        # lse), its backward once per layer and step
        assert calls == [steps * tcfg.n_layers, steps * tcfg.n_layers]
    assert tstate["count"] == steps
    want = jax.tree_util.tree_leaves(jparams)
    got = jax.tree_util.tree_leaves(_bridge_back(tparams))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=PARAM_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("path", ["reference", "flash"])
def test_loss_and_grads_match_jax(request, path):
    """The port's loss and every gradient against ``jax.grad`` of the
    JAX package's loss at the same params and tokens."""
    if path == "flash":
        request.getfixturevalue("flash_on_cpu")
    tokens = _tokens(11, (2, 25))
    jl, jg = jax.value_and_grad(jtrain.lm_loss)(
        _jparams(), jnp.asarray(tokens, jnp.int32), jtf.tiny())
    params = _bridge(_jparams())
    leaves = ttrain.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = ttrain.lm_loss(params, torch.from_numpy(tokens), ttf.tiny())
    grads = iter(torch.autograd.grad(loss, leaves))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    got = jax.tree_util.tree_leaves(_bridge_back(
        ttrain.tree_map(lambda _: next(grads), params)))
    for g, w in zip(got, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL, rtol=0)


def _bridge_back(tparams):
    """The port's params as a numpy tree in the JAX package's key order."""
    return jax.tree_util.tree_map(lambda x: x.detach().numpy(), tparams,
                                  is_leaf=lambda x: isinstance(
                                      x, torch.Tensor))


def _loss_and_grads(loss_fn, tokens):
    params = _bridge(_jparams())
    leaves = ttrain.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, torch.from_numpy(tokens))
    return loss.item(), [g.numpy() for g in torch.autograd.grad(loss,
                                                               leaves)]


def _assert_same(a, b):
    (l0, g0), (l1, g1) = a, b
    np.testing.assert_allclose(l1, l0, rtol=SELF_ATOL)
    assert len(g0) == len(g1)
    for x, y in zip(g1, g0):
        np.testing.assert_allclose(x, y, atol=SELF_ATOL, rtol=0)


def test_chunked_loss_equals_monolithic():
    cfg = ttf.tiny()
    tokens = _tokens(5, (2, 25))
    mono = _loss_and_grads(ttrain.make_loss_fn(cfg), tokens)
    chunked = _loss_and_grads(ttrain.make_loss_fn(cfg, head_chunk=8), tokens)
    _assert_same(mono, chunked)
    # a chunk that does not divide S takes the monolithic loss
    assert _loss_and_grads(ttrain.make_loss_fn(cfg, head_chunk=7),
                           tokens)[0] == mono[0]
    jl = jtrain.lm_loss(_jparams(), jnp.asarray(tokens, jnp.int32),
                        jtf.tiny(), head_chunk=8)
    np.testing.assert_allclose(chunked[0], float(jl), rtol=LOSS_RTOL)


@pytest.mark.parametrize("path", ["reference", "flash"])
def test_remat_modes_agree(request, path):
    """none / layer / full give equal losses and grads; through the flash
    Function, K1 runs once per layer under none and layer (the policy
    keeps its residuals) and twice under full, its backward once."""
    calls = request.getfixturevalue("flash_on_cpu") if path == "flash" \
        else None
    cfg = ttf.tiny()
    tokens = _tokens(9, (2, 25))
    results = {}
    for remat in ("none", "layer", "full"):
        if calls is not None:
            calls[:] = [0, 0]
        results[remat] = _loss_and_grads(ttrain.make_loss_fn(cfg, remat),
                                         tokens)
        if calls is not None:
            k1 = {"none": 1, "layer": 1, "full": 2}[remat] * cfg.n_layers
            assert calls == [k1, cfg.n_layers], remat
    _assert_same(results["none"], results["layer"])
    _assert_same(results["none"], results["full"])


@pytest.mark.parametrize("kind,warmup,total", [("cosine", 10, 100),
                                               ("linear", 10, 100),
                                               ("linear", 0, 10),
                                               ("cosine", 0, 40)])
def test_lr_schedule_matches_jax(kind, warmup, total):
    js = jtrain.make_lr_schedule(1e-3, kind, warmup_steps=warmup,
                                 total_steps=total)
    ts = ttrain.make_lr_schedule(1e-3, kind, warmup_steps=warmup,
                                 total_steps=total)
    warm = max(warmup, 1)
    for step in (0, 1, warm, (warm + total) // 2, total, total + 5):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")
    assert ts(0) == 0.0                            # warmup starts at 0
    assert ttrain.make_lr_schedule(1e-3) == 1e-3   # constant passthrough
    with pytest.raises(ValueError, match="total_steps"):
        ttrain.make_optimizer(schedule=kind)
    with pytest.raises(ValueError, match="constant"):
        ttrain.make_optimizer(schedule="nope")


def test_clipping_bounds_the_second_moment():
    """Clipping bounds what enters adam's moments (the normalized update
    hides it at step 1, so check nu): a 1e3 spike with clip_norm 1 puts
    <= 1-norm grads into nu; unclipped, nu sees the spike.  Both states
    and params equal optax's."""
    spike = np.full((4,), 1e3, np.float32)
    for clip in (1.0, 0.0):
        topt = ttrain.make_optimizer(lr=0.1, grad_clip_norm=clip)
        jopt = jtrain.make_optimizer(lr=0.1, grad_clip_norm=clip)
        p = {"w": torch.full((4,), 0.5)}
        state = topt.init(p)
        topt.update(p, [torch.tensor(spike)], state)
        jp = {"w": jnp.full((4,), 0.5, jnp.float32)}
        jst = jopt.init(jp)
        upd, jst = jopt.update({"w": jnp.asarray(spike)}, jst, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        adam = jst[-1][0] if clip else jst[0]
        nu = state["nu"]["w"]
        if clip:
            assert nu.max().item() <= 1.0 + 1e-6
        else:
            assert nu.max().item() >= 1e4
        np.testing.assert_allclose(nu.numpy(), np.asarray(adam.nu["w"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(state["mu"]["w"].numpy(),
                                   np.asarray(adam.mu["w"]), rtol=1e-6)
        np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("opt", [
    {"lr": 0.1},
    {"lr": 0.1, "schedule": "cosine", "warmup_steps": 2, "total_steps": 6,
     "grad_clip_norm": 3.0},
    {"lr": 0.1, "schedule": "linear", "warmup_steps": 0, "total_steps": 4,
     "weight_decay": 0.3},
])
def test_adamw_matches_optax(monkeypatch, opt):
    """Six steps on the same random grads: params and both moments equal
    optax's (f32, rtol 1e-6), the clip's norm summed in chunks smaller
    than a leaf."""
    monkeypatch.setattr(ttrain.AdamW, "NORM_CHUNK", 7)
    rng = np.random.default_rng(4)
    init = {"a": rng.standard_normal((5, 6), np.float32),
            "b": {"c": rng.standard_normal((13,), np.float32)}}
    topt, jopt = ttrain.make_optimizer(**opt), jtrain.make_optimizer(**opt)
    tp = ttrain.tree_map(torch.tensor, init)      # copies: updated in place
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    tst, jst = topt.init(tp), jopt.init(jp)
    for _ in range(6):
        g = jax.tree_util.tree_map(
            lambda x: 2.0 * rng.standard_normal(x.shape, np.float32), init)
        topt.update(tp, [torch.tensor(x) for x in ttrain.tree_leaves(g)],
                    tst)
        upd, jst = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jst,
                               jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
    adam = jst[-1][0] if opt.get("grad_clip_norm") else jst[0]
    for got, want in ((tp, jp), (tst["mu"], adam.mu), (tst["nu"], adam.nu)):
        for x, y in zip(jax.tree_util.tree_leaves(_bridge_back(got)),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(x, np.asarray(y), rtol=1e-6,
                                       atol=1e-7)
    assert tst["count"] == 6


def _small_cfg():
    return ttf.tiny(d_model=32, n_heads=2, n_kv_heads=1, n_layers=2,
                    vocab=64, max_seq=32)


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(0, 64, (4, 9))


def test_trainer_resume_is_bit_identical(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    # run A: 5 steps straight through, checkpointing only at step 3
    a = Trainer(_small_cfg(), ckpt_dir=ckpt, save_every=3, lr=1e-2,
                device="cpu")
    fixed = list(itertools.islice(_batches(), 5))
    a_losses = []
    a.run(iter(fixed), 5, on_step=lambda s, l: a_losses.append(l))
    # run B: a fresh trainer resumes from step 3's checkpoint
    b = Trainer(_small_cfg(), ckpt_dir=ckpt, save_every=1000, lr=1e-2,
                seed=123, device="cpu")
    assert b.step == 3
    b_losses = []
    b.run(iter(fixed[3:]), 2, on_step=lambda s, l: b_losses.append(l))
    assert a_losses[3:] == b_losses
    for x, y in zip(ttrain.tree_leaves(a.params),
                    ttrain.tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert b.opt_state["count"] == a.opt_state["count"] == 5


def test_trainer_descends_and_refuses_what_is_not_ported():
    t = Trainer(_small_cfg(), lr=1e-2, device="cpu")
    fixed = next(_batches(7))
    losses = []
    last = t.run(itertools.repeat(fixed), 5,
                 on_step=lambda s, l: losses.append(l))
    assert losses[-1] < losses[0] and last == losses[-1] and t.step == 5
    # a mesh must be the port's Mesh; LoRA does not run the 1F1B step
    with pytest.raises(ValueError, match="parallel.mesh.Mesh"):
        Trainer(_small_cfg(), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="lora_rank with a pp mesh"):
        Trainer(_small_cfg(), lora_rank=4,
                mesh=make_mesh({"pp": 2}, devices=["cpu"] * 2))
    # a LoRA trainer trains its adapters: the loss falls on the batch
    lt = Trainer(_small_cfg(), lora_rank=4, lr=1e-2, device="cpu")
    lora_losses = []
    lt.run(itertools.repeat(fixed), 5,
           on_step=lambda s, l: lora_losses.append(l))
    assert lora_losses[-1] < lora_losses[0] and lt.step == 5


def test_checkpoint_manager_commits_then_prunes(tmp_path):
    mgr = tckpt.make_checkpoint_manager(str(tmp_path / "m"), max_to_keep=2)
    assert tckpt.restore_latest(mgr) == (None, None)
    for step in range(1, 5):
        tckpt.save_step(mgr, step, {"x": torch.full((3,), float(step)),
                                    "count": step})
    assert mgr.steps() == [3, 4]
    step, state = tckpt.restore_latest(mgr)
    assert step == 4 and state["count"] == 4
    assert torch.equal(state["x"], torch.full((3,), 4.0))
    # a step directory without a committed state file does not count
    (tmp_path / "m" / "9").mkdir()
    assert mgr.latest_step() == 4


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_jax_saved_params_load_into_the_port(tmp_path, dtype):
    cfg = jtf.tiny(dtype=dtype)
    jparams = _jparams(cfg)
    path = str(tmp_path / "p.npz")
    jckpt.save_params(path, jparams)
    tparams = params_from_numpy(tckpt.load_params(path), device="cpu")
    want_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    assert all(t.dtype == want_dtype for t in ttrain.tree_leaves(tparams))
    for k in ("embed", "final_scale", "lm_head"):
        np.testing.assert_array_equal(tparams[k].float().numpy(),
                                      np.asarray(jparams[k], np.float32))
    assert set(tparams["layers"]) == set(jparams["layers"])
    for k, v in jparams["layers"].items():
        np.testing.assert_array_equal(
            tparams["layers"][k].float().numpy(), np.asarray(v, np.float32))
    # and back: the port's file loads in the JAX package
    path2 = str(tmp_path / "q.npz")
    tckpt.save_params(path2, tparams)
    back = jckpt.load_params(path2)
    np.testing.assert_array_equal(np.asarray(back["lm_head"], np.float32),
                                  np.asarray(jparams["lm_head"], np.float32))
    assert back["lm_head"].dtype == jparams["lm_head"].dtype


def test_token_dataset_matches_jax():
    tokens = np.arange(5000, dtype=np.int32) % 977
    jcfg = jdata.DataConfig(batch=8, seq=31, seed=3)
    tcfg = tdata.DataConfig(batch=8, seq=31, seed=3)
    jds, tds = jdata.TokenDataset(tokens, jcfg), tdata.TokenDataset(tokens,
                                                                    tcfg)
    for a, b in zip(itertools.islice(jds.epochs(dp_rank=1, dp_size=2), 30),
                    itertools.islice(tds.epochs(dp_rank=1, dp_size=2), 30)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="windows"):
        tdata.TokenDataset(tokens[:100], tcfg)
