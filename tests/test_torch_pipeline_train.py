"""Port parity: the 1F1B half of ``tpushare_torch/parallel/pipeline.py``
and ``parallel.train.make_pipeline_train_step`` against the JAX package.

``schedule_1f1b``'s tables equal the reference's table for table, and hold
the reference test's properties.  ``pipeline_train_1f1b`` on the reference
test's 8-layer MLP (d 16, mb 4, M 8, pp 4; and dp 2 x pp 4) equals the
JAX pass: loss, layer grads, head grads and ``dx`` within 1e-5, in every
layout the port takes (a stacked tree, a ``Staged`` of slabs, a
``Replicas`` a dp shard).  The pipelined LM step on ``tiny(n_layers=4,
max_seq=32)``, tokens [8, 17], pp 4 and dp 2 x pp 4, equals JAX's: the
loss within 1e-5 relative, every gradient within 2e-4 (JAX's gradient is
read from one SGD step at lr 1: ``p - p'``), and after one AdamW step its
params are the port's flat step's within 1e-5.  The JAX side runs on the
conftest's 8-device CPU mesh, the port's on ``make_mesh(..., devices=
["cpu"] * n)``; weights cross by ``models.bridge``.  All compute is f32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpushare.models import transformer as jtf
from tpushare.parallel import make_mesh as jax_mesh
from tpushare.parallel import pipeline as jpipe
from tpushare.parallel import train as jtrain
from tpushare_torch.models import transformer as ttf
from tpushare_torch.models.bridge import params_from_numpy
from tpushare_torch.ops import attention as tattn
from tpushare_torch.parallel import mesh as tmesh
from tpushare_torch.parallel import pipeline as tpipe
from tpushare_torch.parallel import train as ttrain
from tpushare_torch.parallel.trainer import Trainer

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: the MLP pass: f32 sums of 8 layers in two frameworks
MLP_ATOL = 1e-5
#: the pipelined LM loss, relative
LOSS_RTOL = 1e-5
#: its gradients, absolute
GRAD_ATOL = 2e-4
#: params after one AdamW step at lr 1e-4, the pipelined step against the
#: port's flat step (AdamW divides each gradient by its own magnitude)
PARAM_ATOL = 1e-5

SCHEDULES = [(1, 1), (2, 4), (4, 8), (8, 8), (4, 3), (8, 32)]


def port_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return tmesh.make_mesh(axes, devices=[CPU] * n)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_stages,n_micro", SCHEDULES)
def test_schedule_1f1b_equals_the_reference(n_stages, n_micro):
    got = tpipe.schedule_1f1b(n_stages, n_micro)
    want = jpipe.schedule_1f1b(n_stages, n_micro)
    for field in ("n_stages", "n_micro", "n_ticks", "act_q", "grad_q",
                  "stash"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("fwd_m", "bwd_m", "arr_act_m", "arr_grad_m"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_schedule_1f1b_properties():
    """Every (stage, microbatch) is forwarded and backwarded exactly once,
    in order; in-flight stage inputs never exceed the 1F1B bound S - s;
    the length is the analytic 2(M + S - 1) (the reference test's
    properties, on the port's tables)."""
    for S, M in SCHEDULES:
        sc = tpipe.schedule_1f1b(S, M)
        for s in range(S):
            fwd = [m for m in sc.fwd_m[:, s] if m >= 0]
            bwd = [m for m in sc.bwd_m[:, s] if m >= 0]
            assert fwd == list(range(M)), (S, M, s)
            assert bwd == list(range(M)), (S, M, s)
            inflight = peak = 0
            for t in range(sc.n_ticks):
                inflight += sc.fwd_m[t, s] >= 0
                peak = max(peak, inflight)
                inflight -= sc.bwd_m[t, s] >= 0
            assert peak <= S - s, (S, M, s, peak)
        assert sc.stash <= S
        assert sc.n_ticks == 2 * (M + S - 1), (S, M, sc.n_ticks)
    with pytest.raises(ValueError, match="at least one microbatch"):
        tpipe.schedule_1f1b(2, 0)


# ---------------------------------------------------------------------------
# pipeline_train_1f1b on the reference test's MLP
# ---------------------------------------------------------------------------
def _mlp_jax(p, x):
    return jax.nn.relu(x @ p["w"]) + p["b"]


def _mlp_torch(p, x):
    return torch.relu(x @ p["w"]) + p["b"]


def _mlp_case(seed=0, d=16, mb=4, M=8, L=8):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((L, d, d)) / np.sqrt(d)
                    ).astype(np.float32),
              "b": (0.01 * rng.standard_normal((L, d))).astype(np.float32)}
    head = {"w": (rng.standard_normal((d, 3)) / 4).astype(np.float32)}
    x = rng.standard_normal((M, mb, d)).astype(np.float32)
    tgt = rng.standard_normal((M, mb, 3)).astype(np.float32)
    return params, head, x, tgt


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _jax_mlp_pass(params, head, x, tgt, axes, dp):
    def loss_fn(hp, y, t):
        return jnp.mean((y @ hp["w"] - t) ** 2)

    as_j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}  # noqa
    return jpipe.pipeline_train_1f1b(
        _mlp_jax, as_j(params), as_j(head), loss_fn, jnp.asarray(x),
        jnp.asarray(tgt), jax_mesh(axes), dp_axis=dp)


def _port_loss_fn(hp, y, t):
    return torch.mean((y @ hp["w"] - t) ** 2)


@pytest.fixture(scope="module")
def jax_mlp():
    """JAX's pass on the MLP case, by dp axis (each call traces its
    shard_map once)."""
    params, head, x, tgt = _mlp_case()
    return {dp: _jax_mlp_pass(params, head, x, tgt, axes, dp)
            for axes, dp in (({"pp": 4}, None), ({"dp": 2, "pp": 4}, "dp"))}


@pytest.mark.parametrize("axes,dp,layout", [
    ({"pp": 4}, None, "stacked"), ({"pp": 4}, None, "staged"),
    ({"dp": 2, "pp": 4}, "dp", "stacked"),
    ({"dp": 2, "pp": 4}, "dp", "staged"),
    ({"dp": 2, "pp": 4}, "dp", "replicas")])
def test_pipeline_train_1f1b_equals_jax(jax_mlp, axes, dp, layout):
    params, head, x, tgt = _mlp_case()
    jl, jgl, jgh, jdx = jax_mlp[dp]
    mesh = port_mesh(**axes)
    layers, heads = _t(params), _t(head)
    if layout == "staged":
        layers = tpipe.stage_slabs(layers, mesh)
    if layout == "replicas":
        # two replicas of distinct tensors: the all-reduce path that
        # dp shards on different cards take
        slabs = tpipe.stage_slabs(layers, mesh.submesh(dp=0))
        layers = tmesh.Replicas(
            (slabs, tmesh.Staged(ttrain.tree_map(torch.clone, s)
                                 for s in slabs)))
        heads = tmesh.Replicas((heads, ttrain.tree_map(torch.clone, heads)))
    loss, gl, gh, dx = tpipe.pipeline_train_1f1b(
        _mlp_torch, layers, heads, _port_loss_fn, torch.from_numpy(x),
        torch.from_numpy(tgt), mesh, dp_axis=dp)
    np.testing.assert_allclose(float(loss), float(jl), rtol=0,
                               atol=MLP_ATOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0,
                               atol=MLP_ATOL)
    if layout == "replicas":
        assert isinstance(gl, tmesh.Replicas)
        assert isinstance(gh, tmesh.Replicas)
        for a, b in zip(ttrain.tree_leaves(gl[0]),
                        ttrain.tree_leaves(gl[1])):
            assert torch.equal(a, b)
        assert torch.equal(gh[0]["w"], gh[1]["w"])
        gl, gh = gl[0], gh[0]
    if layout != "stacked":
        assert isinstance(gl, tmesh.Staged) and len(gl) == axes["pp"]
        gl = {k: torch.cat([s[k] for s in gl]) for k in params}
    for k in params:
        assert gl[k].dtype == torch.float32
        np.testing.assert_allclose(gl[k].numpy(), np.asarray(jgl[k]),
                                   rtol=0, atol=MLP_ATOL)
    np.testing.assert_allclose(gh["w"].numpy(), np.asarray(jgh["w"]),
                               rtol=0, atol=MLP_ATOL)


def test_pipeline_train_1f1b_refusals():
    params, head, x, tgt = _mlp_case(L=6)
    with pytest.raises(ValueError, match="not divisible into 4 stages"):
        tpipe.pipeline_train_1f1b(_mlp_torch, _t(params), _t(head),
                                  _port_loss_fn, torch.from_numpy(x),
                                  torch.from_numpy(tgt), port_mesh(pp=4))
    params, head, x, tgt = _mlp_case(mb=3)
    with pytest.raises(ValueError, match="3 rows"):
        tpipe.pipeline_train_1f1b(_mlp_torch, _t(params), _t(head),
                                  _port_loss_fn, torch.from_numpy(x),
                                  torch.from_numpy(tgt),
                                  port_mesh(dp=2, pp=4), dp_axis="dp")


# ---------------------------------------------------------------------------
# the pipelined LM step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm():
    cfg = jtf.tiny(n_layers=4, max_seq=32)
    jp = jtf.init_params(jax.random.PRNGKey(0), cfg)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 17),
                                           0, cfg.vocab))
    return cfg, jp, tokens


def _tparams(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")


def _by_path(tree, prefix=""):
    """{"embed": x, "layers/wq": x, ...} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_by_path(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def jax_grads(lm):
    """JAX's pipelined loss and gradient on each mesh: one SGD step at lr
    1 of ``make_pipeline_train_step`` (grads ``p - p'``)."""
    import optax

    cfg, jp, tokens = lm
    out = {}
    for key, axes, dp in (("pp", {"pp": 4}, None),
                          ("dp_pp", {"dp": 2, "pp": 4}, "dp")):
        opt = optax.sgd(1.0)
        step = jtrain.make_pipeline_train_step(cfg, opt, jax_mesh(axes),
                                               dp_axis=dp)
        p1, _, loss = step(jax.tree_util.tree_map(jnp.copy, jp),
                           opt.init(jp), jnp.asarray(tokens))
        grads = jax.tree_util.tree_map(
            lambda a, b: np.asarray(a) - np.asarray(b), jp, p1)
        out[key] = (float(loss), _by_path(grads))
    return out


@pytest.mark.parametrize("key,axes,dp", [("pp", {"pp": 4}, None),
                                         ("dp_pp", {"dp": 2, "pp": 4},
                                          "dp")])
def test_pipeline_loss_and_grads_equal_jax(lm, jax_grads, key, axes, dp):
    cfg, jp, tokens = lm
    tcfg = ttf.tiny(n_layers=4, max_seq=32)
    mesh = port_mesh(**axes)
    placed = tmesh.shard_params(_tparams(jp), mesh, tcfg)
    loss, grads = ttrain.pipeline_loss_and_grads(
        placed, torch.from_numpy(tokens), tcfg, mesh, dp_axis=dp)
    want_loss, want = jax_grads[key]
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    if dp:
        assert isinstance(grads, tmesh.Replicas)
        # the replicas share the card: one gradient tree
        assert all(a is b for a, b in zip(ttrain.tree_leaves(grads[0]),
                                           ttrain.tree_leaves(grads[1])))
    assert isinstance((grads[0] if dp else grads)["layers"], tmesh.Staged)
    got = _by_path(tmesh.gather_params(grads, tcfg))
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.float().numpy(), want[name], rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("axes,dp", [({"pp": 4}, None),
                                     ({"dp": 2, "pp": 4}, "dp")])
def test_pipeline_step_equals_the_flat_step(lm, axes, dp):
    """One AdamW step of the pipelined step against the port's flat step
    (itself held to JAX's in tests/test_torch_train.py)."""
    cfg, jp, tokens = lm
    tcfg = ttf.tiny(n_layers=4, max_seq=32)
    opt = ttrain.make_optimizer(lr=1e-4)
    flat = _tparams(jp)
    fstate = opt.init(flat)
    flat, fstate, floss = ttrain.make_train_step(tcfg, opt)(
        flat, fstate, torch.from_numpy(tokens))
    mesh = port_mesh(**axes)
    whole = _tparams(jp)
    state = opt.init(whole)
    placed = tmesh.shard_params(whole, mesh, tcfg)
    state = {**state, "mu": tmesh.shard_params(state["mu"], mesh, tcfg),
             "nu": tmesh.shard_params(state["nu"], mesh, tcfg)}
    step = ttrain.make_pipeline_train_step(tcfg, opt, mesh, dp_axis=dp)
    placed, state, loss = step(placed, state, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(floss), rtol=LOSS_RTOL)
    assert state["count"] == 1
    got = _by_path(tmesh.gather_params(placed, tcfg))
    want = _by_path(flat)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   w.detach().numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    # the step updated the caller's whole tree through the placed views
    np.testing.assert_array_equal(whole["lm_head"].detach().numpy(),
                                  got["lm_head"].detach().numpy())


@pytest.mark.parametrize("axes,n_micro", [({"pp": 4}, 0), ({"pp": 2}, 4),
                                          ({"dp": 2, "pp": 2}, 2)])
def test_pipeline_step_launch_counts(monkeypatch, lm, axes, n_micro):
    """With the flash gate open for CPU tensors a step runs K1's plain
    forward dp.M.L.(2S-1)/S times (a non-last stage forwards twice, the
    backward's recompute) and K3 + K4's plain backward dp.M.L times."""
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
    cfg, jp, tokens = lm
    tcfg = ttf.tiny(n_layers=4, max_seq=32)
    mesh = port_mesh(**axes)
    placed = tmesh.shard_params(_tparams(jp), mesh, tcfg)
    ttrain.pipeline_loss_and_grads(placed, torch.from_numpy(tokens), tcfg,
                                   mesh, n_micro=n_micro,
                                   dp_axis="dp" if "dp" in axes else None)
    S, dp = axes["pp"], axes.get("dp", 1)
    M, L = n_micro or S, tcfg.n_layers
    assert calls == [dp * M * L * (2 * S - 1) // S, dp * M * L]


def test_pipeline_step_refusals(lm):
    cfg, jp, tokens = lm
    tcfg = ttf.tiny(n_layers=4, max_seq=32)
    opt = ttrain.make_optimizer()
    mesh = port_mesh(pp=4)
    with pytest.raises(ValueError, match="not divisible into 3"):
        ttrain.pipeline_loss_and_grads(
            tmesh.shard_params(_tparams(jp), mesh, tcfg),
            torch.from_numpy(tokens), tcfg, mesh, n_micro=3)
    with pytest.raises(NotImplementedError, match="A.17"):
        ttrain.make_pipeline_train_step(tcfg, opt, port_mesh(tp=2, pp=2))
    with pytest.raises(ValueError, match="make_pipeline_train_step"):
        ttrain.make_train_step(tcfg, opt, mesh=mesh)
    dp_mesh = port_mesh(dp=2, pp=2)
    with pytest.raises(ValueError, match="dp_axis"):
        ttrain.pipeline_loss_and_grads(
            tmesh.shard_params(_tparams(jp), dp_mesh, tcfg),
            torch.from_numpy(tokens), tcfg, dp_mesh)


def test_trainer_drives_pp_dp_step():
    """Trainer with a dp x pp mesh picks the 1F1B pipelined step and the
    loss descends (the reference's test, on the port)."""
    cfg = ttf.tiny(n_layers=4, max_seq=32)
    trainer = Trainer(cfg, mesh=port_mesh(dp=2, pp=4), lr=5e-3)
    assert trainer.step_fn.__qualname__.startswith(
        "make_pipeline_train_step")
    rng = np.random.default_rng(7)
    losses = []
    trainer.run((rng.integers(0, cfg.vocab, (8, 17)) for _ in range(12)),
                12, on_step=lambda s, l: losses.append(l))
    assert losses[-1] < losses[0], losses
    assert isinstance(trainer.params, tmesh.Replicas)
    assert trainer.params[0] is trainer.params[1]
