"""Port parity: tensor-parallel (tp) serving against the JAX package's
unsharded batchers.

The port's batchers at tp = 2 (the Megatron split of the weights, KV
storage and the adapter pool on heads, every forward's per-shard body)
on the CPU mesh of its device repeated, against the JAX batchers without
a mesh on the same seeded params: ``tests/test_serving_tp.py`` holds the
JAX tp streams to those, and its tp batchers are too slow for this lane.
Greedy streams are token-equal on the paged pool (bf16 and int8), dense
and rolling rows, speculation, the prefix cache, a mixed-adapter batch,
an MoE config and tp x sp; then f32 logits, sessions moved between tp
degrees, the service and the server's ``--tp``."""

import dataclasses
import functools
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from tpushare.models import transformer as jtf
from tpushare.serving.continuous import ContinuousBatcher as JaxDense
from tpushare.serving.paged import PagedContinuousBatcher as JaxPaged
from tpushare_torch.models import transformer as ttf
from tpushare_torch.models.bridge import adapter_from_numpy, params_from_numpy
from tpushare_torch.ops.attention import tp_degree
from tpushare_torch.parallel import mesh as tmesh
from tpushare_torch.serving.continuous import (ContinuousBatcher,
                                               ContinuousService)
from tpushare_torch.serving.llm import LLMServer, parse_args
from tpushare_torch.serving.paged import PagedContinuousBatcher

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: f32 logits of the split model against the JAX forward: the port's f32
#: tolerance (reassociated sums only)
F32_ATOL = 1e-4
PROMPTS = [[5, 9, 2], [11, 3], [1, 2, 3, 4, 5], [7, 7, 1, 2, 7, 7, 1, 2]]
GEN = 8
MOE = dict(n_experts=4, moe_top_k=2, moe_every=1)
RANK = 4


def tp_mesh(tp=2, sp=1):
    axes = {"tp": tp, **({"sp": sp} if sp > 1 else {})}
    return tmesh.make_mesh(axes, devices=[CPU] * (tp * sp))


def _cfgs(window=None, kv_dtype="bf16", moe=False):
    kw = MOE if moe else {}
    jcfg = dataclasses.replace(jtf.tiny(max_seq=96, window=window),
                               kv_dtype=kv_dtype, **kw)
    tcfg = dataclasses.replace(ttf.tiny(max_seq=96, window=window),
                               kv_dtype=kv_dtype, **kw)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _params(moe=False):
    jcfg, _ = _cfgs(moe=moe)
    jp = jtf.init_params(jax.random.PRNGKey(7), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def _drain(b, prompts=PROMPTS, gen=GEN, **kw):
    rids = [b.admit(list(p), gen, **kw) for p in prompts]
    assert all(r is not None for r in rids)
    b.run_until_drained()
    return [[int(t) for t in b.completed[r]] for r in rids]


@functools.lru_cache(maxsize=None)
def _jax_streams(paged=True, window=None, kv_dtype="bf16", moe=False):
    """The JAX package's unsharded batcher's greedy streams."""
    jcfg, _ = _cfgs(window, kv_dtype, moe)
    jp, _ = _params(moe)
    b = (JaxPaged(jp, jcfg, n_slots=4, page_size=16) if paged
         else JaxDense(jp, jcfg, n_slots=4))
    return _drain(b)


def _port(paged=True, window=None, kv_dtype="bf16", moe=False, mesh=None,
          **kw):
    _, tcfg = _cfgs(window, kv_dtype, moe)
    _, tp = _params(moe)
    mesh = tp_mesh() if mesh is None else mesh
    if paged:
        return PagedContinuousBatcher(tp, tcfg, n_slots=4, page_size=16,
                                      mesh=mesh, **kw)
    return ContinuousBatcher(tp, tcfg, n_slots=4, mesh=mesh, **kw)


# ---------------------------------------------------------------------------
# greedy streams against the unsharded JAX batchers
# ---------------------------------------------------------------------------
STORAGES = {"paged": dict(), "paged_int8": dict(kv_dtype="int8"),
            "dense": dict(paged=False),
            "rolling": dict(paged=False, window=16),
            "moe": dict(moe=True)}


@pytest.mark.parametrize("storage", list(STORAGES))
def test_tp_streams_equal_the_unsharded_jax_batcher(storage):
    """tp = 2 greedy streams token-equal to the JAX batcher's without a
    mesh, and the storage really split: one store pair a tp shard, each
    of its kv heads' half."""
    kw = STORAGES[storage]
    b = _port(**kw)
    assert tp_degree(b.mesh) == 2
    if kw.get("paged", True):
        pairs = ttf._pool_stripes(b.pools)
    else:
        pairs = list(b.caches)
        assert b.rolling_slots == (kw.get("window") is not None)
    assert len(pairs) == 2
    assert all(ttf._kv_leaf(k).shape[2] == 1 for k, _ in pairs)
    assert _drain(b) == _jax_streams(**kw)


def test_tp_sp_streams_equal_the_unsharded_jax_batcher():
    """A 2 x 2 tp x sp mesh of four shards: every shard a stripe of its kv
    heads, the streams token-equal to the JAX batcher's."""
    b = _port(mesh=tp_mesh(2, 2))
    assert b.sp_shards == 2 and len(ttf._pool_stripes(b.pools)) == 4
    assert _drain(b) == _jax_streams()
    assert b.storage_info()["sp_shards"] == 2


@pytest.mark.parametrize("paged", [True, False])
def test_tp_spec_rounds_equal_the_unsharded_jax_batcher(paged):
    """Prompt-lookup speculation (tick_spec) at tp = 2 verifies through
    each shard's stores: greedy streams equal the JAX batcher's plain
    ones (greedy speculation is exact), and rounds accepted tokens."""
    b = _port(paged=paged, spec_k=3)
    rids = [b.admit(list(p), GEN) for p in PROMPTS]
    while b.slots:
        b.tick_spec(2, k=3)
    got = [[int(t) for t in b.completed[r]] for r in rids]
    assert got == _jax_streams(paged=paged)
    assert b._spec_stats["tokens"] > b._spec_stats["rounds"]


def test_tp_prefix_cache_equals_the_unsharded_jax_batcher():
    """The prefix cache at tp = 2: a second request mapping the first's
    registered pages prefills only past them, and both streams equal the
    JAX batcher's."""
    head = list(range(1, 33))
    prompts = [head + [40, 41], head + [50]]
    jcfg, _ = _cfgs()
    jp, _ = _params()
    want = [_drain(JaxPaged(jp, jcfg, n_slots=4, page_size=16), [p])[0]
            for p in prompts]
    b = _port(prefix_cache=True)
    got = [_drain(b, [p])[0] for p in prompts]
    assert got == want
    assert b.storage_info()["cached_prefixes"] >= 1
    assert b.prefill_tokens < sum(len(p) for p in prompts)


def test_tp_mixed_adapter_batch_equals_the_jax_batcher():
    """A batch mixing two adapters and the base at tp = 2 (the pool split
    like its base projections, each shard's delta partial where its base
    product is): streams equal the JAX batcher's with the same adapters,
    through mixed rounds."""
    from tpushare.ops import lora as jlora
    from tpushare.serving import adapters as jadapters

    jcfg, tcfg = _cfgs()
    jp, tp = _params()

    def loader(name):
        return adapter_from_numpy(jax.tree_util.tree_map(
            np.asarray, jlora.make_adapter(
                jcfg, RANK, seed=jadapters._name_seed(name))), device="cpu")

    reqs = list(zip(PROMPTS, ["alice", None, "bob", "alice"]))
    outs = []
    for b in (JaxPaged(jp, jcfg, n_slots=4, page_size=8, adapter_slots=2,
                       adapter_rank=RANK),
              PagedContinuousBatcher(tp, tcfg, n_slots=4, page_size=8,
                                     mesh=tp_mesh(), adapter_slots=2,
                                     adapter_rank=RANK,
                                     adapter_loader=loader)):
        rids = [b.admit_chunked(p, GEN, chunk=8, adapter=a)
                for p, a in reqs]
        while b.slots or b.prefilling:
            b.tick_mixed(2, chunk=8, budget=16)
        outs.append([[int(t) for t in b.completed[r]] for r in rids])
    assert outs[1] == outs[0]
    pool = b.adapter_pool.device_operands()
    assert isinstance(pool, tuple) and len(pool) == 2


# ---------------------------------------------------------------------------
# logits, sessions, the service and the server
# ---------------------------------------------------------------------------
def test_tp_first_step_logits_within_f32_tolerance_of_jax():
    """Each prompt's first-step logits through the tp = 2 pool within
    1e-4 of the JAX forward's last-position logits, f32."""
    jcfg, _ = _cfgs()
    jp, _ = _params()
    b = _port()
    for slot, p in enumerate(PROMPTS):
        assert b._reserve(slot, len(p), 1)
        got = b._prefill_into(slot, p)
        want = np.asarray(jtf.forward(jp, jax.numpy.asarray([p]),
                                      jcfg))[0, -1]
        np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_tp_session_blob_is_the_unsharded_wire_format_both_ways(kv_dtype):
    """A tp = 1 session's blob imported into a tp = 2 pool (each shard its
    block of the heads) exports again byte for byte: the tp pool gathers
    every head back into the JAX wire format.  Blobs exported after 3
    steps from a tp = 1 and a tp = 2 pool each finish token-equal to the
    uninterrupted stream in a pool of the other degree.  (The two pools'
    own blobs are not compared bytewise: the tp forward sums its shards'
    partial products, which reorders f32 sums, so later layers' K/V may
    differ in the last bit.)"""
    _, tcfg = _cfgs(kv_dtype=kv_dtype)
    _, tp = _params()
    prompt = PROMPTS[3]

    def make(mesh):
        if mesh is None:
            return PagedContinuousBatcher(tp, tcfg, n_slots=2, page_size=16,
                                          device="cpu")
        return PagedContinuousBatcher(tp, tcfg, n_slots=2, page_size=16,
                                      mesh=mesh)

    want = _drain(make(None), [prompt], gen=12)[0]
    blobs = {}
    for name, mesh in (("tp1", None), ("tp2", tp_mesh())):
        b = make(mesh)
        rid = b.admit(prompt, 12)
        for _ in range(3):
            b.tick()
        blobs[name] = b.export_session(rid)
    split = make(tp_mesh())
    assert split.export_session(split.import_session(blobs["tp1"])) \
        == blobs["tp1"]
    for name, mesh in (("tp1", tp_mesh()), ("tp2", None)):
        dst = make(mesh)
        rid = dst.import_session(blobs[name])
        dst.run_until_drained()
        assert [int(t) for t in dst.completed[rid]] == want


def test_tp_service_end_to_end():
    """``ContinuousService(mesh=)`` over a tp = 2 paged pool serves the
    JAX batcher's stream."""
    _, tcfg = _cfgs()
    _, tp = _params()
    svc = ContinuousService(tp, tcfg, n_slots=2, page_size=16,
                            mesh=tp_mesh()).start()
    try:
        out = svc.submit(PROMPTS[2], GEN).get(timeout=120)
    finally:
        svc.stop()
    assert out == _jax_streams()[2]
    assert svc.mesh.shape == {"tp": 2}


def _call(srv, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_tp_on_the_cpu():
    """``LLMServer(tp=2)`` on the CPU (the device repeated) serves the JAX
    batcher's streams, answers ``/score`` 400 naming ``--tp``, and
    ``--tp`` with ``--slots 0`` is refused, on the command line and in
    the constructor."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    srv = LLMServer(tcfg, tp, port=0, n_slots=4, page_size=16, tp=2,
                    device="cpu").start()
    try:
        code, body = _call(srv, "POST", "/generate",
                           {"tokens": PROMPTS[:2], "max_new_tokens": GEN})
        s_code, s_body = _call(srv, "POST", "/score",
                               {"tokens": [[1, 2, 3, 4]]})
        _, stats = _call(srv, "GET", "/stats")
    finally:
        srv.stop()
    assert code == 200 and body["tokens"] == _jax_streams()[:2]
    assert s_code == 400 and "--tp" in s_body["Error"]
    assert stats["kv_storage"]["kind"] == "paged"
    assert srv.mesh.shape == {"tp": 2}
    with pytest.raises(SystemExit):
        parse_args(["--tp", "2", "--slots", "0"])
    assert parse_args(["--tp", "2"]).tp == 2
    with pytest.raises(ValueError, match="tp > 1 requires n_slots"):
        LLMServer(tcfg, tp, port=0, n_slots=0, tp=2, device="cpu")
