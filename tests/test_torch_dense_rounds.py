"""Port parity: the dense-slot ``ContinuousBatcher`` (full-size and
rolling rows, bf16 and int8 stores) with chunked admission and its
ticked, fused and mixed rounds, against the golden streams of
``tests/golden_kv_bf16.json`` (read, never recomputed) and the live JAX
batcher, on the golden scenarios' ``tiny`` weights carried over by the
bridge.  Also: sampled streams equal across the three rounds, the
``storage_info`` integers equal JAX's."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from tpushare.models import transformer as jtf
from tpushare.serving.continuous import ContinuousBatcher as JaxBatcher
from tpushare_torch.models import transformer as ttf
from tpushare_torch.models.bridge import params_from_numpy
from tpushare_torch.serving.continuous import ContinuousBatcher

from kv_golden_scenarios import FULL_REQS, WIN_REQS, _drain_fused, \
    _drain_mixed

# tiny shapes: one intra-op thread, so this file does not crowd the
# wall-clock tests that other workers run beside it
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_kv_bf16.json")
WINDOW = 16


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def weights():
    """The golden scenarios' weights: full-causal tiny from PRNGKey(0),
    windowed tiny from PRNGKey(4), in the legacy threefry the goldens
    were drawn with; (jax params, port params) each."""
    with jax.threefry_partitionable(False):
        jp = jtf.init_params(jax.random.PRNGKey(0), jtf.tiny(max_seq=96))
        wjp = jtf.init_params(jax.random.PRNGKey(4),
                              jtf.tiny(max_seq=96, window=WINDOW))

    def bridge(p):
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                 device="cpu")

    return {"full": (jp, bridge(jp)), "window": (wjp, bridge(wjp))}


def _cfg(window=None, kv_dtype="bf16"):
    return ttf.tiny(max_seq=96, window=window, kv_dtype=kv_dtype)


def _batcher(weights, window=None, kv_dtype="bf16", n_slots=3, **kw):
    params = weights["window" if window else "full"][1]
    return ContinuousBatcher(params, _cfg(window, kv_dtype), n_slots,
                             device="cpu", **kw)


def _serve(b, reqs, how, **admit_kw):
    """Admit ``reqs`` and drain them: "ticked" (admit + ticks), "fused"
    (chunked + advance_prefill/tick_fused) or "mixed" (chunked +
    tick_mixed), the golden scenarios' drains."""
    if how == "ticked":
        rids = [b.admit(p, n, **admit_kw) for p, n in reqs]
        b.run_until_drained()
    else:
        rids = [b.admit_chunked(p, n, chunk=4, **admit_kw) for p, n in reqs]
        (_drain_fused if how == "fused" else _drain_mixed)(b)
    assert not b.slots and not b.prefilling
    return [b.completed[r] for r in rids]


@pytest.mark.parametrize("flavor,how,window", [
    ("dense_ticked", "ticked", None), ("dense_fused", "fused", None),
    ("dense_mixed", "mixed", None), ("rolling", "mixed", WINDOW)])
def test_streams_equal_the_goldens(weights, golden, flavor, how, window):
    reqs = WIN_REQS if window else FULL_REQS
    b = _batcher(weights, window)
    assert b.storage_info()["kind"] == ("rolling" if window else "dense")
    assert _serve(b, reqs, how) == golden[flavor]


def test_greedy_row_of_dense_sampled(weights, golden):
    b = _batcher(weights, n_slots=2)
    rid = b.admit([7, 8, 9], 10)
    b.admit(list(range(1, 9)), 10, temperature=0.9, seed=17)
    b.run_until_drained()
    assert b.completed[rid] == golden["dense_sampled"][0]


def _jax_streams(params, cfg, reqs):
    b = JaxBatcher(params, cfg, n_slots=3)
    rids = [b.admit(p, n) for p, n in reqs]
    b.run_until_drained()
    return [[int(t) for t in b.completed[r]] for r in rids]


@pytest.mark.parametrize("window,kv_dtype,how", [
    (WINDOW, "bf16", "ticked"), (WINDOW, "bf16", "fused"),
    (None, "int8", "ticked"), (None, "int8", "mixed"),
    (WINDOW, "int8", "mixed")])
def test_streams_equal_the_live_jax_batcher(weights, window, kv_dtype, how):
    """The rolling pool and the int8 stores against the JAX batcher run
    live on the same weights (its ticked streams; the reference's rounds
    are token-equal to its ticks)."""
    jp = weights["window" if window else "full"][0]
    reqs = WIN_REQS if window else FULL_REQS
    jcfg = dataclasses.replace(jtf.tiny(max_seq=96, window=window),
                               kv_dtype=kv_dtype)
    live = _jax_streams(jp, jcfg, reqs)
    assert _serve(_batcher(weights, window, kv_dtype), reqs, how) == live


@pytest.mark.parametrize("window", [None, WINDOW])
def test_sampled_streams_equal_across_rounds(weights, window):
    """A slot draws from its own generator once a step, whichever round
    runs the step: ticked, fused and mixed drains give the same sampled
    (and greedy) streams."""
    reqs = WIN_REQS if window else FULL_REQS
    streams = {}
    for how in ("ticked", "fused", "mixed"):
        b = _batcher(weights, window)
        rids = []
        for i, (p, n) in enumerate(reqs):
            kw = ({"temperature": 0.9, "seed": 17 + i, "top_k": 20}
                  if i != 1 else {})
            rids.append(b.admit(p, n, **kw) if how == "ticked"
                        else b.admit_chunked(p, n, chunk=4, **kw))
        if how == "ticked":
            b.run_until_drained()
        else:
            (_drain_fused if how == "fused" else _drain_mixed)(b)
        streams[how] = [b.completed[r] for r in rids]
    assert streams["fused"] == streams["ticked"]
    assert streams["mixed"] == streams["ticked"]


def test_mixed_rounds_at_the_max_seq_edge_and_eos(weights, golden):
    """A prompt whose next window would cross max_seq takes one narrow
    chunk after the mixed dispatch; an eos finishes a slot mid-round; a
    mixed budget of several rows packs them round-robin.  Streams equal
    the ticked admission's."""
    edge = (list(np.arange(92) % 200 + 1), 4)       # 92 + 4 = max_seq
    eos = golden["dense_ticked"][0][len(FULL_REQS[0][0]) + 1]
    reqs = [edge] + FULL_REQS
    want = _serve(_batcher(weights, n_slots=4), reqs, "ticked",
                  eos_id=eos)
    b = _batcher(weights, n_slots=4)
    rids = [b.admit_chunked(p, n, chunk=10, eos_id=eos) for p, n in reqs]
    for _ in range(100):
        if not b.prefilling and not b.slots:
            break
        b.tick_mixed(3, chunk=10, budget=30)
    assert [b.completed[r] for r in rids] == want
    assert want[1] == golden["dense_ticked"][0][:len(FULL_REQS[0][0]) + 2]


def test_chunked_admission_holds_its_slot(weights):
    b = _batcher(weights, n_slots=2)
    assert b.admit_chunked([1, 2, 3], 4, chunk=2) == 0
    assert b.admit([4, 5], 10) == 1
    assert b.free_slots() == [] and b.admit_chunked([6], 2) is None
    with pytest.raises(ValueError, match="chunk"):
        b.admit_chunked([6], 2, chunk=0)
    assert b.tick_fused(2) == 1 and b.advance_prefill() == 1
    assert b.advance_prefill() == 0 and set(b.slots) == {0, 1}


@pytest.mark.parametrize("window,kv_dtype,rolling", [
    (None, "bf16", None), (WINDOW, "bf16", None), (WINDOW, "bf16", False),
    (None, "int8", None), (WINDOW, "int8", None)])
def test_storage_info_integers_equal_jax(weights, window, kv_dtype,
                                         rolling):
    jp = weights["window" if window else "full"][0]
    jcfg = dataclasses.replace(jtf.tiny(max_seq=96, window=window),
                               kv_dtype=kv_dtype)
    want = JaxBatcher(jp, jcfg, n_slots=3,
                      rolling_slots=rolling).storage_info()
    got = _batcher(weights, window, kv_dtype,
                   rolling_slots=rolling).storage_info()
    for key in ("kind", "kv_dtype", "slot_tokens", "bytes_per_slot",
                "slots_per_gib", "pool_bytes"):
        assert got[key] == want[key], key
    assert got["attn_kernel"] == "gather" and want["attn_kernel"] == "xla"
    with pytest.raises(ValueError, match="sliding-window"):
        _batcher(weights, rolling_slots=True)

