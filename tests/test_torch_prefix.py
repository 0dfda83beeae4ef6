"""Port parity: the paged pool's prefix cache, and the ``llama2_7b``
preset.

A completed request donates its prompt's whole pages to a registry; a
later request that starts with a registered prefix maps those pages into
its table and prefills only past them.  On ``tiny`` weights (f32) carried
over by the bridge: the ``prefix_cache`` golden of
``tests/golden_kv_bf16.json`` (read, never recomputed);
``tests/test_mixed_equivalence.py``'s ``test_mixed_prefix_cache_reuse``
case and ``tests/test_prefix_cache.py``'s cases against the port's own
``generate``; page tables and the registry equal to the live JAX
batcher's; the registry's pages byte-equal before and after a
neighbour's mixed rounds; eviction only at zero active; the server's
``--prefix-cache``, ``--prefill-budget`` and ``--sequential-prefill``."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from tpushare.models import transformer as jtf
from tpushare.serving.paged import PagedContinuousBatcher as JaxPaged
from tpushare_torch.models import transformer as ttf
from tpushare_torch.models.bridge import params_from_numpy
from tpushare_torch.serving import continuous, llm
from tpushare_torch.serving.continuous import ContinuousService
from tpushare_torch.serving.generate import generate
from tpushare_torch.serving.paged import PagedContinuousBatcher

from kv_golden_scenarios import PREFIX_REQS, _drain_mixed

# tiny shapes: one intra-op thread, so this file does not crowd the
# wall-clock tests that other workers run beside it
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_kv_bf16.json")
P = 4
SYSTEM = list(range(1, 13))          # 12 tokens = 3 whole pages


@pytest.fixture(scope="module")
def golden_weights():
    """The golden scenarios' full-causal tiny (max_seq 96) from
    PRNGKey(0) in the legacy threefry the goldens were drawn with;
    (jax params, port params)."""
    with jax.threefry_partitionable(False):
        jp = jtf.init_params(jax.random.PRNGKey(0), jtf.tiny(max_seq=96))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.fixture(scope="module")
def model():
    """``tests/test_prefix_cache.py``'s model: tiny with max_seq 128."""
    jp = jtf.init_params(jax.random.PRNGKey(0), jtf.tiny(max_seq=128))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")


def _cfg(max_seq=128, **kw):
    return ttf.tiny(max_seq=max_seq, **kw)


def _batcher(params, n_slots=2, max_seq=128, cfg_kw=None, **kw):
    kw.setdefault("prefix_cache", True)
    return PagedContinuousBatcher(params, _cfg(max_seq, **(cfg_kw or {})),
                                  n_slots=n_slots, page_size=P,
                                  device="cpu", **kw)


def _plain(params, prompt, n, max_seq=128):
    return generate(params, _cfg(max_seq), torch.tensor([prompt]),
                    max_new_tokens=n)[0].tolist()


def _drain(b, n_steps=3, chunk=4, budget=8):
    for _ in range(500):
        if not b.prefilling and not b.slots:
            return
        b.tick_mixed(n_steps, chunk=chunk, budget=budget)
    raise RuntimeError("mixed drain did not finish")


@pytest.mark.parametrize("attn_kernel", ["kernel", "gather"])
def test_prefix_cache_golden(golden_weights, attn_kernel):
    """The golden's traffic: three same-head requests, each admitted by
    ``admit_chunked`` and drained by ``tick_mixed``; the later two map
    the first one's two registered pages."""
    with open(GOLDEN) as f:
        want = json.load(f)["prefix_cache"]
    b = _batcher(golden_weights[1], max_seq=96,
                 cfg_kw={"attn_kernel": attn_kernel})
    rids, starts = [], []
    for p, n in PREFIX_REQS:
        rids.append(b.admit_chunked(p, n, chunk=4))
        starts.append([st.pos for st in b.prefilling.values()])
        _drain_mixed(b)
    assert [b.completed[r] for r in rids] == want
    assert starts == [[0], [8], [8]]
    assert b.free_page_count() == b.n_pages - 1 - 2


def test_mixed_prefix_cache_reuse(golden_weights):
    """tests/test_mixed_equivalence.py's case: a second same-prefix
    request admitted through mixed rounds maps the registry pages (its
    prefill starts past the shared head) and decodes exactly."""
    params = golden_weights[1]
    b = _batcher(params, max_seq=96)
    pref = list(range(1, 13))
    b.admit_chunked(pref, 4, chunk=4)
    _drain(b, n_steps=4)
    r2 = b.admit_chunked(pref + [50, 51], 5, chunk=4)
    assert [st.pos for st in b.prefilling.values()] == [12]
    _drain(b, n_steps=4)
    assert b.completed[r2] == _plain(params, pref + [50, 51], 5, max_seq=96)


def test_tables_and_registry_equal_the_live_jax_batcher(golden_weights):
    """The golden's traffic on both batchers: every admission's page-table
    row, the free page count and the registry (keys, pages, active) after
    every drain equal."""
    jp, tp = golden_weights
    jb = JaxPaged(jp, jtf.tiny(max_seq=96), n_slots=2, page_size=P,
                  prefix_cache=True)
    tb = _batcher(tp, max_seq=96)
    for p, n in PREFIX_REQS + [(PREFIX_REQS[0][0] + [7] * 5, 3)]:
        jr, tr = jb.admit_chunked(p, n, chunk=4), tb.admit_chunked(p, n,
                                                                   chunk=4)
        np.testing.assert_array_equal(tb.page_table, jb.page_table)
        assert [st.pos for st in tb.prefilling.values()] == \
            [st.pos for st in jb.prefilling.values()]
        _drain_mixed(jb)
        _drain_mixed(tb)
        assert tb.completed[tr] == [int(t) for t in jb.completed[jr]]
        assert tb.free_page_count() == jb.free_page_count()
        assert {k: (e.pages, e.active) for k, e in tb._prefixes.items()} \
            == {k: (list(e.pages), e.active) for k, e in
                jb._prefixes.items()}


def test_prefix_registered_then_reused_exactly(model):
    b = _batcher(model)
    p1 = SYSTEM + [50, 51]
    r1 = b.admit(p1, 6)
    b.run_until_drained()
    assert b.completed[r1] == _plain(model, p1, 6)
    assert list(b._prefixes) == [tuple(p1[:12])]
    (entry,) = b._prefixes.values()
    assert entry.active == 0 and len(entry.pages) == 3
    free_before = b.free_page_count()
    p2 = SYSTEM + [77, 78, 79]
    r2 = b.admit_chunked(p2, 9, chunk=P)
    assert [st.pos for st in b.prefilling.values()] == [12]
    assert entry.active == 1
    # only its own pages: 6 ranges without the 3 shared
    assert free_before - b.free_page_count() == 6 - 3
    tokens_before = b.prefill_tokens
    _drain(b)
    assert b.prefill_tokens - tokens_before == len(p2) - 12
    assert b.completed[r2] == _plain(model, p2, 9)
    assert entry.active == 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_registry_pages_never_written_beside_a_neighbour(model, kv_dtype):
    """A slot mid-prefill on a mapped prefix beside a decoding one,
    through mixed rounds: every leaf of the registry's pages (K and V,
    every layer, an int8 pool's scales too) byte-equal before and after,
    and both streams exact."""
    b = _batcher(model, n_slots=3, cfg_kw={"kv_dtype": kv_dtype})
    b.admit(SYSTEM + [50], 4)
    b.run_until_drained()
    (entry,) = b._prefixes.values()
    pages = torch.tensor(entry.pages)
    leaves = [leaf for store in b.pools for leaf in ttf._kv_leaves(store)]
    before = [leaf[:, pages].clone() for leaf in leaves]
    rn = b.admit([9, 8, 7, 6, 5], 30)           # the decoding neighbour
    b.tick()
    p2 = SYSTEM + list(range(60, 80))
    r2 = b.admit_chunked(p2, 12, chunk=4)
    assert [st.pos for st in b.prefilling.values()] == [12]
    rounds = 0
    while b.prefilling or b.slots:
        b.tick_mixed(3, chunk=4, budget=4)
        rounds += 1
    assert rounds > 5
    for leaf, old in zip(leaves, before):
        assert torch.equal(leaf[:, pages], old), "a registry page changed"
    if kv_dtype == "bf16":
        assert b.completed[r2] == _plain(model, p2, 12)
        assert b.completed[rn] == _plain(model, [9, 8, 7, 6, 5], 30)


def test_prefix_eviction_under_page_pressure(model):
    """32 usable pages: after the first request 3 park on the registry;
    an unrelated request of 31 pages fits only once the idle prefix
    gives them back."""
    b = _batcher(model, n_pages=33)
    p1 = SYSTEM + [50]
    b.admit(p1, 4)
    b.run_until_drained()
    assert list(b._prefixes) == [tuple(p1[:12])]
    long = [99] * 100
    rid = b.admit(long, 24)
    assert rid is not None
    assert tuple(p1[:12]) not in b._prefixes
    b.run_until_drained()
    assert b.completed[rid] == _plain(model, long, 24)


def test_matched_prefix_never_evicts_itself(model):
    """With an active filler holding the pool, a same-prefix request
    whose own pages do not fit is refused (its claim rolled back), not
    served by evicting the prefix it matched."""
    b = _batcher(model, n_pages=17)
    b.admit(SYSTEM + [50], 3)
    b.run_until_drained()
    (key,) = b._prefixes
    filler = b.admit_chunked([77] * 20, 20, chunk=P)
    assert filler is not None and b.free_page_count() == 3
    assert b.admit(SYSTEM + [51], 15) is None
    assert key in b._prefixes and b._prefixes[key].active == 0
    _drain(b)
    rid = b.admit(SYSTEM + [52], 4)
    assert rid is not None
    b.run_until_drained()
    assert b.completed[rid] == _plain(model, SYSTEM + [52], 4)


def test_eviction_waits_for_zero_active(model):
    """The registry's budget (two slots' pages) evicts the least recently
    used IDLE prefix for a new one, never one a slot maps."""
    b = _batcher(model, n_slots=3)
    b.max_cached_pages = 6
    heads = [[h] * 12 for h in (20, 21, 22)]
    b.admit(heads[0] + [1], 2)
    b.run_until_drained()
    b.admit(heads[1] + [1], 2)
    b.run_until_drained()
    assert len(b._prefixes) == 2
    keep = b.admit_chunked(heads[0] + [2], 6, chunk=P)   # maps heads[0]
    b.admit(heads[2] + [1], 2)
    _drain(b)
    # heads[1] was idle: evicted for heads[2]; heads[0] was mapped
    assert set(b._prefixes) == {tuple(heads[0]), tuple(heads[2])}
    assert b.completed[keep] == _plain(model, heads[0] + [2], 6)


def test_unchunked_admit_streams_past_the_shared_prefix(model, monkeypatch):
    """``admit`` of a prompt whose head is cached streams the rest through
    the chunk body: the whole-prompt page walk would rewrite the
    registry's pages."""
    b = _batcher(model)
    b.admit(SYSTEM + [50], 3)
    b.run_until_drained()
    calls = []
    whole = ttf.forward_paged_prefill
    monkeypatch.setattr(ttf, "forward_paged_prefill",
                        lambda *a, **k: calls.append(1) or whole(*a, **k))
    p2 = SYSTEM + [61, 62]
    before = b.prefill_tokens
    rid = b.admit(p2, 5)
    assert not calls and b.prefill_tokens - before == 2
    b.run_until_drained()
    assert b.completed[rid] == _plain(model, p2, 5)


def test_cancelled_prefill_never_registers(model):
    """A slot released mid-prefill donates nothing (its pages hold part
    of a prompt)."""
    b = _batcher(model)
    b.admit_chunked(SYSTEM + [50, 51, 52], 8, chunk=P)
    b.advance_prefill()
    (slot,) = b.prefilling
    del b.prefilling[slot]
    b._release(slot)
    assert not b._prefixes and b.free_page_count() == b.n_pages - 1


def test_storage_info_and_refusals(model):
    b = _batcher(model)
    info = b.storage_info()
    assert (info["prefix_cache"], info["cached_prefixes"],
            info["cached_pages"], info["max_cached_pages"]) == (
                True, 0, 0, 2 * 128 // P)
    b.admit(SYSTEM + [50], 3)
    b.run_until_drained()
    info = b.storage_info()
    assert (info["cached_prefixes"], info["cached_pages"]) == (1, 3)
    assert info["free_pages"] == b.n_pages - 1 - 3
    assert _batcher(model, prefix_cache=False).storage_info()[
        "prefix_cache"] is False
    with pytest.raises(ValueError, match="full-causal"):
        PagedContinuousBatcher(model, ttf.tiny(max_seq=128, window=16),
                               n_slots=1, page_size=P, device="cpu",
                               prefix_cache=True)
    with pytest.raises(ValueError, match="paged"):
        ContinuousService(model, _cfg(), n_slots=1, page_size=0,
                          device="cpu", prefix_cache=True)


def test_prefix_cache_through_the_service(model, monkeypatch):
    monkeypatch.setattr(continuous, "PREFILL_CHUNK", P)
    svc = ContinuousService(model, _cfg(), n_slots=2, page_size=P,
                            device="cpu", prefix_cache=True).start()
    try:
        reqs = [(SYSTEM + [50, 51], 8), (SYSTEM + [60], 10),
                ([7, 7, 7, 7, 7], 6), (SYSTEM + [50, 51], 8)]
        sinks = [svc.submit(p, n) for p, n in reqs]
        for (p, n), s in zip(reqs, sinks):
            assert s.get(timeout=120) == _plain(model, p, n)
        assert svc.storage_info()["cached_prefixes"] >= 1
    finally:
        svc.stop()


def test_server_flags():
    args = llm.parse_args(["--model", "tiny", "--device", "cpu",
                           "--prefix-cache", "--prefill-budget", "32",
                           "--sequential-prefill", "--port", "0"])
    assert (args.prefix_cache, args.prefill_budget,
            args.sequential_prefill) == (True, 32, True)
    srv = llm.start_server(args, env={})
    try:
        svc = srv._service
        assert svc._batcher.prefix_cache_enabled
        assert (svc._prefill_budget, svc._mixed_step) == (32, False)
    finally:
        srv.stop()
    for bad in (["--prefix-cache", "--page-size", "0"],
                ["--prefill-budget", "8", "--slots", "0"],
                ["--sequential-prefill", "--slots", "0"]):
        with pytest.raises(SystemExit):
            llm.parse_args(bad)


def test_llama2_7b_is_the_reference_default_config():
    got, want = ttf.llama2_7b(), jtf.ModelConfig()
    for f in ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "max_seq", "rope_theta", "norm_eps", "window"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.dtype == torch.bfloat16 and got.head_dim == 128
    assert llm.MODELS["llama2-7b"] is ttf.llama2_7b
    assert dataclasses.replace(got, n_layers=2).n_kv_heads == got.n_heads
