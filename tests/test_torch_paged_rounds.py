"""Port parity: the paged pool's chunked admission and its fused and mixed
rounds, and the service loop that runs on them.

On the golden scenarios' ``tiny`` weights (f32) carried over by the
bridge: the ``paged`` and ``page_ring`` goldens of
``tests/golden_kv_bf16.json`` (read, never recomputed) through
``admit_chunked`` + ``tick_mixed`` and through ``advance_prefill`` +
``tick_fused``; ``forward_paged_prefill_batch`` against JAX's with rows at
different offsets and a padded row, on f32 and int8 pools and striped over
an ``sp = 2`` CPU mesh; the paged counterparts of
``tests/test_mixed_equivalence.py``'s cases against the port's own
``generate`` (held to JAX in ``tests/test_torch_generate.py``); an int8
pool through mixed rounds against the live JAX batcher; sampled streams
equal across ticked, fused and mixed rounds; and ``ContinuousService``
with ``mixed_step`` on and off, on dense and paged storage, against the
live JAX service, its ``ttft_s`` taken where the slot activates."""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpushare.models import transformer as jtf
from tpushare.serving.continuous import ContinuousService as JaxService
from tpushare.serving.paged import PagedContinuousBatcher as JaxPaged
from tpushare_torch.models import transformer as ttf
from tpushare_torch.models.bridge import params_from_numpy
from tpushare_torch.parallel.mesh import make_mesh
from tpushare_torch.serving import continuous
from tpushare_torch.serving.continuous import ContinuousService
from tpushare_torch.serving.generate import generate
from tpushare_torch.serving.paged import PagedContinuousBatcher

from kv_golden_scenarios import FULL_REQS, WIN_REQS, _drain_fused, \
    _drain_mixed

# tiny shapes: one intra-op thread, so this file does not crowd the
# wall-clock tests that other workers run beside it
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_kv_bf16.json")
WINDOW = 16
#: f32 logits through two layers in two frameworks (~1e-6 relative)
LOGIT_ATOL = 1e-4


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


def _cfg(window=None, kv_dtype="bf16", attn_kernel="kernel"):
    return ttf.tiny(max_seq=96, window=window, kv_dtype=kv_dtype,
                    attn_kernel=attn_kernel)


def _paged(weights, window=None, n_slots=3, **kw):
    cfg_kw = {k: kw.pop(k) for k in ("kv_dtype", "attn_kernel") if k in kw}
    if window:
        kw.setdefault("max_prefill_chunk", 4)
    return PagedContinuousBatcher(
        weights["window" if window else "full"][1], _cfg(window, **cfg_kw),
        n_slots=n_slots, page_size=4, device="cpu", **kw)


def _plain(weights, prompt, n, window=None):
    """The port's ``generate`` on dense (or rolling) rows: the reference
    stream of one request."""
    out = generate(weights["window" if window else "full"][1], _cfg(window),
                   torch.tensor([prompt]), max_new_tokens=n)
    return out[0].tolist()


def _drain(b, n_steps=4, chunk=4, budget=8):
    for _ in range(500):
        if not b.prefilling and not b.slots:
            return
        b.tick_mixed(n_steps, chunk=chunk, budget=budget)
    raise RuntimeError("mixed drain did not finish")


# ---------------------------------------------------------------------------
# the goldens
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attn_kernel", ["kernel", "gather"])
@pytest.mark.parametrize("drain", [_drain_mixed, _drain_fused],
                         ids=["mixed", "fused"])
@pytest.mark.parametrize("flavor,window", [("paged", None),
                                           ("page_ring", WINDOW)])
def test_streams_equal_the_goldens(weights, golden, flavor, window, drain,
                                   attn_kernel):
    """The reference drew these goldens through ``admit_chunked`` and
    ``tick_mixed``; the sequential rounds give the same streams.  The
    windowed page ring takes ``max_prefill_chunk`` 4, so its frozen rows'
    garbage writes must not recycle a lane still in a window."""
    reqs = WIN_REQS if window else FULL_REQS
    b = _paged(weights, window, attn_kernel=attn_kernel)
    rids = [b.admit_chunked(p, n, chunk=4) for p, n in reqs]
    drain(b)
    assert [b.completed[r] for r in rids] == golden[flavor]
    assert not b.slots and not b.prefilling
    assert b.free_page_count() == b.n_pages - 1


@pytest.mark.parametrize("budget", [4, 8])
def test_frozen_rows_hold_on_the_page_ring(weights, golden, budget):
    """Decode rounds longer than the ring's prefill margin (12 steps
    against a ring of 24 positions over a window of 16): a row still
    prefilling stays frozen at its aimed position; a write wandering to
    q would recycle the lane of q - 24, inside its next window."""
    b = _paged(weights, WINDOW)
    rids = [b.admit_chunked(p, n, chunk=4) for p, n in WIN_REQS]
    _drain(b, n_steps=12, chunk=4, budget=budget)
    assert [b.completed[r] for r in rids] == golden["page_ring"]


# ---------------------------------------------------------------------------
# forward_paged_prefill_batch
# ---------------------------------------------------------------------------
PAGE = 4


def _batch_plan(n_pages, sp=1):
    """Three live rows (tables of distinct pages, range j on stripe
    j % sp) prefilled in windows of 8: calls run rows at offsets
    (0, 0), then (8, 0) with a padded row, then (0, 16, 8) with a padded
    row.  Returns (tables [3, 24], calls of (rows, offsets))."""
    rng = np.random.default_rng(5)
    per = n_pages // sp
    free = [list(rng.permutation(np.arange(s * per + 1, (s + 1) * per)))
            for s in range(sp)]
    tables = np.zeros((3, 96 // PAGE), np.int32)
    for r in range(3):
        for j in range(8):
            tables[r, j] = free[j % sp].pop()
    calls = [((1, 2), (0, 0)), ((1, None), (8, 0)),
             ((0, 2, None, 1), (0, 8, 0, 16))]
    return tables, calls


def _batch_tokens(rng, rows):
    return rng.integers(1, 256, (len(rows), 8)).astype(np.int32)


def _global_leaves(pools, sp):
    """Every leaf of the pool, the stripes concatenated in page order:
    [k values, (k scales,) v values, (v scales)]."""
    stripes = list(pools) if sp > 1 else [pools]
    out = []
    for i in range(2):
        kinds = ttf._kv_leaves(stripes[0][i])
        for n in range(len(kinds)):
            out.append(torch.cat([ttf._kv_leaves(st[i])[n]
                                  for st in stripes], dim=1).numpy())
    return out


def _jax_leaves(pools):
    return [np.asarray(leaf) for store in pools
            for leaf in ([store["q"], store["s"]]
                         if isinstance(store, dict) else [store])]


def _load_pool(tpools, jpools, sp):
    """Copy the JAX pool into the port's, page for page (stripe s takes
    global pages [s * per, (s + 1) * per)), so that a call starts both
    from one pool: an int8 rounding tie of an earlier call cannot carry
    into a later call's logits."""
    stripes = list(tpools) if sp > 1 else [tpools]
    src = iter(_jax_leaves(jpools))
    for i in range(2):
        for n in range(len(ttf._kv_leaves(stripes[0][i]))):
            whole = torch.from_numpy(np.array(next(src)))
            per = whole.shape[1] // sp
            for st_i, st in enumerate(stripes):
                ttf._kv_leaves(st[i])[n].copy_(
                    whole[:, st_i * per:(st_i + 1) * per])


def _run_batches(weights, kv_dtype, attn_kernel, sp):
    """The plan through the port's and JAX's forward_paged_prefill_batch,
    each call from the same pool; returns each live row's logits (port,
    jax, whether its window's codes are JAX's), both final pools' leaves
    with the trash pages (0, and each stripe's first page) left out, and
    a mask of those pages outside a window with an int8 tie."""
    jp, tp = weights["full"]
    jcfg = dataclasses.replace(jtf.tiny(max_seq=96), kv_dtype=kv_dtype)
    tcfg = _cfg(kv_dtype=kv_dtype, attn_kernel=attn_kernel)
    n_pages = 2 * 49
    tables, calls = _batch_plan(n_pages, sp)
    mesh = make_mesh({"sp": sp}, devices=["cpu"] * sp) if sp > 1 else None
    tpools = ttf.init_paged_kv(tcfg, n_pages, PAGE, device="cpu", mesh=mesh)
    jpools = jtf.init_paged_kv(jcfg, n_pages, PAGE)
    rng = np.random.default_rng(9)
    logits, tie_pages = [], set()
    for rows, offsets in calls:
        toks = _batch_tokens(rng, rows)
        tbl = np.stack([tables[r] if r is not None
                        else np.zeros_like(tables[0]) for r in rows])
        pos = np.asarray(offsets, np.int32)
        last = np.asarray([7 if r is not None else 0 for r in rows],
                          np.int32)
        last[0] = 5                       # a padded tail in a live row
        _load_pool(tpools, jpools, sp)
        tl, tpools = ttf.forward_paged_prefill_batch(
            tp, torch.from_numpy(toks).long(), tcfg, tpools,
            torch.from_numpy(tbl), torch.from_numpy(pos),
            torch.from_numpy(last), mesh=mesh)
        jl, jpools = jtf.forward_paged_prefill_batch(
            jp, jnp.asarray(toks), jcfg, jpools, jnp.asarray(tbl),
            jnp.asarray(pos), jnp.asarray(last))
        # a live row is compared where its window's stored codes equal
        # JAX's: an int8 rounding tie (x / s a hair either side of .5 in
        # the two frameworks) changes one key by a whole step, and that
        # row's logits with it
        tl_np, jl_np = tl.numpy(), np.asarray(jl)
        got_w = _global_leaves(tpools, sp)
        want_w = _jax_leaves(jpools)
        for i, r in enumerate(rows):
            if r is None:
                continue
            pages = tables[r][pos[i] // PAGE:pos[i] // PAGE + 2]
            same = all(np.array_equal(g[:, pages], w[:, pages])
                       for g, w in zip(got_w, want_w)
                       if g.dtype == np.int8)
            logits.append((tl_np[i], jl_np[i], same))
            if not same:
                tie_pages.update(int(p) for p in pages)
    keep = np.ones(n_pages, bool)
    keep[[s * (n_pages // sp) for s in range(sp)]] = False
    exact = keep.copy()
    exact[sorted(tie_pages)] = False
    return (logits, [x[:, keep] for x in _global_leaves(tpools, sp)],
            [x[:, keep] for x in _jax_leaves(jpools)], exact[keep])


@pytest.mark.parametrize("sp", [1, 2])
@pytest.mark.parametrize("kv_dtype,attn_kernel", [
    ("bf16", "kernel"), ("bf16", "gather"), ("int8", "kernel")])
def test_prefill_batch_matches_jax(weights, kv_dtype, attn_kernel, sp):
    """Rows at different offsets, a live row with a padded tail and a
    padded row on an all-zero table, through three calls that build each
    row's history, each call from JAX's pool: logits within 1e-4 of
    JAX's at every call, and every page but the trash pages equal (int8
    codes but for rare ties of the rounding; a row whose own window holds
    such a tie reads a key one step off, so its logits and its window's
    scales are left out, at most one row of the eight).  With ``sp = 2``
    the pool is striped over two CPU shards, and the padded row's writes
    land on each stripe's trash page."""
    logits, got, want, exact = _run_batches(weights, kv_dtype, attn_kernel,
                                            sp)
    held = [(tl, jl) for tl, jl, same in logits if same]
    assert len(held) >= len(logits) - 1
    for tl, jl in held:
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
    if kv_dtype == "int8":
        for g, w in zip(got, want):
            if g.dtype == np.int8:
                diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            else:
                np.testing.assert_allclose(g[:, exact], w[:, exact],
                                           rtol=1e-5, atol=1e-7)
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        assert any(np.abs(g).max() > 0 for g in got)


def test_prefill_batch_refuses_a_window_off_the_page():
    cfg = _cfg()
    params = ttf.init_params(cfg, seed=0, device="cpu")
    pools = ttf.init_paged_kv(cfg, 9, PAGE, device="cpu")
    with pytest.raises(ValueError, match="page-aligned"):
        ttf.forward_paged_prefill_batch(
            params, torch.zeros((1, 6), dtype=torch.long), cfg, pools,
            torch.zeros((1, 24), dtype=torch.int32), torch.zeros(1),
            torch.zeros(1))


# ---------------------------------------------------------------------------
# the mixed rounds (tests/test_mixed_equivalence.py's cases, paged)
# ---------------------------------------------------------------------------
def test_mixed_greedy_matches_generate(weights):
    b = _paged(weights)
    rids = [b.admit_chunked(p, n, chunk=4) for p, n in FULL_REQS]
    _drain(b)
    for rid, (p, n) in zip(rids, FULL_REQS):
        assert b.completed[rid] == _plain(weights, p, n), rid
    assert b.free_page_count() == b.n_pages - 1


def test_mixed_windowed_page_ring(weights):
    """The ring's prefill margin: chunks clamped into
    ``max_prefill_chunk`` (8), prompts longer than the ring."""
    reqs = [(list(range(1, 25)), 8), ([3, 5, 7], 10), ([9] * 30, 6)]
    b = _paged(weights, WINDOW, max_prefill_chunk=8)
    rids = [b.admit_chunked(p, n, chunk=8) for p, n in reqs]
    assert all(st.chunk == 8 for st in b.prefilling.values())
    _drain(b, chunk=8, budget=16)
    for rid, (p, n) in zip(rids, reqs):
        assert b.completed[rid] == _plain(weights, p, n, WINDOW), rid


def test_mixed_budget_tighter_than_queue(weights):
    """Four prompts, two block rows a round: the rotation drains them
    all exactly."""
    reqs = [([1 + i] * 22, 4) for i in range(4)]
    b = _paged(weights, n_slots=4)
    rids = [b.admit_chunked(p, n, chunk=4) for p, n in reqs]
    _drain(b, n_steps=2, chunk=4, budget=8)
    for rid, (p, n) in zip(rids, reqs):
        assert b.completed[rid] == _plain(weights, p, n), rid


def test_mixed_boundary_overflow_falls_back_narrow(weights):
    """A slot whose next mixed window (12) would cross max_seq advances
    by one narrow chunk (8, still page-aligned) and stays exact."""
    b = _paged(weights, n_slots=2)
    prompt = [2] * 95
    r = b.admit_chunked(prompt, 1, chunk=44)
    rd = b.admit([4, 5, 6], 8)                  # decoding neighbour
    b.advance_prefill()
    b.advance_prefill()
    assert [st.pos for st in b.prefilling.values()] == [88]
    b.tick_mixed(2, chunk=12, budget=24)
    assert not b.prefilling
    _drain(b, n_steps=2, chunk=12, budget=24)
    assert b.completed[r] == _plain(weights, prompt, 1)
    assert b.completed[rd] == _plain(weights, [4, 5, 6], 8)


def test_mixed_rounds_round_the_chunk_to_pages(weights):
    """Chunked admission and the mixed window round up to a page multiple
    (and clamp to the ring's margin on a windowed config); a chunk below
    1 raises."""
    b = _paged(weights, n_slots=2)
    b.admit_chunked([1] * 9, 2, chunk=5)
    assert [st.chunk for st in b.prefilling.values()] == [8]
    assert b._mixed_chunk_len(5) == 8 and b._mixed_chunk_len(0) == 4
    with pytest.raises(ValueError, match="chunk"):
        b.admit_chunked([1], 2, chunk=0)
    ring = _paged(weights, WINDOW, max_prefill_chunk=8)
    assert ring._mixed_chunk_len(64) == 8
    ring.admit_chunked([1] * 9, 2, chunk=64)
    assert [st.chunk for st in ring.prefilling.values()] == [8]


def test_prefill_block_rows_and_tables(weights, monkeypatch):
    """Every mixed block: a padded row rides an all-zero table at offset
    0, and no live row's window maps page 0 inside its reservation (the
    trash page repeats only for padded rows and past a reservation)."""
    seen = []
    forward = ttf.forward_paged_prefill_batch

    def spy(params, tokens, cfg, pools, page_rows, pos, last_idx, mesh=None):
        seen.append((page_rows.clone(), pos.clone()))
        return forward(params, tokens, cfg, pools, page_rows, pos, last_idx,
                       mesh=mesh)

    monkeypatch.setattr(ttf, "forward_paged_prefill_batch", spy)
    b = _paged(weights, n_slots=4)
    reqs = [([1] * 30, 4), ([2] * 5, 6), ([3] * 13, 3)]
    spans = [len(p) + n for p, n in reqs]
    for p, n in reqs:
        b.admit_chunked(p, n, chunk=8)
    _drain(b, n_steps=2, chunk=8, budget=24)
    assert seen and any((t == 0).all(dim=1).any() for t, _ in seen)
    for tables, pos in seen:
        for row, p in zip(tables, pos.tolist()):
            if (row == 0).all():
                assert p == 0
                continue
            n_ranges = next(-(-s // 4) for s in spans
                            if (row[:-(-s // 4)] != 0).all())
            lo, hi = p // 4, min(p // 4 + 2, n_ranges)
            assert (row[lo:hi] != 0).all()


def test_int8_pool_through_mixed_rounds_equals_the_live_jax_batcher(
        weights):
    jp = weights["full"][0]
    jcfg = dataclasses.replace(jtf.tiny(max_seq=96), kv_dtype="int8")
    jb = JaxPaged(jp, jcfg, n_slots=3, page_size=4)
    jrids = [jb.admit(p, n) for p, n in FULL_REQS]
    jb.run_until_drained()
    want = [[int(t) for t in jb.completed[r]] for r in jrids]
    for kind in ("kernel", "gather"):
        b = _paged(weights, kv_dtype="int8", attn_kernel=kind)
        rids = [b.admit_chunked(p, n, chunk=4) for p, n in FULL_REQS]
        _drain_mixed(b)
        assert [b.completed[r] for r in rids] == want, kind


@pytest.mark.parametrize("window", [None, WINDOW])
def test_sampled_streams_equal_across_rounds(weights, window):
    """A slot draws from its own generator once a step, whichever round
    runs the step: ticked, fused and mixed drains on the paged pool give
    the same sampled (and greedy) streams."""
    reqs = WIN_REQS if window else FULL_REQS
    streams = {}
    for how in ("ticked", "fused", "mixed"):
        b = _paged(weights, window)
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


def test_striped_mixed_rounds_equal_the_unstriped_ticks(weights):
    """On an ``sp = 2`` CPU mesh a mixed block's padded rows write every
    stripe's trash page; the striped pool's mixed streams equal the
    unstriped pool's ticked ones."""
    reqs = FULL_REQS + [([4] * 21, 5)]
    want_b = _paged(weights, n_slots=4)
    want = [want_b.admit(p, n) for p, n in reqs]
    want_b.run_until_drained()
    b = PagedContinuousBatcher(weights["full"][1], _cfg(), n_slots=4,
                               page_size=4,
                               mesh=make_mesh({"sp": 2},
                                              devices=["cpu"] * 2))
    rids = [b.admit_chunked(p, n, chunk=4) for p, n in reqs]
    _drain(b, n_steps=3, chunk=4, budget=12)
    assert [b.completed[r] for r in rids] == [want_b.completed[r]
                                              for r in want]


def test_decode_past_the_table_lands_on_the_trash_page(weights):
    """A slot ending at max_seq inside a fused round decodes its surplus
    steps past the page table: they go to the trash page."""
    b = _paged(weights, n_slots=1)
    prompt = [5] * 90
    rid = b.admit(prompt, 6)                    # 90 + 6 = max_seq
    b.tick_fused(8)
    assert b.completed[rid] == _plain(weights, prompt, 6)


# ---------------------------------------------------------------------------
# the service loop
# ---------------------------------------------------------------------------
SERVICE_REQS = [([3, 5, 7], 10), ([1] * 14, 8), ([2] * 11, 6), ([6, 6, 6], 9)]


@pytest.fixture(scope="module")
def jax_service_outputs(weights):
    """The live JAX service (dense storage, mixed rounds) on the same
    traffic: the reference the port's services are held to."""
    svc = JaxService(weights["full"][0], jtf.tiny(max_seq=96), n_slots=2,
                     prefill_chunk=4, decode_chunk=4).start()
    try:
        sinks = [svc.submit(p, n) for p, n in SERVICE_REQS]
        return [[int(t) for t in s.get(timeout=120)] for s in sinks]
    finally:
        svc.stop()


@pytest.fixture
def small_windows(monkeypatch):
    """The service's window and fused steps at 4 tokens, so that the
    tiny prompts stream over several windows."""
    monkeypatch.setattr(continuous, "PREFILL_CHUNK", 4)
    monkeypatch.setattr(continuous, "DECODE_CHUNK", 4)


@pytest.mark.parametrize("page_size", [0, 4], ids=["dense", "paged"])
@pytest.mark.parametrize("mixed", [True, False],
                         ids=["mixed", "sequential"])
def test_service_mixed_equals_sequential_flag(weights, jax_service_outputs,
                                              small_windows, page_size,
                                              mixed):
    """All four requests queued before the loop starts: the first pass
    (nothing decoding) admits two whole, and the later ones are admitted
    while a slot decodes, so they stream through the rounds."""
    svc = ContinuousService(weights["full"][1], _cfg(), n_slots=2,
                            page_size=page_size, device="cpu",
                            mixed_step=mixed)
    sinks = [svc.submit(p, n) for p, n in SERVICE_REQS]
    svc.start()
    try:
        outs = [s.get(timeout=120) for s in sinks]
        snap = svc.snapshot()
    finally:
        svc.stop()
    assert outs == jax_service_outputs
    assert snap["rounds"] > 0 and snap["prefills"] > len(SERVICE_REQS)
    assert (snap["admitted_whole"], snap["admitted_chunked"]) == (3, 1)
    assert snap["prefill_tokens"] == sum(len(p) for p, _ in SERVICE_REQS)


def test_service_defaults_are_the_reference_knobs(weights):
    svc = ContinuousService(weights["full"][1], _cfg(), n_slots=2,
                            page_size=4, device="cpu")
    assert (continuous.PREFILL_CHUNK, continuous.DECODE_CHUNK,
            svc._mixed_step, svc._prefill_budget) == (64, 8, True, 128)
    assert svc._batcher.max_prefill_chunk == 64
    svc = ContinuousService(weights["full"][1], _cfg(), n_slots=2,
                            page_size=4, device="cpu", prefill_budget=40)
    assert svc._prefill_budget == 40


def _serve_by_hand(svc, sinks):
    """The loop's body, run on this thread until every sink holds its
    output: admission, a round, delivery.  Returns each round's
    (start, end) times."""
    spans = []
    while not all(s.full() for s in sinks):
        svc._admit_waiting()
        t0 = time.perf_counter()
        svc._round()
        spans.append((t0, time.perf_counter()))
        svc._deliver()
        assert len(spans) < 200
    return spans


def test_service_ttft_is_taken_at_activation(weights, small_windows):
    """A 40-token prompt that arrives while a slot decodes streams in
    4-token windows and activates ten rounds after its admission: its
    ``ttft_s`` lies inside the round that activated it, not at the
    admission."""
    svc = ContinuousService(weights["full"][1], _cfg(), n_slots=2,
                            page_size=4, device="cpu", prefill_budget=4)
    b = svc._batcher
    decoder = svc.submit([5, 6, 7], 60)
    svc._admit_waiting()
    svc._round()
    t0 = time.perf_counter()
    sink = svc.submit([7] * 40, 3)
    t1 = time.perf_counter()
    svc._admit_waiting()
    (rid,) = [r for r, req in svc._inflight.items() if req.sink is sink]
    assert [st.request_id for st in b.prefilling.values()] == [rid]
    activated, spans = None, []
    while not sink.full():
        start = time.perf_counter()
        svc._round()
        spans.append((start, time.perf_counter()))
        if activated is None and rid in b.activated_at:
            activated = len(spans) - 1
        svc._deliver()
    timing = svc.timings[-1]
    _serve_by_hand(svc, [decoder])
    assert sink.get() == _plain(weights, [7] * 40, 3)
    assert decoder.get() == _plain(weights, [5, 6, 7], 60)
    assert (svc.admitted_whole, svc.admitted_chunked) == (1, 1)
    assert activated >= 9
    lo, hi = spans[activated]
    assert lo - t1 <= timing["ttft_s"] <= hi - t0
    assert timing["ttft_s"] < timing["total_s"]


def test_service_admits_whole_when_nothing_decodes(weights, small_windows):
    """A pass that starts with no slot decoding prefills each prompt in
    one forward, however long; a prompt that arrives while a slot decodes
    streams in windows through mixed rounds."""
    svc = ContinuousService(weights["full"][1], _cfg(), n_slots=3,
                            page_size=4, device="cpu")
    b = svc._batcher
    burst = [svc.submit([3] * 30, 10), svc.submit([4] * 21, 10)]
    svc._admit_waiting()
    assert (b.prefills, len(b.slots), len(b.prefilling)) == (2, 2, 0)
    svc._round()
    late = svc.submit([9] * 30, 5)
    svc._admit_waiting()
    assert len(b.prefilling) == 1 and svc.admitted_chunked == 1
    _serve_by_hand(svc, burst + [late])
    assert b.prefills == 2 + -(-30 // 4)
    assert [s.get() for s in burst + [late]] == [
        _plain(weights, [3] * 30, 10), _plain(weights, [4] * 21, 10),
        _plain(weights, [9] * 30, 5)]
