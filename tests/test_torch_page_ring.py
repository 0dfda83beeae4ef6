"""Port parity: the windowed page ring of the paged batcher.

A sliding-window config (window 16 < max_seq 128, pages of 8,
``max_prefill_chunk`` 16) holds each sequence in a ring of
ceil(16/8) + ceil(16/8) + 1 = 5 pages, range j on ring page j % 5, on a
pool of 8 pages (7 usable) that no request's full span would fit.  The
same requests go to the JAX ``PagedContinuousBatcher`` (live, the
reference) and to the port's, with the same bridged ``tiny`` weights:
admissions, held pages and page-table rows must be equal, and greedy
streams token-equal on both read paths ("kernel" runs K2's plain version
here, on the CPU), a prompt longer than its ring (chunked prefill)
included."""

import numpy as np
import pytest
import torch

import jax

from tpushare.models import transformer as jtf
from tpushare.serving.paged import PagedContinuousBatcher as JaxPaged
from tpushare_torch.models import transformer as ttf
from tpushare_torch.models.bridge import params_from_numpy
from tpushare_torch.serving.paged import PagedContinuousBatcher

# tiny shapes: one intra-op thread, so this file does not crowd the
# wall-clock tests that other workers run beside it
torch.set_num_threads(1)

WINDOW, PAGE, CHUNK, N_PAGES, MAX_SEQ = 16, 8, 16, 8, 128
RING = 5

_rng = np.random.default_rng(3)
#: (prompt, max_new): a prompt longer than the ring's 40 tokens (chunked
#: prefill, 4 windows), a short request that fits without a ring, a ring
#: whose prompt fits its span (one whole prefill), and a request whose
#: full span (13 pages) exceeds the pool's 7 usable pages
REQS = [(_rng.integers(1, 256, 50).tolist(), 20),
        (_rng.integers(1, 256, 12).tolist(), 10),
        (_rng.integers(1, 256, 30).tolist(), 30),
        (_rng.integers(1, 256, 45).tolist(), 55)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jtf.tiny(max_seq=MAX_SEQ, window=WINDOW)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tparams


def _drive(b):
    """Admit REQS in order whenever a slot and the pages allow, one decode
    tick between attempts; returns (the tick of each admission, each
    admission's held pages and page-table row, the streams)."""
    pending = list(range(len(REQS)))
    admitted, rids = [], {}
    tick = 0
    while pending or b.slots:
        while pending:
            slot = b.free_slots()[0] if b.free_slots() else None
            prompt, n = REQS[pending[0]]
            rid = None if slot is None else b.admit(prompt, n)
            if rid is None:
                break
            rids[pending.pop(0)] = rid
            admitted.append((tick, slot, len(b._slot_pages[slot]),
                             b.page_table[slot].tolist()))
        b.tick()
        tick += 1
    return admitted, [list(map(int, b.completed[rids[i]]))
                      for i in range(len(REQS))]


@pytest.fixture(scope="module")
def reference(weights):
    jcfg, jparams, _ = weights
    b = JaxPaged(jparams, jcfg, n_slots=3, page_size=PAGE, n_pages=N_PAGES,
                 max_prefill_chunk=CHUNK)
    return _drive(b)


def _port(tparams, attn_kernel):
    cfg = ttf.tiny(max_seq=MAX_SEQ, window=WINDOW, attn_kernel=attn_kernel)
    return PagedContinuousBatcher(tparams, cfg, n_slots=3, page_size=PAGE,
                                  n_pages=N_PAGES, device="cpu",
                                  max_prefill_chunk=CHUNK)


@pytest.mark.parametrize("attn_kernel", ["gather", "kernel"])
def test_ring_tables_and_streams_equal_jax(weights, reference, attn_kernel):
    b = _port(weights[2], attn_kernel)
    admitted, streams = _drive(b)
    ref_admitted, ref_streams = reference
    assert admitted == ref_admitted
    assert streams == ref_streams
    # the rings were held: 5 pages for every windowed request longer
    # than 5 pages, the row repeating them
    assert [a[2] for a in admitted] == [RING, 3, RING, RING]
    row = admitted[3][3]
    assert row[:13] == (row[:RING] * 3)[:13] and not any(row[13:])
    # every page went back to the free list; the table is all trash
    assert b.free_page_count() == N_PAGES - 1
    assert not b.page_table.any()


def test_ring_admits_what_the_full_span_would_refuse(weights):
    jcfg, jparams, tparams = weights
    ref = JaxPaged(jparams, jcfg, n_slots=2, page_size=PAGE,
                   n_pages=N_PAGES, max_prefill_chunk=CHUNK)
    b = _port(tparams, "kernel")
    prompt, n = REQS[3]                  # 100 tokens: 13 ranges, 7 usable
    for bat in (ref, b):
        bat.validate_request(prompt, n)
        assert bat._held_pages(len(prompt), n) == RING
        assert bat._ring_held_pages() == RING
    assert b.max_prefill_chunk == ref.max_prefill_chunk == CHUNK
    assert b.admit(prompt, n) is not None
    # 2 pages left: a second ring waits for the first (backpressure)
    assert b.admit(REQS[0][0], REQS[0][1]) is None
    assert b.free_page_count() == N_PAGES - 1 - RING


@pytest.mark.parametrize("chunk,want", [(1, 8), (16, 16), (17, 24)])
def test_prefill_chunk_rounds_to_pages(weights, chunk, want):
    cfg = ttf.tiny(max_seq=MAX_SEQ, window=WINDOW)
    b = PagedContinuousBatcher(weights[2], cfg, n_slots=1, page_size=PAGE,
                               device="cpu", max_prefill_chunk=chunk)
    assert b.max_prefill_chunk == want
    assert b._ring_held_pages() == 2 + want // PAGE + 1


def test_chunked_prefill_counts_each_window(weights):
    b = _port(weights[2], "kernel")
    prompt, n = REQS[0]                  # 50 tokens past a 40-token ring
    b.admit(prompt, n)
    assert b.prefills == 4               # windows of 16, 16, 16, 2
