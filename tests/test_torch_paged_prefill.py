"""K2's prefill arm (S > 1) on the CPU: the walk of its Hopper body.

The prefill kernel (``csrc/paged_attn.cu``) packs the n_rep q heads of a
kv head into one row space (row r: head kh * n_rep + r // S at position
r % S), gives each block 128 of those rows as two consumers of 64, and
walks 128-key tiles of the page table from each consumer's own key
range: tiles wholly outside it are skipped, tiles every row keeps whole
are folded unmasked, the rest masked.  Its plain version,
``_paged_prefill_plain``, is held here to the one-pass plain version
``_paged_plain`` (f32, 1e-6: reassociated sums only) and to the JAX
package's Pallas kernel in interpret mode (``default_interpret()``, 2e-5
as the port's other K2 parity tests), on an f32 pool and an int8 store,
unstriped and on a stripe's local table and ``pos_map`` with stats:
windows that skip whole tiles, tiles that cross a head boundary
(S = 100, n_rep 4), n_rep 1/4/8, D 64/128, pages of 4, 8 and 16.  Then
the kernel's block order, from shapes alone.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpushare.ops import quant as jq
from tpushare_torch.ops import attention as tattn
from tpushare_torch.ops import quant as tq

# tiny shapes: one intra-op thread, so this file does not crowd the
# wall-clock tests that other workers run beside it
torch.set_num_threads(1)

# the JAX package's ops/__init__ re-exports a function named attention
jattn = importlib.import_module("tpushare.ops.attention")

#: the tiled walk against the one-pass plain version, f32
PLAIN_ATOL = 1e-6
#: against the interpreted Pallas kernel, f32: reassociated sums
JAX_ATOL = 2e-5


def _store(rng, int8, n_pages, hkv, page, d):
    x = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
    if int8:
        return jq.quantize_kv(jnp.asarray(x)), tq.quantize_kv(
            torch.from_numpy(x))
    return jnp.asarray(x), torch.from_numpy(x)


def _table(rng, contexts, page, n_tbl, n_pages, sp=1):
    """Rows' pages drawn without replacement, 0-padded; with ``sp`` > 1
    laid out as the striped batcher lays them (range j from stripe
    j % sp, never a stripe's trash page)."""
    per = n_pages // sp
    free = [list(rng.permutation(np.arange(t * per + 1, (t + 1) * per)))
            for t in range(sp)]
    table = np.zeros((len(contexts), n_tbl), np.int32)
    for i, c in enumerate(contexts):
        for j in range(-(-c // page)):
            table[i, j] = free[j % sp].pop()
    return table


#: (id, n_rep, d, page, n_tbl, contexts, S, window, int8, sp): each row's
#: queries are its last S positions; sp > 1 reads stripe 1 of sp (its
#: local table and pos_map, with stats).  What each case must show of the
#: walk: "skip" a consumer whose first tile lies past the block's first
#: (a window, or a stripe's early row), "cross" a consumer whose rows
#: span two q heads, "whole" a tile folded unmasked, "empty" a row that
#: keeps no key of its stripe
CASES = [
    ("cross_heads", 4, 64, 8, 20, [130, 150], 100, None, False, 1,
     {"cross", "whole"}),
    ("cross_heads_int8", 4, 128, 16, 12, [150, 180], 100, None, True, 1,
     {"cross"}),
    ("window_skips_tiles", 4, 64, 8, 70, [420, 500], 40, 300, False, 1,
     {"skip", "whole"}),
    ("window_skips_int8_page4", 8, 64, 4, 96, [330, 290], 20, 48, True, 1,
     {"skip"}),
    ("n_rep1_d128", 1, 128, 16, 24, [90, 350], 30, None, False, 1,
     {"whole"}),
    ("n_rep8_page16", 8, 64, 16, 20, [40, 300], 24, 100, False, 1,
     {"cross", "skip"}),
    ("whole_tiles_page4", 4, 64, 4, 80, [310], 16, None, False, 1,
     {"whole"}),
    ("striped", 4, 64, 8, 48, [150, 330], 40, None, False, 2,
     {"whole"}),
    ("striped_int8_window", 4, 128, 8, 48, [320, 380], 36, 100, True, 2,
     {"skip"}),
    ("striped_n_rep8_page16", 8, 64, 16, 24, [60, 360], 50, None, True, 3,
     {"cross", "empty"}),
    ("striped_empty_rows", 1, 64, 4, 40, [6, 150], 6, None, False, 2,
     {"empty"}),
]


def _walk_shows(walk, s):
    shows = set()
    for w in walk:
        ra, rb = w["rows"]
        if w["t_lo"] > 0 or w["kb"] > 0:
            shows.add("skip")
        if ra // s != (rb - 1) // s:
            shows.add("cross")
        if w["whole"]:
            shows.add("whole")
    return shows


@pytest.mark.parametrize(
    "n_rep,d,page,n_tbl,contexts,s,window,int8,sp,shows",
    [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_prefill_walk_matches_plain_and_jax(n_rep, d, page, n_tbl,
                                            contexts, s, window, int8, sp,
                                            shows):
    rng = np.random.default_rng(n_tbl * 100 + n_rep * 10 + d + sp + s)
    b, hkv = len(contexts), 2
    n_pages = 2 * n_tbl + sp + 1
    n_pages -= n_pages % sp
    table = _table(rng, contexts, page, n_tbl, n_pages, sp)
    (jk, tk), (jv, tv) = (_store(rng, int8, n_pages, hkv, page, d)
                          for _ in range(2))
    q = rng.standard_normal((b, hkv * n_rep, s, d)).astype(np.float32)
    pos = np.asarray([np.arange(c - s, c) for c in contexts], np.int32)
    jtbl, ttbl, jmap, tmap = jnp.asarray(table), torch.from_numpy(table), \
        None, None
    if sp > 1:
        # stripe 1's own pool slice, local table and pos_map
        per = n_pages // sp

        def local(j, t):
            if int8:
                return ({k: v[per:2 * per] for k, v in j.items()},
                        {k: v[per:2 * per] for k, v in t.items()})
            return j[per:2 * per], t[per:2 * per]

        (jk, tk), (jv, tv) = local(jk, tk), local(jv, tv)
        jtbl, jmap = jattn.striped_local_view(jtbl, sp, 1, per, page)
        ttbl, tmap = tattn.striped_local_view(ttbl, sp, 1, per, page)
    tq_, tpos = torch.from_numpy(q), torch.from_numpy(pos)
    walk = []
    got = tattn._paged_prefill_plain(tq_, tk, tv, ttbl, tpos, window,
                                     pos_map=tmap, return_stats=True,
                                     walk=walk)
    want = tattn._paged_plain(tq_, tk, tv, ttbl, tpos, window, pos_map=tmap,
                              return_stats=True)
    jwant = jattn.paged_decode_attention(
        jnp.asarray(q), jk, jv, jtbl, jnp.asarray(pos), window=window,
        pos_map=jmap, return_stats=True)
    for g, w, jw in zip(got, want, jwant):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=PLAIN_ATOL,
                                   rtol=PLAIN_ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(jw),
                                   atol=JAX_ATOL, rtol=JAX_ATOL)
    assert shows - {"empty"} <= _walk_shows(walk, s)
    assert walk and all(0 <= w["t_lo"] < w["t_hi"] for w in walk)
    # rows that keep no key (of the stripe): out 0, m NEG_INF, l 0
    out, m, l = got
    empty = l == 0
    assert (m[empty] == tattn.NEG_INF).all() and (out[empty] == 0).all()
    assert empty.any() == ("empty" in shows)


def test_prefill_walk_with_bf16_values_rounds_p():
    """On a bf16 pool the walk rounds p to bf16 before PV, as the kernel
    does: within bf16 noise of the one-pass plain version, which rounds
    p at the final max instead."""
    rng = np.random.default_rng(7)
    table = _table(rng, [200, 260], 8, 40, 90)
    k, v = (torch.from_numpy(rng.standard_normal((90, 2, 8, 64)).astype(
        np.float32)).bfloat16() for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((2, 8, 70, 64)).astype(
        np.float32)).bfloat16()
    pos = torch.from_numpy(np.asarray([np.arange(c - 70, c)
                                       for c in (200, 260)], np.int32))
    got = tattn._paged_prefill_plain(q, k, v, torch.from_numpy(table), pos,
                                     50)
    want = tattn._paged_plain(q, k, v, torch.from_numpy(table), pos, 50)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


#: (S, n_rep): the prefill window and its ragged neighbours, the ring's
#: 64-token chunk, a lone q head, two-token windows at 8 heads
SCHEDULES = [(2000, 4), (100, 4), (64, 4), (128, 8), (129, 1), (2, 8),
             (300, 8), (2048, 4), (1, 4)]


@pytest.mark.parametrize("s,n_rep", SCHEDULES)
def test_prefill_schedule_covers_every_tile_once(s, n_rep):
    """The kernel's block order for one (row, kv head): every 128-row
    tile of the packed row space exactly once, each in the band of its
    first row's position (the heaviest bands first), and at most one
    empty block a q head."""
    order = tattn.prefill_schedule(s, n_rep)
    t = tattn.PREFILL_TILE_ROWS
    starts = [r for r in order if r is not None]
    assert sorted(starts) == list(range(0, n_rep * s, t))
    assert len(order) - len(starts) <= n_rep
    for i, r0 in enumerate(order):
        if r0 is None:
            continue
        band, hh = divmod(i, n_rep)
        local = r0 - hh * s
        assert max(s - t * (band + 1), 0) <= local < s - t * band
