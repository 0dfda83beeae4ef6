"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``-m cuda``; these skip on a machine without a CUDA device):

    python -m pytest tests/test_torch_cuda.py -m cuda

bf16 inputs; the kernels and the plain versions both round P to bf16
before PV, so outputs differ by accumulation order and by where that
rounding happens (a running max in the kernel, the final max in the
plain version): out within 2e-2, lse within 1e-3 (K2's int8 entry point
likewise: on int8 stores both dequantize each element as bf16(f32(q) *
s) before the same softmax; K2's striped entry points likewise, their f32
softmax partials m within 1e-3 and l within 1e-3 relative).  The
backward kernels (K3 dK/dV, K4 dQ) round P and dS to bf16 before their second product as
the plain version does, but from an ``ex2.approx`` exponential, so a P
or dS element may land one bf16 step away; with the f32 sums in another
order and the bf16 output rounding, each gradient is held within 2e-2
of the plain version's largest magnitude.
"""

import pytest
import torch

from tpushare_torch.ops import attention as attn
from tpushare_torch.profile_k2 import DECODE_EDGES, PREFILL_EDGES

OUT_TOL = 2e-2
LSE_TOL = 1e-3
BWD_TOL = 2e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(g, *shape):
    return torch.randn(*shape, generator=g, device="cuda",
                       dtype=torch.bfloat16)


@pytest.mark.parametrize("s,d,h,hkv,causal,window",
                         [(1000, 128, 8, 2, True, 0),
                          (256, 128, 4, 4, True, 64),
                          (600, 64, 4, 2, True, 200),
                          (192, 64, 4, 1, False, 0),
                          (77, 64, 2, 2, True, 0)])
def test_flash_kernel_matches_plain(cuda, s, d, h, hkv, causal, window):
    _check_flash(cuda, 2, h, hkv, s, d, causal, window)


def _check_flash(g, b, h, hkv, s, d, causal, window):
    q, k, v = (_randn(g, b, h, s, d), _randn(g, b, hkv, s, d),
               _randn(g, b, hkv, s, d))
    before = attn.flash_attention_lse.launches
    out, lse = attn.flash_attention_lse(q, k, v, causal=causal,
                                        window=window)
    p_out, p_lse = attn._flash_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert attn.flash_attention_lse.launches == before + 1
    assert out.shape == q.shape and lse.shape == (b, h, s)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - p_out.float()).abs().max().item() <= OUT_TOL
    assert (lse - p_lse).abs().max().item() <= LSE_TOL


#: K1's tile edges: its blocks own 128 query rows and walk keys 128 at a
#: time, so S one short of, at and one past a multiple of 64 and 128, a
#: lone row, the ragged /score S and the main one; GQA ratios 1, 4 and 8
#: in turn
FLASH_EDGE_S = [1, 63, 64, 65, 127, 128, 129, 255, 1000, 2047, 2048]
FLASH_GQA = [(4, 4), (8, 2), (8, 1)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", FLASH_EDGE_S)
def test_flash_kernel_tile_edges(cuda, s, d, causal):
    h, hkv = FLASH_GQA[FLASH_EDGE_S.index(s) % len(FLASH_GQA)]
    _check_flash(cuda, 2, h, hkv, s, d, causal, 0)


#: windows one short of, at and one past a key tile, the smallest, and
#: two tiles; over S that end inside the first tile's reach, ragged, and
#: whole tiles
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [129, 1000, 2048])
@pytest.mark.parametrize("window", [1, 127, 128, 129, 256])
def test_flash_kernel_windows(cuda, window, s, d):
    _check_flash(cuda, 2, 8, 2, s, d, True, window)


def _paged_operands(g, contexts, s, d, hkv=2, h=8, page=16, n_tbl=64,
                    n_pages=200):
    kp, vp = (_randn(g, n_pages, hkv, page, d) for _ in range(2))
    q = _randn(g, len(contexts), h, s, d)
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda") + 1
    table = torch.zeros(len(contexts), n_tbl, dtype=torch.int32,
                        device="cuda")
    used = 0
    for i, c in enumerate(contexts):
        n = -(-c // page)
        table[i, :n] = perm[used:used + n].int()
        used += n
    pos = torch.stack([torch.arange(c - s, c, dtype=torch.int32,
                                    device="cuda") for c in contexts])
    return q, kp, vp, table, pos


#: the full Llama-3-8B layer: 32 heads over 8 kv heads, a table and pool
#: wide enough for two rows of ~2000 tokens
FULL = {"h": 32, "hkv": 8, "n_tbl": 128, "n_pages": 300}

#: (contexts, S, window, D, operand kwargs): decode rows and prefill
#: windows; then the prefill arm's edges: S = 2000 at full width, the
#: windowed ring's 64-token chunk at a context of ~2000 (alone and in a
#: window of 256), S not a multiple of 128 at n_rep 1 and 8, pages of 8,
#: 4 and 6 (the bf16 pool takes any page)
PAGED_CASES = [([5, 100, 700], 1, None, 128, {}),
               ([64, 300], 1, 50, 128, {}),
               ([160], 160, None, 128, {}),
               ([48, 130], 16, 40, 128, {}),
               ([700, 1000], 1, 300, 128, {}),
               ([37, 300, 1000], 1, None, 64, {}),
               ([300], 300, None, 64, {}),
               ([2000], 2000, None, 128, FULL),
               ([2000, 1990], 64, None, 128, FULL),
               ([1990], 64, 256, 128, FULL),
               ([300, 1000], 200, None, 128, {"h": 2, "hkv": 2}),
               ([777], 777, None, 64, {"h": 16, "hkv": 2}),
               ([513, 129], 129, 100, 128, {"page": 8, "n_tbl": 80}),
               ([260], 130, None, 64, {"page": 4, "n_tbl": 80}),
               ([150], 100, None, 128, {"page": 6, "n_tbl": 40})]


@pytest.mark.parametrize("contexts,s,window,d,kw", PAGED_CASES)
def test_paged_kernel_matches_plain(cuda, contexts, s, window, d, kw):
    q, kp, vp, table, pos = _paged_operands(cuda, contexts, s, d, **kw)
    out = attn.paged_decode_attention(q, kp, vp, table, pos, window=window)
    ref = attn._paged_plain(q, kp, vp, table, pos, window)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= OUT_TOL


#: the bf16 cases whose page is a multiple of 4, the CPU suite's S in
#: {1, 4} with and without a window of 16 (fully masked leading pages) at
#: both head dims
INT8_CASES = [c for c in PAGED_CASES if c[4].get("page", 16) % 4 == 0] + [
    ([9, 21], 1, None, 64, {}), ([9, 21], 4, None, 128, {}),
    ([40, 60], 4, 16, 64, {}), ([200], 1, 16, 128, {})]


@pytest.mark.parametrize("contexts,s,window,d,kw", INT8_CASES)
def test_paged_int8_kernel_matches_plain(cuda, contexts, s, window, d, kw):
    """K2's int8 entry point against the plain version on the same int8
    stores: every key and value bf16(f32(q) * s) in both."""
    from tpushare_torch.ops.quant import quantize_kv

    q, kp, vp, table, pos = _paged_operands(cuda, contexts, s, d, **kw)
    ks, vs = quantize_kv(kp), quantize_kv(vp)
    k2 = attn.paged_decode_attention
    # S = 1 goes to the decode arm, S > 1 to paged_attn.cu
    arm = "launches_decode" if s == 1 else "launches"
    before = (getattr(k2, arm), getattr(k2, arm + "_int8"))
    out = k2(q, ks, vs, table, pos, window=window)
    ref = attn._paged_plain(q, ks, vs, table, pos, window)
    torch.cuda.synchronize()
    assert (getattr(k2, arm), getattr(k2, arm + "_int8")) == \
        (before[0], before[1] + 1)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= OUT_TOL


def test_paged_int8_kernel_refuses_what_it_does_not_take(cuda):
    from tpushare_torch.ops.quant import quantize_kv

    q, kp, vp, table, pos = _paged_operands(cuda, [30], 1, 64, page=6,
                                            n_tbl=8, n_pages=20)
    ks, vs = quantize_kv(kp), quantize_kv(vp)
    with pytest.raises(ValueError, match="multiple of 4"):
        attn.paged_decode_attention(q, ks, vs, table, pos)
    q, kp, vp, table, pos = _paged_operands(cuda, [30], 1, 64)
    ks, vs = quantize_kv(kp), quantize_kv(vp)
    with pytest.raises(TypeError, match="float32"):
        attn.paged_decode_attention(q, ks, {"q": vs["q"],
                                            "s": vs["s"].bfloat16()},
                                    table, pos)
    with pytest.raises(TypeError, match="int8"):
        attn.paged_decode_attention(q, ks, {"q": vs["q"].float(),
                                            "s": vs["s"]}, table, pos)
    with pytest.raises(ValueError, match="contiguous"):
        attn.paged_decode_attention(
            q, ks, {"q": vs["q"].transpose(0, 1).contiguous()
                    .transpose(0, 1), "s": vs["s"]}, table, pos)
    with pytest.raises(ValueError, match="one kind"):
        attn.paged_decode_attention(q, ks, vp, table, pos)


def _striped_operands(g, contexts, s, d, sp, hkv=2, h=8, page=16, n_tbl=64,
                      per=100):
    """A pool of sp * per pages striped as the batcher lays it (range j of
    a row on stripe j % sp, each stripe's local page 0 its trash), q at
    the last ``s`` positions of each context, the global table, and the
    stripes (``shard_kv_storage``)."""
    from tpushare_torch.parallel.mesh import make_mesh, shard_kv_storage

    n_pages = sp * per
    kp, vp = (_randn(g, n_pages, hkv, page, d) for _ in range(2))
    q = _randn(g, len(contexts), h, s, d)
    free = [(torch.randperm(per - 1, generator=g, device="cuda") + 1
             + t * per).tolist() for t in range(sp)]
    table = torch.zeros(len(contexts), n_tbl, dtype=torch.int32,
                        device="cuda")
    for i, c in enumerate(contexts):
        for j in range(-(-c // page)):
            table[i, j] = free[j % sp].pop()
    pos = torch.stack([torch.arange(c - s, c, dtype=torch.int32,
                                    device="cuda") for c in contexts])
    mesh = make_mesh({"sp": sp}, devices=["cuda"] * sp)
    stripes = shard_kv_storage((kp[None], vp[None]), mesh)
    return q, kp, vp, table, pos, mesh, [(k[0], v[0]) for k, v in stripes]


#: (contexts, S, window, d, sp, operand kwargs): decode rows whose
#: context ends before stripe 1's first position (5) or inside its first
#: page (20), prefill windows whose leading rows see nothing of stripe 1,
#: windows that skip whole entries, both head dims, three stripes; then
#: the prefill arm's edges as in PAGED_CASES (pages a multiple of 4)
STRIPED_CASES = [([5, 100, 700], 1, None, 128, 2, {}),
                 ([20, 300], 1, 50, 128, 2, {}),
                 ([160], 160, None, 128, 2, {}),
                 ([48, 130], 16, 40, 64, 2, {}),
                 ([700, 1000], 1, 300, 128, 2, {}),
                 ([37, 300, 1000], 1, None, 64, 3, {}),
                 ([300], 300, 100, 128, 3, {}),
                 ([2000], 2000, None, 128, 2,
                  {"h": 32, "hkv": 8, "n_tbl": 128, "per": 150}),
                 ([2000, 1990], 64, None, 128, 2,
                  {"h": 32, "hkv": 8, "n_tbl": 128, "per": 150}),
                 ([1000], 200, 256, 128, 2, {"h": 2, "hkv": 2}),
                 ([777], 777, None, 64, 2, {"h": 16, "hkv": 2}),
                 ([513, 129], 129, 100, 128, 2, {"page": 8, "n_tbl": 80}),
                 ([260], 130, None, 64, 2, {"page": 4, "n_tbl": 80})]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("contexts,s,window,d,sp,kw", STRIPED_CASES)
def test_paged_striped_kernels_match_plain(cuda, contexts, s, window, d, sp,
                                           kw, int8):
    """K2's striped entry points (``tpushare_paged_attn_striped``,
    ``tpushare_paged_attn_int8_striped``) on each stripe against the plain
    version on the same local table and pos_map: out within 2e-2, m
    within 1e-3, l within 1e-3 relative (rows that see nothing of a
    stripe: out 0, m NEG_INF and l 0 exactly); the merged stripes within
    2e-2 of the unstriped kernel over the same keys."""
    from tpushare_torch.ops.quant import quantize_kv

    q, kp, vp, table, pos, mesh, stripes = _striped_operands(
        cuda, contexts, s, d, sp, **kw)
    if int8:
        kp, vp = quantize_kv(kp), quantize_kv(vp)
        stripes = [(quantize_kv(k), quantize_kv(v)) for k, v in stripes]
    k2 = attn.paged_decode_attention
    counter = ("launches_decode" if s == 1 else "launches") + \
        ("_int8_striped" if int8 else "_striped")
    per = attn._store_values(stripes[0][0]).shape[0]
    outs, ms, ls = [], [], []
    for t, (ks, vs) in enumerate(stripes):
        tbl, pmap = attn.striped_local_view(table, sp, t, per,
                                            kw.get("page", 16))
        before = getattr(k2, counter)
        o, m, l = k2(q, ks, vs, tbl, pos, window=window, pos_map=pmap,
                     return_stats=True)
        po, pm, pl = attn._paged_plain(q, ks, vs, tbl, pos, window,
                                       pos_map=pmap, return_stats=True)
        torch.cuda.synchronize()
        assert getattr(k2, counter) == before + 1
        assert (o.float() - po.float()).abs().max().item() <= OUT_TOL
        assert (m - pm).abs().max().item() <= LSE_TOL
        assert ((l - pl).abs() / pl.clamp_min(1e-30)).max().item() <= LSE_TOL
        empty = pl == 0
        assert torch.equal(l[empty], pl[empty])
        assert (m[empty] == attn.NEG_INF).all()
        assert (o[empty] == 0).all()
        outs.append(o)
        ms.append(m)
        ls.append(l)
    merged = attn.sp_merge_partials(outs, ms, ls, q.device)
    whole = k2(q, kp, vp, table, pos, window=window)
    torch.cuda.synchronize()
    assert (merged.float() - whole.float()).abs().max().item() <= OUT_TOL
    # the wrapper over every stripe is the same fold
    got = attn.sp_striped_paged_decode_attention(
        q, [k for k, _ in stripes], [v for _, v in stripes], table, pos,
        mesh, window=window)
    assert torch.equal(got, merged)


def _check_entry_points(g, contexts, s, window, n_rep, d, page, n_tbl,
                        int8, arm):
    """K2's unstriped entry point of one store and arm against the plain
    version (out within 2e-2), then its striped one on each of 2 stripes
    (out within 2e-2, m within 1e-3, l within 1e-3 relative; a row that
    keeps no key of a stripe out 0, m NEG_INF and l 0 exactly); every
    call one launch of its entry point of ``arm`` (``"_decode"`` or
    ``""``, the prefill arm)."""
    from tpushare_torch.ops.quant import quantize_kv

    q, kp, vp, table, pos, mesh, stripes = _striped_operands(
        g, contexts, s, d, 2, h=2 * n_rep, page=page, n_tbl=n_tbl, per=300)
    if int8:
        kp, vp = quantize_kv(kp), quantize_kv(vp)
        stripes = [(quantize_kv(k), quantize_kv(v)) for k, v in stripes]
    k2 = attn.paged_decode_attention
    counter = f"launches{arm}" + ("_int8" if int8 else "")
    before = getattr(k2, counter)
    out = k2(q, kp, vp, table, pos, window=window)
    ref = attn._paged_plain(q, kp, vp, table, pos, window)
    torch.cuda.synchronize()
    assert getattr(k2, counter) == before + 1
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= OUT_TOL
    for t, (ks, vs) in enumerate(stripes):
        tbl, pmap = attn.striped_local_view(table, 2, t, 300, page)
        before = getattr(k2, counter + "_striped")
        o, m, l = k2(q, ks, vs, tbl, pos, window=window, pos_map=pmap,
                     return_stats=True)
        po, pm, pl = attn._paged_plain(q, ks, vs, tbl, pos, window,
                                       pos_map=pmap, return_stats=True)
        torch.cuda.synchronize()
        assert getattr(k2, counter + "_striped") == before + 1
        assert (o.float() - po.float()).abs().max().item() <= OUT_TOL
        assert (m - pm).abs().max().item() <= LSE_TOL
        assert ((l - pl).abs() / pl.clamp_min(1e-30)).max().item() <= LSE_TOL
        empty = pl == 0
        assert torch.equal(l[empty], pl[empty])
        assert (m[empty] == attn.NEG_INF).all()
        assert (o[empty] == 0).all()


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("contexts,window,n_rep,d", DECODE_EDGES)
def test_paged_decode_kernels_match_plain(cuda, contexts, window, n_rep, d,
                                          int8):
    """K2's four decode entry points (``csrc/paged_decode.cu``, S = 1)
    against the plain version on the decode arm's edges, pages of 16 and
    tables of 160 entries (``_check_entry_points``)."""
    _check_entry_points(cuda, contexts, 1, window, n_rep, d, 16, 160, int8,
                        "_decode")


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("contexts,s,window,n_rep,d,page,n_tbl",
                         PREFILL_EDGES)
def test_paged_prefill_kernels_match_plain(cuda, contexts, s, window, n_rep,
                                           d, page, n_tbl, int8):
    """K2's four prefill entry points (``csrc/paged_attn.cu``, S > 1) on
    the prefill arm's edges, as ``chip_smoke.py`` runs them, a table of
    20,000 entries among them (``_check_entry_points``).  The int8 store
    takes pages of a multiple of 4 only: at a page of 6 its entry point
    raises."""
    from tpushare_torch.ops.quant import quantize_kv

    if int8 and page % 4:
        q, kp, vp, table, pos = _paged_operands(
            cuda, contexts, s, d, hkv=2, h=2 * n_rep, page=page, n_tbl=n_tbl)
        with pytest.raises(ValueError, match="multiple of 4"):
            attn.paged_decode_attention(q, quantize_kv(kp), quantize_kv(vp),
                                        table, pos, window=window)
        return
    _check_entry_points(cuda, contexts, s, window, n_rep, d, page, n_tbl,
                        int8, "")



def test_k2_arms_by_kernel_name(cuda):
    """By the profiler's kernel names: S = 1 launches the decode kernel
    (its splits folded in its own tail: one kernel a call) and never the
    prefill arm's; S > 1 launches the prefill arm's Hopper kernel
    (``paged_prefill_kernel`` of ``csrc/paged_attn.cu``), one a call."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(s):
        q, kp, vp, table, pos = _paged_operands(cuda, [300, 700], s, 128)
        attn.paged_decode_attention(q, kp, vp, table, pos)
        torch.cuda.synchronize()
        # three calls a window: the profiler can lose a window's first
        # kernel (utils/cuda_timing.py)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                attn.paged_decode_attention(q, kp, vp, table, pos)
            torch.cuda.synchronize()
        return [e.key for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "paged" in e.key]

    decode, prefill = kernels(1), kernels(16)
    assert len(decode) == 1 and "paged_decode_kernel" in decode[0]
    assert len(prefill) == 1 and "paged_prefill_kernel" in prefill[0]


def test_paged_decode_on_two_streams(cuda):
    """Decode launches queued on two streams of one card at once: each
    stream has its own per-(row, kv head) ticket counters, and every call
    on either stream is within 2e-2 of the plain version (counters shared
    across streams would skip or repeat a row's fold)."""
    cases = [_paged_operands(cuda, [300, 700, 2000, 17], 1, 128, n_tbl=160)
             for _ in range(2)]
    refs = [attn._paged_plain(*c, None) for c in cases]
    streams = [torch.cuda.Stream() for _ in cases]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, (st, c) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(st):
                outs[i].append(attn.paged_decode_attention(*c))
    torch.cuda.synchronize()
    keys = {(q.device, st.cuda_stream) for st, (q, *_) in zip(streams, cases)}
    assert len(keys) == 2 and keys <= set(attn._tickets)
    assert len({attn._tickets[k].data_ptr() for k in keys}) == 2
    for ref, got in zip(refs, outs):
        for o in got:
            assert (o.float() - ref.float()).abs().max().item() <= OUT_TOL


def test_paged_striped_kernel_refuses_what_it_does_not_take(cuda):
    q, kp, vp, table, pos, _, stripes = _striped_operands(cuda, [30], 1, 64,
                                                          2)
    tbl, pmap = attn.striped_local_view(table, 2, 0, 100, 16)
    with pytest.raises(TypeError, match="pos_map"):
        attn.paged_decode_attention(q, *stripes[0], tbl, pos,
                                    pos_map=pmap.long(), return_stats=True)
    with pytest.raises(ValueError, match="one device"):
        attn.paged_decode_attention(q, *stripes[0], tbl, pos,
                                    pos_map=pmap.cpu(), return_stats=True)
    with pytest.raises(ValueError, match="pos_map"):
        attn.paged_decode_attention(q, *stripes[0], tbl, pos,
                                    pos_map=pmap[:-1], return_stats=True)


def _bwd_operands(g, b, h, hkv, s, d, causal, window, g_lse):
    q, k, v = _randn(g, b, h, s, d), _randn(g, b, hkv, s, d), \
        _randn(g, b, hkv, s, d)
    do = _randn(g, b, h, s, d)
    out, lse = attn._flash_plain(q, k, v, causal, window)
    dvec = (do.float() * out.float()).sum(-1)
    if g_lse:
        dvec = dvec - torch.randn(b, h, s, generator=g, device="cuda")
    return q, k, v, do, lse.contiguous(), dvec.contiguous()


def _rel_err(a, ref):
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


#: K3 and K4: a few mixed cases; then the tile edges (K3's blocks own 64
#: keys and walk q tiles of 64, K4's own 128 queries and walk key tiles of
#: 64), K1's edge S causal or not, both head dims, GQA ratios 1, 4 and 8 in
#: turn, the lse cotangent at D = 64; windows around a tile; n_rep 1, 4
#: and 8 with and without the lse cotangent.  Where each query sees one
#: key (S = 1, window 1), P = 1 and dS = dO v - dO o = 0 up to rounding:
#: dQ and dK are rounding noise, so those cases carry the lse cotangent,
#: which gives them a gradient to hold.
BWD_CASES = [(1000, 128, 8, 2, True, 0, False),
             (256, 128, 4, 4, True, 64, True),
             (600, 64, 4, 2, True, 200, False),
             (192, 64, 4, 1, False, 0, True),
             (77, 64, 2, 2, True, 0, False),
             (320, 128, 8, 8, False, 0, False)] + [
    (s, d, *FLASH_GQA[FLASH_EDGE_S.index(s) % len(FLASH_GQA)], causal, 0,
     d == 64 or s == 1)
    for s in FLASH_EDGE_S for d in (64, 128) for causal in (True, False)] + [
    (s, d, 8, 2, True, w, w == 1) for w in (1, 127, 128, 129, 256)
    for s in (129, 1000, 2048) for d in (64, 128)] + [
    (1000, 128, 8, hkv, True, 0, g_lse) for hkv in (8, 2, 1)
    for g_lse in (False, True)]


@pytest.mark.parametrize("s,d,h,hkv,causal,window,g_lse", BWD_CASES)
def test_flash_bwd_kernels_match_plain(cuda, s, d, h, hkv, causal, window,
                                       g_lse):
    args = _bwd_operands(cuda, 2, h, hkv, s, d, causal, window, g_lse)
    n3, n4 = attn.flash_bwd_dkv.launches, attn.flash_bwd_dq.launches
    dk, dv = attn.flash_bwd_dkv(*args, causal=causal, window=window)
    dq = attn.flash_bwd_dq(*args, causal=causal, window=window)
    p_dq, p_dk, p_dv = attn._flash_bwd_plain(*args, causal, window)
    torch.cuda.synchronize()
    assert (attn.flash_bwd_dkv.launches, attn.flash_bwd_dq.launches) == \
        (n3 + 1, n4 + 1)
    for got, ref in ((dq, p_dq), (dk, p_dk), (dv, p_dv)):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all()
        assert _rel_err(got, ref) <= BWD_TOL


def test_flash_autograd_runs_k1_k3_k4(cuda):
    """flash_attention_lse's backward is K3 + K4 (one launch each), with
    dvec = rowsum(dO * O) - g_lse formed from the f32 cotangents."""
    q, k, v = (_randn(cuda, 1, 8, 300, 128).requires_grad_(),
               _randn(cuda, 1, 2, 300, 128).requires_grad_(),
               _randn(cuda, 1, 2, 300, 128).requires_grad_())
    g_out = _randn(cuda, 1, 8, 300, 128)
    g_lse = torch.randn(1, 8, 300, generator=cuda, device="cuda")
    counts = (attn.flash_attention_lse.launches, attn.flash_bwd_dkv.launches,
              attn.flash_bwd_dq.launches)
    out, lse = attn.flash_attention_lse(q, k, v)
    grads = torch.autograd.grad((out, lse), (q, k, v), (g_out, g_lse))
    torch.cuda.synchronize()
    assert (attn.flash_attention_lse.launches, attn.flash_bwd_dkv.launches,
            attn.flash_bwd_dq.launches) == tuple(c + 1 for c in counts)
    dvec = (g_out.float() * out.detach().float()).sum(-1) - g_lse
    ref = attn._flash_bwd_plain(q.detach(), k.detach(), v.detach(), g_out,
                                lse.detach(), dvec, True, 0)
    for got, want in zip(grads, ref):
        assert _rel_err(got, want) <= BWD_TOL


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = _randn(cuda, 1, 2, 16, 32)                 # head dim 32
    with pytest.raises(ValueError, match="head dim"):
        attn.flash_attention_lse(q, q, q)
    with pytest.raises(TypeError, match="bfloat16"):
        attn.flash_attention_lse(q.float(), q.float(), q.float())
    lse = torch.zeros(1, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        attn.flash_bwd_dkv(q, q, q, q, lse, lse)
    q = _randn(cuda, 1, 2, 16, 64)
    with pytest.raises(TypeError, match="float32"):
        attn.flash_bwd_dq(q, q, q, q, lse.bfloat16(), lse)
