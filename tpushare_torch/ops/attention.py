"""Attention for the port: the reference paths, and the four kernels.

Counterpart of ``tpushare/ops/attention.py``.  Hand-written CUDA kernels
replace the Pallas ones:

* K1, the flash forward (``csrc/flash_fwd.cu``): the no-cache forward's
  causal attention, what ``/score`` and the training forward run;
* K2, :func:`paged_decode_attention`: the read of the paged KV pool, a
  bf16 pool or an int8 ``{"q","s"}`` store (its own entry points,
  dequantizing as they read), what every paged prefill and decode step
  runs; and its striped variant (``pos_map`` + ``return_stats``, an
  entry point a store), which :func:`sp_striped_paged_decode_attention`
  runs once per position stripe before :func:`sp_merge_partials` folds
  the stripes' softmax partials.  Two arms: ``csrc/paged_attn.cu`` for
  S > 1 (prefill windows, chunks), warp-specialised on wgmma over 128-row
  tiles of the packed GQA rows (plain version of its walk
  :func:`_paged_prefill_plain`, block order :func:`prefill_schedule`),
  and ``csrc/paged_decode.cu`` for S = 1, the table cut into splits
  (:func:`decode_splits`) whose partials the kernel's last block folds
  (plain versions :func:`_paged_split_plain` and
  :func:`_paged_combine_plain`);
* K3 and K4, :func:`flash_bwd_dkv` and :func:`flash_bwd_dq`
  (``csrc/flash_bwd.cu``): the flash backward, dK/dV and dQ.

:func:`flash_attention_lse` is one ``torch.autograd.Function``: K1 forward
(saving q, k, v, out, lse), K3 + K4 backward — the counterpart of the JAX
module's two ``custom_vjp``s.  K1 is registered as the custom operator
``tpushare_torch::flash_fwd``, so a selective-checkpoint policy can name
its outputs (``parallel.train.ATTN_SAVING_POLICY``).

Each wrapper launches its kernel for a CUDA tensor and raises on what the
kernel does not take; it takes its plain PyTorch version (``_flash_plain``,
``_paged_plain``, ``_flash_bwd_plain``, the same arithmetic written out
densely) only for a tensor that lies on the CPU.  Nothing falls back.
Each kernel's wrapper counts its launches in an integer ``launches``
attribute (K1's on :func:`flash_attention_lse`).

The TPU-only gates of the JAX module (``s % 128``, ``_fit_block``, the
128-lane head-dim padding, ``PAGED_KERNEL_MAX_ROWS``) do not apply here.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch

from . import _cuda

#: the finite masking sentinel every mask in the port relies on
NEG_INF = -1e30

#: head dims the kernels are compiled for
KERNEL_HEAD_DIMS = (64, 128)

_count_lock = threading.Lock()


def _count(fn, attr: str = "launches") -> None:
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)


def expand_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, Hkv, T, D] -> [B, Hkv * n_rep, T, D]: each kv head repeated
    for its n_rep q-heads (GQA), for the plain paths."""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=1)


def paged_gather(pool, page_table):
    """pool [n_pages, Hkv, P, D] + table [B, pages] -> [B, Hkv, pages*P, D]:
    the dense per-layer view of a paged pool in logical key order (the
    JAX package's ``transformer._paged_gather``)."""
    g = pool[page_table.long()]                    # [B, pages, Hkv, P, D]
    b, npg, hkv, p, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, npg * p, d)


def reference_attention(q, k, v, causal: bool = True,
                        scale: Optional[float] = None,
                        window: Optional[int] = None):
    """Plain softmax attention; q [B, H, S, D], k/v [B, Hkv, T, D] (GQA
    expanded here).  ``window`` limits each query to its last ``window``
    keys."""
    return reference_attention_lse(q, k, v, causal=causal, scale=scale,
                                   window=window)[0]


def reference_attention_lse(q, k, v, causal: bool = True,
                            scale: Optional[float] = None,
                            window: Optional[int] = None):
    """Reference attention that also returns the per-row logsumexp of the
    scaled scores [B, H, S].  Cross-length blocks (T != S) use global
    positions: query i sees key j iff j <= i + (T - S) (and, with a
    window, j > i + (T - S) - window).  Logits are computed in the input
    dtype, as in the JAX reference; the softmax in f32."""
    n_rep = q.shape[1] // k.shape[1]
    k, v = expand_kv(k, n_rep), expand_kv(v, n_rep)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
    if causal:
        s, t = q.shape[2], k.shape[2]
        ones = torch.ones((s, t), dtype=torch.bool, device=q.device)
        mask = torch.tril(ones, diagonal=t - s)
        if window is not None:
            mask &= ~torch.tril(ones, diagonal=t - s - window)
        logits = logits.masked_fill(~mask, NEG_INF)
    elif window is not None:
        raise ValueError("window requires causal attention")
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    probs = torch.exp(lf - lse[..., None])
    out = torch.einsum("bhst,bhtd->bhsd", probs.to(v.dtype), v)
    return out, lse


# ---------------------------------------------------------------------------
# K1: flash attention forward
# ---------------------------------------------------------------------------
def _flash_plain(q, k, v, causal: bool, window: int):
    """K1's function written out densely: f32 scaled scores, finite-
    NEG_INF mask, probabilities rounded to v's dtype before PV with f32
    accumulation, l clamped to 1e-30, lse = m + log(l)."""
    b, h, s, d = q.shape
    n_rep = h // k.shape[1]
    kf = expand_kv(k, n_rep).float()
    vv = expand_kv(v, n_rep)
    sc = torch.einsum("bhsd,bhtd->bhst", q.float(),
                      kf) * (1.0 / math.sqrt(d))
    if causal:
        i = torch.arange(s, device=q.device)
        keep = i[None, :] <= i[:, None]
        if window:
            keep &= i[None, :] > i[:, None] - window
        sc = sc.masked_fill(~keep, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    if causal:
        p = p * keep
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhst,bhtd->bhsd", p.to(vv.dtype).float(), vv.float())
    return (out / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _check_kernel_operand(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_on_cuda(*xs) -> None:
    for x in xs:
        if x.device.type != "cuda":
            raise ValueError(f"operands must all lie on one device: got "
                             f"{[str(y.device) for y in xs]}")


def _check_qkv(q, k, v) -> None:
    b, h, s, d = q.shape
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"GQA needs n_heads % n_kv_heads == 0, got "
                         f"{h} % {k.shape[1]}")
    if k.shape != (b, k.shape[1], s, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, Hkv, S, D] with q's B, S, D; "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")


def _check_kernel_inputs(kernel: str, *named) -> None:
    """What the CUDA attention kernels take: bf16 (f32 for the row
    statistics), contiguous, 16-byte aligned, on the card, head dim 64 or
    128."""
    _check_on_cuda(*(x for _, x in named))
    for name, x in named:
        if name in ("lse", "dvec"):
            if x.dtype != torch.float32 or not x.is_contiguous():
                raise TypeError(f"{name} must be a contiguous float32 "
                                f"tensor")
        else:
            _check_kernel_operand(name, x)
    d = named[0][1].shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel head dim must be one of "
                         f"{KERNEL_HEAD_DIMS}, got {d}")


@torch.library.custom_op("tpushare_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as a dispatched operator (what a selective-checkpoint policy
    sees): ``csrc/flash_fwd.cu`` for CUDA tensors, :func:`_flash_plain`
    for CPU ones.  The caller has checked the operands."""
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, causal, window)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _cuda.call("flash_fwd", "tpushare_flash_fwd", q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
               b, h, k.shape[1], s, d, int(causal), window,
               1.0 / math.sqrt(d))
    _count(flash_attention_lse)
    return out, lse


#: the registered K1 operator, as selective-checkpoint policies name it
FLASH_FWD_OP = torch.ops.tpushare_torch.flash_fwd.default


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K3 + K4 backward: the counterpart of the JAX module's
    ``_flash_core_lse`` custom VJP.  The lse output's cotangent folds into
    the same kernels as dvec = rowsum(dO * O) - g_lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = torch.ops.tpushare_torch.flash_fwd(q, k, v, causal,
                                                      window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        # D_i in f32 from the cotangent as it arrives, before dO is cast
        # to q's dtype for the kernels
        dvec = (g_out.float() * out.float()).sum(-1)
        if g_lse is not None:
            dvec = dvec - g_lse.float()
        args = (q, k, v, g_out.to(q.dtype).contiguous(), lse,
                dvec.contiguous(), ctx.causal, ctx.window)
        if q.device.type == "cpu":
            dq, dk, dv = _flash_bwd_plain(*args)
        else:
            dk, dv = flash_bwd_dkv(*args)
            dq = flash_bwd_dq(*args)
        return dq, dk, dv, None, None


def flash_attention_lse(q, k, v, causal: bool = True,
                        window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable flash attention: (out [B, H, S, D], lse [B, H, S]
    f32 of the scaled scores) for q [B, H, S, D] and k/v [B, Hkv, S, D]
    with H % Hkv == 0.  ``window`` > 0 (causal only) keeps each query's
    last ``window`` keys.

    CUDA tensors launch K1 (``csrc/flash_fwd.cu``) forward and K3 + K4
    (``csrc/flash_bwd.cu``) backward (bf16, contiguous, head dim 64 or
    128, else raises); CPU tensors take :func:`_flash_plain` and
    :func:`_flash_bwd_plain`.  ``flash_attention_lse.launches`` counts K1
    launches."""
    if window and not causal:
        raise ValueError("window requires causal attention")
    _check_qkv(q, k, v)
    if q.device.type != "cpu":
        _check_kernel_inputs("flash", ("q", q), ("k", k), ("v", v))
    return _FlashAttention.apply(q, k, v, bool(causal), int(window or 0))


flash_attention_lse.launches = 0


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """:func:`flash_attention_lse` without the lse."""
    return flash_attention_lse(q, k, v, causal=causal, window=window)[0]


# ---------------------------------------------------------------------------
# K3 + K4: flash attention backward
# ---------------------------------------------------------------------------
def _flash_bwd_plain(q, k, v, do, lse, dvec, causal: bool, window: int):
    """K3 + K4's function written out densely: (dq, dk, dv) in the input
    dtypes.  P = exp(S - lse) of the f32 scaled scores (NEG_INF-masked),
    dV = bf16(P)^T dO, dS = P (dO V^T - dvec) rounded to the input dtype,
    dK = dS^T q * scale, dQ = dS K * scale, all sums f32, the GQA group
    summed per kv head (the JAX ``_flash_bwd_pallas``)."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    n_rep = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    kf = expand_kv(k, n_rep).float()
    vf = expand_kv(v, n_rep).float()
    sc = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    if causal:
        i = torch.arange(s, device=q.device)
        keep = i[None, :] <= i[:, None]
        if window:
            keep &= i[None, :] > i[:, None] - window
        sc = sc.masked_fill(~keep, NEG_INF)
    p = torch.exp(sc - lse.float()[..., None])
    dv = torch.einsum("bhst,bhsd->bhtd", p.to(v.dtype).float(), dof)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vf)
    ds = (p * (dp - dvec.float()[..., None])).to(q.dtype).float()
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    if n_rep > 1:
        dk = dk.reshape(b, hkv, n_rep, s, d).sum(2)
        dv = dv.reshape(b, hkv, n_rep, s, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q, k, v, do, lse, dvec) -> None:
    _check_qkv(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"do must have q's shape {tuple(q.shape)}, got "
                         f"{tuple(do.shape)}")
    for name, x in (("lse", lse), ("dvec", dvec)):
        if x.shape != q.shape[:3]:
            raise ValueError(f"{name} must be [B, H, S] = "
                             f"{tuple(q.shape[:3])}, got {tuple(x.shape)}")


def flash_bwd_dkv(q, k, v, do, lse, dvec, causal: bool = True,
                  window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's wrapper: (dk, dv) [B, Hkv, S, D] in k/v's dtype, each the sum
    over the kv head's n_rep q heads, from q, do [B, H, S, D], k, v, the
    forward's lse and dvec = rowsum(dO * O) - g_lse ([B, H, S] f32).

    CUDA tensors launch ``tpushare_flash_bwd_dkv`` of
    ``csrc/flash_bwd.cu`` (the checks of K1, else raises); CPU tensors
    take :func:`_flash_bwd_plain`."""
    _check_bwd(q, k, v, do, lse, dvec)
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, do, lse, dvec, causal, window)[1:]
    _check_kernel_inputs("flash backward", ("q", q), ("k", k), ("v", v),
                         ("do", do), ("lse", lse), ("dvec", dvec))
    b, h, s, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _cuda.call("flash_bwd", "tpushare_flash_bwd_dkv", q.data_ptr(),
               k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
               dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
               k.shape[1], s, d, int(causal), int(window),
               1.0 / math.sqrt(d))
    _count(flash_bwd_dkv)
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q, k, v, do, lse, dvec, causal: bool = True,
                 window: int = 0) -> torch.Tensor:
    """K4's wrapper: dq [B, H, S, D] in q's dtype (operands as for
    :func:`flash_bwd_dkv`).  CUDA tensors launch ``tpushare_flash_bwd_dq``
    of ``csrc/flash_bwd.cu``; CPU tensors take :func:`_flash_bwd_plain`."""
    _check_bwd(q, k, v, do, lse, dvec)
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, do, lse, dvec, causal, window)[0]
    _check_kernel_inputs("flash backward", ("q", q), ("k", k), ("v", v),
                         ("do", do), ("lse", lse), ("dvec", dvec))
    b, h, s, d = q.shape
    dq = torch.empty_like(q)
    _cuda.call("flash_bwd", "tpushare_flash_bwd_dq", q.data_ptr(),
               k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
               dvec.data_ptr(), dq.data_ptr(), b, h, k.shape[1], s, d,
               int(causal), int(window), 1.0 / math.sqrt(d))
    _count(flash_bwd_dq)
    return dq


flash_bwd_dq.launches = 0


def use_flash(q, k) -> bool:
    """The flash dispatch gate: a CUDA tensor, equal q/k lengths (K1
    masks in one coordinate system), and GQA divisibility."""
    return (q.device.type == "cuda" and k.shape[2] == q.shape[2]
            and q.shape[1] % k.shape[1] == 0)


def attention(q, k, v, causal: bool = True, window: Optional[int] = None):
    """Dispatch: K1 where :func:`use_flash` allows, the reference
    otherwise (the CPU, cross-length blocks)."""
    if use_flash(q, k):
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal,
                               window=int(window or 0))
    return reference_attention(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# K2: paged-pool attention read
# ---------------------------------------------------------------------------
def _store_values(store) -> torch.Tensor:
    """The values leaf of a pool store (a tensor, or int8 {"q","s"})."""
    return store["q"] if isinstance(store, dict) else store


def _gather_store(store, page_table, dtype) -> torch.Tensor:
    """A pool store through the table into the dense [B, Hkv, pages*P, D]
    view: a bf16 pool as it is, an int8 store dequantized to ``dtype``
    (each element ``dtype(f32(q) * s)``, the scales gathered beside their
    values)."""
    if not isinstance(store, dict):
        return paged_gather(store, page_table)
    return (paged_gather(store["q"], page_table).float()
            * paged_gather(store["s"], page_table)).to(dtype)


def _paged_scores(q, k_store, v_store, page_table, positions,
                  window: Optional[int], pos_map=None):
    """The dense operands of K2's plain versions: the f32 scaled scores
    [B, H, S, T] with masked entries NEG_INF, the keep mask [B, 1, S, T]
    and the values [B, H, T, D] (T = n_tbl * page keys in table order,
    an int8 store dequantized to q's dtype).  A key's position is
    ``pos_map[jj] + lane`` for table entry jj (default ``jj * page``);
    the mask keeps key <= position (and > position - window)."""
    d = q.shape[-1]
    page = _store_values(k_store).shape[2]
    n_rep = q.shape[1] // _store_values(k_store).shape[1]
    n_tbl = page_table.shape[1]
    kk = expand_kv(_gather_store(k_store, page_table, q.dtype), n_rep)
    vv = expand_kv(_gather_store(v_store, page_table, q.dtype), n_rep)
    sc = torch.einsum("bhsd,bhtd->bhst", q.float(),
                      kk.float()) * (1.0 / math.sqrt(d))
    lane = torch.arange(page, device=q.device)
    base = (pos_map.long() if pos_map is not None
            else torch.arange(n_tbl, device=q.device) * page)
    k_pos = (base[:, None] + lane).reshape(-1)[None, None, None, :]
    q_pos = positions.long()[:, None, :, None]
    keep = k_pos <= q_pos
    if window:
        keep &= k_pos > q_pos - window
    return sc.masked_fill(~keep, NEG_INF), keep, vv


def _softmax_partials(sc, keep, vv):
    """(o, m, l) of one run of keys: m the max of the masked scores
    (NEG_INF for a row that keeps none), p = exp(sc - m) times the keep
    mask, l = sum p unclamped, o = bf16(p) V / max(l, 1e-30) in f32 (p
    rounded to the values' dtype, the sums f32)."""
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m) * keep
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhst,bhtd->bhsd", p.to(vv.dtype).float(), vv.float())
    return o / l.clamp_min(1e-30), m[..., 0], l[..., 0]


def _paged_plain(q, k_store, v_store, page_table, positions,
                 window: Optional[int], pos_map=None,
                 return_stats: bool = False):
    """K2's function written out densely (:func:`_paged_scores`, then one
    softmax over every key): the output in q's dtype.  ``return_stats``
    also returns m, the max of the masked scaled scores (NEG_INF for a
    row that keeps no key), and l, the sum of p unclamped ([B, H, S]
    f32 each): the partials :func:`sp_merge_partials` folds."""
    out, m, l = _softmax_partials(*_paged_scores(
        q, k_store, v_store, page_table, positions, window, pos_map))
    out = out.to(q.dtype)
    if return_stats:
        return out, m, l
    return out


#: K2's prefill arm (S > 1, ``csrc/paged_attn.cu``): the packed GQA rows
#: of one (row, kv head) a block owns, the rows of each of its two
#: consumer warpgroups, and the keys of a tile
PREFILL_TILE_ROWS = 128
PREFILL_CONSUMER_ROWS = 64
PREFILL_TILE_KEYS = 128
_INT_MAX = 2 ** 31 - 1


def prefill_schedule(s: int, n_rep: int):
    """The prefill kernel's block order within one (row, kv head): for
    band k = 0, 1, ... (each q head's last 128 positions first, the
    heaviest causal rows) and q head hh, the packed row where that
    block's 128-row tile starts, or None where the band holds no tile
    start (the block returns at once).  Band k of head hh is packed rows
    ``[hh*s + max(s - 128(k+1), 0), hh*s + s - 128k)``."""
    t = PREFILL_TILE_ROWS
    out = []
    for k in range(-(-s // t)):
        for hh in range(n_rep):
            lo, hi = hh * s + max(s - t * (k + 1), 0), hh * s + s - t * k
            r0 = -(-lo // t) * t
            out.append(r0 if r0 < hi else None)
    return out


def _prefill_key_range(pos, window: int, page: int, n_tbl: int,
                       pos_map=None) -> Tuple[int, int]:
    """``[begin, end)`` in walk index (table entry * page + lane) of the
    keys that a consumer's rows, at positions ``pos``, can keep: up to the
    last entry starting at or before the last position, from the first
    entry the window reaches.  (0, 0) when there is no row or no key."""
    if pos.numel() == 0:
        return 0, 0
    lo, hi = int(pos.min()), int(pos.max())
    if pos_map is None:
        end = min(hi + 1, n_tbl * page)
        begin = max(lo - window + 1, 0) if window else 0
    else:
        pm = pos_map.long()
        end = int((pm <= hi).sum()) * page
        begin = int((pm + page - 1 <= lo - window).sum()) * page \
            if window else 0
    return (begin, end) if begin < end else (0, 0)


def _paged_prefill_plain(q, k_store, v_store, page_table, positions,
                         window: Optional[int], pos_map=None,
                         return_stats: bool = False, walk=None):
    """K2's prefill arm's walk written out (the decomposition of
    ``csrc/paged_attn.cu``'s Hopper body; nothing on the main path calls
    it).  For each (row, kv head), the packed GQA rows (row r of kv head
    kh is head kh * n_rep + r // S at position r % S) in tiles of 128,
    each tile two consumers of 64 rows.  A consumer's key range comes
    from its rows' positions and the window (:func:`_prefill_key_range`);
    the tile's walk starts at the 128-key tile holding its consumers'
    first key and ends after their last.  A consumer folds the 128-key
    tiles of its own range into an online softmax (f32 m, l, acc; p
    rounded to the values' dtype before PV): unmasked where every one of
    its rows keeps every key of the tile, masked otherwise; keys past the
    block's range read as zeros at position INT_MAX.  A consumer with no
    key writes out 0, m NEG_INF, l 0.  Returns as :func:`_paged_plain`.
    ``walk``, a list, receives one dict a consumer: its rows, tiles
    walked (``t_lo``, ``t_hi`` from the block's first tile ``kb``) and
    how many it folded whole and masked."""
    b, h, s, d = q.shape
    kq = _store_values(k_store)
    hkv, page = kq.shape[1], kq.shape[2]
    n_rep, n_tbl = h // hkv, page_table.shape[1]
    rows, n_keys = n_rep * s, n_tbl * page
    win = int(window or 0)
    tk, half = PREFILL_TILE_KEYS, PREFILL_CONSUMER_ROWS
    kk = _gather_store(k_store, page_table, q.dtype)
    vv = _gather_store(v_store, page_table, q.dtype)
    base = (pos_map.long() if pos_map is not None
            else torch.arange(n_tbl, device=q.device) * page)
    k_pos = (base[:, None] + torch.arange(page, device=q.device)).reshape(-1)
    qp = q.reshape(b, hkv, rows, d).float()
    prow = positions.long().repeat(1, n_rep)             # [B, rows]
    out = torch.zeros(b, hkv, rows, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, rows), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    scale = 1.0 / math.sqrt(d)
    for bi in range(b):
        for kh in range(hkv):
            for r0 in range(0, rows, PREFILL_TILE_ROWS):
                cons = []
                for c in range(PREFILL_TILE_ROWS // half):
                    ra = r0 + c * half
                    rb = min(ra + half, rows)
                    pos = prow[bi, ra:rb] if ra < rows else prow[bi, :0]
                    cons.append((ra, rb, pos, _prefill_key_range(
                        pos, win, page, n_tbl, pos_map)))
                live = [x[3] for x in cons if x[3][0] < x[3][1]]
                kb = min(x[0] for x in live) // tk * tk if live else 0
                ke = max(x[1] for x in live) if live else 0
                for ra, rb, pos, (cb, ce) in cons:
                    if cb >= ce:
                        continue
                    t_lo, t_hi = (cb - kb) // tk, -(-(ce - kb) // tk)
                    qr = qp[bi, kh, ra:rb]
                    mm = torch.full((rb - ra,), NEG_INF, device=q.device)
                    ll = torch.zeros(rb - ra, device=q.device)
                    acc = torch.zeros(rb - ra, d, device=q.device)
                    n_whole = 0
                    p_lo, p_hi = int(pos.min()), int(pos.max())
                    for i in range(t_lo, t_hi):
                        keys = kb + i * tk + torch.arange(tk, device=q.device)
                        inside = keys < ke
                        idx = keys.clamp(max=n_keys - 1)
                        kt = kk[bi, kh, idx].float() * inside[:, None]
                        vt = vv[bi, kh, idx] * inside[:, None].to(vv.dtype)
                        kp = torch.where(inside, k_pos[idx], _INT_MAX)
                        sc = qr @ kt.T * scale
                        whole = (int(kp[-1]) <= p_lo and
                                 (not win or int(kp[0]) > p_hi - win))
                        if whole:
                            keep = None
                        else:
                            keep = kp[None, :] <= pos[:, None]
                            if win:
                                keep &= kp[None, :] > pos[:, None] - win
                            sc = sc.masked_fill(~keep, NEG_INF)
                        n_whole += whole
                        m_new = torch.maximum(mm, sc.amax(dim=-1))
                        alpha = torch.exp(mm - m_new)
                        p = torch.exp(sc - m_new[:, None])
                        if keep is not None:
                            p = p * keep
                        ll = ll * alpha + p.sum(dim=-1)
                        acc = acc * alpha[:, None] + (
                            p.to(vt.dtype).float() @ vt.float())
                        mm = m_new
                    out[bi, kh, ra:rb] = acc / ll.clamp_min(1e-30)[:, None]
                    m[bi, kh, ra:rb] = mm
                    l[bi, kh, ra:rb] = ll
                    if walk is not None:
                        walk.append({"b": bi, "kh": kh, "rows": (ra, rb),
                                     "kb": kb, "t_lo": t_lo, "t_hi": t_hi,
                                     "whole": n_whole,
                                     "masked": t_hi - t_lo - n_whole})
    out = out.reshape(b, h, s, d).to(q.dtype)
    if return_stats:
        return out, m.reshape(b, h, s), l.reshape(b, h, s)
    return out


#: the least number of keys a split of K2's decode arm covers
DECODE_SPLIT_KEYS = 256
#: the most splits the decode arm cuts a table into (a wider table gets
#: longer splits)
DECODE_MAX_SPLITS = 64
#: the decode kernel's key tile: every split starts at a multiple of it
DECODE_TILE_KEYS = 64


def decode_splits(page: int, n_tbl: int) -> Tuple[int, int]:
    """``(split_pages, n_splits)`` of K2's decode arm: the table cut into
    runs of ``split_pages`` whole entries, at least
    :data:`DECODE_SPLIT_KEYS` keys each and at most
    :data:`DECODE_MAX_SPLITS` of them, each a multiple of the kernel's
    64-key tile.  From the page size and the table width alone: no
    position is read back, so the host never waits on the card."""
    align = DECODE_TILE_KEYS // math.gcd(int(page), DECODE_TILE_KEYS)
    pages = max(-(-DECODE_SPLIT_KEYS // page),
                -(-int(n_tbl) // DECODE_MAX_SPLITS))
    pages = -(-pages // align) * align
    return pages, -(-int(n_tbl) // pages)


def _paged_split_plain(q, k_store, v_store, page_table, positions,
                       window: Optional[int], pos_map=None,
                       split_pages: Optional[int] = None):
    """K2's decode arm before its fold, written out densely: the table
    cut into runs of ``split_pages`` entries (default
    :func:`decode_splits`), each run's softmax partials as
    :func:`_softmax_partials` gives them.  Returns (o [n_splits, B, H, S,
    D] f32, m and l [n_splits, B, H, S] f32, m in base e); a run that
    keeps no key of a row gives it o = 0, m = NEG_INF and l = 0."""
    page = _store_values(k_store).shape[2]
    if split_pages is None:
        split_pages = decode_splits(page, page_table.shape[1])[0]
    sc, keep, vv = _paged_scores(q, k_store, v_store, page_table, positions,
                                 window, pos_map)
    parts = [_softmax_partials(sc[..., t:t + split_pages * page],
                               keep[..., t:t + split_pages * page],
                               vv[:, :, t:t + split_pages * page])
             for t in range(0, sc.shape[-1], split_pages * page)]
    return tuple(torch.stack(x) for x in zip(*parts))


def _paged_combine_plain(o, m, l):
    """The fold of :func:`_paged_split_plain`'s partials over their
    first dim, as :func:`sp_merge_partials` folds stripes: M = max m,
    w = exp(m - M) * l, out = sum w * o / max(sum w, 1e-30).  Returns
    (out f32, M, sum w): a row no split keeps a key of gets out 0,
    m = NEG_INF and l = 0, the striped entry points' stats."""
    mx = m.amax(dim=0)
    w = torch.exp(m - mx) * l
    out = (w[..., None] * o).sum(dim=0)
    return out / w.sum(dim=0).clamp_min(1e-30)[..., None], mx, w.sum(dim=0)


def _check_int8_leaf(name: str, x: torch.Tensor, dtype) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: the int8 kernel takes {dtype}, got "
                        f"{x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def paged_decode_attention(q, k_store, v_store, page_table, positions,
                           window: Optional[int] = None, pos_map=None,
                           return_stats: bool = False):
    """K2's wrapper: attention of q [B, H, S, D] at ``positions`` [B, S]
    over one layer's pool read through ``page_table`` [B, n_tbl] (int32,
    logical order, 0 = trash page, masked positionally).  Returns
    [B, H, S, D].  A store is a bf16 pool [n_pages, Hkv, page, D] or the
    int8 store {"q": int8 [n_pages, Hkv, page, D], "s": f32 [n_pages, Hkv,
    page, 1]}, dequantized to q's dtype as it is read.

    Position striping: ``pos_map`` (int32 [n_tbl]) gives each table
    entry's starting position (default ``j * page``), so one stripe's
    local table masks in global positions; it must increase along the
    table.  ``return_stats`` returns ``(out, m, l)``: m the max of the
    kept scaled scores and l the sum of their exponentials relative to
    it, [B, H, S] f32.  A row that keeps no key returns a zero output,
    m = NEG_INF and l = 0 (weight 0 in :func:`sp_merge_partials`).

    CUDA tensors launch one of two arms, each with an entry point a
    store and a striped one a store (when ``pos_map`` or
    ``return_stats`` is given): at S = 1 ``csrc/paged_decode.cu``
    (``tpushare_paged_decode``, ``_int8``, ``_striped``,
    ``_int8_striped``), the table cut into :func:`decode_splits` whose
    partials the kernel's last block for each (row, kv head) folds; at
    S > 1 ``csrc/paged_attn.cu`` (``tpushare_paged_attn`` and its three
    kin), each key's table entry read a tile ahead.  They take bf16 q,
    contiguous 16-byte-aligned leaves, head dim 64 or 128, an int8
    store's pages a multiple of 4 tokens, an int32 table, pos_map and
    positions on the same card, and at S = 1 at most 64 q heads a kv
    head; else the wrapper raises.  The table's entries
    must name pages of the pool: the kernels read them unchecked.  The
    decode arm's per-(row, kv head) tickets are one buffer a (card,
    stream).  CPU tensors take :func:`_paged_plain`.  The wrapper counts
    the launches of each entry point: ``paged_decode_attention.launches``
    (bf16), ``.launches_int8``, ``.launches_striped`` and
    ``.launches_int8_striped`` for the S > 1 arm, the same names with
    ``launches_decode`` for the S = 1 arm; ``.decode_plan`` is the
    (split_pages, n_splits) its last decode launch was given."""
    quantized = isinstance(k_store, dict)
    kq, vq = _store_values(k_store), _store_values(v_store)
    b, h, s, d = q.shape
    n_pages, hkv, page, dk = kq.shape
    if h % hkv:
        raise ValueError(f"GQA needs n_heads % n_kv_heads == 0, got "
                         f"{h} % {hkv}")
    if (dk != d or vq.shape != kq.shape
            or isinstance(v_store, dict) != quantized):
        raise ValueError(f"pool leaves must be [n_pages, Hkv, page, {d}] "
                         f"and of one kind, got {tuple(kq.shape)} / "
                         f"{tuple(vq.shape)}")
    if quantized and not (k_store["s"].shape == v_store["s"].shape
                          == (n_pages, hkv, page, 1)):
        raise ValueError(f"int8 scales must be [n_pages, Hkv, page, 1] = "
                         f"{(n_pages, hkv, page, 1)}, got "
                         f"{tuple(k_store['s'].shape)} / "
                         f"{tuple(v_store['s'].shape)}")
    if page_table.shape[0] != b or positions.shape != (b, s):
        raise ValueError(f"page_table [B, n_tbl] and positions [B, S] must "
                         f"match q's B={b}, S={s}; got "
                         f"{tuple(page_table.shape)}, "
                         f"{tuple(positions.shape)}")
    n_tbl = page_table.shape[1]
    if pos_map is not None and pos_map.shape != (n_tbl,):
        raise ValueError(f"pos_map must be [n_tbl] = ({n_tbl},), got "
                         f"{tuple(pos_map.shape)}")
    win = int(window or 0)
    if q.device.type == "cpu":
        return _paged_plain(q, k_store, v_store, page_table, positions, win,
                            pos_map=pos_map, return_stats=return_stats)
    striped = pos_map is not None or return_stats
    if striped and pos_map is None:
        pos_map = torch.arange(0, n_tbl * page, page, dtype=torch.int32,
                               device=q.device)
    leaves = ([kq, k_store["s"], vq, v_store["s"]] if quantized
              else [kq, vq])
    _check_on_cuda(q, *leaves, page_table, positions,
                   *([pos_map] if striped else []))
    _check_kernel_operand("q", q)
    if quantized:
        for name, x, dtype in (("k_store['q']", kq, torch.int8),
                               ("k_store['s']", k_store["s"], torch.float32),
                               ("v_store['q']", vq, torch.int8),
                               ("v_store['s']", v_store["s"], torch.float32)):
            _check_int8_leaf(name, x, dtype)
        if page % 4:
            raise ValueError(f"the int8 kernel copies four scales at a "
                             f"time: page must be a multiple of 4, got "
                             f"{page}")
    else:
        _check_kernel_operand("k_pool", kq)
        _check_kernel_operand("v_pool", vq)
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged kernel head dim must be one of "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    ints = [("page_table", page_table), ("positions", positions)]
    for name, x in ints + ([("pos_map", pos_map)] if striped else []):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32 tensor")
    if s == 1 and h // hkv > DECODE_MAX_REP:
        raise ValueError(f"the decode kernel holds at most "
                         f"{DECODE_MAX_REP} q heads a kv head, got "
                         f"{h // hkv}")
    out, m, l, plan = launch_k2(
        _cuda, q, leaves, page_table, positions,
        pos_map if striped else None, win, _decode_tickets)
    kind = ("_int8" if quantized else "") + ("_striped" if striped else "")
    if plan is None:
        _count(paged_decode_attention, f"launches{kind}")
    else:
        paged_decode_attention.decode_plan = plan
        _count(paged_decode_attention, f"launches_decode{kind}")
    return (out, m, l) if return_stats else out


def launch_k2(cuda, q, leaves, page_table, positions, pos_map, window: int,
              tickets=None):
    """Launch K2 through ``cuda`` (this package's ``_cuda`` module, or the
    one of another checkout) on checked operands: ``leaves`` the store's
    tensors ([k, v] or [kq, ks, vq, vs]), ``pos_map`` None for the
    unstriped entry points.  With ``tickets`` (``fn(device, n)``: the
    address of n zeroed per-(row, kv head) counters) a call at S = 1 goes
    to the decode arm, cut into :func:`decode_splits`; else to
    ``paged_attn``.  Returns (out, m, l, plan): m and l None unstriped,
    plan the (split_pages, n_splits) a decode launch was given, else
    None."""
    b, h, s, d = q.shape
    hkv, page = leaves[0].shape[1], leaves[0].shape[2]
    n_tbl = page_table.shape[1]
    striped = pos_map is not None
    out = torch.empty_like(q)
    m = l = plan = None
    args = [q.data_ptr(), *(x.data_ptr() for x in leaves),
            page_table.data_ptr()]
    if striped:
        m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        args.append(pos_map.data_ptr())
    args += [positions.data_ptr(), out.data_ptr()]
    if striped:
        args += [m.data_ptr(), l.data_ptr()]
    kind = ("_int8" if len(leaves) == 4 else "") + \
        ("_striped" if striped else "")
    scale = 1.0 / math.sqrt(d)
    if s == 1 and tickets is not None:
        plan = decode_splits(page, n_tbl)
        ws = torch.empty(b * h * plan[1] * (d + 2), dtype=torch.float32,
                         device=q.device)
        cuda.call("paged_decode", f"tpushare_paged_decode{kind}", *args,
                  ws.data_ptr(), tickets(q.device, b * hkv), b, h, hkv, d,
                  page, n_tbl, plan[0], window, scale)
    else:
        cuda.call("paged_attn", f"tpushare_paged_attn{kind}", *args, b, h,
                  hkv, s, d, page, n_tbl, window, scale)
    return out, m, l, plan


#: the most q heads a kv head the decode kernel holds (its 4 warps of 16)
DECODE_MAX_REP = 64

K2_KINDS = ("", "_int8", "_striped", "_int8_striped")
for _kind in K2_KINDS:
    setattr(paged_decode_attention, f"launches{_kind}", 0)
    setattr(paged_decode_attention, f"launches_decode{_kind}", 0)
#: the (split_pages, n_splits) of the wrapper's last decode launch
paged_decode_attention.decode_plan = None

_tickets = {}


def _decode_tickets(device, n: int) -> int:
    """The address of the decode kernel's per-(row, kv head) ticket
    counters for the current stream on ``device``: one zeroed int32
    buffer a (card, stream), grown to at least ``n``.  Every launch
    leaves its counters zeroed again, and the launches of one stream run
    one after another, so no two launches share a counter at once."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with _count_lock:
        t = _tickets.get((device, stream))
        if t is None or t.numel() < n:
            t = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
            _tickets[(device, stream)] = t
        return t.data_ptr()


# ---------------------------------------------------------------------------
# Position striping (the sp mesh axis): K2's striped variant per stripe
# ---------------------------------------------------------------------------
def tp_degree(mesh, axis: str = "tp") -> int:
    """Size of ``axis`` in ``mesh`` (1 when mesh is None or lacks the
    axis)."""
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return int(mesh.shape[axis])


def striped_local_view(page_table, sp: int, shard: int,
                       pages_per_shard: int, page: int):
    """One position stripe's view of a global striped page table [B,
    n_tbl]: range j of a sequence lives on stripe ``j % sp``, and stripe
    ``shard`` owns global pages ``[shard*per, (shard+1)*per)`` with its
    local page 0 as its trash page.  Returns

    * ``local_table`` [B, ceil(n_tbl/sp)] int32: entry jj is global range
      ``jj*sp + shard`` in local page indices; unreserved (0) and
      past-the-table entries map to local trash page 0;
    * ``pos_map`` [ceil(n_tbl/sp)] int32: entry jj's starting position
      ``(jj*sp + shard) * page`` (past-the-table entries sit at or beyond
      ``n_tbl * page``, after every query)."""
    n_tbl = page_table.shape[1]
    n_local = -(-n_tbl // sp)
    cols = shard + sp * torch.arange(n_local, device=page_table.device)
    g = page_table.index_select(1, cols.clamp(max=n_tbl - 1))
    g = torch.where((cols < n_tbl)[None, :], g, 0)
    local = torch.where(g == 0, 0, g - shard * pages_per_shard)
    return (local.to(torch.int32).contiguous(),
            (cols * page).to(torch.int32))


def sp_merge_partials(outs, ms, ls, device):
    """Fold one ``(out, m, l)`` partial per stripe into the full-key
    softmax, in f32 on ``device``: with M = max_s m_s and w_s =
    exp(m_s - M) * l_s, out = sum_s w_s * out_s / max(sum_s w_s, 1e-30).
    A stripe with no kept key (m = NEG_INF, l = 0) weighs 0.  Returns
    out_s's dtype."""
    m = torch.stack([x.to(device).float() for x in ms])
    w = torch.exp(m - m.amax(dim=0)) * torch.stack(
        [x.to(device).float() for x in ls])
    num = (w[..., None] * torch.stack(
        [x.to(device).float() for x in outs])).sum(dim=0)
    return (num / w.sum(dim=0).clamp_min(1e-30)[..., None]).to(outs[0].dtype)


def sp_striped_paged_decode_attention(q, k_stripes, v_stripes, page_table,
                                      positions, mesh,
                                      window: Optional[int] = None):
    """:func:`paged_decode_attention` over a pool striped on the mesh's
    ``sp`` axis: ``k_stripes``/``v_stripes`` hold one layer store a
    stripe, stripe s on the mesh's device s.  For each stripe, q and its
    local view of the global ``page_table`` (:func:`striped_local_view`)
    go to its device and K2's striped variant returns its partials;
    :func:`sp_merge_partials` folds them on q's device."""
    sp = tp_degree(mesh, "sp")
    leaf = _store_values(k_stripes[0])
    per, page = leaf.shape[0], leaf.shape[2]
    outs, ms, ls = [], [], []
    for s in range(sp):
        dev = mesh.devices[s]
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            tbl, pmap = striped_local_view(page_table.to(dev), sp, s, per,
                                           page)
            o, m, l = paged_decode_attention(
                q.to(dev), k_stripes[s], v_stripes[s], tbl,
                positions.to(dev), window=window, pos_map=pmap,
                return_stats=True)
        outs.append(o)
        ms.append(m)
        ls.append(l)
    # a named range, so a profile can tell the merge's operations apart
    with torch.profiler.record_function("sp_merge_partials"):
        return sp_merge_partials(outs, ms, ls, q.device)
