"""Weight-only int8 / int4 quantization and the int8 KV byte model.

Counterpart of ``tpushare/ops/quant.py``, in plain PyTorch, with the same
names, layouts and arithmetic:

* int8 weights: per-output-channel symmetric, ``w ~ q * s`` with
  ``q`` int8 ``[..., d_in, d_out]`` and ``s`` f32 ``[..., 1, d_out]``;
  :func:`qmatmul` takes ``x @ q`` in the activation dtype, then scales
  the product (valid for per-output-channel scales).  The int8 codes are
  bit-equal to the JAX package's: ``torch.round`` and ``jnp.round`` both
  round half to even, and both divide in f32.
* int4 weights: grouped symmetric, values in [-7, 7] packed two to a byte
  along the contraction dim in the half-interleaved layout (byte j of a
  group holds rows j and j + group/2).
* the int8 KV store: one f32 scale per (token, kv head), riding the
  values' rank with a trailing singleton; :func:`kv_cache_bytes` is the
  one byte model every pool size and report goes through.

The weight products here are plain large matrix products (the JAX
package leaves them to XLA); they run through ``torch.matmul`` on a
transient copy of the weight in the activation dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

#: leaf names :func:`quantize_params` quantizes (the embedding stays)
QUANT_SUFFIXES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "lm_head")


def _amax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """max |x| over ``dim`` (kept), without an ``abs`` copy of ``x``."""
    return torch.maximum(x.amax(dim, keepdim=True),
                         -x.amin(dim, keepdim=True))


def quantize(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [..., d_in, d_out] -> (int8 values, f32 scale [..., 1, d_out]):
    per output channel (and per layer for stacked [L, ...] leaves), the
    reduction over the contraction dim only.  One f32 copy of ``w`` is
    the only weight-sized transient (the steps run in place on it)."""
    wf = w.to(torch.float32, copy=True)
    scale = _amax(wf, -2).clamp_min_(1e-8).div_(127.0)
    q = wf.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def qmatmul(x: torch.Tensor, qw: Dict, dtype=None) -> torch.Tensor:
    """x @ dequant(qw): the product of ``x`` and the int8 values in the
    activation dtype, then the per-output-channel scale on the product."""
    dtype = dtype or x.dtype
    y = x @ qw["q"].to(dtype)
    return y * qw["s"].to(dtype)    # scale [..., 1, d_out] broadcasts


# ---------------------------------------------------------------------------
# KV-cache quantization (int8, per token and kv head)
# ---------------------------------------------------------------------------
#: dtype of the per-(token, kv head) KV scales
KV_SCALE_DTYPE = torch.float32


def quantize_kv(x: torch.Tensor) -> Dict:
    """K or V block [..., D] -> {"q": int8 [..., D], "s": f32 [..., 1]}:
    one scale per vector, reduced over the head dim only, so a written
    position's codes never change when a neighbour is written."""
    xf = x.float()
    s = _amax(xf, -1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s.to(KV_SCALE_DTYPE)}


def dequantize_kv(store: Dict, dtype=torch.bfloat16) -> torch.Tensor:
    """{"q","s"} -> the dense [..., D] block in ``dtype``: each element
    is ``dtype(f32(q) * s)``."""
    return (store["q"].float() * store["s"]).to(dtype)


def kv_bytes_per_elem(cfg) -> float:
    """Persistent bytes per stored KV element for ``cfg.kv_dtype``: the
    value byte(s) plus the per-(token, kv head) scale spread over the
    head dim."""
    if getattr(cfg, "kv_dtype", "bf16") == "int8":
        return 1.0 + KV_SCALE_DTYPE.itemsize / cfg.head_dim
    return float(cfg.dtype.itemsize)


def kv_cache_bytes(cfg, tokens: int) -> int:
    """Persistent KV bytes for ``tokens`` positions: K and V over every
    layer and kv head (+ the int8 scales)."""
    kv_pair = 2
    elems = kv_pair * cfg.n_layers * cfg.n_kv_heads * tokens * cfg.head_dim
    return int(round(elems * kv_bytes_per_elem(cfg)))


# ---------------------------------------------------------------------------
# int4 (grouped, packed two to a byte)
# ---------------------------------------------------------------------------
def quantize4(w: torch.Tensor, group: int = 512) -> Dict:
    """w [..., d_in, d_out] -> {'q4': uint8 [..., g, group/2, d_out],
    's': f32 [..., g, 1, d_out]}, values in [-7, 7], byte j of a group
    holding rows j (low nibble) and j + group/2 (high nibble).  A group
    that does not divide d_in halves until one does (768 with the 512
    default lands on 256), else it is the whole contraction dim."""
    wf = w.float()
    d_in = wf.shape[-2]
    while group > 2 and (d_in % group or group % 2):
        group //= 2
    if d_in % group or group % 2:
        group = d_in
    if group % 2:
        raise ValueError(f"odd contraction dim {d_in} cannot pack int4")
    lead = wf.shape[:-2]
    g = d_in // group
    wg = wf.reshape(*lead, g, group, wf.shape[-1])
    scale = _amax(wg, -2).clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int32)
    lo, hi = q[..., :group // 2, :], q[..., group // 2:, :]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8)
    return {"q4": packed, "s": scale.to(torch.float32)}


def _unpack4(p: torch.Tensor):
    """packed uint8 -> (lo, hi) int8 nibbles, sign-extended by arithmetic
    shifts: lo holds rows [0, group/2) of each group, hi the rest."""
    i8 = p.view(torch.int8)
    return (i8 << 4) >> 4, i8 >> 4


def dequantize4(qw: Dict, dtype=torch.bfloat16) -> torch.Tensor:
    """{'q4','s'} -> the dense [..., d_in, d_out] weight."""
    lo, hi = _unpack4(qw["q4"])
    w = torch.cat([lo, hi], dim=-2).float() * qw["s"]
    *lead, g, group, d_out = w.shape
    return w.reshape(*lead, g * group, d_out).to(dtype)


def q4matmul(x: torch.Tensor, qw: Dict, row_block=None) -> torch.Tensor:
    """Grouped int4 product with the scales on the per-group partials:
    y = sum_g s_g * (x_g @ w_g), w_g group g's rows (the low nibbles,
    then the high ones: the group's row order), each group's partial an
    f32-output product (:class:`F32Matmul`), scaled and summed over the
    groups in f32, then rounded once to x's dtype.

    ``row_block`` ``(t, n)``: ``qw["q4"]`` is block t of n of the
    packed-row dim (the reference's tp split of a row-parallel leaf:
    rows ``{j, j + group/2 : j in block t}`` of every group) beside the
    whole ``s``, and ``x`` the whole activation; the block's partial
    product, left in f32."""
    if qw["q4"].ndim != 3:
        raise ValueError(
            f"q4matmul takes one layer's packed weight (ndim 3), got "
            f"ndim {qw['q4'].ndim}; slice the stacked leaf per layer "
            "before the matmul")
    lo, hi = _unpack4(qw["q4"])                    # [g, k, d_out]
    g, k = lo.shape[-3], lo.shape[-2]
    w = torch.cat([lo, hi], dim=-2).to(x.dtype)    # [g, 2k, d_out]
    lead = x.shape[:-1]
    t, n = row_block or (0, 1)
    xg = x.reshape(-1, g, 2, k * n)[..., t * k:(t + 1) * k]
    xg = xg.reshape(-1, g, 2 * k).transpose(0, 1)  # [g, N, 2k]
    y = (F32Matmul.apply(xg, w) * qw["s"]).sum(dim=0)
    y = y.reshape(*lead, y.shape[-1])
    return y if row_block is not None else y.to(x.dtype)


class F32Matmul(torch.autograd.Function):
    """a @ b -> f32, 2-D or batched 3-D.  On the card bf16 operands go
    through one f32-output GEMM (``out_dtype=float32``); elsewhere the
    product is taken in f32.  The backward takes both grads as products
    in the operands' dtype (f32 accumulation) from the cotangent cast to
    that dtype, so no f32 copy of ``b`` is made."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type == "cuda" and a.dtype == b.dtype == torch.bfloat16:
            mm = torch.mm if a.dim() == 2 else torch.bmm
            return mm(a, b, out_dtype=torch.float32)
        return torch.matmul(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = g @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        db = a.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return da, db


def matmul_maybe_q(x: torch.Tensor, w) -> torch.Tensor:
    """Dispatch on the weight leaf: LoRA {'a','b',...} (recursing on its
    base, so adapters compose with a quantized base), int8 {'q','s'},
    int4 {'q4','s'}, or a plain tensor."""
    if isinstance(w, dict) and "a" in w and "b" in w:
        base = {k: v for k, v in w.items() if k not in ("a", "b", "scale")}
        if list(base) == ["w"]:
            base = base["w"]
        y = matmul_maybe_q(x, base)
        adapter = (x @ w["a"].to(x.dtype)) @ w["b"].to(x.dtype)
        return y + adapter * w["scale"].to(y.dtype)
    if isinstance(w, dict) and "q4" in w:
        return q4matmul(x, w)
    if isinstance(w, dict) and "q" in w:
        return qmatmul(x, w)
    return x @ w


# ---------------------------------------------------------------------------
# Model-level helpers
# ---------------------------------------------------------------------------
def quantize_leaf(w: torch.Tensor, bits: int = 8, group: int = 512) -> Dict:
    """One weight leaf (2D, or stacked 3D) in its quantized form."""
    if bits == 4:
        return quantize4(w, group=group)
    q, s = quantize(w)
    return {"q": q, "s": s}


def quantize_params(params, suffixes=QUANT_SUFFIXES, bits: int = 8,
                    group: int = 512):
    """Quantize the matching 2D / stacked 3D weight leaves of a nested
    param dict (``bits`` 8 = per-channel int8, 4 = grouped packed int4);
    every other leaf is kept as it is."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")

    def visit(name, leaf):
        if isinstance(leaf, dict):
            return {k: visit(k, v) for k, v in leaf.items()}
        if name in suffixes and leaf.ndim >= 2:
            return quantize_leaf(leaf, bits, group)
        return leaf

    return visit("", params)


def tensor_leaves(tree):
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    return [tree]


def hbm_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in tensor_leaves(params))
