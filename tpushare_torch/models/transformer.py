"""LLaMA-style decoder-only transformer in PyTorch.

Counterpart of ``tpushare/models/transformer.py``, with the same parameter
keys and stacked ``[L, ...]`` layer leaves, so weights carry over leaf by
leaf (:mod:`tpushare_torch.models.bridge`).  The JAX layer ``scan``
becomes a Python loop over the layer index; the paged forwards write
their new K/V pages into the pool IN PLACE (the pool tensors passed in are
the pool tensors returned).

Attention goes through the port's CUDA kernels on the card: the no-cache
:func:`forward` through K1 (``ops.attention.attention``; its backward,
the training path, through K3 and K4), every
paged read through K2 when ``cfg.attn_kernel == "kernel"`` (the default;
``"gather"`` is the counterpart of the JAX ``"xla"`` path: gather the dense
view, then :func:`cached_attention`).

Quantized weights: a weight leaf may be an int8 ``{"q","s"}`` or int4
``{"q4","s"}`` dict (``ops.quant``; every product goes through
``matmul_maybe_q``), and :func:`init_params` can build such a tree one
layer slice at a time.  ``cfg.kv_dtype="int8"`` stores the paged pool as
int8 ``{"q","s"}`` stores (one f32 scale per token and kv head, riding
the values' rank with a trailing singleton), quantized once as each
position is written and read through K2's int8 entry point.

Position striping: under a mesh with an ``sp`` axis
(:mod:`tpushare_torch.parallel.mesh`) the paged pool is a tuple of one
``(k, v)`` pair of stores per stripe, stripe s on the mesh's device s
holding global pages ``[s*per, (s+1)*per)`` (its local page 0 its trash
page), and a sequence's page range j lives on stripe ``j % sp``.  Writes
go to the owning stripe; the read is K2's striped variant per stripe
merged across stripes (``"kernel"``), or the stripes' gathers reassembled
in global order (``"gather"``, bit-identical to the unstriped gather).
The dense part of the forward runs on the mesh's first device.

Left for later slices: dense and rolling caches, LoRA, MoE, and the tp/pp
mesh axes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import default_device
from ..ops import quant
from ..ops.attention import (NEG_INF, attention, expand_kv, paged_gather,
                             paged_decode_attention,
                             sp_striped_paged_decode_attention,
                             striped_local_view, tp_degree)
from ..ops.quant import matmul_maybe_q as _mm

ATTN_KERNELS = ("gather", "kernel")
KV_DTYPES = ("bf16", "int8")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    #: sliding-window attention: each position attends its last
    #: ``window`` tokens (None = full causal)
    window: Optional[int] = None
    #: paged-pool read path: "kernel" (K2, csrc/paged_attn.cu; the plain
    #: version on the CPU) or "gather" (dense view + cached_attention)
    attn_kernel: str = "kernel"
    #: paged KV storage: "bf16" (a cfg.dtype pool) or "int8" ({"q","s"}
    #: stores with per-(token, kv head) f32 scales)
    kv_dtype: str = "bf16"

    def __post_init__(self):
        if self.window is not None and self.window < 1:
            raise ValueError("window must be None or >= 1")
        if self.attn_kernel not in ATTN_KERNELS:
            raise ValueError(f"attn_kernel must be one of {ATTN_KERNELS}, "
                             f"got {self.attn_kernel!r}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {self.kv_dtype!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def wants_rolling(cfg: ModelConfig) -> bool:
    """A sliding-window config whose window is smaller than its context:
    the paged batcher holds such a sequence in a ring of pages."""
    return cfg.window is not None and cfg.window < cfg.max_seq


def llama3_8b() -> ModelConfig:
    """Llama-3-8B architecture: GQA 8 kv-heads, 128k vocab, theta 5e5."""
    return ModelConfig(vocab=128256, d_model=4096, n_layers=32, n_heads=32,
                       n_kv_heads=8, d_ff=14336, max_seq=8192,
                       rope_theta=5e5)


def flagship_small() -> ModelConfig:
    """The JAX server's ``flagship-small`` (``serving/llm.py``)."""
    return ModelConfig(vocab=32000, d_model=512, n_layers=4, n_heads=8,
                       n_kv_heads=4, d_ff=1408, max_seq=512)


def tiny(vocab: int = 256, d_model: int = 64, n_layers: int = 2,
         n_heads: int = 4, n_kv_heads: int = 2, d_ff: int = 128,
         max_seq: int = 128, dtype=torch.float32,
         window: Optional[int] = None, attn_kernel: str = "kernel",
         kv_dtype: str = "bf16") -> ModelConfig:
    return ModelConfig(vocab=vocab, d_model=d_model, n_layers=n_layers,
                       n_heads=n_heads, n_kv_heads=n_kv_heads, d_ff=d_ff,
                       max_seq=max_seq, dtype=dtype, window=window,
                       attn_kernel=attn_kernel, kv_dtype=kv_dtype)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                quantize_bits: int = 0) -> Dict:
    """Random params ``{'embed', 'layers': {stacked [L, ...] leaves},
    'final_scale', 'lm_head'}`` from a seeded ``torch.Generator``: the
    JAX package's keys and shapes, N(0, 1/fan_in) weights and unit norm
    scales.  The draws differ from ``jax.random``'s; to reproduce a JAX
    model, bridge its params instead (:mod:`.bridge`).  Stacked leaves
    are filled one layer at a time, so the f32 transient is one layer's.

    ``quantize_bits`` 8 or 4 quantizes the weight leaves
    (``ops.quant.QUANT_SUFFIXES``) as they are drawn, one layer slice at
    a time into the stacked quantized leaf, so the cfg.dtype tree never
    exists whole; per-output-channel scales reduce over d_in only, so the
    result equals ``quant.quantize_params(init_params(cfg, seed),
    bits=quantize_bits)`` bit for bit."""
    if quantize_bits not in (0, 4, 8):
        raise ValueError(f"quantize_bits must be 0, 4 or 8, got "
                         f"{quantize_bits}")
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    d, kvd, L = cfg.d_model, cfg.n_kv_heads * cfg.head_dim, cfg.n_layers

    def normal(fan_in, shape):
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return x.div_(math.sqrt(fan_in)).to(cfg.dtype)

    def leaf(w):
        return (quant.quantize_leaf(w, quantize_bits) if quantize_bits
                else w)

    def stacked(fan_in, shape):
        out = {}
        for l in range(L):
            w = leaf(normal(fan_in, shape))
            parts = w if isinstance(w, dict) else {None: w}
            for k, v in parts.items():
                if k not in out:       # the stacked tensor, of v's kind
                    out[k] = torch.empty((L, *v.shape), dtype=v.dtype,
                                         device=dev)
                out[k][l] = v
        return out if quantize_bits else out[None]

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    layers = {
        "attn_scale": ones(L, d),
        "wq": stacked(d, (d, d)),
        "wk": stacked(d, (d, kvd)),
        "wv": stacked(d, (d, kvd)),
        "wo": stacked(d, (d, d)),
        "ffn_scale": ones(L, d),
        "w_gate": stacked(d, (d, cfg.d_ff)),
        "w_up": stacked(d, (d, cfg.d_ff)),
        "w_down": stacked(cfg.d_ff, (cfg.d_ff, d)),
    }
    return {"embed": normal(d, (cfg.vocab, d)), "layers": layers,
            "final_scale": ones(d),
            "lm_head": leaf(normal(d, (d, cfg.vocab)))}


def param_count(params) -> int:
    """Elements over every tensor leaf (a quantized leaf's values and
    scales both count, as in the JAX package)."""
    return sum(t.numel() for t in quant.tensor_leaves(params))


def _layers(params) -> List[Dict]:
    """Per-layer views of the stacked ``[L, ...]`` leaves, taken with one
    ``torch.unbind`` per tensor (a quantized leaf's values and scales
    each): its backward is a single stack, where indexing ``v[l]`` would
    write a zero-filled ``[L, ...]`` gradient per layer and leaf."""
    cols = {k: ({s: torch.unbind(t, 0) for s, t in v.items()}
                if isinstance(v, dict) else torch.unbind(v, 0))
            for k, v in params["layers"].items()}
    n = params["layers"]["attn_scale"].shape[0]
    return [{k: ({s: t[l] for s, t in c.items()} if isinstance(c, dict)
                 else c[l]) for k, c in cols.items()} for l in range(n)]


class _HeadMM(torch.autograd.Function):
    """x [N, d] @ w [d, V] -> f32 logits.  On the card bf16 operands go
    through one f32-output GEMM (``torch.mm(..., out_dtype=float32)``);
    elsewhere the product is taken in f32.  The backward takes both grads
    as products in the operands' dtype (f32 accumulation) from the
    cotangent cast to that dtype, so no f32 copy of ``w`` is made."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cuda" and x.dtype == w.dtype == torch.bfloat16:
            return torch.mm(x, w, out_dtype=torch.float32)
        return torch.mm(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = x.t() @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def _head_mm(x, w):
    """LM-head projection with f32-accumulated f32 logits: bf16 operands,
    never rounded through bf16 on the way out (near-tie argmaxes stay
    stable across prefill and decode).  Differentiable (:class:`_HeadMM`).
    A quantized head is its product in x's dtype, scaled, then widened to
    f32, as in the JAX package."""
    x2 = x.reshape(-1, x.shape[-1])
    out = _mm(x2, w).float() if isinstance(w, dict) else _HeadMM.apply(x2, w)
    return out.reshape(*x.shape[:-1], out.shape[-1])


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps: float):
    """x * rsqrt(mean(x^2) + eps) * scale in f32, back in x's dtype."""
    xf = x.float()
    return F.rms_norm(xf, (xf.shape[-1],), weight=scale.float(),
                      eps=eps).to(x.dtype)


def rope_tables(positions, d: int, theta: float):
    """(cos, sin) [B, S, 1, D] f32 of the rotary angles at ``positions``
    [B, S], the sine's first half negated, so that :func:`rope` is two
    products and a sum.  Built once per forward: the frequencies are the
    reference's numpy ones, and moving them to the card is a blocking
    copy that waits for the device, so it must not run in every layer."""
    freqs = torch.from_numpy(
        1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ).to(positions.device)
    angles = positions[..., None].float() * freqs              # [B, S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], dim=-1)[:, :, None, :],
            torch.cat([-sin, sin], dim=-1)[:, :, None, :])


def rope(x, tables):
    """x: [B, S, H, D]; rotate half-pairs (x1, x2) by the angles of
    :func:`rope_tables`: (x1 cos - x2 sin, x2 cos + x1 sin), as
    x * cos + roll(x) * sin."""
    cos, sin = tables
    xf = x.float()
    return (xf * cos + xf.roll(x.shape[-1] // 2, dims=-1) * sin).to(x.dtype)


def _qkv(p, x, cfg: ModelConfig, tables):
    """Project + RoPE (``tables`` from :func:`rope_tables`): x [B, S, d] ->
    q [B, H, S, D], k/v [B, Hkv, S, D]."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _mm(x, p["wq"]).reshape(b, s, h, hd)
    k = _mm(x, p["wk"]).reshape(b, s, hkv, hd)
    v = _mm(x, p["wv"]).reshape(b, s, hkv, hd)
    q = rope(q, tables)
    k = rope(k, tables)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def cached_attention(q, kk, vv, positions, window: Optional[int] = None):
    """Masked attention of q over a dense cache view (heads expanded):
    key position == cache slot; positions mask causality and the
    unwritten tail (and the window); scores and softmax in f32, the
    probabilities rounded to the cache dtype before PV.  (The JAX
    reference rounds the scores to the input dtype first; in f32 the two
    are the same, and in bf16 the f32 scores are what K2 computes.)"""
    hd = q.shape[-1]
    t = kk.shape[2]
    q_pos = positions[:, None, :, None]                        # [B,1,S,1]
    k_pos = torch.arange(t, device=q.device)[None, None, None, :]
    valid = (k_pos <= q_pos) & (k_pos >= 0)
    if window is not None:
        valid &= k_pos > q_pos - window
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(),
                          kk.float()) / math.sqrt(hd)
    logits = logits.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs.to(vv.dtype), vv)


def ffn_block(p, x):
    return _mm(F.silu(_mm(x, p["w_gate"])) * _mm(x, p["w_up"]), p["w_down"])


def _attn_ffn(layer, x, cfg: ModelConfig, attend):
    """THE pre-norm decoder layer: rmsnorm -> attend -> o-proj residual ->
    rmsnorm -> ffn residual.  ``attend(layer, xin) -> o [B, H, S, D]``
    plugs in the cache flavor (none / paged)."""
    b, s, _ = x.shape
    xin = rmsnorm(x, layer["attn_scale"], cfg.norm_eps)
    o = attend(layer, xin)
    o = o.transpose(1, 2).reshape(b, s, cfg.d_model)
    x = x + _mm(o, layer["wo"])
    xn = rmsnorm(x, layer["ffn_scale"], cfg.norm_eps)
    return x + ffn_block(layer, xn)


def _embed(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens.long()].to(cfg.dtype)


def forward(params, tokens, cfg: ModelConfig, remat_policy=None,
            return_hidden: bool = False):
    """tokens [B, S] -> logits [B, S, vocab] f32, no cache; differentiable
    (the training forward; serving callers wrap it in inference mode).
    Attention is :func:`tpushare_torch.ops.attention.attention`: K1
    forward and K3 + K4 backward on the card.

    ``remat_policy`` wraps each layer in ``torch.utils.checkpoint`` with
    that selective-checkpoint policy: the backward recomputes the layer
    but what the policy saves (``parallel.train.ATTN_SAVING_POLICY``:
    K1's out and lse, so the recompute skips the forward kernel).
    ``return_hidden`` returns the post-final-norm hidden states [B, S, d]
    instead of the logits (the chunked loss applies the head itself)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    rot = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = _embed(params, tokens, cfg)

    def attend(lyr, xin):
        q, k, v = _qkv(lyr, xin, cfg, rot)
        return attention(q, k, v, causal=True, window=cfg.window)

    def body(x, lyr):
        return _attn_ffn(lyr, x, cfg, attend)

    for lyr in _layers(params):
        if remat_policy is None:
            x = body(x, lyr)
        else:
            x = checkpoint(body, x, lyr, use_reentrant=False,
                           context_fn=functools.partial(
                               create_selective_checkpoint_contexts,
                               remat_policy))
    x = rmsnorm(x, params["final_scale"], cfg.norm_eps)
    if return_hidden:
        return x
    return _head_mm(x, params["lm_head"])


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------
# A pool "store" is what one of K or V persists as: a cfg.dtype tensor
# (kv_dtype="bf16"), or an int8 {"q": [..., D] int8, "s": [..., 1] f32}
# dict (kv_dtype="int8").  The scale rides the values' rank with a
# trailing singleton, so every index op on a store applies to each of its
# leaves unchanged (:func:`_kv_leaves`).
def kv_quantized(cfg: ModelConfig) -> bool:
    return cfg.kv_dtype == "int8"


def _kv_leaf(store) -> torch.Tensor:
    """The values tensor of a store (for shape queries)."""
    return store["q"] if isinstance(store, dict) else store


def _kv_leaves(store) -> List[torch.Tensor]:
    """Every tensor of a store, values first."""
    return [store["q"], store["s"]] if isinstance(store, dict) else [store]


def _kv_layer(store, l: int):
    """Layer ``l`` of a stacked [L, ...] store (views, no copy)."""
    if isinstance(store, dict):
        return {k: v[l] for k, v in store.items()}
    return store[l]


def _kv_pack(x, cfg: ModelConfig):
    """Fresh K or V block [..., D] -> its storage form.  int8 quantizes
    per (token, kv head) here, once, at write time, so a position's
    stored value is the same whichever forward wrote it."""
    return quant.quantize_kv(x) if kv_quantized(cfg) else x


def _kv_unpack(store, cfg: ModelConfig):
    """Storage form -> dense cfg.dtype block for the attention read."""
    if isinstance(store, dict):
        return quant.dequantize_kv(store, cfg.dtype)
    return store


def _kv_store_zeros(shape, cfg: ModelConfig, device):
    """Zeroed storage for one of K/V: a cfg.dtype tensor, or the int8
    {"q","s"} pair with its scale riding the values' rank.  Zero scales
    dequantize to exact zeros, so unwritten and trash positions read the
    same 0.0 a bf16 pool holds."""
    if kv_quantized(cfg):
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.zeros(shape[:-1] + (1,),
                                 dtype=quant.KV_SCALE_DTYPE, device=device)}
    return torch.zeros(shape, dtype=cfg.dtype, device=device)


def init_paged_kv(cfg: ModelConfig, n_pages: int, page_size: int,
                  device=None, mesh=None) -> Tuple:
    """Paged KV pool: a (k, v) pair of zeroed [L, n_pages, Hkv, page, D]
    stores (cfg.dtype tensors, or int8 {"q","s"} stores under
    ``kv_dtype="int8"``: the same page geometry at about half the bytes).
    Page 0 is the TRASH page: unowned table entries and inactive slots
    point at it, and the position mask keeps it out of every softmax.

    Under a ``mesh`` with an ``sp`` axis of size > 1, the striped pool:
    one such pair of [L, n_pages / sp, ...] stores per stripe, each
    allocated on its shard's device (the layout of
    ``parallel.mesh.shard_kv_storage``, with no full-size transient)."""
    sp = tp_degree(mesh, "sp")
    if sp > 1:
        if n_pages % sp:
            raise ValueError(f"{n_pages} pages do not split into {sp} "
                             f"equal position stripes")
        return tuple(init_paged_kv(cfg, n_pages // sp, page_size, device=d)
                     for d in mesh.devices)
    dev = default_device(device)
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    return (_kv_store_zeros(shape, cfg, dev), _kv_store_zeros(shape, cfg, dev))


def _pool_stripes(pools, mesh) -> List[Tuple]:
    """The ``(k, v)`` store pairs of a pool: one, or one per stripe."""
    return list(pools) if tp_degree(mesh, "sp") > 1 else [pools]


def _stripe_page_ids(page_ids, stripes, mesh) -> List[torch.Tensor]:
    """Global page ids [N] -> each stripe's local ids on its device:
    page p belongs to stripe ``p // per`` at local page ``p % per``; on
    the other stripes the row writes that stripe's trash page 0, so every
    stripe writes every row and no host sync decides who owns what."""
    if len(stripes) == 1:
        return [page_ids]
    per = _kv_leaf(stripes[0][0]).shape[1]
    out = []
    for s, dev in enumerate(mesh.devices):
        ids = page_ids.to(dev)
        out.append(torch.where(ids // per == s, ids % per, 0))
    return out


def _layer_stores(stripes, l: int, mesh):
    """Layer ``l``'s K and V stores: a store each, or under a striping
    mesh a list of one store per stripe."""
    if tp_degree(mesh, "sp") > 1:
        return ([_kv_layer(k, l) for k, _ in stripes],
                [_kv_layer(v, l) for _, v in stripes])
    return _kv_layer(stripes[0][0], l), _kv_layer(stripes[0][1], l)


def _paged_gather_deq(store, page_table, cfg: ModelConfig):
    """Gather one layer's store through a page table into the dense
    cfg.dtype attention view (an int8 store's scales gathered beside its
    values, then dequantized)."""
    if isinstance(store, dict):
        store = {k: paged_gather(v, page_table) for k, v in store.items()}
        return _kv_unpack(store, cfg)
    return paged_gather(store, page_table)


def paged_attention(q, k_store, v_store, page_table, positions,
                    cfg: ModelConfig, mesh=None):
    """THE paged-pool read dispatcher: every paged forward routes here, so
    ``cfg.attn_kernel`` governs one site.  ``k_store``/``v_store`` are one
    layer's stores ([n_pages, Hkv, page, D], or int8 {"q","s"});
    ``page_table`` [B, n_tbl] int32; ``positions`` [B, S] int32.

    Under a ``mesh`` whose ``sp`` axis is > 1 the stores are lists of one
    store per stripe and ``page_table`` is global: ``"kernel"`` runs
    ``ops.attention.sp_striped_paged_decode_attention`` (K2's striped
    variant per stripe, then the merge), ``"gather"``
    :func:`_sp_gather_attention`."""
    if tp_degree(mesh, "sp") > 1:
        if cfg.attn_kernel == "kernel":
            return sp_striped_paged_decode_attention(
                q.contiguous(), k_store, v_store, page_table, positions,
                mesh, window=cfg.window)
        return _sp_gather_attention(q, k_store, v_store, page_table,
                                    positions, cfg, mesh)
    if cfg.attn_kernel == "kernel":
        return paged_decode_attention(q.contiguous(), k_store, v_store,
                                      page_table, positions,
                                      window=cfg.window)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    return cached_attention(
        q, expand_kv(_paged_gather_deq(k_store, page_table, cfg), n_rep),
        expand_kv(_paged_gather_deq(v_store, page_table, cfg), n_rep),
        positions, window=cfg.window)


def _sp_gather_attention(q, k_stores, v_stores, page_table, positions,
                         cfg: ModelConfig, mesh):
    """The striped gather read (``_sp_local_gather_attention`` of the JAX
    package): each stripe gathers its local view
    (``ops.attention.striped_local_view``), the views move to q's device
    and interleave back into global key order (local entry jj of stripe
    s is global range ``jj*sp + s``), and ONE :func:`cached_attention`
    runs over the reassembled view: the key order, shapes and reduction
    of the unstriped gather, so its results are bit-identical."""
    sp = tp_degree(mesh, "sp")
    leaf = _kv_leaf(k_stores[0])
    per, page = leaf.shape[0], leaf.shape[2]
    n_tbl = page_table.shape[1]
    n_local = -(-n_tbl // sp)

    def regather(stores):
        views = []
        for s, store in enumerate(stores):
            tbl, _ = striped_local_view(page_table.to(mesh.devices[s]), sp,
                                        s, per, page)
            views.append(_paged_gather_deq(store, tbl, cfg).to(q.device))
        g = torch.stack(views)             # [sp, B, Hkv, n_local*page, D]
        _, b, h, _, d = g.shape
        g = g.reshape(sp, b, h, n_local, page, d).permute(1, 2, 3, 0, 4, 5)
        return g.reshape(b, h, n_local * sp * page,
                         d)[:, :, :n_tbl * page].contiguous()

    n_rep = cfg.n_heads // cfg.n_kv_heads
    return cached_attention(q, expand_kv(regather(k_stores), n_rep),
                            expand_kv(regather(v_stores), n_rep), positions,
                            window=cfg.window)


@torch.inference_mode()
def forward_paged_decode(params, tokens, cfg: ModelConfig, pools,
                         page_table, lengths, mesh=None):
    """One decode step for every slot against the paged pool.

    tokens [B, 1]; pools from :func:`init_paged_kv` (striped under
    ``mesh``); page_table [B, max_seq // page] int32 (logical page order,
    0-padded, global page ids); lengths [B] int32.  Each slot's new K/V
    lands at logical position ``length`` (page length // P, lane
    length % P) in place, before the read.  Returns (logits [B, 1, vocab]
    f32, pools)."""
    b, s = tokens.shape
    stripes = _pool_stripes(pools, mesh)
    page = _kv_leaf(stripes[0][0]).shape[3]
    lengths = lengths.to(torch.int32)
    positions = (lengths[:, None]
                 + torch.arange(s, device=lengths.device,
                                dtype=torch.int32)[None, :]).contiguous()
    page_ids = page_table.gather(1, (lengths // page)[:, None].long())[:, 0]
    ids = _stripe_page_ids(page_ids.long(), stripes, mesh)
    offsets = [(lengths % page).long().to(i.device) for i in ids]
    rot = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = _embed(params, tokens, cfg)
    for l, layer in enumerate(_layers(params)):
        def attend(lyr, xin, l=l):
            q, k, v = _qkv(lyr, xin, cfg, rot)
            new = (_kv_pack(k, cfg), _kv_pack(v, cfg))
            # distinct active slots own distinct pages; inactive slots all
            # land on the trash page
            for pair, pid, off in zip(stripes, ids, offsets):
                for pool, st in zip(pair, new):
                    for leaf, part in zip(_kv_leaves(pool), _kv_leaves(st)):
                        leaf[l][pid, :, off, :] = part[:, :, 0, :].to(
                            leaf.device)
            return paged_attention(q, *_layer_stores(stripes, l, mesh),
                                   page_table, positions, cfg, mesh=mesh)

        x = _attn_ffn(layer, x, cfg, attend)
    x = rmsnorm(x, params["final_scale"], cfg.norm_eps)
    return _head_mm(x, params["lm_head"]), pools


@torch.inference_mode()
def forward_paged_prefill_chunk(params, tokens, cfg: ModelConfig, pools,
                                page_rows, pos: int, last_idx: int,
                                mesh=None):
    """One prompt WINDOW into a slot's reserved pages at offset ``pos``.

    tokens [1, W] with W a multiple of the page size and ``pos``
    page-aligned; page_rows [max_seq // page] int32, the slot's page-table
    row (global page ids; pools striped under ``mesh``).  The window's K/V
    pages are written in place first, then its queries attend history and
    themselves through the pool.  A padded tail is contained: within the
    reservation it sits at positions the next window or decode overwrites
    before they are attendable, past the reservation the 0-padded row
    sends it to the trash page.  Returns (logits [vocab] f32 at
    ``last_idx``, pools)."""
    b, s = tokens.shape
    if b != 1:
        raise ValueError("paged prefill is per-request (batch 1)")
    stripes = _pool_stripes(pools, mesh)
    page = _kv_leaf(stripes[0][0]).shape[3]
    if s % page or pos % page:
        raise ValueError("prefill window and offset must be page-aligned")
    n_chunks, first = s // page, pos // page
    if first + n_chunks > page_rows.shape[0]:
        raise ValueError("prefill window runs past the page table")
    positions = (pos + torch.arange(s, device=tokens.device,
                                    dtype=torch.int32))[None, :]
    ids = _stripe_page_ids(page_rows[first:first + n_chunks].long(), stripes,
                           mesh)
    table = page_rows[None]
    hkv = cfg.n_kv_heads
    rot = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = _embed(params, tokens, cfg)
    for l, layer in enumerate(_layers(params)):
        def attend(lyr, xin, l=l):
            q, k, v = _qkv(lyr, xin, cfg, rot)             # k [1, Hkv, W, D]
            new = (_kv_pack(k, cfg), _kv_pack(v, cfg))
            for pair, pid in zip(stripes, ids):
                for pool, st in zip(pair, new):
                    for leaf, part in zip(_kv_leaves(pool), _kv_leaves(st)):
                        leaf[l][pid] = part[0].reshape(
                            hkv, n_chunks, page, part.shape[-1]).transpose(
                                0, 1).to(leaf.device)
            return paged_attention(q, *_layer_stores(stripes, l, mesh),
                                   table, positions, cfg, mesh=mesh)

        x = _attn_ffn(layer, x, cfg, attend)
    x = rmsnorm(x, params["final_scale"], cfg.norm_eps)
    return _head_mm(x[0, last_idx], params["lm_head"]), pools


def forward_paged_prefill(params, tokens, cfg: ModelConfig, pools,
                          page_rows, prompt_len: int, mesh=None):
    """Prefill ONE whole request into its reserved pages: the chunk body
    at pos 0 with the prompt padded to a page multiple.  Returns
    (last-position logits [1, vocab], pools)."""
    b, s = tokens.shape
    page = _kv_leaf(_pool_stripes(pools, mesh)[0][0]).shape[3]
    w = -(-s // page) * page
    if w != s:
        tokens = F.pad(tokens[:, :s], (0, w - s))
    logits, pools = forward_paged_prefill_chunk(
        params, tokens, cfg, pools, page_rows, 0, prompt_len - 1, mesh=mesh)
    return logits[None], pools
