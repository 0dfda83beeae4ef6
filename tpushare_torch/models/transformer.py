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

Tensor parallelism: under a mesh with a ``tp`` axis, params laid out by
``parallel.mesh.shard_params`` (``params["layers"]`` one tree a tp shard,
the Megatron split of :data:`TP_COL_LEAVES` / :data:`TP_ROW_LEAVES`) run
:func:`_attn_ffn`'s per-shard body: shard t projects q/k/v with its
column blocks (a :func:`local_cfg` of H/tp and Hkv/tp heads, whole GQA
groups), attends over its own KV stores (K1 no-cache, K2 paged, the dense
read on dense rows), and its ``wo`` and ``w_down`` row blocks give
partial products that are summed on the first device (the JAX package's
``psum``).  KV storage is one ``(k, v)`` pair a shard of the mesh,
row-major: under tp x sp, shard (t, s) holds stripe s of tp shard t's
heads.  Quantized weights split by the reference's rule: an int8 or
int4 column block takes its columns of the whole scale, an int8 row
block's partial is scaled by the whole scale, and an int4 row block,
which holds rows of every group, reads the whole activation, joined from
the shards (:func:`_row_parts`).  A model the split does not fit
(:func:`tp_splits`) runs as tp = 1 on the first device
(:func:`serving_mesh`).

Dense and rolling caches: :func:`forward` with ``kv_caches`` from
:func:`init_kv_caches` (stacked ``[L, B, Hkv, T, D]`` stores, T = max_seq,
or a window-sized ring for a sliding-window config) writes each step's
K/V into them in place and reads them through :func:`cached_attention`,
in plain PyTorch as the JAX package reads them in XLA (no TPU kernel lies
on that path).

Multi-adapter LoRA serving: every entry point the batchers call takes
``adapters`` (a stacked pool of ``ops.lora.init_adapter_pool_arrays``)
and ``adapter_ids`` ([B] pool rows, 0 the identity).  Each forward
gathers every leaf's rows once (:func:`_adapter_layers`) and adds each
row's delta to the seven projections at one composition point,
:func:`_mm_ad`; with ``adapters=None`` the program is the pool-less one,
op for op.

Mixture of experts: an ``n_experts`` config replaces every layer's
dense FFN by a routed expert pool (``ops.experts.moe_ffn``: per-token
top-k routing, the whole pool evaluated over the layer's tokens, no host
read), and every forward takes ``return_expert_load=``: True appends the
[E] f32 token-to-expert counts summed over the layers (None on a dense
config).  A dense config's program is the one it was, op for op.

LoRA fine-tuning rides ``matmul_maybe_q``'s adapter branch: a loraized
leaf ``{"w" | "q","s" | "q4","s", "a", "b", "scale"}`` is sliced per
layer like any other dict leaf (``ops.lora``).

Pipeline stages: under a mesh with a ``pp`` axis of more than one stage,
``params["layers"]``, KV storage and the adapter pool are
``parallel.mesh.Staged``, one part a stage (its layer slab, laid over the
other axes on ``mesh.submesh(pp=p)``), and every forward the batchers
call walks the stages in order (:func:`_stage_walk`): layer l runs on its
stage's device(s) and reads its stage's slab, and the activation moves at
each stage boundary.  :func:`forward_pipelined` runs the no-cache forward
as the GPipe wavefront over microbatches (``parallel.pipeline``), and
:func:`forward_pp_decode` / :func:`forward_paged_decode_pp` run a decode
step that way over dense rows and the paged pool: stage s decodes
row-microbatch t - s at tick t, each (stage, microbatch) once, composed
with the tp shards and sp stripes of each stage.  A layer count the
stages do not divide runs as pp = 1 (:func:`serving_mesh`).

Expert parallelism: under a mesh with an ``ep`` axis (an ``n_experts``
config whose expert count the axis divides), params laid out by
``parallel.mesh.shard_params`` hold each MoE layer's expert stacks as
``ops.experts.ExpertBlocks``, one block of ``E/ep`` experts an ep shard
on its device, and :func:`_attn_ffn` runs the sharded mixture
(``ops.experts.moe_ffn_shard``: routing once, each shard's partial on its
device, the partials summed on x's device in shard order), in every
forward the batchers call and in the staged stage bodies alike, with
``return_expert_load`` as before.  Everything else of a forward, and the
KV storage, lies on the mesh's ep = 0 row.  A count the axis does not
divide runs the pool whole (:func:`serving_mesh`).
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
from ..ops.experts import (ExpertBlocks, expert_fallback_reason,
                           moe_ffn_shard)
from ..ops.lora import adapter_delta
from ..ops.attention import (NEG_INF, attention, expand_kv, on_card,
                             paged_gather, paged_decode_attention,
                             sp_striped_paged_decode_attention,
                             striped_local_view, tp_degree)
from ..ops.quant import matmul_maybe_q as _mm
from ..parallel.mesh import (Staged, shard_device, stage_meshes,
                             tp_compute_tree, without_ep)

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
    #: mixture of experts: ``n_experts`` > 0 swaps every layer's dense
    #: w_gate/w_up/w_down for a routed pool (router [d, E], moe_gate/up
    #: [E, d, f], moe_down [E, f, d]) of which each token takes
    #: ``moe_top_k``; layer l routes iff ``l % moe_every == 0``, the
    #: others run expert 0 as their dense FFN.  0 = the dense FFN
    n_experts: int = 0
    moe_top_k: int = 1
    moe_every: int = 1

    def __post_init__(self):
        if self.window is not None and self.window < 1:
            raise ValueError("window must be None or >= 1")
        if self.attn_kernel not in ATTN_KERNELS:
            raise ValueError(f"attn_kernel must be one of {ATTN_KERNELS}, "
                             f"got {self.attn_kernel!r}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {self.kv_dtype!r}")
        if self.n_experts < 0:
            raise ValueError(f"n_experts must be >= 0, "
                             f"got {self.n_experts}")
        if self.n_experts:
            if not 1 <= self.moe_top_k <= self.n_experts:
                raise ValueError(
                    f"moe_top_k must be in [1, n_experts={self.n_experts}], "
                    f"got {self.moe_top_k}")
            if self.moe_every < 1:
                raise ValueError(f"moe_every must be >= 1, "
                                 f"got {self.moe_every}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def wants_rolling(cfg: ModelConfig) -> bool:
    """A sliding-window config whose window is smaller than its context:
    the paged batcher holds such a sequence in a ring of pages."""
    return cfg.window is not None and cfg.window < cfg.max_seq


def mistral_7b() -> ModelConfig:
    """Mistral-7B architecture: GQA 8 kv-heads, SwiGLU ff 14336, sliding
    window 4096 over a 32k context."""
    return ModelConfig(vocab=32000, d_model=4096, n_layers=32, n_heads=32,
                       n_kv_heads=8, d_ff=14336, max_seq=32768,
                       rope_theta=1e4, window=4096)


def llama2_7b() -> ModelConfig:
    """Llama-2-7B architecture: full multi-head attention (32 kv heads),
    SwiGLU ff 11008, a 4k context (the reference's ``ModelConfig()``)."""
    return ModelConfig()


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
# Tensor parallelism (the mesh's tp axis)
# ---------------------------------------------------------------------------
#: the Megatron split: column-parallel projections take a block of their
#: output dim (activations stay shard-local after them), row-parallel ones
#: a block of their input dim (their partial products are summed)
TP_COL_LEAVES = ("wq", "wk", "wv", "w_gate", "w_up")
TP_ROW_LEAVES = ("wo", "w_down")


def tp_splits(layers, cfg: ModelConfig, tp: int) -> bool:
    """Does the model take the Megatron split over ``tp`` shards?  tp > 1
    dividing both head counts (whole GQA groups a shard) and both
    feature dims (so d_out of every column leaf), and the packed-row dim
    ``group/2`` of every int4 row leaf, which its split cuts
    (``parallel.mesh.shard_params``); an int8 leaf splits wherever a
    plain one does.  ``layers``: the stacked layer leaves, or
    ``shard_params``' tuple of shard trees."""
    if tp <= 1:
        return False
    if (cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_model % tp
            or cfg.d_ff % tp):
        return False
    while isinstance(layers, tuple):     # a stage's part, a tp shard's tree
        layers = layers[0]
    for name, d_in in (("wo", cfg.d_model), ("w_down", cfg.d_ff)):
        w = layers.get(name)
        # the whole s [L, g, 1, d_out] gives the group count on any layout
        if isinstance(w, dict) and "q4" in w and (
                d_in // (2 * w["s"].shape[-3])) % tp:
            return False
    return True


def local_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """One tp shard's view of the config: H/tp and Hkv/tp heads at the
    same head dim (d_model scales along); every other field as it is."""
    if tp <= 1:
        return cfg
    return dataclasses.replace(cfg, d_model=cfg.d_model // tp,
                               n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp)


def serving_mesh(mesh, cfg: ModelConfig, layers):
    """The mesh ``cfg``'s model runs on: ``mesh`` itself where the model
    takes the tp split (:func:`tp_splits`) or the mesh has no tp axis,
    else the mesh's tp = 0 row, the model run as tp = 1 on the first
    device with its KV storage whole there (None when no axis remains).
    Likewise a ``pp`` axis whose stage count does not divide the layers
    (the ``pp_layers`` gate) is dropped: the model runs as pp = 1 on the
    mesh's pp = 0 row, the values the reference's replication gives.
    An ``ep`` axis stays where the gate admits it (an ``n_experts``
    config whose expert count it divides,
    ``ops.experts.expert_fallback_reason``); otherwise the model runs on
    the mesh's ep = 0 row with its pool whole.  The batchers lay their
    storage out on this mesh."""
    ep = tp_degree(mesh, "ep")
    if ep > 1 and (not getattr(cfg, "n_experts", 0)
                   or expert_fallback_reason(cfg.n_experts, ep)):
        mesh = without_ep(mesh)
    pp = tp_degree(mesh, "pp")
    if pp > 1 and cfg.n_layers % pp:
        mesh = mesh.submesh(pp=0)
        if not mesh.axis_names:
            return None
    tp = tp_degree(mesh)
    if tp > 1 and not tp_splits(layers, cfg, tp):
        sub = mesh.submesh(tp=0)
        return sub if sub.axis_names else None
    return mesh


def _first_tree(layers) -> Dict:
    """The first layer tree of a placed ``params["layers"]`` (stage 0's,
    tp shard 0's), or the stacked tree itself."""
    while isinstance(layers, tuple):
        layers = layers[0]
    return layers


def _tp_setup(params, cfg: ModelConfig, mesh):
    """(mesh, tp, the shard config) a forward runs with: the serving mesh
    of ``mesh`` without its ep axis (the expert blocks carry their
    devices; the rest runs on the ep = 0 row), its tp degree and
    :func:`local_cfg`.  Under tp, pp or ep > 1 the params must be
    ``shard_params``' layout."""
    mesh = serving_mesh(mesh, cfg, params["layers"])
    tp = tp_degree(mesh)
    staged = isinstance(params["layers"], Staged)
    if (tp_degree(mesh, "pp") > 1) != staged or (
            tp > 1 and not isinstance(params["layers"], tuple)) or (
            tp_degree(mesh, "ep") > 1 and not isinstance(
                _first_tree(params["layers"])["moe_gate"], ExpertBlocks)):
        raise ValueError("under a tp, pp or ep mesh the params must be laid "
                         "out by parallel.mesh.shard_params on that mesh")
    return without_ep(mesh), tp, local_cfg(cfg, tp)


def _to(x, dev):
    """A tensor, or a tuple of them, on ``dev`` (itself where it lies)."""
    if isinstance(x, tuple):
        return tuple(_to(v, dev) for v in x)
    return x.to(dev)


def _per_shard(x, mesh, tp: int) -> List:
    """``x`` on each tp shard's device of ``mesh`` (a stage's mesh: its
    shards' devices): ``[x]`` without a mesh."""
    if mesh is None:
        return [x]
    return [_to(x, shard_device(mesh, tp=t)) for t in range(tp)]


def _stage_walk(params, mesh, *trees) -> List[Tuple]:
    """The pipeline stages a forward walks, in order: ``[(the stage's
    mesh, its part of params["layers"], its part of each of trees)]``.
    Under a ``pp`` axis of more than one stage each of ``trees`` (KV
    storage, the adapter pool; None passes through) is a
    ``parallel.mesh.Staged`` like the layers, and a stage's mesh is
    ``mesh.submesh(pp=p)``, its tp shards and sp stripes; otherwise one
    stage holds everything, on ``mesh``."""
    pp = tp_degree(mesh, "pp")
    if pp == 1:
        return [(mesh, params["layers"], *trees)]
    for t in (params["layers"], *trees):
        if t is not None and not (isinstance(t, Staged) and len(t) == pp):
            raise ValueError(f"under a {pp}-stage mesh the layers, KV "
                             f"storage and adapter pool are laid out by "
                             f"stage (parallel.mesh)")
    return [(mesh.submesh(pp=p), params["layers"][p],
             *(None if t is None else t[p] for t in trees))
            for p in range(pp)]


def _stage_device(mesh, x) -> torch.device:
    """Where a stage's dense part runs: its mesh's first device (``x``'s
    without a mesh)."""
    return x.device if mesh is None else mesh.device()


def _rows(tree, rows: slice):
    """Rows ``rows`` (dim 0) of every tensor of a tuple tree; None
    passes."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(_rows(t, rows) for t in tree)
    return tree[rows]


def _shard_meshes(mesh, tp: int) -> List:
    """Each tp shard's own mesh, its sp stripes: ``[mesh]`` at tp = 1."""
    if tp == 1:
        return [mesh]
    return [mesh.submesh(tp=t) for t in range(tp)]


def _tp_sum(parts, x):
    """The row-parallel partial products summed on ``x``'s device, in
    ``x``'s dtype (the JAX package's ``psum``): one part is returned as
    it is, the tp = 1 program; several f32 parts are added in f32 and
    rounded once."""
    if len(parts) == 1:
        return parts[0]
    acc = parts[0].to(x.device)
    for p in parts[1:]:
        acc = acc + p.to(x.device)
    return acc.to(x.dtype)


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
    bits=quantize_bits)`` bit for bit.

    An ``n_experts`` config draws the reference's MoE leaves in place of
    the dense FFN's: ``router`` [L, d, E], ``moe_gate``/``moe_up``
    [L, E, d, f], ``moe_down`` [L, E, f, d] and ``moe_route`` [L] f32
    (1.0 where ``l % moe_every == 0``).  They stay in ``cfg.dtype`` under
    ``quantize_bits``, as ``quantize_params`` leaves them."""
    if quantize_bits not in (0, 4, 8):
        raise ValueError(f"quantize_bits must be 0, 4 or 8, got "
                         f"{quantize_bits}")
    dev = default_device(device)
    # the meta device (shapes alone, the cost plane's check) has no
    # generator of its own; a CPU one draws nothing there
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev
                          ).manual_seed(int(seed))
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

    def plain_stacked(fan_in, shape):
        out = torch.empty((L, *shape), dtype=cfg.dtype, device=dev)
        for l in range(L):
            out[l] = normal(fan_in, shape)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    layers = {
        "attn_scale": ones(L, d),
        "wq": stacked(d, (d, d)),
        "wk": stacked(d, (d, kvd)),
        "wv": stacked(d, (d, kvd)),
        "wo": stacked(d, (d, d)),
        "ffn_scale": ones(L, d),
    }
    e, f = cfg.n_experts, cfg.d_ff
    if e:
        layers.update({
            "router": plain_stacked(d, (d, e)),
            "moe_gate": plain_stacked(d, (e, d, f)),
            "moe_up": plain_stacked(d, (e, d, f)),
            "moe_down": plain_stacked(f, (e, f, d)),
            "moe_route": (torch.arange(L, device=dev) % cfg.moe_every
                          == 0).float()})
    else:
        layers.update({
            "w_gate": stacked(d, (d, f)),
            "w_up": stacked(d, (d, f)),
            "w_down": stacked(f, (f, d))})
    return {"embed": normal(d, (cfg.vocab, d)), "layers": layers,
            "final_scale": ones(d),
            "lm_head": leaf(normal(d, (d, cfg.vocab)))}


def param_count(params) -> int:
    """Elements over every tensor leaf (a quantized leaf's values and
    scales both count, as in the JAX package)."""
    return sum(t.numel() for t in quant.tensor_leaves(params))


def _layers(params, tp: int = 1) -> List:
    """Per-layer views of the stacked ``[L, ...]`` leaves, taken with one
    ``torch.unbind`` per tensor (a quantized leaf's values and scales
    each): its backward is a single stack, where indexing ``v[l]`` would
    write a zero-filled ``[L, ...]`` gradient per layer and leaf.  On
    ``shard_params``' layout at tp > 1, a tuple of one view a shard per
    layer; at tp = 1 (a model the split does not fit) tree 0's views."""
    layers = params["layers"]
    if isinstance(layers, tuple):
        if tp > 1:
            per = [_layers({"layers": tp_compute_tree(tree, t)})
                   for t, tree in enumerate(layers)]
            return [tuple(views) for views in zip(*per)]
        layers = tp_compute_tree(layers[0], None)
    def unbind(v):
        if isinstance(v, ExpertBlocks):          # one block list a layer
            return [ExpertBlocks(bs) for bs in
                    zip(*(torch.unbind(b, 0) for b in v))]
        return torch.unbind(v, 0)

    cols = {k: ({s: unbind(t) for s, t in v.items()}
                if isinstance(v, dict) else unbind(v))
            for k, v in layers.items()}
    first = next(iter(cols.values()))
    n = len(next(iter(first.values())) if isinstance(first, dict)
            else first)
    return [{k: ({s: t[l] for s, t in c.items()} if isinstance(c, dict)
                 else c[l]) for k, c in cols.items()} for l in range(n)]


def _head_mm(x, w):
    """LM-head projection with f32-accumulated f32 logits: bf16 operands,
    never rounded through bf16 on the way out (near-tie argmaxes stay
    stable across prefill and decode).  Differentiable
    (``ops.quant.F32Matmul``).
    A quantized head is its product in x's dtype, scaled, then widened to
    f32, as in the JAX package."""
    x2 = x.reshape(-1, x.shape[-1])
    out = (_mm(x2, w).float() if isinstance(w, dict)
           else quant.F32Matmul.apply(x2, w))
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


# ---------------------------------------------------------------------------
# Multi-adapter LoRA serving plumbing
# ---------------------------------------------------------------------------
# ``lora`` threads as None (the pool-less program, op for op) or as one
# layer's ``({leaf: (a_rows [B, d_in, r], b_rows [B, r, d_out])},
# s_rows [B] f32)``: the rows of each batch row's adapter, gathered out of
# the stacked pool once a forward for every layer.
def _adapter_layers(adapters, adapter_ids, n_layers: int, dtype) -> List:
    """Each layer's ``lora`` operand of :func:`_mm_ad`: [None] * L without
    a pool; else every leaf's rows taken ONCE for all layers
    (``pool[leaf]["a"][:, ids]`` -> [L, B, d_in, r]) and the scales once,
    cast once to the activations' ``dtype`` (the cast the delta's scaling
    makes, the same values), then sliced by layer (views)."""
    if adapters is None:
        return [None] * n_layers
    if isinstance(adapters, tuple):
        # one pool a tp shard (``parallel.mesh.shard_adapter_pool``): a
        # list of one operand a shard per layer
        per = [_adapter_layers(a, adapter_ids, n_layers, dtype)
               for a in adapters]
        return [list(ops) for ops in zip(*per)]
    ids = adapter_ids.to(adapters["scale"].device).long()
    rows = {k: (v["a"][:, ids], v["b"][:, ids])
            for k, v in adapters.items() if k != "scale"}
    s_rows = adapters["scale"][ids].to(dtype)
    return [({k: (a[l], b[l]) for k, (a, b) in rows.items()}, s_rows)
            for l in range(n_layers)]


def _mm_ad(x, w, lora, name: str, partial: bool = False, block=None):
    """``matmul_maybe_q`` plus the per-row adapter delta when this leaf
    carries adapters: the one composition point (a quantized base stays
    inside ``_mm``, QLoRA-style).  ``partial``: a row-parallel tp
    shard's partial product (:func:`_partial_mm`), returned in f32 for
    :func:`_tp_sum`, its adapter delta added before the sum; ``block``
    ``(t, n, whole)``: shard t of n and the whole activation on its
    device, which an int4 row block reads (``x`` is the shard's own
    block of it, which the adapters read)."""
    if partial and isinstance(w, dict) and "a" in w:
        # a loraized base: its partial product, then its adapter delta in
        # f32 beside it
        base = {k: v for k, v in w.items() if k not in ("a", "b", "scale")}
        y = _partial_mm(x, base.get("w", base), block)
        ad = (x @ w["a"].to(x.dtype)) @ w["b"].to(x.dtype)
        y = y + (ad * w["scale"].to(x.dtype)).float()
    elif partial:
        y = _partial_mm(x, w, block)
    else:
        y = _mm(x, w)
    if lora is None:
        return y
    rows, s_rows = lora
    if name not in rows:
        return y
    a, b = rows[name]
    delta = adapter_delta(x, a, b, s_rows)
    return y + (delta.float() if partial else delta)


def _partial_mm(x, w, block=None):
    """A row-parallel shard's partial product in f32: a plain or int8
    block ``x @ w`` (on the card a bf16 product is one GEMM with f32
    output, ``ops.quant.F32Matmul``, so that the partials are
    rounded once, after their sum, as the whole GEMM rounds), int8 then
    times the whole ``s``; an int4 block ``ops.quant.q4matmul`` of the
    whole activation ``block[2]`` at ``row_block=block[:2]``."""
    if isinstance(w, dict) and "q4" in w:
        t, n, whole = block
        return quant.q4matmul(whole, w, row_block=(t, n))
    base, s = (w["q"], w["s"]) if isinstance(w, dict) else (w, None)
    y = quant.F32Matmul.apply(x.reshape(-1, x.shape[-1]),
                              base.to(x.dtype)).reshape(*x.shape[:-1],
                                                        base.shape[-1])
    return y if s is None else y * s


def _qkv(p, x, cfg: ModelConfig, tables, lora=None):
    """Project + RoPE (``tables`` from :func:`rope_tables`): x [B, S, d] ->
    q [B, H, S, D], k/v [B, Hkv, S, D]."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _mm_ad(x, p["wq"], lora, "wq").reshape(b, s, h, hd)
    k = _mm_ad(x, p["wk"], lora, "wk").reshape(b, s, hkv, hd)
    v = _mm_ad(x, p["wv"], lora, "wv").reshape(b, s, hkv, hd)
    q = rope(q, tables)
    k = rope(k, tables)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def cached_attention(q, kk, vv, positions, window: Optional[int] = None,
                     k_positions=None):
    """Masked attention of q [B, H, S, D] over a dense cache view kk/vv
    [B, Hkv, T, D] (Hkv dividing H; heads already expanded is Hkv = H).
    Key position == cache slot, or ``k_positions`` [T] / [B, T] (the
    rolling ring's slots hold data-dependent positions; negative entries
    are never-written slots); positions [B, S] mask causality and the
    unwritten tail (and the window).  GQA groups q's heads over their kv
    head (q head h reads kv head h // (H / Hkv), as ``expand_kv``
    repeats them) instead of copying K/V.  Scores and softmax in f32,
    the probabilities rounded to the cache dtype before PV.  (The JAX
    reference rounds the scores to the input dtype first; in f32 the two
    are the same, and in bf16 the f32 scores are what K2 computes.)  On
    the card, bf16 q and K go into one GEMM with f32 output, the exact
    products summed in f32, as a widened copy of K would give them."""
    b, h, s, hd = q.shape
    hkv, t = kk.shape[1], kk.shape[2]
    rep = h // hkv
    q_pos = positions[:, None, :, None]                        # [B,1,S,1]
    if k_positions is None:
        k_pos = torch.arange(t, device=q.device)[None, None, None, :]
    else:
        kp = k_positions.to(q.device)
        k_pos = (kp[None, None, None, :] if kp.dim() == 1
                 else kp[:, None, None, :])                    # [B,1,1,T]
    valid = (k_pos <= q_pos) & (k_pos >= 0)
    if window is not None:
        valid &= k_pos > q_pos - window
    qg = q.reshape(b * hkv, rep * s, hd)
    kt = kk.reshape(b * hkv, t, hd).transpose(1, 2)
    if q.is_cuda and q.dtype == kk.dtype and q.dtype != torch.float32:
        logits = torch.bmm(qg, kt, out_dtype=torch.float32)
    else:
        logits = torch.bmm(qg.float(), kt.float())
    logits = logits.div_(math.sqrt(hd)).view(b, hkv, rep, s, t)
    logits.masked_fill_(~valid[:, :, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(vv.dtype)
    out = torch.matmul(probs.view(b, hkv, rep * s, t), vv)
    return out.reshape(b, h, s, hd)


def ffn_block(p, x, lora=None):
    return _mm_ad(_ffn_hidden(p, x, lora), p["w_down"], lora, "w_down")


def _ffn_hidden(p, x, lora=None):
    """``silu(x @ w_gate) * (x @ w_up)``: the FFN's activation before
    ``w_down``."""
    g = _mm_ad(x, p["w_gate"], lora, "w_gate")
    u = _mm_ad(x, p["w_up"], lora, "w_up")
    return F.silu(g) * u


def _row_parts(xs, shards, loras, devs, name: str, split: bool) -> List:
    """Each tp shard's product of row-parallel leaf ``name`` from its own
    activation block ``xs[t]`` (its heads' o, its FFN columns), with its
    adapter delta: partial under a split.  An int4 row block holds rows
    of every group (``parallel.mesh.shard_params``), so its product reads
    the whole activation: the shards' blocks joined on shard t's device,
    the all-gather the reference's program makes."""
    parts = []
    for t, (x, lyr, lo, dev) in enumerate(zip(xs, shards, loras, devs)):
        with on_card(dev):
            w = lyr[name]
            block = None
            if split and isinstance(w, dict) and "q4" in w:
                block = (t, len(xs),
                         torch.cat([y.to(dev) for y in xs], dim=-1))
            parts.append(_mm_ad(x, w, lo, name, partial=split, block=block))
    return parts


def _attn_ffn(layer, x, cfg: ModelConfig, attend, lora=None):
    """THE pre-norm decoder layer: rmsnorm -> attend -> o-proj residual ->
    rmsnorm -> ffn residual.  ``attend(lyr, xin, lora, t) -> o [B, H, S,
    D]`` plugs in the cache flavor (none / dense / paged) and threads
    ``lora`` into :func:`_qkv` itself; ``lora`` (:func:`_mm_ad`) adds
    each row's adapter delta to the o-projection and the FFN.

    Tensor parallelism (the counterpart of the JAX package's
    ``_attn_ffn_shard``): ``layer`` is then a tuple of one layer view a
    tp shard and ``lora`` a list of one operand a shard.  Shard t's
    ``attend`` gets its view, its operand, ``xin`` on its device and its
    index, and returns its own heads' o; its ``wo`` rows and its FFN
    (``w_gate``/``w_up`` columns, ``w_down`` rows) give partial products,
    each with its adapter delta, that :func:`_tp_sum` adds on x's device
    (:func:`_row_parts`).  The norms run there once.  One layer view is
    the tp = 1 program, op for op.

    Returns ``(x, load)``: a layer with a ``router`` leaf (an
    ``n_experts`` config) runs its FFN through
    ``ops.experts.moe_ffn_shard`` once, routed on x's device (expert
    weights never tp-shard): the whole pool there, or with
    ``ExpertBlocks`` leaves (an ep mesh) each ep shard's experts on its
    device and the partials summed on x's; ``load`` is its [E] f32
    token-to-expert counts; a dense layer's ``load`` is None.  An MoE layer takes no FFN adapter delta: serving
    pools on such a config carry the attention targets only
    (``ops.lora.serving_adapter_dims``)."""
    split = isinstance(layer, tuple)
    shards = layer if split else (layer,)
    loras = (lora or [None] * len(shards)) if split else (lora,)
    devs = [_leaf_device(lyr["wo"]) if split else None for lyr in shards]
    b, s, _ = x.shape
    xin = rmsnorm(x, shards[0]["attn_scale"], cfg.norm_eps)
    os_ = []
    for t, (lyr, lo, dev) in enumerate(zip(shards, loras, devs)):
        with on_card(dev):
            o = attend(lyr, xin.to(dev) if split else xin, lo, t)
            os_.append(o.transpose(1, 2).reshape(b, s, -1))
    x = x + _tp_sum(_row_parts(os_, shards, loras, devs, "wo", split), x)
    xn = rmsnorm(x, shards[0]["ffn_scale"], cfg.norm_eps)
    if "router" in shards[0]:
        ep_axis = ("ep" if isinstance(shards[0]["moe_gate"], ExpertBlocks)
                   else None)
        y, load = moe_ffn_shard(xn, shards[0], cfg, ep_axis=ep_axis)
        return x + y, load
    hs = []
    for lyr, lo, dev in zip(shards, loras, devs):
        with on_card(dev):
            hs.append(_ffn_hidden(lyr, xn.to(dev) if split else xn, lo))
    return x + _tp_sum(_row_parts(hs, shards, loras, devs, "w_down",
                                  split), x), None


def _leaf_device(w) -> torch.device:
    """Where a weight leaf (a tensor or a weight dict) lies."""
    if isinstance(w, dict):
        w = next(w[k] for k in ("w", "q", "q4") if k in w)
    return w.device


def _sum_loads(loads):
    """The layers' [E] loads summed (None on a dense config)."""
    loads = [l for l in loads if l is not None]
    if not loads:
        return None
    # stages' loads on their devices, summed on the first
    return torch.stack([l.to(loads[0].device) for l in loads]).sum(dim=0)


def _embed(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens.long()].to(cfg.dtype)


def forward(params, tokens, cfg: ModelConfig, remat_policy=None,
            return_hidden: bool = False, kv_caches=None, cache_len=None,
            kv_write_len=None, adapters=None, adapter_ids=None,
            return_expert_load: bool = False, mesh=None,
            attention_fn=None):
    """tokens [B, S] -> logits [B, S, vocab] f32, no cache; differentiable
    (the training forward; serving callers wrap it in inference mode).
    Attention is :func:`tpushare_torch.ops.attention.attention`: K1
    forward and K3 + K4 backward on the card.

    ``remat_policy`` wraps each layer in ``torch.utils.checkpoint`` with
    that selective-checkpoint policy: the backward recomputes the layer
    but what the policy saves (``parallel.train.ATTN_SAVING_POLICY``:
    K1's out and lse, so the recompute skips the forward kernel).
    ``return_hidden`` returns the post-final-norm hidden states [B, S, d]
    instead of the logits (the chunked loss applies the head itself).

    With ``kv_caches`` (dense or rolling, :func:`init_kv_caches`) it is the
    cached step of :func:`forward_cached` and returns ``(logits,
    kv_caches)``, as the JAX ``forward`` does.  ``adapters`` /
    ``adapter_ids`` thread the serving adapter pool (:func:`_mm_ad`).
    ``return_expert_load`` appends the [E] f32 token-to-expert counts
    summed over the layers (None on a dense config) to what is returned,
    as the JAX ``forward`` does: ``(logits, load)``, or with
    ``kv_caches`` ``(logits, kv_caches, load)``.

    ``mesh`` with a tp axis (params from ``parallel.mesh.shard_params``):
    each tp shard attends over its own H/tp q heads and Hkv/tp kv heads,
    K1 once a shard and layer on the card (:func:`_attn_ffn`).

    ``attention_fn(q, k, v, causal=)`` (no-cache path only; the cached
    step ignores it, as the JAX package's does) replaces the attention:
    the long-context hook, e.g. ``functools.partial(parallel.ring.
    ring_attention, mesh=sp_mesh)`` for exact causal attention over
    sequence shards, or ``parallel.ulysses.ulysses_attention``.  It gets
    K/V expanded to q's heads; under a tp mesh each shard calls it on its
    own heads.  A sliding-window config raises."""
    if kv_caches is not None:
        return forward_cached(params, tokens, cfg, kv_caches,
                              0 if cache_len is None else cache_len,
                              kv_write_len=kv_write_len, adapters=adapters,
                              adapter_ids=adapter_ids,
                              return_expert_load=return_expert_load,
                              mesh=mesh)
    if attention_fn is not None and cfg.window is not None:
        raise ValueError("sliding-window configs are not supported by "
                         "custom attention_fn (ring/ulysses) yet")
    b, s = tokens.shape
    mesh, tp, lcfg = _tp_setup(params, cfg, mesh)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = _embed(params, tokens, cfg)
    loads = []
    for sub, stage, ads in _stage_walk(params, mesh, adapters):
        rots = _per_shard(tables, sub, tp)
        x = _to(x, _stage_device(sub, x))

        def body(x, lyr, lora, rots=rots):
            def attend(lyr, xin, lora, t):
                q, k, v = _qkv(lyr, xin, lcfg, rots[t], lora)
                if attention_fn is not None:
                    # ring/ulysses take equal head counts
                    n_rep = lcfg.n_heads // lcfg.n_kv_heads
                    return attention_fn(q, expand_kv(k, n_rep),
                                        expand_kv(v, n_rep), causal=True)
                return attention(q, k, v, causal=True, window=cfg.window)

            return _attn_ffn(lyr, x, cfg, attend, lora)

        layers = _layers({"layers": stage}, tp)
        loras = _adapter_layers(ads, adapter_ids, len(layers), cfg.dtype)
        with on_card(x.device):
            for lyr, lora in zip(layers, loras):
                if remat_policy is None:
                    x, load = body(x, lyr, lora)
                else:
                    x, load = checkpoint(
                        body, x, lyr, lora, use_reentrant=False,
                        context_fn=functools.partial(
                            create_selective_checkpoint_contexts,
                            remat_policy))
                loads.append(load)
    x = rmsnorm(_to(x, params["final_scale"].device), params["final_scale"],
                cfg.norm_eps)
    if return_hidden:
        return x
    logits = _head_mm(x, params["lm_head"])
    if return_expert_load:
        return logits, _sum_loads(loads)
    return logits


def forward_pipelined(params, tokens, cfg: ModelConfig, mesh,
                      n_micro: Optional[int] = None, axis_name: str = "pp"):
    """The no-cache :func:`forward` with the layer stack pipelined over the
    mesh's ``pp`` axis: the JAX package's ``forward_pipelined``.  The
    embedding runs on the mesh's first device, the batch splits into
    ``n_micro`` microbatches (default: the stage count; a ValueError when
    it does not divide the batch), ``parallel.pipeline.pipeline_apply``
    walks them through the stages' layer slabs (each stage's attention the
    port's :func:`~tpushare_torch.ops.attention.attention`: K1 on the
    card, once a (stage, microbatch, layer)), and the final norm and
    ``lm_head`` run on the first device.  ``params`` are the stacked
    tree, cut into stage slabs there (views on the params' device).
    Differentiable: K3 and K4 on the card in the backward."""
    from ..parallel.pipeline import pipeline_apply

    b, s = tokens.shape
    n_micro = n_micro or mesh.shape[axis_name]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible into {n_micro} "
                         f"microbatches")
    mb = b // n_micro
    positions = torch.arange(s, device=tokens.device)[None, :].expand(mb, s)
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    rots = {}                                   # the tables on each card

    def layer_fn(layer, x):
        rot = rots.setdefault(x.device, _to(tables, x.device))

        def attend(lyr, xin, lora, t):
            q, k, v = _qkv(lyr, xin, cfg, rot, lora)
            return attention(q, k, v, causal=True, window=cfg.window)

        with on_card(x.device):
            return _attn_ffn(layer, x, cfg, attend)[0]

    x = _embed(params, tokens, cfg)
    out = pipeline_apply(layer_fn, params["layers"],
                         x.reshape(n_micro, mb, s, cfg.d_model), mesh,
                         axis_name=axis_name)
    x = rmsnorm(out.reshape(b, s, cfg.d_model), params["final_scale"],
                cfg.norm_eps)
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


# ---------------------------------------------------------------------------
# Dense and rolling KV caches
# ---------------------------------------------------------------------------
def init_kv_caches(cfg: ModelConfig, batch: int, rolling: bool = False,
                   ring_slack: int = 0, device=None, mesh=None) -> Tuple:
    """Stacked KV cache: a (k, v) pair of zeroed [L, B, Hkv, T, D] stores
    with T = max_seq, or for a ROLLING ring (sliding-window configs only)
    T = min(window + ring_slack, max_seq): position p lives in slot
    p % T, so a slot costs O(window), not O(max_seq).  ``ring_slack``
    adds ring slots beyond the window.  ``cfg.kv_dtype="int8"`` makes
    each store an int8 {"q","s"} pair (:func:`_kv_store_zeros`).

    Under a ``mesh`` with a tp axis of size > 1, one such pair a tp shard,
    of its Hkv/tp kv heads, allocated on its device (the layout of
    ``parallel.mesh.shard_kv_storage(axis="tp")``, with no whole-size
    transient); dense rows take no sp axis.  Under a ``pp`` axis of more
    than one stage, a ``parallel.mesh.Staged`` of one such layout a stage,
    of its layers, allocated on the stage's mesh.  An ep axis adds
    nothing: the storage lies on its ep = 0 row."""
    mesh = without_ep(mesh)
    stages = stage_meshes(mesh, cfg.n_layers)
    if stages is not None:
        return Staged(init_kv_caches(
            dataclasses.replace(cfg, n_layers=b - a), batch, rolling=rolling,
            ring_slack=ring_slack, device=sub.device(), mesh=sub)
            for _, (a, b), sub in stages)
    tp = tp_degree(mesh)
    if tp_degree(mesh, "sp") > 1:
        raise ValueError("dense and rolling rows take no sp axis (position "
                         "striping is a paged-pool feature)")
    if tp > 1:
        lc = _kv_shard_cfg(cfg, tp)
        return tuple(init_kv_caches(lc, batch, rolling=rolling,
                                    ring_slack=ring_slack,
                                    device=mesh.device(tp=t))
                     for t in range(tp))
    if rolling:
        if cfg.window is None:
            raise ValueError("rolling caches need a sliding-window cfg")
        t = min(cfg.window + max(0, int(ring_slack)), cfg.max_seq)
    else:
        t = cfg.max_seq
    dev = default_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, t, cfg.head_dim)
    return (_kv_store_zeros(shape, cfg, dev), _kv_store_zeros(shape, cfg, dev))


def _kv_shard_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config of one tp shard's KV storage: Hkv/tp kv heads, whole
    GQA groups, else a ValueError (lay such a model's storage out on
    :func:`serving_mesh`, which keeps it whole)."""
    if cfg.n_kv_heads % tp or cfg.n_heads % tp:
        raise ValueError(f"{tp} tp shards do not split {cfg.n_heads} q and "
                         f"{cfg.n_kv_heads} kv heads into whole GQA groups")
    return local_cfg(cfg, tp)


def _kv_map(f, store):
    """``f`` applied to every tensor of a store, the same kind back."""
    if isinstance(store, dict):
        return {k: f(v) for k, v in store.items()}
    return f(store)


def kv_tree_map(f, tree):
    """``f`` applied to every tensor of KV storage: a store, a ``(k, v)``
    pair, a tuple of one pair a shard, or a ``Staged`` of one of those a
    stage; the same nesting (and kind of tuple) back."""
    if isinstance(tree, tuple):
        return type(tree)(kv_tree_map(f, x) for x in tree)
    return _kv_map(f, tree)


def kv_tree_leaves(tree) -> List[torch.Tensor]:
    """Every tensor of KV storage, in :func:`kv_tree_map`'s order."""
    if isinstance(tree, tuple):
        return [t for x in tree for t in kv_tree_leaves(x)]
    return _kv_leaves(tree)


def _rows_of(x, b: int, device) -> torch.Tensor:
    """A scalar or [B] integer (python or tensor) as an int64 [B] tensor
    (a python int is filled on the device: no blocking host copy)."""
    if isinstance(x, int):
        return torch.full((b,), x, dtype=torch.long, device=device)
    t = torch.as_tensor(x, device=device).long()
    return t.expand(b) if t.dim() == 0 else t


def _attend_dense(q, k, v, cfg: ModelConfig, positions, ck, cv, cache_len,
                  kv_write_len=None, key_bound: Optional[int] = None):
    """One layer's attention over its dense or rolling cache stores ck/cv
    ([B, Hkv, T, D], or int8 {"q","s"}), which take this step's K/V in
    place; returns o [B, H, S, D].  ``cache_len`` [B] int64 is each row's
    first position.  The JAX package's ``_attend_dense`` with its scalar
    and vector ``cache_len`` arms as one (a scalar broadcasts to every
    row, the same values).

    Full-size (T == max_seq): the S keys land at ``cache_len`` (the start
    clamped into [0, T - S], as ``dynamic_update_slice`` clamps, so a
    step past a finished request's end stays in the row), then the
    queries read the first ``key_bound`` slots (default T; positions past
    every query are masked anyway, so a bound that covers them changes
    no value).

    Rolling (T < max_seq, slot = position % T):
    - S = 1: commit, then attend the ring; the one key evicted is
      outside the new query's window;
    - S > 1: attend the PRE-chunk ring plus the chunk's own keys in their
      unpacked storage form (a position reads the same number now and
      from the ring later), then commit per ring slot the latest real
      chunk offset mapping to it; ``kv_write_len`` (int or [B]) marks the
      real tokens, and a padded tail is never committed (it would wrap
      onto keys still in the window).

    Ring positions divide negative numbers: floor division and floor
    modulo throughout, as in JAX."""
    ring = _kv_leaf(ck).shape[2]
    b, _, s_new, _ = k.shape
    dev = k.device
    # the storage form of the fresh K/V: int8 quantizes ONCE here
    k_st, v_st = _kv_pack(k, cfg), _kv_pack(v, cfg)
    pairs = ((ck, k_st), (cv, v_st))
    if ring >= cfg.max_seq:
        start = cache_len.clamp(0, ring - s_new)
        idx = start[:, None] + torch.arange(s_new, device=dev)[None, :]
        for store, new in pairs:
            for leaf, part in zip(_kv_leaves(store), _kv_leaves(new)):
                leaf.scatter_(2, idx[:, None, :, None].expand(
                    b, leaf.shape[1], s_new, leaf.shape[3]), part)
        kb = ring if key_bound is None else max(1, min(ring, key_bound))
        view_k = _kv_unpack(_kv_map(lambda t: t[:, :, :kb], ck), cfg)
        view_v = _kv_unpack(_kv_map(lambda t: t[:, :, :kb], cv), cfg)
        return cached_attention(q, view_k, view_v, positions,
                                window=cfg.window)

    if cfg.window > ring:
        raise ValueError(f"rolling cache of {ring} slots cannot hold a "
                         f"window of {cfg.window}")
    r = torch.arange(ring, device=dev)[None, :]                 # [1, W]
    if s_new == 1:
        slot = torch.remainder(cache_len, ring)
        for store, new in pairs:
            for leaf, part in zip(_kv_leaves(store), _kv_leaves(new)):
                leaf[torch.arange(b, device=dev), :, slot] = part[:, :, 0]
        l_end = cache_len[:, None] + 1
        k_pos = r + ring * torch.div(l_end - 1 - r, ring,
                                     rounding_mode="floor")      # [B, W]
        return cached_attention(q, _kv_unpack(ck, cfg), _kv_unpack(cv, cfg),
                                positions, window=cfg.window,
                                k_positions=k_pos)
    nv = (torch.full((b, 1), s_new, device=dev, dtype=torch.long)
          if kv_write_len is None
          else _rows_of(kv_write_len, b, dev)[:, None])         # [B, 1]
    cl = cache_len[:, None]
    ring_pos = r + ring * torch.div(cl - 1 - r, ring, rounding_mode="floor")
    new_pos = cl + torch.arange(s_new, device=dev)[None, :]
    k_pos = torch.cat([ring_pos, new_pos], dim=1)               # [B, W+S]
    o = cached_attention(
        q, torch.cat([_kv_unpack(ck, cfg), _kv_unpack(k_st, cfg)], dim=2),
        torch.cat([_kv_unpack(cv, cfg), _kv_unpack(v_st, cfg)], dim=2),
        positions,
        window=cfg.window, k_positions=k_pos)
    # commit: ring slot r takes chunk offset a + W*floor((nv-1-a)/W), the
    # latest real offset mapping to it, where a = (r - cache_len) mod W is
    # the first; slots no real offset reaches keep their key
    a = torch.remainder(r - cl, ring)                           # [B, W]
    j_r = (a + ring * torch.div(nv - 1 - a, ring, rounding_mode="floor")
           ).clamp(0, s_new - 1)
    write = (a < nv)[:, None, :, None]
    for store, new in pairs:
        for leaf, part in zip(_kv_leaves(store), _kv_leaves(new)):
            sel = part.gather(2, j_r[:, None, :, None].expand(
                b, part.shape[1], ring, part.shape[3]))
            leaf.copy_(torch.where(write, sel, leaf))
    return o


@torch.inference_mode()
def forward_cached(params, tokens, cfg: ModelConfig, kv_caches, cache_len,
                   kv_write_len=None, key_bound: Optional[int] = None,
                   adapters=None, adapter_ids=None,
                   return_expert_load: bool = False, mesh=None):
    """tokens [B, S] through a dense or rolling cache (from
    :func:`init_kv_caches`) at ``cache_len`` (int, or [B] per row): the
    S positions' K/V are written into ``kv_caches`` in place (see
    :func:`_attend_dense`).  Returns (logits [B, S, vocab] f32,
    kv_caches).  ``key_bound`` caps the slots a full-size cache's read
    covers; by default an int ``cache_len``'s ``cache_len + S``.
    ``return_expert_load`` appends the summed [E] expert load.  Under a
    ``mesh`` with a tp axis the caches hold one pair a tp shard, each
    read and written by its own shard."""
    b, s = tokens.shape
    dev = tokens.device
    mesh, tp, lcfg = _tp_setup(params, cfg, mesh)
    if key_bound is None and isinstance(cache_len, int):
        key_bound = cache_len + s
    cl = _rows_of(cache_len, b, dev)
    positions = cl[:, None] + torch.arange(s, device=dev)[None, :]
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = _embed(params, tokens, cfg)
    loads = []
    for sub, layers, caches, ads in _stage_walk(params, mesh, kv_caches,
                                                adapters):
        x = _cached_stage(x, layers, caches, ads, adapter_ids, sub, tp, cfg,
                          lcfg, positions, tables, cl, kv_write_len,
                          key_bound, loads)
    x = rmsnorm(_to(x, dev), params["final_scale"], cfg.norm_eps)
    logits = _head_mm(x, params["lm_head"])
    if return_expert_load:
        return logits, kv_caches, _sum_loads(loads)
    return logits, kv_caches


def _cached_stage(x, layers, caches, ads, adapter_ids, mesh, tp: int,
                  cfg: ModelConfig, lcfg: ModelConfig, positions, tables, cl,
                  kv_write_len, key_bound, loads: List):
    """One stage's layers of the cached step over rows x [R, S, d]: THE
    body of :func:`forward_cached` (every row) and of
    :func:`forward_pp_decode` (a microbatch's rows, views of the stage's
    caches).  ``layers``, ``caches`` and ``ads`` are the stage's parts on
    its mesh ``mesh``; positions [R, S], ``tables`` (:func:`rope_tables`)
    and ``cl`` [R] are the rows' own.  Appends each layer's expert load to
    ``loads``; returns x on the stage's device."""
    x = _to(x, _stage_device(mesh, x))
    rots = _per_shard(tables, mesh, tp)
    shard_caches = list(caches) if tp > 1 else [caches]
    poss, cls = _per_shard(positions, mesh, tp), _per_shard(cl, mesh, tp)
    kwls = (_per_shard(kv_write_len, mesh, tp)
            if isinstance(kv_write_len, torch.Tensor)
            else [kv_write_len] * tp)
    views = _layers({"layers": layers}, tp)
    loras = _adapter_layers(ads, adapter_ids, len(views), cfg.dtype)
    with on_card(x.device):
        for l, (layer, lora) in enumerate(zip(views, loras)):
            def attend(lyr, xin, lora, t, l=l):
                q, k, v = _qkv(lyr, xin, lcfg, rots[t], lora)
                ck, cv = shard_caches[t]
                return _attend_dense(q, k, v, lcfg, poss[t],
                                     _kv_layer(ck, l), _kv_layer(cv, l),
                                     cls[t], kwls[t], key_bound)

            x, load = _attn_ffn(layer, x, cfg, attend, lora)
            loads.append(load)
    return x


def _microbatches(mesh, b: int, n_micro: Optional[int]) -> Tuple[int, int]:
    """(n_micro, rows a microbatch) of a staged step over ``b`` rows:
    ``n_micro`` defaults to the stage count and must divide ``b``."""
    n_stages = tp_degree(mesh, "pp")
    if n_stages < 2:
        raise ValueError("a staged step needs a mesh with a pp axis of two "
                         "or more stages")
    n_micro = n_micro or n_stages
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible into {n_micro} "
                         f"microbatches")
    return n_micro, b // n_micro


def _wavefront(run, x, stages: List[Tuple], n_micro: int, mb: int):
    """The GPipe wavefront of a staged step over x's rows
    (``parallel.pipeline.walk_wavefront``): ``run(stage, rows, x_rows)
    -> y`` once a (stage, microbatch) cell, microbatch m being rows
    ``[m*mb, (m+1)*mb)``, stage 0 fed those rows of x; no bubble cell
    runs or writes.  The last stage's outputs come back on x's device in
    row order."""
    from ..parallel.pipeline import walk_wavefront

    def rows(m):
        return slice(m * mb, (m + 1) * mb)

    outs = walk_wavefront(lambda st, m, xm: run(st, rows(m), xm),
                          lambda m: x[rows(m)],
                          [_stage_device(st[0], x) for st in stages],
                          n_micro)
    return torch.cat([_to(y, x.device) for y in outs], dim=0)


@torch.inference_mode()
def forward_pp_decode(params, tokens, cfg: ModelConfig, kv_caches, cache_len,
                      mesh, n_micro: Optional[int] = None,
                      key_bound: Optional[int] = None, adapters=None,
                      adapter_ids=None):
    """One MICROBATCHED decode step over pipeline stages on dense
    full-size caches (the ``pp_storage`` gate refuses rolling rows): the
    JAX package's ``forward_pp_decode``, with :func:`forward_cached`'s
    signature and return, (logits [B, S, vocab] f32, kv_caches).

    Under a mesh with a ``pp`` axis of two or more stages (params, caches
    and adapter pool laid out by stage, ``parallel.mesh``), the rows split
    into ``n_micro`` microbatches of B / n_micro (default n_micro = pp; a
    ValueError when it does not divide B) and the GPipe wavefront runs
    (:func:`_wavefront`): stage s decodes microbatch t - s at tick t over
    views of its cache slab's rows (dim 1), so writes land in the pool,
    each (stage, microbatch) once.  A stage's body is
    :func:`forward_cached`'s (:func:`_cached_stage`), with its tp shards.
    Microbatching is row-local: the values are the flat step's, up to the
    smaller GEMMs' rounding.  Per-layer expert load is not kept, as in the
    reference."""
    b, s = tokens.shape
    dev = tokens.device
    mesh, tp, lcfg = _tp_setup(params, cfg, mesh)
    n_micro, mb = _microbatches(mesh, b, n_micro)
    if key_bound is None and isinstance(cache_len, int):
        key_bound = cache_len + s
    cl = _rows_of(cache_len, b, dev)
    positions = cl[:, None] + torch.arange(s, device=dev)[None, :]
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    stages = _stage_walk(params, mesh, kv_caches, adapters)

    def run(st, rows, x):
        sub, layers, caches, ads = stages[st]
        return _cached_stage(
            x, layers, kv_tree_map(lambda t: t[:, rows], caches), ads,
            _rows(adapter_ids, rows), sub, tp, cfg, lcfg, positions[rows],
            _rows(tables, rows), cl[rows], None, key_bound, [])

    x = _wavefront(run, _embed(params, tokens, cfg), stages, n_micro, mb)
    x = rmsnorm(x, params["final_scale"], cfg.norm_eps)
    return _head_mm(x, params["lm_head"]), kv_caches


def init_paged_kv(cfg: ModelConfig, n_pages: int, page_size: int,
                  device=None, mesh=None) -> Tuple:
    """Paged KV pool: a (k, v) pair of zeroed [L, n_pages, Hkv, page, D]
    stores (cfg.dtype tensors, or int8 {"q","s"} stores under
    ``kv_dtype="int8"``: the same page geometry at about half the bytes).
    Page 0 is the TRASH page: unowned table entries and inactive slots
    point at it, and the position mask keeps it out of every softmax.

    Under a ``mesh`` with ``sp`` and/or ``tp`` axes of more than one
    shard, one such pair a shard of the mesh, in its row-major order,
    allocated on that shard's device (the layout of
    ``parallel.mesh.shard_kv_storage``, with no full-size transient):
    shard (t, s) holds ``[L, n_pages / sp, Hkv / tp, page, D]``, stripe s
    of tp shard t's kv heads.  Under a ``pp`` axis of more than one
    stage, a ``parallel.mesh.Staged`` of one such pool a stage, of its
    layers, allocated on the stage's mesh: page ids, and so the page
    tables, are the same on every stage.  An ep axis adds nothing: the
    pool lies on its ep = 0 row."""
    mesh = without_ep(mesh)
    stages = stage_meshes(mesh, cfg.n_layers)
    if stages is not None:
        return Staged(init_paged_kv(dataclasses.replace(cfg, n_layers=b - a),
                                    n_pages, page_size, device=sub.device(),
                                    mesh=sub)
                      for _, (a, b), sub in stages)
    sp, tp = tp_degree(mesh, "sp"), tp_degree(mesh)
    if sp * tp > 1:
        if n_pages % sp:
            raise ValueError(f"{n_pages} pages do not split into {sp} "
                             f"equal position stripes")
        lc = _kv_shard_cfg(cfg, tp) if tp > 1 else cfg
        return tuple(init_paged_kv(lc, n_pages // sp, page_size, device=d)
                     for d in mesh.devices)
    dev = default_device(device)
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    return (_kv_store_zeros(shape, cfg, dev), _kv_store_zeros(shape, cfg, dev))


def paged_read_transient_bytes(cfg: ModelConfig, rows: int,
                               attn_kernel: Optional[str] = None) -> int:
    """The bytes the gather read materializes a layer for one paged read
    over ``rows`` table rows: the K and V dense views, [rows, H, max_seq,
    D] in cfg.dtype (full q-head width: the view is expanded to q's heads
    before :func:`cached_attention`; the compute dtype: an int8 pool's
    view is dequantized whole first).  0 under K2 (``"kernel"``: pages
    stream through the kernel).  ``attn_kernel`` names the read path
    when it is not ``cfg.attn_kernel``.  The reference's function of the
    same name, priced by the cost plane (``analysis.costmodel``)."""
    if (attn_kernel or cfg.attn_kernel) == "kernel":
        return 0
    item = torch.empty((), dtype=cfg.dtype).element_size()
    return int(2 * rows * cfg.n_heads * cfg.max_seq * cfg.head_dim * item)


def _pool_stripes(pools, mesh=None) -> List[Tuple]:
    """The ``(k, v)`` store pairs of a pool (of one stage's, under pp):
    one, or one a shard of the mesh in its row-major order (stripes of tp
    shard t at ``[t*sp, (t+1)*sp)``)."""
    return list(pools) if isinstance(pools[0], tuple) else [pools]


def pool_page_size(pools) -> int:
    """The page size of a paged pool, whatever its layout."""
    store = pools
    while isinstance(store, tuple):
        store = store[0]
    return _kv_leaf(store).shape[3]


def _stripe_page_ids(page_ids, stripes, mesh) -> List[torch.Tensor]:
    """Global page ids [N] -> each shard's local ids on its device:
    page p belongs to stripe ``p // per`` at local page ``p % per``; on
    the other stripes the row writes that stripe's trash page 0, so every
    stripe writes every row and no host sync decides who owns what.
    Every tp shard's stripe s takes stripe s's ids."""
    if len(stripes) == 1:
        return [page_ids.to(_kv_leaf(stripes[0][0]).device)]
    sp = tp_degree(mesh, "sp")
    per = _kv_leaf(stripes[0][0]).shape[1]
    out = []
    for i, dev in enumerate(mesh.devices):
        ids = page_ids.to(dev)
        out.append(torch.where(ids // per == i % sp, ids % per, 0)
                   if sp > 1 else ids)
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
                         page_table, lengths, mesh=None, adapters=None,
                         adapter_ids=None, return_expert_load: bool = False):
    """One decode step for every slot against the paged pool.

    tokens [B, 1]; pools from :func:`init_paged_kv` (striped under
    ``mesh``); page_table [B, max_seq // page] int32 (logical page order,
    0-padded, global page ids); lengths [B] int32.  Each slot's new K/V
    lands at logical position ``length`` (page length // P, lane
    length % P) in place, before the read.  Returns (logits [B, 1, vocab]
    f32, pools), and the summed [E] expert load third with
    ``return_expert_load``.  Under a ``mesh`` with a tp axis, each tp shard
    writes and reads its own kv heads' stores (K2 once a shard and layer,
    on each stripe under tp x sp)."""
    b, s = tokens.shape
    mesh, tp, lcfg = _tp_setup(params, cfg, mesh)
    x, operands = _paged_decode_operands(params, tokens, cfg, pools,
                                         page_table, lengths)
    loads = []
    for sub, layers, stage_pools, ads in _stage_walk(params, mesh, pools,
                                                     adapters):
        x = _paged_decode_stage(x, layers, stage_pools, ads, adapter_ids,
                                sub, tp, cfg, lcfg, *operands, loads)
    x = rmsnorm(_to(x, tokens.device), params["final_scale"], cfg.norm_eps)
    logits = _head_mm(x, params["lm_head"])
    if return_expert_load:
        return logits, pools, _sum_loads(loads)
    return logits, pools


def _paged_decode_operands(params, tokens, cfg: ModelConfig, pools,
                           page_table, lengths):
    """The embedded tokens and the per-row operands of a paged decode
    step, on the tokens' device: (x, (positions [B, S] int32, the rope
    tables, page_table, the written page ids [B], their lanes [B]))."""
    b, s = tokens.shape
    page = pool_page_size(pools)
    lengths = lengths.to(torch.int32)
    positions = (lengths[:, None]
                 + torch.arange(s, device=lengths.device,
                                dtype=torch.int32)[None, :]).contiguous()
    # a slot that finished mid-round decodes its surplus steps on; past
    # the table's end they land on the trash page
    idx = (lengths // page)[:, None].long()
    n_tbl = page_table.shape[1]
    page_ids = torch.where(
        idx < n_tbl, page_table.gather(1, idx.clamp(max=n_tbl - 1)),
        0)[:, 0].long()
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    return _embed(params, tokens, cfg), (positions, tables, page_table,
                                         page_ids, (lengths % page).long())


def _paged_decode_stage(x, layers, pools, ads, adapter_ids, mesh, tp: int,
                        cfg: ModelConfig, lcfg: ModelConfig, positions,
                        tables, page_table, page_ids, offsets,
                        loads: List):
    """One stage's layers of a paged decode step over rows x [R, 1, d]:
    THE body of :func:`forward_paged_decode` (every row) and of
    :func:`forward_paged_decode_pp` (a microbatch's rows).  ``layers``,
    ``pools`` and ``ads`` are the stage's parts on its mesh ``mesh``; the
    operands (:func:`_paged_decode_operands`) are the rows' own.  Each
    row's K/V lands at its page and lane in place, on the stripe that owns
    the page (the others write their trash page), before the read.
    Appends each layer's expert load to ``loads``; returns x on the
    stage's device."""
    x = _to(x, _stage_device(mesh, x))
    stripes = _pool_stripes(pools, mesh)
    sp = len(stripes) // tp
    ids = _stripe_page_ids(page_ids, stripes, mesh)
    offs = [offsets.to(i.device) for i in ids]
    rots = _per_shard(tables, mesh, tp)
    subs, tbls = _shard_meshes(mesh, tp), _per_shard(page_table, mesh, tp)
    poss = _per_shard(positions, mesh, tp)
    views = _layers({"layers": layers}, tp)
    loras = _adapter_layers(ads, adapter_ids, len(views), cfg.dtype)
    with on_card(x.device):
        for l, (layer, lora) in enumerate(zip(views, loras)):
            def attend(lyr, xin, lora, t, l=l):
                q, k, v = _qkv(lyr, xin, lcfg, rots[t], lora)
                new = (_kv_pack(k, lcfg), _kv_pack(v, lcfg))
                mine = slice(t * sp, (t + 1) * sp)
                # distinct active slots own distinct pages; inactive slots
                # all land on the trash page
                for pair, pid, off in zip(stripes[mine], ids[mine],
                                          offs[mine]):
                    for pool, st in zip(pair, new):
                        for leaf, part in zip(_kv_leaves(pool),
                                              _kv_leaves(st)):
                            leaf[l][pid, :, off, :] = part[:, :, 0, :].to(
                                leaf.device)
                return paged_attention(
                    q, *_layer_stores(stripes[mine], l, subs[t]), tbls[t],
                    poss[t], lcfg, mesh=subs[t])

            x, load = _attn_ffn(layer, x, cfg, attend, lora)
            loads.append(load)
    return x


@torch.inference_mode()
def forward_paged_decode_pp(params, tokens, cfg: ModelConfig, pools,
                            page_table, lengths, mesh,
                            n_micro: Optional[int] = None, adapters=None,
                            adapter_ids=None):
    """The microbatched pipeline twin of :func:`forward_paged_decode`, with
    its signature and return, (logits [B, 1, vocab] f32, pools): the JAX
    package's ``forward_paged_decode_pp``.

    Under a mesh with a ``pp`` axis of two or more stages (params, pool
    and adapter pool laid out by stage, ``parallel.mesh``), the rows split
    into ``n_micro`` microbatches of B / n_micro (default n_micro = pp; a
    ValueError when it does not divide B) and the GPipe wavefront runs
    (:func:`_wavefront`): stage s decodes microbatch t - s at tick t.  A
    microbatch is rows ``[m*mb, (m+1)*mb)`` of the positions, page table,
    written pages and lanes and adapter ids, sliced on the device.  Each
    (stage, microbatch) writes its rows' pages once; the reference's
    bubble ticks, which compute a clipped microbatch and write the trash
    page, do not run.  A stage's body is :func:`forward_paged_decode`'s
    (:func:`_paged_decode_stage`): composed with the stage's tp shards
    (K2 on each shard's kv heads, the o and down partials summed once)
    and its sp stripes (K2's striped entry point per stripe, each stripe
    writing only the pages it owns), K2 once a (stage, microbatch, layer,
    shard) on the card.  Per-layer expert load is not kept, as in the
    reference."""
    b, s = tokens.shape
    mesh, tp, lcfg = _tp_setup(params, cfg, mesh)
    n_micro, mb = _microbatches(mesh, b, n_micro)
    x, operands = _paged_decode_operands(params, tokens, cfg, pools,
                                         page_table, lengths)
    stages = _stage_walk(params, mesh, pools, adapters)

    def run(st, rows, x):
        sub, layers, stage_pools, ads = stages[st]
        return _paged_decode_stage(
            x, layers, stage_pools, ads, _rows(adapter_ids, rows), sub, tp,
            cfg, lcfg, *_rows(operands, rows), [])

    x = _wavefront(run, x, stages, n_micro, mb)
    x = rmsnorm(x, params["final_scale"], cfg.norm_eps)
    return _head_mm(x, params["lm_head"]), pools


def _paged_prefill_rows(params, tokens, cfg: ModelConfig, pools, page_rows,
                        pos, mesh=None, adapters=None, adapter_ids=None):
    """THE paged prefill body: row r's window tokens[r] [W] into the pages
    of its table row ``page_rows[r]`` at offset ``pos[r]`` (int64 [R] on
    the tokens' device).  Each layer writes every row's K/V pages in
    place first (one indexed store of R * W / page pages), then the
    queries at ``pos[:, None] + arange(W)`` attend history and their own
    window through :func:`paged_attention` (K2's S > 1 arm on the card,
    once a layer for all R rows).  Returns (the final-norm hidden states
    [R, W, d_model], pools, the summed [E] expert load or None).  The caller keeps W and every ``pos`` page
    multiples with ``pos + W <= max_seq``; the one chunk and the batch of
    chunks are this body, so the two cannot drift."""
    r, s = tokens.shape
    mesh, tp, lcfg = _tp_setup(params, cfg, mesh)
    page = pool_page_size(pools)
    n_chunks = s // page
    positions = (pos[:, None] + torch.arange(s, device=tokens.device)[None, :]
                 ).to(torch.int32)
    pids = page_rows.long().gather(
        1, (pos // page)[:, None]
        + torch.arange(n_chunks, device=tokens.device)[None, :]).reshape(-1)
    hkv = lcfg.n_kv_heads
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = _embed(params, tokens, cfg)
    loads = []
    for sub, layers, stage_pools, ads in _stage_walk(params, mesh, pools,
                                                     adapters):
        x = _to(x, _stage_device(sub, x))
        stripes = _pool_stripes(stage_pools, sub)
        sp = len(stripes) // tp
        ids = _stripe_page_ids(pids, stripes, sub)
        rots = _per_shard(tables, sub, tp)
        subs, tbls = _shard_meshes(sub, tp), _per_shard(page_rows, sub, tp)
        poss = _per_shard(positions, sub, tp)
        views = _layers({"layers": layers}, tp)
        loras = _adapter_layers(ads, adapter_ids, len(views), cfg.dtype)
        with on_card(x.device):
            for l, (layer, lora) in enumerate(zip(views, loras)):
                def attend(lyr, xin, lora, t, l=l):
                    q, k, v = _qkv(lyr, xin, lcfg, rots[t], lora)
                    new = (_kv_pack(k, lcfg), _kv_pack(v, lcfg))
                    mine = slice(t * sp, (t + 1) * sp)
                    # live rows own distinct pages; a padded row's all-zero
                    # table sends every one of its pages to the trash page,
                    # which repeats harmlessly (masked out of every softmax)
                    for pair, pid in zip(stripes[mine], ids[mine]):
                        for pool, st in zip(pair, new):
                            for leaf, part in zip(_kv_leaves(pool),
                                                  _kv_leaves(st)):
                                leaf[l][pid] = part.reshape(
                                    r, hkv, n_chunks, page, part.shape[-1]
                                ).transpose(1, 2).reshape(
                                    r * n_chunks, hkv, page,
                                    part.shape[-1]).to(leaf.device)
                    return paged_attention(
                        q, *_layer_stores(stripes[mine], l, subs[t]),
                        tbls[t], poss[t], lcfg, mesh=subs[t])

                x, load = _attn_ffn(layer, x, cfg, attend, lora)
                loads.append(load)
    x = _to(x, tokens.device)
    return (rmsnorm(x, params["final_scale"], cfg.norm_eps), pools,
            _sum_loads(loads))


@torch.inference_mode()
def forward_paged_prefill_chunk(params, tokens, cfg: ModelConfig, pools,
                                page_rows, pos: int, last_idx: int,
                                mesh=None, adapters=None, adapter_ids=None,
                                return_expert_load: bool = False):
    """One prompt WINDOW into a slot's reserved pages at offset ``pos``.

    tokens [1, W] with W a multiple of the page size and ``pos``
    page-aligned; page_rows [max_seq // page] int32, the slot's page-table
    row (global page ids; pools striped under ``mesh``).  The window's K/V
    pages are written in place first, then its queries attend history and
    themselves through the pool (:func:`_paged_prefill_rows`).  A padded
    tail is contained: within the reservation it sits at positions the
    next window or decode overwrites before they are attendable, past the
    reservation the 0-padded row sends it to the trash page.  Returns
    (logits [vocab] f32 at ``last_idx``, pools), and the summed [E]
    expert load third with ``return_expert_load``."""
    b, s = tokens.shape
    if b != 1:
        raise ValueError("paged prefill is per-request (batch 1)")
    page = pool_page_size(pools)
    if s % page or pos % page:
        raise ValueError("prefill window and offset must be page-aligned")
    if (pos + s) // page > page_rows.shape[0]:
        raise ValueError("prefill window runs past the page table")
    x, pools, load = _paged_prefill_rows(
        params, tokens, cfg, pools, page_rows[None],
        torch.full((1,), pos, dtype=torch.long, device=tokens.device),
        mesh=mesh, adapters=adapters, adapter_ids=adapter_ids)
    logits = _head_mm(x[0, last_idx], params["lm_head"])
    if return_expert_load:
        return logits, pools, load
    return logits, pools


@torch.inference_mode()
def forward_paged_prefill_batch(params, tokens, cfg: ModelConfig, pools,
                                page_rows, pos, last_idx, mesh=None,
                                adapters=None, adapter_ids=None,
                                return_expert_load: bool = False):
    """Coalesced MULTI-prompt prefill, the prefill half of a mixed round:
    one window a row, each into its own slot's reserved pages, in one
    forward (K2's S > 1 arm once a layer for all rows).

    tokens [R, W] with W a page multiple; page_rows [R, max_seq // page]
    int32 (each row's page-table row; a padded row's is all zeros, so its
    writes land on the masked trash page); pos [R] page-aligned offsets
    and last_idx [R] each row's last REAL position in its window (int
    tensors).  Per-row math is :func:`forward_paged_prefill_chunk`'s (the
    one body, :func:`_paged_prefill_rows`).  Live rows target distinct
    slots, so their page writes never collide; the caller keeps
    ``pos + W <= max_seq``.  Returns (logits [R, vocab] f32 at each row's
    ``last_idx``, pools), and the summed [E] expert load (padded rows
    included) third with ``return_expert_load``."""
    r, s = tokens.shape
    page = pool_page_size(pools)
    if s % page:
        raise ValueError("prefill window must be page-aligned")
    dev = tokens.device
    x, pools, load = _paged_prefill_rows(params, tokens, cfg, pools,
                                         page_rows, pos.to(dev).long(),
                                         mesh=mesh, adapters=adapters,
                                         adapter_ids=adapter_ids)
    xl = x[torch.arange(r, device=dev), last_idx.to(dev).long()]
    logits = _head_mm(xl, params["lm_head"])
    if return_expert_load:
        return logits, pools, load
    return logits, pools


@torch.inference_mode()
def forward_paged_verify(params, tokens, cfg: ModelConfig, pools,
                         page_table, lengths, mesh=None, adapters=None,
                         adapter_ids=None, return_expert_load: bool = False):
    """Speculative VERIFY step against the paged pool: every slot's
    pending token and its k proposal tokens scored in one forward.

    tokens [B, 1+k]; lengths [B] (int tensor): row b's block occupies
    positions ``lengths[b] .. lengths[b] + k``, starting exactly at the
    committed context, so no committed position is ever rewritten
    (append-only: a position's int8 codes are quantized once).  The
    k+1 fresh K/V entries scatter per POSITION through each row's own
    table walk (pools striped under ``mesh``; global page ids), in place
    before the read; inactive rows ride all-zero tables onto the trash
    page.  A position past the table's reach (only a rejected or garbage
    tail near max_seq) goes to the trash page 0, never clamped onto a
    real page.  The read is :func:`paged_attention`: K2's S > 1 arm on
    the card, once a layer for all rows (n_rep * (1+k) rows a kv head).
    Returns (logits [B, 1+k, vocab] f32, pools), and the summed [E]
    expert load third with ``return_expert_load``."""
    b, s = tokens.shape
    mesh, tp, lcfg = _tp_setup(params, cfg, mesh)
    page = pool_page_size(pools)
    dev = tokens.device
    positions = (lengths.to(device=dev, dtype=torch.int32)[:, None]
                 + torch.arange(s, device=dev, dtype=torch.int32)[None, :]
                 ).contiguous()
    ranges = (positions // page).long()
    n_tbl = page_table.shape[1]
    pids = torch.where(ranges < n_tbl,
                       page_table.gather(1, ranges.clamp(max=n_tbl - 1)),
                       0).reshape(-1).long()
    lanes = (positions % page).reshape(-1).long()
    hkv = lcfg.n_kv_heads
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = _embed(params, tokens, cfg)
    loads = []
    for sub, layers, stage_pools, ads in _stage_walk(params, mesh, pools,
                                                     adapters):
        x = _to(x, _stage_device(sub, x))
        stripes = _pool_stripes(stage_pools, sub)
        sp = len(stripes) // tp
        ids = _stripe_page_ids(pids, stripes, sub)
        offsets = [lanes.to(i.device) for i in ids]
        rots = _per_shard(tables, sub, tp)
        subs, tbls = _shard_meshes(sub, tp), _per_shard(page_table, sub, tp)
        poss = _per_shard(positions, sub, tp)
        views = _layers({"layers": layers}, tp)
        loras = _adapter_layers(ads, adapter_ids, len(views), cfg.dtype)
        with on_card(x.device):
            for l, (layer, lora) in enumerate(zip(views, loras)):
                def attend(lyr, xin, lora, t, l=l):
                    q, k, v = _qkv(lyr, xin, lcfg, rots[t], lora)
                    new = (_kv_pack(k, lcfg), _kv_pack(v, lcfg))
                    mine = slice(t * sp, (t + 1) * sp)
                    for pair, pid, off in zip(stripes[mine], ids[mine],
                                              offsets[mine]):
                        for pool, st in zip(pair, new):
                            for leaf, part in zip(_kv_leaves(pool),
                                                  _kv_leaves(st)):
                                leaf[l][pid, :, off, :] = part.transpose(
                                    1, 2).reshape(b * s, hkv,
                                                  part.shape[-1]).to(
                                                      leaf.device)
                    return paged_attention(
                        q, *_layer_stores(stripes[mine], l, subs[t]),
                        tbls[t], poss[t], lcfg, mesh=subs[t])

                x, load = _attn_ffn(layer, x, cfg, attend, lora)
                loads.append(load)
    x = rmsnorm(_to(x, dev), params["final_scale"], cfg.norm_eps)
    logits = _head_mm(x, params["lm_head"])
    if return_expert_load:
        return logits, pools, _sum_loads(loads)
    return logits, pools


def forward_paged_prefill(params, tokens, cfg: ModelConfig, pools,
                          page_rows, prompt_len: int, mesh=None,
                          adapters=None, adapter_ids=None,
                          return_expert_load: bool = False):
    """Prefill ONE whole request into its reserved pages: the chunk body
    at pos 0 with the prompt padded to a page multiple.  Returns
    (last-position logits [1, vocab], pools), and the summed [E] expert
    load third with ``return_expert_load``."""
    b, s = tokens.shape
    page = pool_page_size(pools)
    w = -(-s // page) * page
    if w != s:
        tokens = F.pad(tokens[:, :s], (0, w - s))
    out = forward_paged_prefill_chunk(
        params, tokens, cfg, pools, page_rows, 0, prompt_len - 1, mesh=mesh,
        adapters=adapters, adapter_ids=adapter_ids,
        return_expert_load=return_expert_load)
    return (out[0][None],) + tuple(out[1:])
