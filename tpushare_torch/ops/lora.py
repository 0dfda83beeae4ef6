"""LoRA: adapter fine-tuning, and multi-adapter serving's stacked pool.

Counterpart of ``tpushare/ops/lora.py``.

Fine-tuning: a loraized weight leaf is the dict ``{"w": base, "a":
[.., d_in, r], "b": [.., r, d_out], "scale": alpha/r}`` (or the int8
``{"q","s"}`` / int4 ``{"q4","s"}`` base beside ``a``/``b``/``scale``:
QLoRA), and ``ops.quant.matmul_maybe_q`` computes ``x @ base + (x @ a) @ b
* scale``.  ``b`` starts at zero, so a freshly loraized model is the base
model; :func:`make_lora_train_step` differentiates the adapter leaves
only (the frozen base never asks for a gradient and never enters the
optimizer, whose state is the adapters' alone), and :func:`merge_lora`
folds the adapters back into dense (or requantized) weights.

Serving (S-LoRA / Punica's batched formulation).  One base model stays
resident and the
adapters live in a STACKED pool: per target leaf an ``a`` buffer
``[L, N, d_in, r]`` and a ``b`` buffer ``[L, N, r, d_out]`` (the leading
L beside the base model's stacked layers), plus one f32 ``scale`` [N].
Every batched forward gathers each row's adapter by index and pays two
skinny matmuls a projection, so a batch mixing N tenants is one forward.
Pool row 0 is the IDENTITY adapter: its a/b are zero, its delta is
exactly 0.0, and the allocator never hands it out, so base-model rows
ride the same program unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from . import quant
from .experts import contract_rows

#: every projection a serving adapter may target, and the attention ones
LORA_SUFFIXES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
ATTN_LORA_SUFFIXES = ("wq", "wk", "wv", "wo")


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# Fine-tuning
# ---------------------------------------------------------------------------
def _is_weight_dict(x) -> bool:
    """A WEIGHT dict (quantized and/or loraized), not any dict: the params
    tree itself is a dict of dicts."""
    return isinstance(x, dict) and ("w" in x or "q" in x or "q4" in x)


def _keystr(path: Tuple[str, ...]) -> str:
    """A path's key as ``jax.tree_util.keystr`` writes a dict path
    (``['layers']['wq']['a']``), so adapter dicts name their leaves as the
    reference's do."""
    return "".join(f"[{k!r}]" for k in path)


def _map_weights(fn, tree, path=()):
    """``fn(path, leaf)`` over every weight leaf (a tensor or a weight
    dict) of a nested dict; the same nesting back."""
    if isinstance(tree, dict) and not _is_weight_dict(tree):
        return {k: _map_weights(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _map_tensors(fn, tree, path=()):
    """``fn(path, leaf)`` over every tensor (and None placeholder) of a
    nested dict, weight dicts included, and of the tuples a placed tree
    holds (``parallel.mesh``'s tp trees, ``Replicas``, blocks; their
    indices in the path), except that an adapter's value (under an
    ``"a"`` or ``"b"`` key) is one leaf however it is split; the same
    nesting back."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and not (path and path[-1] in ("a", "b")):
        return type(tree)(_map_tensors(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _leaf_dims(leaf) -> tuple:
    """(d_in, d_out) of a 2D or stacked [L, d_in, d_out] weight leaf, or
    of its quantized dict form."""
    if isinstance(leaf, dict):
        if "q4" in leaf:
            # [.., g, group/2, d_out] packed: d_in = g * group
            g, half, d_out = leaf["q4"].shape[-3:]
            return g * half * 2, d_out
        return leaf["q"].shape[-2], leaf["q"].shape[-1]
    return leaf.shape[-2], leaf.shape[-1]


def loraize_params(params, rank: int = 8, alpha: float = 16.0,
                   suffixes=LORA_SUFFIXES, seed: int = 0,
                   adapter_dtype=None):
    """Wrap the matching weight leaves (plain or quantized) with adapters:
    ``a`` ~ N(0, 1) / sqrt(d_in) from a CPU ``torch.Generator`` seeded by
    ``seed`` (the port's own draws; the reference's come from
    ``jax.random``), ``b`` zero, ``scale`` = alpha / rank with the leaf's
    lead shape ([L] for a stacked leaf: each layer's slice takes its
    own).  The adapters are ``adapter_dtype``, else bf16 over a quantized
    base (the QLoRA layout), else the leaf's own dtype.  Leaves that are
    not matched, and leaves already loraized, are kept as they are (the
    same tensors)."""
    if rank < 1:
        raise ValueError("rank must be >= 1")
    gen = torch.Generator().manual_seed(int(seed))

    def visit(path, leaf):
        if not path or path[-1] not in suffixes:
            return leaf
        is_dict = isinstance(leaf, dict)
        if is_dict and ("a" in leaf or "b" in leaf):
            return leaf
        d_in, d_out = _leaf_dims(leaf)
        base = (leaf["q4"] if is_dict and "q4" in leaf
                else leaf["q"] if is_dict else leaf)
        lead = base.shape[:-3] if is_dict and "q4" in leaf \
            else base.shape[:-2]
        if adapter_dtype is not None:
            dtype = adapter_dtype
        elif is_dict:
            dtype = torch.bfloat16
        else:
            dtype = leaf.dtype
        a = torch.randn((*lead, d_in, rank), generator=gen,
                        dtype=torch.float32) / math.sqrt(d_in)
        dev = base.device
        return {**(leaf if is_dict else {"w": leaf}),
                "a": a.to(device=dev, dtype=dtype),
                "b": torch.zeros((*lead, rank, d_out), dtype=dtype,
                                 device=dev),
                "scale": torch.full(tuple(lead), alpha / rank,
                                    dtype=torch.float32, device=dev)}

    return _map_weights(visit, params)


def lora_mask(params):
    """The params' nesting with True at the adapter tensors ("a"/"b") and
    False elsewhere: what trains and what stays frozen."""
    return _map_tensors(lambda path, _: _is_adapter(path), params)


def _is_adapter(path) -> bool:
    return bool(path) and path[-1] in ("a", "b")


def partition(params):
    """(adapters, frozen): ``adapters`` a flat ``{keystr: tensor}`` dict of
    the trainable tensors (keyed as the reference keys them), ``frozen``
    the params' nesting with None in their places.  The tensors are the
    params' own, not copies: an in-place update of ``adapters`` is an
    update of the tree.  On ``parallel.mesh.shard_params``' layout an
    entry is what the placed tree holds there (a tensor, or its tp and
    fsdp blocks), keyed with the tp shard's index."""
    adapters: Dict[str, torch.Tensor] = {}

    def visit(path, leaf):
        if _is_adapter(path):
            adapters[_keystr(path)] = leaf
            return None
        return leaf

    frozen = _map_tensors(visit, params)
    return adapters, frozen


def combine(adapters: Dict, frozen):
    """Inverse of :func:`partition`: the adapter dict's tensors back in
    the frozen tree's None places."""
    return _map_tensors(
        lambda path, leaf: adapters.get(_keystr(path), leaf), frozen)


def make_lora_train_step(cfg, optimizer, remat: str = "none",
                         head_chunk: int = 0, mesh=None):
    """``(params, opt_state, tokens [B, S+1]) -> (params, opt_state,
    loss)`` differentiating ONLY the adapters of a loraized tree, with
    ``opt_state = optimizer.init(partition(params)[0])``.  The frozen base
    (plain, int8 or int4) is set not to require gradients and never
    enters ``torch.autograd.grad`` or the optimizer, so its memory is
    the forward's alone.  ``remat`` (none / layer / full) and
    ``head_chunk`` are ``parallel.train.make_loss_fn``'s.  The adapters
    and the state update in place; the loss is a device scalar.

    ``mesh`` (``dp``, ``fsdp``, ``tp`` and their products): the params
    are ``parallel.mesh.shard_params``' layout on it, the state is
    ``optimizer.init(placed_adapters(params))``, and each dp shard runs
    its rows with its replica, fsdp blocks gathered and tp shards through
    the forward's (``parallel.train.sharded_loss_and_grads``).  A ``pp``
    mesh raises: the 1F1B step differentiates whole stage params.  An
    int8 or int4 base trains on tp in its blocks, as a plain one does.
    At the step, a ``tp`` axis the model does not take the split over
    raises (``models.transformer.tp_splits``: heads, feature dims or an
    int4 row leaf's ``group/2`` tp does not divide): that forward runs as
    tp = 1 and would join every tp block of the base on tp shard 0 each
    step."""
    from ..parallel.train import make_loss_fn, sharded_loss_and_grads

    if mesh is not None and "pp" in mesh.axis_names:
        raise ValueError("LoRA training on a pp mesh is not supported (the "
                         "1F1B step differentiates whole stage params)")
    loss_fn = make_loss_fn(cfg, remat, head_chunk)

    def adapters_of(tree):
        adapters, frozen = partition(tree)

        def freeze(_, t):
            if t is not None and t.is_floating_point():
                t.requires_grad_(False)
            return t

        _map_tensors(freeze, frozen)
        return adapters

    def step(params, opt_state, tokens):
        if mesh is not None:
            _refuse_unsplit_tp(params, cfg, mesh)
            loss, grads = sharded_loss_and_grads(loss_fn, params, tokens,
                                                 mesh, trained=adapters_of)
            optimizer.update(placed_adapters(params), grads, opt_state)
            return params, opt_state, loss
        adapters = adapters_of(params)
        leaves = list(adapters.values())
        for p in leaves:
            p.requires_grad_(True)
        tokens = torch.as_tensor(tokens, device=leaves[0].device)
        loss = loss_fn(params, tokens)
        grads = list(torch.autograd.grad(loss, leaves))
        optimizer.update(adapters, grads, opt_state)
        return params, opt_state, loss.detach()

    return step


def _refuse_unsplit_tp(params, cfg, mesh):
    """NotImplementedError where ``mesh`` has a ``tp`` axis that the
    placed loraized tree's model does not take the split over."""
    from ..models.transformer import tp_splits
    from ..parallel.mesh import Replicas

    tp = mesh.shape.get("tp", 1)
    tree = params[0] if isinstance(params, Replicas) else params
    if tp > 1 and not tp_splits(tree["layers"], cfg, tp):
        raise NotImplementedError(
            f"LoRA training on tp {tp}: this model does not take the tp "
            "split (heads, feature dims or an int4 row leaf's group/2 "
            "that tp does not divide), so each step would join its whole "
            "base on tp shard 0 (train it on a mesh without tp)")


def placed_adapters(params):
    """The adapter dict of a loraized tree (:func:`partition`), or one a
    dp replica of a ``parallel.mesh.Replicas``: what the optimizer steps
    on a mesh."""
    from ..parallel.mesh import Replicas

    if isinstance(params, Replicas):
        return Replicas(partition(r)[0] for r in params)
    return partition(params)[0]


@torch.no_grad()
def whole_adapters(adapters, device=None):
    """An adapter dict of a placed loraized tree (:func:`placed_adapters`
    of it, or a tree of tensors keyed so: the optimizer's moments) whole,
    keyed as the unplaced tree's: tp shard 0's entries (``['layers'][0]``
    of ``parallel.mesh.shard_params``' tuple of shard trees) with their
    fsdp and tp blocks joined on ``device`` (default: each entry's first
    block's); every other shard's entries name the same adapters."""
    from ..parallel.mesh import Replicas, whole_leaf

    if isinstance(adapters, Replicas):
        adapters = adapters[0]
    layers, shard0 = _keystr(("layers",)), _keystr(("layers", 0))
    out = {}
    for key, v in adapters.items():
        if key.startswith(shard0):
            key = layers + key[len(shard0):]
        elif key.startswith(layers):
            continue
        out[key] = whole_leaf(v, device).detach()
    return out


@torch.no_grad()
def merge_lora(params, requantize_bits: int = 0):
    """Fold the adapters into dense weights: ``w + a @ b * scale`` in f32,
    stored in the adapters' dtype (a quantized base is dequantized first);
    ``requantize_bits`` 8 or 4 quantizes the merged weight again (int4 at
    the base's own group size)."""
    def visit(path, leaf):
        if not (isinstance(leaf, dict) and "a" in leaf and "b" in leaf):
            return leaf
        if "q4" in leaf:
            base = quant.dequantize4({"q4": leaf["q4"], "s": leaf["s"]},
                                     dtype=torch.float32)
        elif "q" in leaf:
            base = quant.dequantize(leaf["q"], leaf["s"], torch.float32)
        else:
            base = leaf["w"].float()
        scale = leaf["scale"]
        if scale.dim():                      # stacked [L] -> [L, 1, 1]
            scale = scale[..., None, None]
        delta = (leaf["a"].float() @ leaf["b"].float()) * scale
        merged = (base + delta).to(leaf["a"].dtype)
        if requantize_bits == 8:
            q, s = quant.quantize(merged)
            return {"q": q, "s": s}
        if requantize_bits == 4:
            group = leaf["q4"].shape[-2] * 2 if "q4" in leaf else 512
            return quant.quantize4(merged, group=group)
        return merged

    return _map_weights(visit, params)


def serving_adapter_dims(cfg, suffixes=None) -> Dict:
    """{leaf: (d_in, d_out)} of the adapter targets: the one definition
    the pool, the byte model and the synthetic loader derive from.  A
    config with experts (``cfg.n_experts``) restricts to the attention
    projections, whose layers carry no dense FFN leaves for a delta."""
    if suffixes is None:
        suffixes = (ATTN_LORA_SUFFIXES if getattr(cfg, "n_experts", 0)
                    else LORA_SUFFIXES)
    d = cfg.d_model
    kvd = cfg.n_kv_heads * cfg.head_dim
    dims = {"wq": (d, d), "wk": (d, kvd), "wv": (d, kvd), "wo": (d, d),
            "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
            "w_down": (cfg.d_ff, d)}
    return {k: dims[k] for k in suffixes if k in dims}


def init_adapter_pool_arrays(cfg, rank: int, n_adapters: int, dtype=None,
                             device=None) -> Dict:
    """A zeroed stacked serving pool: {leaf: {"a": [L, N, d_in, r],
    "b": [L, N, r, d_out]}, "scale": [N] f32}.  All-zero entries ARE the
    identity adapter, so a fresh pool serves base traffic."""
    if rank < 1:
        raise ValueError("rank must be >= 1")
    if n_adapters < 1:
        raise ValueError("n_adapters must be >= 1 (index 0 is the "
                         "identity adapter)")
    dtype = dtype or cfg.dtype
    ll = cfg.n_layers
    pool = {}
    for name, (d_in, d_out) in serving_adapter_dims(cfg).items():
        pool[name] = {
            "a": torch.zeros((ll, n_adapters, d_in, rank), dtype=dtype,
                             device=device),
            "b": torch.zeros((ll, n_adapters, rank, d_out), dtype=dtype,
                             device=device)}
    pool["scale"] = torch.zeros((n_adapters,), dtype=torch.float32,
                                device=device)
    return pool


def make_adapter(cfg, rank: int, seed: int, alpha: float = 16.0,
                 dtype=None, device=None) -> Dict:
    """One synthetic NON-identity adapter, determined by ``seed``:
    {leaf: {"a": [L, d_in, r], "b": [L, r, d_out]}, "scale": float}, with
    the reference's scales (a ~ N(0, 1) / sqrt(d_in), b ~ N(0, 1) /
    sqrt(r * d_out), so distinct adapters give distinct streams).  The
    draws come from a CPU ``torch.Generator`` seeded by ``seed``, the same
    on every device; they cannot equal the reference's ``jax.random``
    draws (to serve the reference's adapter, bridge it:
    ``models.bridge.adapter_from_numpy``)."""
    dtype = dtype or cfg.dtype
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, (d_in, d_out) in serving_adapter_dims(cfg).items():
        a = torch.randn((cfg.n_layers, d_in, rank), generator=gen,
                        dtype=torch.float32) / math.sqrt(d_in)
        b = torch.randn((cfg.n_layers, rank, d_out), generator=gen,
                        dtype=torch.float32) / math.sqrt(rank * d_out)
        out[name] = {"a": a.to(device=device, dtype=dtype),
                     "b": b.to(device=device, dtype=dtype)}
    out["scale"] = float(alpha / rank)
    return out


def adapter_entry_bytes(cfg, rank: int, dtype=None) -> int:
    """The pool bytes ONE resident adapter costs: a and b over every
    target leaf and layer, plus its f32 scale."""
    item = _itemsize(dtype or cfg.dtype)
    elems = sum(rank * (d_in + d_out)
                for d_in, d_out in serving_adapter_dims(cfg).values())
    return int(cfg.n_layers * elems * item + 4)


def adapter_pool_bytes(cfg, rank: int, n_adapters: int, dtype=None) -> int:
    """The bytes of a whole stacked pool of ``n_adapters`` entries, the
    identity row included."""
    return adapter_entry_bytes(cfg, rank, dtype) * n_adapters


def merged_adapter_bytes(cfg, dtype=None) -> int:
    """What ONE merged per-adapter model costs in the target leaves alone
    (d_in x d_out a leaf and layer): the denominator of the pool's
    capacity win."""
    item = _itemsize(dtype or cfg.dtype)
    elems = sum(d_in * d_out
                for d_in, d_out in serving_adapter_dims(cfg).values())
    return int(cfg.n_layers * elems * item)


def batched_adapter_matmul(x, a_pool, b_pool, scales, adapter_ids):
    """The gathered per-row LoRA delta: row i of ``x`` [B, S, d_in] rides
    adapter ``adapter_ids[i]`` of the stacked ``a_pool`` [N, d_in, r] /
    ``b_pool`` [N, r, d_out]; returns ``((x @ A[id]) @ B[id]) * scale[id]``
    as [B, S, d_out]: :func:`~.experts.gathered_matmul`'s take, then
    :func:`adapter_delta`.  A row of adapter 0 gathers the all-zero
    identity entry, so its delta is exactly 0.0."""
    ids = adapter_ids.long()
    return adapter_delta(x, a_pool[ids], b_pool[ids], scales[ids])


def adapter_delta(x, a_rows, b_rows, s_rows):
    """The delta on rows already gathered (the decoder takes them once a
    forward, for every layer): ``a_rows`` [B, d_in, r], ``b_rows``
    [B, r, d_out], ``s_rows`` [B] (f32, or already cast to ``x.dtype``).
    Both products are :func:`~.experts.gathered_matmul`'s contraction
    (cast to ``x.dtype``, then contract)."""
    xa = contract_rows(x, a_rows)                        # [B, S, r]
    delta = contract_rows(xa, b_rows)                    # [B, S, d_out]
    return delta * s_rows[:, None, None].to(x.dtype)
