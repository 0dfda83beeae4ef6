"""Language-model training steps: loss, AdamW, remat; one device, a
``dp`` / ``fsdp`` / ``tp`` mesh, and the 1F1B pipeline over ``pp``.

Counterpart of ``tpushare/parallel/train.py``.  The JAX step is one
``jit`` over ``value_and_grad`` + ``optax.adamw``; here it is an eager
forward, ``torch.autograd.grad`` and an AdamW written out with optax's
arithmetic.  Params and optimizer state are updated IN PLACE (where the
JAX step donates its buffers) by one fused pass, so the update makes no
f32 copy of the stacked ``[L, ...]`` leaves (``w_gate`` of Llama-3-8B is
3.8 GB in bf16).  Moments are kept in each param's dtype, as optax keeps
them.

On a mesh (:func:`make_train_step` with ``mesh=``) the params are
``parallel.mesh.shard_params``' layout: each ``dp`` shard runs the loss
on its rows (``shard_batch``) with its replica, fsdp blocks gathered at
use and tp shards through ``forward(mesh=)``, and the shards' gradients
are summed (the all-reduce).  A ``pp`` mesh takes
:func:`make_pipeline_train_step`: the layers through
``parallel.pipeline.pipeline_train_1f1b``.

The attention inside runs K1 forward and K3 + K4 backward on the card
(``ops.attention.flash_attention_lse``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Union

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint

from ..models import transformer
from ..ops.attention import FLASH_FWD_OP
from .mesh import (Replicas, Staged, gather_fsdp, shard_batch,
                   view_key)

Schedule = Union[float, Callable[[int], float]]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dicts and tuples (``Staged``, tp shards,
    ``Replicas``, fsdp blocks), in order."""
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, tuple):
        return [tree]
    out: List[torch.Tensor] = []
    for v in tree:
        out += tree_leaves(v)
    return out


def tree_map(fn, tree):
    """``fn`` over every tensor of nested dicts and tuples, each container
    rebuilt as its own type."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _chunk_nll(xc, tc, w):
    """Summed NLL of one sequence chunk: its [B, C, vocab] f32 logits
    exist only here (and again in the backward's recompute)."""
    logits = transformer._head_mm(xc, w)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tc[..., None])[..., 0]
    return (lse - gold).sum()


def lm_loss(params, tokens, cfg: transformer.ModelConfig,
            remat_policy=None, head_chunk: int = 0, mesh=None):
    """Next-token cross-entropy; tokens [B, S+1] split into input/target.

    ``head_chunk`` > 0 computes the head + softmax one sequence chunk at
    a time under ``torch.utils.checkpoint``, so the [B, S, vocab] f32
    logits never exist whole: the same loss (a reassociation of the
    mean), one extra head product in the backward.  Falls back to the
    monolithic loss when the chunk does not divide S.  ``mesh`` (a tp
    mesh, params from ``parallel.mesh.shard_params``) runs the forward's
    tp shards."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:].long()
    b, s = inputs.shape
    if head_chunk and s % head_chunk == 0 and s > head_chunk:
        hidden = transformer.forward(params, inputs, cfg,
                                     remat_policy=remat_policy,
                                     return_hidden=True,
                                     mesh=mesh)                # [B, S, D]
        total = hidden.new_zeros((), dtype=torch.float32)
        for c in range(0, s, head_chunk):
            total = total + checkpoint(
                _chunk_nll, hidden[:, c:c + head_chunk],
                targets[:, c:c + head_chunk], params["lm_head"],
                use_reentrant=False)
        return total / (b * s)
    logits = transformer.forward(params, inputs, cfg,
                                 remat_policy=remat_policy,
                                 mesh=mesh)                  # [B,S,V] f32
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def make_lr_schedule(lr: float, schedule: str = "constant",
                     warmup_steps: int = 0, total_steps: int = 0,
                     end_lr_frac: float = 0.1) -> Schedule:
    """The LR envelope, with optax's arithmetic: constant (the float
    itself), or a linear warmup from 0 to ``lr`` over
    ``max(warmup_steps, 1)`` steps, then cosine or linear decay reaching
    ``lr * end_lr_frac`` AT ``total_steps``
    (``optax.warmup_cosine_decay_schedule`` /
    ``join_schedules`` of two ``linear_schedule``\\ s)."""
    if schedule == "constant":
        return lr
    if schedule not in ("cosine", "linear"):
        raise ValueError(
            f"schedule must be constant|cosine|linear, got {schedule!r}")
    if total_steps <= 0:
        raise ValueError(f"{schedule} schedule needs total_steps")
    warm = max(warmup_steps, 1)
    end = lr * end_lr_frac

    def linear(init, stop, steps, t):
        t = min(max(t, 0), steps)
        return (init - stop) * (1 - t / steps) + stop

    if schedule == "cosine":
        decay = total_steps - warm
        if decay <= 0:
            raise ValueError(f"cosine decay needs total_steps > warmup, got "
                             f"{total_steps} <= {warm}")
        alpha = 0.0 if lr == 0.0 else end / lr

        def after(t):
            t = min(t, decay)
            c = 0.5 * (1 + math.cos(math.pi * t / decay))
            return lr * ((1 - alpha) * c + alpha)
    else:
        after = functools.partial(linear, lr, end, max(total_steps - warm, 1))

    def sched(count: int) -> float:
        if count < warm:
            return linear(0.0, lr, warm, count)
        return after(count - warm)

    return sched


class AdamW:
    """``optax.adamw`` (optionally after ``optax.clip_by_global_norm``)
    over a tree of tensors (nested dicts and tuples: a placed tree too),
    in place.

    State ``{"count": int, "mu": tree, "nu": tree}``, moments in each
    param's dtype.  Per step, with the learning rate taken at the count
    BEFORE the increment and bias correction at count + 1:
    ``g *= max_norm / ||g||`` only when ``||g|| >= max_norm``;
    ``mu = (1 - b1) g + b1 mu``; ``nu = (1 - b2) g^2 + b2 nu``;
    ``p += -lr * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p)``
    (decay on every leaf).  One ``torch._fused_adamw_`` pass per (device,
    dtype) computes it in f32 and stores each tensor once (the clip rides
    in as its ``grad_scale`` divisor), so no f32 copy of a leaf is made.

    A placed tree may name one set of elements more than once (dp
    replicas sharing a card are one tensor; two views may have one
    :func:`~tpushare_torch.parallel.mesh.view_key`): each is stepped, and
    its gradient counted in the clip's norm, once.  The fused pass reads
    its tensors as contiguous, so a strided view (a tp column block, an
    fsdp block) is stepped through contiguous copies written back."""

    def __init__(self, lr: Schedule, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 grad_clip_norm: float = 0.0):
        self.lr = lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm

    def init(self, params) -> Dict:
        """Zero moments shaped like ``params``; one moment tensor for a
        tensor the tree names twice."""
        def zeros():
            memo = {}

            def like(p):
                if id(p) not in memo:
                    memo[id(p)] = torch.zeros_like(p)
                return memo[id(p)]
            return like

        return {"count": 0, "mu": tree_map(zeros(), params),
                "nu": tree_map(zeros(), params)}

    #: elements per f32 chunk of the clip's sum of squares (256 MB), so
    #: no f32 copy of a whole leaf is made
    NORM_CHUNK = 1 << 26

    def _clip_divisor(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """``norm / max_norm`` when the global norm (summed in f32) is at
        least ``max_norm``, else 1: a device scalar on the first
        gradient's device, no host sync."""
        home = grads[0].device
        norm = torch.sqrt(sum(
            sum(c.float().square().sum()
                for c in g.reshape(-1).split(self.NORM_CHUNK)).to(home)
            for g in grads))
        return torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                           norm / self.grad_clip_norm)

    @torch.no_grad()
    def update(self, params, grads: List[torch.Tensor], state: Dict) -> Dict:
        """One step: ``grads`` in :func:`tree_leaves` order of
        ``params`` (they are overwritten)."""
        count = state["count"]
        lr = self.lr(count) if callable(self.lr) else self.lr
        seen, leaves = set(), []
        for leaf in zip(tree_leaves(params), grads, tree_leaves(state["mu"]),
                        tree_leaves(state["nu"])):
            key = view_key(leaf[0])
            if key not in seen:
                seen.add(key)
                leaves.append(leaf)
        scale = (self._clip_divisor([g for _, g, _, _ in leaves])
                 if self.grad_clip_norm > 0 else None)
        groups: Dict[tuple, List[list]] = {}
        for p, g, m, v in leaves:
            groups.setdefault((p.device, p.dtype), []).append(
                [p, g.contiguous(), m, v])
        for (dev, _), group in groups.items():
            step = torch.full((), float(count + 1), device=dev)
            kw = dict(lr=lr, beta1=self.b1, beta2=self.b2,
                      weight_decay=self.weight_decay, eps=self.eps,
                      amsgrad=False, maximize=False,
                      grad_scale=None if scale is None else scale.to(dev))
            dense = [l for l in group
                     if all(t.is_contiguous() for t in l)]
            if dense:
                ps, gs, ms, vs = map(list, zip(*dense))
                torch._fused_adamw_(ps, gs, ms, vs, [], [step] * len(ps),
                                    **kw)
            for p, g, m, v in (l for l in group
                               if not all(t.is_contiguous() for t in l)):
                pc, mc, vc = p.contiguous(), m.contiguous(), v.contiguous()
                torch._fused_adamw_([pc], [g], [mc], [vc], [], [step], **kw)
                p.copy_(pc)
                m.copy_(mc)
                v.copy_(vc)
        state["count"] = count + 1
        return state


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01,
                   schedule: str = "constant", warmup_steps: int = 0,
                   total_steps: int = 0, end_lr_frac: float = 0.1,
                   grad_clip_norm: float = 0.0) -> AdamW:
    """AdamW (b1 0.9, b2 0.95, eps 1e-8) with the standard LM envelope:
    ``schedule`` constant / cosine / linear (see
    :func:`make_lr_schedule`), and global-norm clipping when
    ``grad_clip_norm`` > 0."""
    return AdamW(make_lr_schedule(lr, schedule, warmup_steps, total_steps,
                                  end_lr_frac),
                 b1=0.9, b2=0.95, weight_decay=weight_decay,
                 grad_clip_norm=grad_clip_norm)


def _save_flash_residuals(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op == FLASH_FWD_OP
            else CheckpointPolicy.PREFER_RECOMPUTE)


#: Per-layer selective-checkpoint policy: keep K1's (out, lse) — the
#: registered operator ``tpushare_torch::flash_fwd`` — so the backward's
#: recompute of a layer is only the projections and the FFN, never the
#: O(S^2) forward kernel (K1 launches once per layer and step).
ATTN_SAVING_POLICY = _save_flash_residuals


def make_loss_fn(cfg: transformer.ModelConfig, remat: str = "none",
                 head_chunk: int = 0):
    """``(params, tokens) -> loss`` with the recompute/memory trade
    ``remat``: ``"none"`` keeps every residual; ``"layer"`` checkpoints
    each layer with :data:`ATTN_SAVING_POLICY` (backward memory is one
    layer's internals plus K1's out/lse per layer); ``"full"``
    checkpoints the whole loss (the forward runs twice, K1 included).
    ``head_chunk`` > 0 turns on the chunked loss (:func:`lm_loss`)."""
    loss = functools.partial(lm_loss, cfg=cfg, head_chunk=head_chunk)
    if remat == "full":
        return functools.partial(checkpoint, loss, use_reentrant=False)
    if remat == "layer":
        return functools.partial(loss, remat_policy=ATTN_SAVING_POLICY)
    if remat == "none":
        return loss
    raise ValueError(f"remat must be none|layer|full, got {remat!r}")


def make_train_step(cfg: transformer.ModelConfig, optimizer: AdamW,
                    remat: str = "none", head_chunk: int = 0, mesh=None):
    """Returns ``(params, opt_state, tokens [B, S+1]) -> (params,
    opt_state, loss)`` over :func:`make_loss_fn`'s loss; params and state
    are updated in place and returned, the loss is a device scalar (no
    host sync).

    ``mesh`` (``dp``, ``fsdp`` and/or ``tp`` axes; a ``pp`` axis takes
    :func:`make_pipeline_train_step`): the params and the moments are
    ``parallel.mesh.shard_params``' layout on it and the tokens may be
    ``shard_batch``'s row blocks (:func:`sharded_loss_and_grads`)."""
    loss_fn = make_loss_fn(cfg, remat, head_chunk)
    if mesh is not None and "pp" in mesh.axis_names:
        raise ValueError("a pp mesh trains through make_pipeline_train_step")

    def train_step(params, opt_state, tokens):
        if mesh is not None:
            loss, grads = sharded_loss_and_grads(loss_fn, params, tokens,
                                                 mesh)
            optimizer.update(params, grads, opt_state)
            return params, opt_state, loss
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tokens = torch.as_tensor(tokens, device=leaves[0].device)
        loss = loss_fn(params, tokens)
        # a leaf the loss does not reach (an MoE layer's route flag) gets
        # a zero gradient, as jax.grad gives it
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        optimizer.update(params, grads, opt_state)
        return params, opt_state, loss.detach()

    return train_step


def _compute_mesh(sub):
    """The mesh a replica's forward runs on: its fsdp shard 0 (the blocks
    are gathered there), None when no axis is left."""
    if "fsdp" in sub.axis_names:
        sub = sub.submesh(fsdp=0)
    return sub if sub.axis_names else None


def sharded_loss_and_grads(loss_fn, params, tokens, mesh,
                           trained=lambda tree: tree):
    """(loss, grads) of one step on a ``dp`` / ``fsdp`` / ``tp`` mesh.

    ``params`` is ``shard_params``' layout on ``mesh`` (a ``Replicas``
    under dp), ``tokens`` ``[B, S+1]`` or ``shard_batch``'s row blocks.
    Dp shard i runs ``loss_fn(replica_i gathered, rows_i, mesh=its tp
    mesh)`` on its own devices, weighted by its share of the batch, so
    the summed loss is the undivided batch's mean and its gradient the
    undivided batch's; a batch dp does not divide runs whole on shard 0.
    Fsdp blocks are gathered once a replica (:func:`~tpushare_torch.
    parallel.mesh.gather_fsdp`).  The gradients of the leaves of
    ``trained(replica)`` (the whole replica, or a LoRA tree's adapters)
    come back in :func:`tree_leaves` order over every replica; a tensor
    two replicas share gets the sum of both shards' gradients from
    autograd, replicas on different devices the sum of theirs (the dp
    all-reduce), added in f32, so the replicas stay equal."""
    dp = "dp" in mesh.axis_names
    replicas = params if isinstance(params, Replicas) else (params,)
    subs = ([mesh.submesh(dp=i) for i in range(mesh.shape["dp"])] if dp
            else [mesh])
    if len(replicas) != len(subs) or isinstance(params, Replicas) != dp:
        raise ValueError("the params must be laid out by "
                         "parallel.mesh.shard_params on this mesh")
    blocks = tokens
    if dp and not isinstance(tokens, tuple):
        blocks = shard_batch(torch.as_tensor(tokens), mesh)
    if not isinstance(blocks, tuple):
        blocks = (blocks,)          # whole: dp shard 0 runs it alone
    per = [tree_leaves(trained(r)) for r in replicas]
    uniq = list({id(p): p for leaves in per for p in leaves}.values())
    for p in uniq:
        p.requires_grad_(True)
    n_rows = sum(b.shape[0] for b in blocks)
    gathered, total = {}, None
    for tree, sub, rows in zip(replicas, subs, blocks):
        if id(tree) not in gathered:
            gathered[id(tree)] = gather_fsdp(tree)
        rows = torch.as_tensor(rows, device=sub.device())
        loss = loss_fn(gathered[id(tree)], rows,
                       mesh=_compute_mesh(sub)) * (rows.shape[0] / n_rows)
        total = loss if total is None else total + loss.to(total.device)
    del gathered
    grads = dict(zip(map(id, uniq), torch.autograd.grad(
        total, uniq, allow_unused=True, materialize_grads=True)))
    for k in range(len(per[0])):
        ps = list({id(leaves[k]): leaves[k] for leaves in per}.values())
        if len(ps) > 1:
            home = ps[0].device
            s = sum(grads[id(p)].float().to(home) for p in ps)
            for p in ps:
                grads[id(p)] = s.to(p.device, p.dtype)
    return total.detach(), [grads[id(p)] for leaves in per for p in leaves]


def _one_tree(part):
    """The stacked tree of a tp = 1 part of ``shard_params``' layout (a
    tuple of one tree), or the tree itself."""
    if not isinstance(part, tuple):
        return part
    if len(part) != 1:
        raise NotImplementedError("the 1F1B step runs whole stage slabs; "
                                  "tp shards inside a stage wait for "
                                  "ROADMAP A.17")
    return part[0]


def _stage_slabs_of(layers):
    """``params["layers"]`` as ``pipeline_train_1f1b`` takes it: a
    ``Staged`` of stacked slabs, or the stacked tree (one stage)."""
    if isinstance(layers, Staged):
        return Staged(_one_tree(p) for p in layers)
    return _one_tree(layers)


def pipeline_loss_and_grads(params, tokens, cfg: transformer.ModelConfig,
                            mesh, n_micro: int = 0, axis_name: str = "pp",
                            dp_axis: str = None):
    """(loss, grads) of the pipelined LM loss: the reference's
    ``loss_and_grads`` inside ``make_pipeline_train_step``.  The
    embedding runs on the first device over the whole batch, the layers
    through ``parallel.pipeline.pipeline_train_1f1b`` (``n_micro``
    microbatches, default the stage count; a batch they do not divide
    raises), the head is ``final_scale`` + ``lm_head`` with the loss
    through ``transformer._head_mm``, and the embedding's gradient is
    pulled back through the returned ``dx_micro``.  ``params``:
    ``shard_params``' layout on the mesh (a ``Replicas`` under
    ``dp_axis``) or the stacked tree; ``tokens`` ``[B, S+1]`` or
    ``shard_batch``'s row blocks.  The grads are f32 (the embedding's in
    its dtype), in ``params``' layout."""
    from .pipeline import pipeline_train_1f1b

    n_micro = n_micro or mesh.shape[axis_name]
    replicas = params if isinstance(params, Replicas) else (params,)
    if isinstance(params, Replicas) != bool(dp_axis):
        raise ValueError("params laid over a dp axis take dp_axis, and "
                         "dp_axis takes them so laid")
    if isinstance(tokens, tuple):
        tokens = torch.cat([torch.as_tensor(t).to(mesh.device())
                            for t in tokens])
    emb = replicas[0]["embed"]
    tokens = torch.as_tensor(tokens, device=emb.device)
    b, s1 = tokens.shape
    s = s1 - 1
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible into {n_micro} "
                         f"microbatches")
    mb = b // n_micro
    targets = tokens[:, 1:].long().reshape(n_micro, mb, s)
    tables = {}                              # rope tables by (card, rows)

    def layer_fn(layer, x):
        key = (x.device, x.shape[0])
        if key not in tables:
            pos = torch.arange(s, device=x.device)[None, :].expand(
                x.shape[0], s)
            tables[key] = transformer.rope_tables(pos, cfg.head_dim,
                                                  cfg.rope_theta)

        def attend(lyr, xin, lora, t):
            q, k, v = transformer._qkv(lyr, xin, cfg, tables[key], lora)
            return transformer.attention(q, k, v, causal=True,
                                         window=cfg.window)

        with transformer.on_card(x.device):
            return transformer._attn_ffn(layer, x, cfg, attend)[0]

    def loss_fn(hp, y, tgt):
        h = transformer.rmsnorm(y, hp["final_scale"], cfg.norm_eps)
        # _head_mm, not a bf16 product: the pipelined step's logits are
        # the sequential forward's
        logp = torch.log_softmax(transformer._head_mm(h, hp["lm_head"]), -1)
        return -logp.gather(-1, tgt[..., None])[..., 0].mean()

    e = emb.detach().requires_grad_(True)
    with torch.enable_grad():
        x_micro = transformer._embed({"embed": e}, tokens[:, :-1], cfg)
        x_micro = x_micro.reshape(n_micro, mb, s, cfg.d_model)

    def over(fn):
        parts = [fn(r) for r in replicas]
        return Replicas(parts) if dp_axis else parts[0]

    layers = over(lambda r: _stage_slabs_of(r["layers"]))
    head = over(lambda r: {"final_scale": r["final_scale"],
                           "lm_head": r["lm_head"]})
    loss, g_layers, g_head, dx = pipeline_train_1f1b(
        layer_fn, layers, head, loss_fn, x_micro, targets, mesh,
        axis_name=axis_name, dp_axis=dp_axis)
    (g_embed,) = torch.autograd.grad(x_micro, e, dx.to(x_micro.dtype))
    del x_micro, dx
    if not dp_axis:
        g_layers, g_head = (g_layers,), (g_head,)
    out = []
    for r, gl, gh in zip(replicas, g_layers, g_head):
        if isinstance(r["layers"], Staged):
            gl = Staged(g if isinstance(p, dict) else (g,)
                        for p, g in zip(r["layers"], gl))
        elif isinstance(r["layers"], tuple):
            gl = (gl,)
        grads = {"layers": gl, "embed": g_embed.to(r["embed"].device), **gh}
        out.append({k: grads[k] for k in r})
    return loss, (Replicas(out) if dp_axis else out[0])


def make_pipeline_train_step(cfg: transformer.ModelConfig, optimizer: AdamW,
                             mesh, n_micro: int = 0, axis_name: str = "pp",
                             dp_axis: str = None):
    """Pipelined LM train step: the layers 1F1B-scheduled over
    ``axis_name`` (optionally data-parallel over ``dp_axis``), the
    embedding and the norm + ``lm_head`` loss at the pipeline's edges
    (:func:`pipeline_loss_and_grads`), the f32 gradients cast to each
    param's dtype, then the optimizer in place.

    Returns ``(params, opt_state, tokens [B, S+1]) -> (params,
    opt_state, loss)``; B must divide into ``n_micro`` (default: the pp
    size) microbatches.  ``params`` and the moments are
    ``parallel.mesh.shard_params``' layout on ``mesh``.  The stages run
    whole slabs: a ``tp``, ``fsdp`` or ``sp`` axis of more than one shard
    beside ``pp`` raises."""
    beside = [a for a in mesh.axis_names
              if a not in (axis_name, dp_axis) and mesh.shape[a] > 1]
    if beside:
        raise NotImplementedError(
            f"the 1F1B step runs over {axis_name!r} and dp; {beside} "
            f"beside it waits for ROADMAP A.17")

    def train_step(params, opt_state, tokens):
        loss, grads = pipeline_loss_and_grads(
            params, tokens, cfg, mesh, n_micro, axis_name, dp_axis)
        leaves = tree_leaves(grads)
        del grads
        cast = {}
        for k, p in enumerate(tree_leaves(params)):
            g = leaves[k]
            if id(g) not in cast:
                cast[id(g)] = g.to(p.dtype)
            leaves[k] = cast[id(g)]
        del cast
        optimizer.update(params, leaves, opt_state)
        return params, opt_state, loss

    return train_step
