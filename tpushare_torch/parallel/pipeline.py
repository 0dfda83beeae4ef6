"""Pipeline parallelism over the mesh's ``pp`` axis: the GPipe schedule
and its forward, and the 1F1B training schedule and its pass.

Counterpart of ``tpushare/parallel/pipeline.py``
(:func:`pp_stage_schedule`, :func:`pp_bubble_fraction`,
:func:`pipeline_apply`, :class:`Schedule1F1B`, :func:`schedule_1f1b`,
:func:`pipeline_train_1f1b`).  The stacked ``[L, ...]`` layer leaves are cut
into one slab a stage (``parallel.mesh.stage_layer_ranges``), stage s on
``mesh.device(pp=s)``, and microbatches walk the wavefront: at tick t
stage s runs microbatch t - s.  The JAX package runs the table inside one
``shard_map`` as a ``fori_loop`` whose ``ppermute`` hands each stage's
output to the next; here one process walks the same table in tick order,
the hand-off is a move of the activation to the next stage's device (no
copy where two stages share a card), and a cell whose microbatch does not
exist (a bubble) is skipped rather than computed and discarded.  Launches
on different cards are asynchronous, so stages on different cards overlap
as the wavefront intends; on one card the stages run one after another.

:func:`pipeline_apply` is differentiable by autograd, as the reference's
is by ``jax.grad``: slicing, unbinding and moving a tensor are all
recorded.

:func:`pipeline_train_1f1b` walks the 1F1B table of
:func:`schedule_1f1b` (the reference's simulator, table for table) the
same way: one process, stage s's slab on ``mesh.device(pp=s)`` (and
``dp=i`` for each data-parallel shard, whose cells interleave tick by
tick), the activation handed forward and the cotangent back by ``.to()``.
A non-last stage's forward runs without autograd and stashes its input;
its backward recomputes the stage under autograd from the stash (the
reference's stage-granularity remat); the last stage computes once,
inside its backward's loss."""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np
import torch

from .mesh import Replicas, Staged, stage_layer_ranges


def pp_stage_schedule(n_stages: int, n_micro: int):
    """The GPipe wavefront as a static table ``((t, s, m), ...)``: at tick
    t stage s works microbatch m = t - s, for every tick where
    0 <= m < n_micro; ``n_micro + n_stages - 1`` ticks, each (stage,
    microbatch) pair exactly once."""
    if n_stages < 1 or n_micro < 1:
        raise ValueError(f"need n_stages >= 1 and n_micro >= 1, got "
                         f"({n_stages}, {n_micro})")
    return tuple((t, s, t - s)
                 for t in range(n_micro + n_stages - 1)
                 for s in range(n_stages)
                 if 0 <= t - s < n_micro)


def pp_bubble_fraction(n_stages: int, n_micro: int) -> float:
    """The GPipe bubble's share of the wavefront, idle (stage, tick) cells
    over all cells: ``(S-1)/(M+S-1)``, 0.0 at one stage (the gauge
    ``tpushare_pp_bubble_fraction``)."""
    if n_stages <= 1:
        return 0.0
    return (n_stages - 1) / (n_micro + n_stages - 1)


def walk_wavefront(run: Callable, feed: Callable, devices: List,
                   n_micro: int) -> List:
    """Walk :func:`pp_stage_schedule` in tick order over
    ``len(devices)`` stages: for each (tick, stage s, microbatch m) cell,
    ``y = run(s, m, x)`` with x ``feed(m)`` at stage 0 and, at stage
    s > 0, what stage s - 1 handed on, moved to ``devices[s]`` (the
    ``ppermute``).  Bubble cells are not in the table, so nothing runs
    there.  Returns the last stage's outputs in microbatch order."""
    n_stages = len(devices)
    in_flight, outs = {}, [None] * n_micro
    for _, s, m in pp_stage_schedule(n_stages, n_micro):
        x = (feed(m) if s == 0 else in_flight.pop(m)).to(devices[s])
        y = run(s, m, x)
        if s == n_stages - 1:
            outs[m] = y
        else:
            in_flight[m] = y.to(devices[s + 1])
    return outs


def _tree_map(f, tree):
    """``f`` over every tensor of a tree of dicts, the same nesting back."""
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    return f(tree)


def _tree_zip(f, *trees):
    """``f`` over the tensors of trees of one nesting, leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: _tree_zip(f, *(t[k] for t in trees)) for k in trees[0]}
    return f(*trees)


def _unbind_layers(tree) -> List:
    """The per-layer views of a tree of stacked ``[n, ...]`` leaves, each
    leaf cut with one ``torch.unbind`` (its backward is one stack, where
    ``x[l]`` would write a zero-filled gradient a layer)."""
    if isinstance(tree, dict):
        cols = {k: _unbind_layers(v) for k, v in tree.items()}
        n = len(next(iter(cols.values())))
        return [{k: c[l] for k, c in cols.items()} for l in range(n)]
    return list(torch.unbind(tree, 0))


def stage_slabs(stacked, mesh, axis_name: str = "pp") -> Staged:
    """Each stage's slab of a tree of stacked ``[L, ...]`` leaves: stage s
    takes layers ``stage_layer_ranges(L, pp)[s]`` on
    ``mesh.device(pp=s)``, a view where that is the leaf's device, a copy
    of the slab alone elsewhere."""
    n_stages = mesh.shape[axis_name]
    first = stacked
    while isinstance(first, dict):
        first = next(iter(first.values()))
    ranges = stage_layer_ranges(first.shape[0], n_stages)
    return Staged(
        _tree_map(lambda x, a=a, b=b, s=s: x[a:b].to(
            mesh.device(**{axis_name: s})), stacked)
        for s, (a, b) in enumerate(ranges))


def pipeline_apply(layer_fn: Callable, stacked_params, x_micro, mesh,
                   axis_name: str = "pp"):
    """Run microbatches through layer stages spread over ``axis_name``.

    * ``layer_fn(layer, x) -> x``: one layer body, applied over each
      stage's layers in order;
    * ``stacked_params``: a tree of stacked ``[L, ...]`` leaves, cut into
      stage slabs by :func:`stage_slabs`;
    * ``x_micro``: ``[M, mb, ...]`` microbatched activations.

    Walks :func:`pp_stage_schedule`: stage 0 takes microbatch m from
    ``x_micro``, stage s > 0 the activation stage s - 1 handed on; the
    last stage's outputs come back on the mesh's first device.  Returns
    ``[M, mb, ...]`` in microbatch order."""
    n_stages = mesh.shape[axis_name]
    layers = [_unbind_layers(slab)
              for slab in stage_slabs(stacked_params, mesh, axis_name)]

    def run(s, m, x):
        for layer in layers[s]:
            x = layer_fn(layer, x)
        return x

    outs = walk_wavefront(
        run, lambda m: x_micro[m],
        [mesh.device(**{axis_name: s}) for s in range(n_stages)],
        x_micro.shape[0])
    home = mesh.device()
    return torch.stack([y.to(home) for y in outs])


# ---------------------------------------------------------------------------
# 1F1B training schedule
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Schedule1F1B:
    """Static per-(tick, stage) action tables for the 1F1B schedule.

    All arrays are [T, S] int32; ``-1`` means "nothing this tick".  Slot
    columns index fixed-size ring buffers whose safety the simulator
    guarantees (entries alive at once are consecutive microbatch ids,
    fewer than the buffer length, hence distinct modulo it)."""

    n_stages: int
    n_micro: int
    n_ticks: int
    fwd_m: np.ndarray        # microbatch forwarded (or -1)
    bwd_m: np.ndarray        # microbatch backwarded (or -1)
    arr_act_m: np.ndarray    # microbatch whose activation arrives (or -1)
    arr_grad_m: np.ndarray   # microbatch whose cotangent arrives (or -1)
    act_q: int               # activation-queue depth (slot = m % act_q)
    grad_q: int              # grad-queue depth (slot = m % grad_q)
    stash: int               # input-stash depth (slot = m % stash)


def schedule_1f1b(n_stages: int, n_micro: int) -> Schedule1F1B:
    """Discrete-event simulation of non-interleaved 1F1B (PipeDream-
    flush): per tick every stage does at most ONE action, a ready
    backward first, else a forward if an activation is there and the
    stage's in-flight count is under its 1F1B bound ``S - s`` (the bound
    is the warmup: stage s admits S - s forwards before its first
    backward).  Messages sent at tick t are readable from tick t + 1 (one
    hop).  Returns the dense action tables."""
    S, M = n_stages, n_micro
    if M < 1:
        raise ValueError("need at least one microbatch")
    fwd_rows, bwd_rows, aa_rows, ag_rows = [], [], [], []
    fwds = [0] * S               # forwards done per stage
    bwds = [0] * S               # backwards done per stage
    act_q = [[] for _ in range(S)]    # microbatches queued for fwd
    grad_q = [[] for _ in range(S)]   # cotangents queued for bwd
    max_aq = [0] * S
    max_gq = [0] * S
    max_stash = [0] * S
    # messages in flight: lists of (dest_stage, microbatch)
    flying_act: list = []
    flying_grad: list = []
    t = 0
    while any(b < M for b in bwds):
        if t > 4 * (M + S) + 8:   # simulator bug guard, not a real bound
            raise RuntimeError("1F1B schedule did not converge")
        aa = [-1] * S
        ag = [-1] * S
        for dst, m in flying_act:
            act_q[dst].append(m)
            aa[dst] = m
        for dst, m in flying_grad:
            grad_q[dst].append(m)
            ag[dst] = m
        flying_act, flying_grad = [], []
        for s in range(S):
            max_aq[s] = max(max_aq[s], len(act_q[s]))
            max_gq[s] = max(max_gq[s], len(grad_q[s]))
        fw = [-1] * S
        bw = [-1] * S
        for s in range(S):
            last = s == S - 1
            bwd_ready = (fwds[s] > bwds[s]) if last else bool(grad_q[s])
            fwd_ready = (fwds[s] < M
                         and (s == 0 or bool(act_q[s]))
                         and fwds[s] - bwds[s] < S - s)
            if bwd_ready:
                m = bwds[s]
                if not last:
                    assert grad_q[s][0] == m, "grad order broke"
                    grad_q[s].pop(0)
                bw[s] = m
                bwds[s] += 1
                if s > 0:
                    flying_grad.append((s - 1, m))
            elif fwd_ready:
                m = fwds[s]
                if s > 0:
                    assert act_q[s][0] == m, "act order broke"
                    act_q[s].pop(0)
                fw[s] = m
                fwds[s] += 1
                max_stash[s] = max(max_stash[s], fwds[s] - bwds[s])
                if s < S - 1:
                    flying_act.append((s + 1, m))
        fwd_rows.append(fw)
        bwd_rows.append(bw)
        aa_rows.append(aa)
        ag_rows.append(ag)
        t += 1

    def as_np(rows):
        return np.asarray(rows, np.int32)

    return Schedule1F1B(
        n_stages=S, n_micro=M, n_ticks=t,
        fwd_m=as_np(fwd_rows), bwd_m=as_np(bwd_rows),
        arr_act_m=as_np(aa_rows), arr_grad_m=as_np(ag_rows),
        act_q=max(1, max(max_aq)), grad_q=max(1, max(max_gq)),
        stash=max(1, max(max_stash)))


class _Cells:
    """The (dp shard, stage) cells of one 1F1B pass: each cell's slab as
    autograd leaves on its device (``detach`` of the caller's tensors:
    views, never copies, where the slab already lies there), the head
    likewise on the last stage's device, and one f32 accumulator a leaf.
    Cells whose source tensors are the same (dp shards sharing a card)
    share their leaves and so their accumulators: the dp all-reduce of shards on
    one device is their sum."""

    def __init__(self, layers, heads, device, n_stages: int):
        self.layers, self.heads, self.device = layers, heads, device
        self.n_stages = n_stages
        self._memo = {}

    def _local(self, key, make):
        if key not in self._memo:
            tree = make()
            leaves = _leaves(tree)
            self._memo[key] = (tree, leaves, [
                torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves])
        return self._memo[key]

    def stage(self, i: int, s: int):
        """(slab, its leaves, their accumulators) of dp shard i, stage s."""
        src, dev = self.layers[i][s], self.device(i, s)
        return self._local((_ids(src), dev), lambda: _tree_map(
            lambda x: x.detach().to(dev).requires_grad_(True), src))

    def head(self, i: int):
        """(head params, leaves, accumulators) of dp shard i on its last
        stage's device."""
        src, dev = self.heads[i], self.device(i, self.n_stages - 1)
        return self._local(("head", _ids(src), dev), lambda: _tree_map(
            lambda x: x.detach().to(dev).requires_grad_(True), src))


def _as_staged(tree, mesh, axis_name: str) -> Staged:
    """A stacked tree's stage slabs (:func:`stage_slabs`); a ``Staged`` as
    it is."""
    if isinstance(tree, Staged):
        return tree
    lead = tree
    while isinstance(lead, dict):
        lead = next(iter(lead.values()))
    if lead.shape[0] % mesh.shape[axis_name]:
        raise ValueError(f"layer count {lead.shape[0]} not divisible into "
                         f"{mesh.shape[axis_name]} stages")
    return stage_slabs(tree, mesh, axis_name)


def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _ids(tree) -> tuple:
    """Which tensors a tree holds: two trees of the same tensors are one
    cell's source."""
    return tuple(map(id, _leaves(tree)))


def _reduce(cells: List, n_div: float):
    """The dp all-reduce of one slab's (or the head's) gradients over the
    dp shards' cells: the distinct accumulators summed on the first one's
    device and copied to every one, each divided by ``n_div``; the
    shards' gradient trees (f32, each on its cell's devices) in shard
    order, the same object for cells that are one."""
    uniq = list({id(c[2]): c for c in cells}.values())
    for k in range(len(uniq[0][2])):
        accs = [c[2][k] for c in uniq]
        if len(accs) == 1:
            accs[0].div_(n_div)
            continue
        total = accs[0].clone()
        for a in accs[1:]:
            total += a.to(total.device)
        total /= n_div
        for a in accs:
            a.copy_(total)
    grads = {}
    for c in uniq:
        it = iter(c[2])
        grads[id(c[2])] = _tree_map(lambda _: next(it), c[0])
    return [grads[id(c[2])] for c in cells]


def pipeline_train_1f1b(layer_fn: Callable, stacked_params, head_params,
                        loss_fn: Callable, x_micro, targets_micro, mesh,
                        axis_name: str = "pp", dp_axis=None):
    """One 1F1B-scheduled training pass; returns ``(loss, layer_grads,
    head_grads, dx_micro)``.

    * ``layer_fn(layer, x) -> x``: one layer body, run over each stage's
      layers in order.
    * ``stacked_params``: a tree of stacked ``[L, ...]`` leaves (L
      divisible by the pp size), cut into stage slabs here; or a
      ``Staged`` of the slabs, stage s's on ``mesh.device(pp=s)``; under
      ``dp_axis`` either of those, or a ``Replicas`` of one a dp shard.
      Gradients come back f32 in the same layout, on the same devices.
    * ``head_params`` / ``loss_fn(head_params, y, targets) -> scalar``:
      the LAST stage maps its output to a microbatch's mean loss; head
      gradients come back in ``head_params``' layout (a dict, or a
      ``Replicas`` of one a dp shard).  The loss is the mean over
      microbatches (and dp shards).
    * ``x_micro`` ``[M, mb, ...]`` / ``targets_micro`` ``[M, mb, ...]``:
      ``dx_micro`` (the cotangents of ``x_micro``, on its device) lets the
      caller pull the gradient back into what produced the pipeline
      input, the embedding.
    * ``dp_axis``: the microbatches' rows split over it, shard i taking
      block i of each microbatch's ``mb`` rows through the stages on
      ``mesh.device(pp=s, dp=i)``; its cells run tick by tick beside the
      other shards'.  Loss and gradients are averaged over the shards,
      and ``dx_micro`` is divided by the dp size too (each shard's loss
      was a mean over its own rows).

    Each stage keeps at most its 1F1B bound of stage inputs; the
    backward's recompute is the forward's work again on every stage but
    the last.  Gradients add up in f32 a leaf."""
    n_stages = mesh.shape[axis_name]
    n_micro = x_micro.shape[0]
    n_dp = mesh.shape[dp_axis] if dp_axis else 1
    sched = schedule_1f1b(n_stages, n_micro)
    if x_micro.shape[1] % n_dp:
        raise ValueError(f"a microbatch of {x_micro.shape[1]} rows does "
                         f"not split over {n_dp} dp shards")
    rows = x_micro.shape[1] // n_dp
    layers = (stacked_params if isinstance(stacked_params, Replicas)
              else (stacked_params,) * n_dp)
    heads = (head_params if isinstance(head_params, Replicas)
             else (head_params,) * n_dp)
    if len(layers) != n_dp or len(heads) != n_dp:
        raise ValueError(f"{len(layers)} layer and {len(heads)} head "
                         f"replicas for {n_dp} dp shards")
    slabs = {}
    for tree in layers:
        if id(tree) not in slabs:
            slabs[id(tree)] = _as_staged(tree, mesh, axis_name)

    def device(i, s):
        index = {axis_name: s}
        if dp_axis:
            index[dp_axis] = i
        return mesh.device(**index)

    cells = _Cells([slabs[id(t)] for t in layers], heads, device,
                   n_stages)
    dtype = x_micro.dtype
    x_all = x_micro.detach()
    dx_buf = torch.zeros_like(x_all)
    act = [[{} for _ in range(n_stages)] for _ in range(n_dp)]
    cot = [[{} for _ in range(n_stages)] for _ in range(n_dp)]
    stash = [[{} for _ in range(n_stages)] for _ in range(n_dp)]
    loss_sum = [None] * n_dp
    last = n_stages - 1

    def run(params, x):
        for layer in _unbind_layers(params):
            x = layer_fn(layer, x)
        return x

    for t in range(sched.n_ticks):
        for s in range(n_stages):
            fm, bm = int(sched.fwd_m[t, s]), int(sched.bwd_m[t, s])
            for i in range(n_dp):
                lo, hi = i * rows, (i + 1) * rows
                dev = device(i, s)
                if fm >= 0:
                    x = (x_all[fm, lo:hi].to(dev) if s == 0
                         else act[i][s].pop(fm))
                    stash[i][s][fm] = x
                    if s < last:
                        # the forward alone: the backward recomputes it
                        with torch.no_grad():
                            y = run(cells.stage(i, s)[0], x).to(dtype)
                        act[i][s + 1][fm] = y.to(device(i, s + 1))
                if bm < 0:
                    continue
                params, leaves, accs = cells.stage(i, s)
                x = stash[i][s].pop(bm).detach().requires_grad_(True)
                with torch.enable_grad():
                    if s == last:
                        hp, h_leaves, h_accs = cells.head(i)
                        lm = loss_fn(hp, run(params, x),
                                     targets_micro[bm, lo:hi].to(dev))
                        wrt, sinks = leaves + h_leaves, accs + h_accs
                        grads = torch.autograd.grad(
                            lm, wrt + [x], allow_unused=True,
                            materialize_grads=True)
                        lm = lm.detach().float()
                        loss_sum[i] = (lm if loss_sum[i] is None
                                       else loss_sum[i] + lm)
                    else:
                        y = run(params, x)
                        wrt, sinks = leaves, accs
                        grads = torch.autograd.grad(
                            y, wrt + [x], cot[i][s].pop(bm).to(dtype),
                            allow_unused=True, materialize_grads=True)
                for a, g in zip(sinks, grads):
                    a.add_(g)
                dx = grads[-1].to(dtype)
                if s > 0:
                    cot[i][s - 1][bm] = dx.to(device(i, s - 1))
                else:
                    dx_buf[bm, lo:hi] = dx.to(dx_buf.device)
                del grads, x

    scale = n_micro * n_dp
    home = x_micro.device
    loss = sum(l.to(home) for l in loss_sum) / scale
    per_stage = [_reduce([cells.stage(i, s) for i in range(n_dp)], scale)
                 for s in range(n_stages)]
    heads_g = _reduce([cells.head(i) for i in range(n_dp)], scale)
    layer_g, head_g = [], []
    for i in range(n_dp):
        parts = [per_stage[s][i] for s in range(n_stages)]
        if isinstance(layers[i], Staged):
            layer_g.append(Staged(
                _tree_zip(lambda g, p: g.to(p.device), part, src)
                for part, src in zip(parts, layers[i])))
        else:
            layer_g.append(_tree_zip(
                lambda p, *gs: torch.cat([g.to(p.device) for g in gs]),
                layers[i], *parts))
        head_g.append(_tree_zip(lambda g, p: g.to(p.device), heads_g[i],
                                heads[i]))
    if dp_axis and isinstance(stacked_params, Replicas):
        layer_g = Replicas(layer_g)
    else:
        layer_g = layer_g[0]
    head_g = Replicas(head_g) if isinstance(head_params, Replicas) \
        else head_g[0]
    return loss, layer_g, head_g, dx_buf / scale
