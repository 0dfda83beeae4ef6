"""The device mesh of the port, and how params, KV storage and the adapter
pool are laid on it.

Counterpart of ``tpushare/parallel/mesh.py``.  The JAX package drives a
pod's devices from one process: ``make_mesh`` lays a ``jax.sharding.Mesh``
over the visible devices and ``shard_map`` runs a program per shard.  Here
a :class:`Mesh` is the same thing for one process: axis names, their sizes
and one ``torch.device`` a shard, and the code that runs per shard loops
over the shards and places each one's tensors on its device.  Several
cards put the shards on different cards; one card (or the CPU) holds every
shard, which is how the tests and the one-card smoke run it.

Three axes are ported: ``tp``, tensor parallelism (the Megatron split of
the layer weights, :func:`shard_params`; KV storage and the adapter pool
split on heads, :func:`shard_kv_storage` and :func:`shard_adapter_pool`);
``sp``, position striping of the paged pool and the sequence shards of
long-context attention (``parallel.ring``, ``parallel.ulysses``: S-chunk
i on ``mesh.device(sp=i)``); and ``pp``, pipeline stages: the layer dim
of the params, of KV storage and of the adapter pool cut into one slab a
stage (:func:`stage_layer_ranges`, a :class:`Staged` of one part a
stage), stage p's part laid over the other axes on
``mesh.submesh(pp=p)`` (``parallel.pipeline`` walks the stages).  Shards
lie row-major over the axes as they are named, as ``jax.sharding.Mesh``
lays them: on ``{"tp": 2, "sp": 2}`` shard (t, s) is ``devices[t * sp +
s]`` (:meth:`Mesh.device`), and on ``{"tp", "sp", "pp"}`` shard (p, t, s)
is ``mesh.device(pp=p, tp=t, sp=s)``.

Two more axes lay out training (:func:`shard_params`, :func:`shard_batch`):
``dp``, data parallelism: the params once a dp shard (a :class:`Replicas`,
replica i laid as below on ``mesh.submesh(dp=i)``, the very same tensors
where two shards' devices coincide) and the batch split into row blocks,
block i on ``mesh.device(dp=i)``; and ``fsdp``, the ZeRO-3 split of the
reference's ``SHARDING_RULES``: ``embed``, ``lm_head`` and the column
projections (wq, wk, wv, w_gate, w_up) split their dim -2, the row ones
(wo, w_down) their dim -1, into one block an fsdp shard (an
:class:`FsdpBlocks`, block f on ``mesh.device(fsdp=f, ...)``); the steps
gather a leaf's blocks at use (:func:`gather_fsdp`) and autograd hands
each block its slice of the gradient back.

``ep``, expert parallelism (serving): an MoE layer's stacked expert
leaves (``moe_gate``, ``moe_up``, ``moe_down``; :data:`EXPERT_SHARDING_RULES`)
split their expert dim into one block an ep shard, an
``ops.experts.ExpertBlocks`` whose block e holds ``E/ep`` experts on
``mesh.device(ep=e)``: the ep shard's first device, once (the reference
replicates a block over the shard's tp and sp devices; one copy gives
the same values and the same bytes a card).  The router and the route
flag stay whole.  Where ep does not divide ``n_experts`` the pool stays
whole (the ``ep_experts`` demotion).  KV storage, the adapter pool and
the dense part of every forward lie on the mesh's ep = 0 row.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.attention import tp_degree
from ..ops.experts import ExpertBlocks, expert_fallback_reason

#: the mesh axes the port runs
PORTED_AXES = ("tp", "sp", "pp", "dp", "fsdp", "ep")

#: where each axis the port does not run yet waits, by ROADMAP item
AXES_TO_COME: Dict[str, str] = {}

#: the serving MoE pool over ``ep``: each leaf's ep dim from the end
#: (None: whole).  The stacked ``[L, E, d, f]`` / ``[L, E, f, d]`` expert
#: leaves split their expert dim (-3, dim 1 of the stacked leaf), the
#: router and the route flag stay whole (routing runs once): the
#: reference's ``EXPERT_SHARDING_RULES``
EXPERT_SHARDING_RULES = (("router", None), ("moe_route", None),
                         ("moe_gate", ExpertBlocks.dim),
                         ("moe_up", ExpertBlocks.dim),
                         ("moe_down", ExpertBlocks.dim))

#: the fsdp dim of each leaf the reference's ``SHARDING_RULES`` split over
#: ``fsdp`` (its rules right-aligned on the leaf): ``P("fsdp", "tp")``
#: puts fsdp on dim -2, ``P("tp", "fsdp")`` on dim -1; every other leaf
#: (norm scales, an MoE layer's router and experts) stays whole
FSDP_DIMS = {"embed": -2, "lm_head": -2, "wq": -2, "wk": -2, "wv": -2,
             "w_gate": -2, "w_up": -2, "wo": -1, "w_down": -1}


class Staged(tuple):
    """One part a pipeline stage, in stage order: ``params["layers"]``,
    KV storage or the adapter pool laid over a ``pp`` axis.  Part p holds
    layers ``stage_layer_ranges(L, pp)[p]`` in the layout the other axes
    give it on ``mesh.submesh(pp=p)`` (a stacked tree, or a tuple of one
    a tp shard; a ``(k, v)`` pair, or a tuple of one a shard).  A tuple,
    so the KV tree walks (``transformer.kv_tree_map``) keep it one."""

    __slots__ = ()


class Replicas(tuple):
    """One tree a ``dp`` shard, in shard order: :func:`shard_params` on a
    mesh with a ``dp`` axis.  Replica i is laid out on
    ``mesh.submesh(dp=i)``; two replicas whose devices coincide are the
    same tree, so a card holds each tensor once."""

    __slots__ = ()


class FsdpBlocks(tuple):
    """A leaf split along dim -2 into one block an ``fsdp`` shard, block f
    on ``mesh.device(fsdp=f, ...)`` (:data:`FSDP_DIMS`)."""

    __slots__ = ()
    dim = -2


class FsdpBlocksLast(FsdpBlocks):
    """:class:`FsdpBlocks` along dim -1 (the row-parallel leaves)."""

    __slots__ = ()
    dim = -1


class TpBlocks(tuple):
    """A member of a loraized weight dict split along dim -2 over ``tp``
    (:func:`lora_member_dims`): block t on ``mesh.device(tp=t)``, an
    :class:`FsdpBlocks` where ``fsdp`` splits it too.  Every tp shard's
    tree holds the same object, so each shard can join the blocks its
    product needs (:func:`tp_compute_tree`)."""

    __slots__ = ()
    dim = -2


class TpBlocksLast(TpBlocks):
    """:class:`TpBlocks` along dim -1 (the column-parallel targets)."""

    __slots__ = ()
    dim = -1


def view_key(t: torch.Tensor) -> tuple:
    """What makes two tensors the same elements: device, storage, offset,
    shape, strides and dtype.  Two views with one key are one set of
    elements; the optimizer steps them once."""
    return (t.device, t.untyped_storage().data_ptr(), t.storage_offset(),
            tuple(t.shape), tuple(t.stride()), t.dtype)


class _Placer:
    """``x.to(dev)`` that hands back the same tensor for the same elements
    placed on the same device again (a replica of a shared card, a stage
    of two dp shards on one card)."""

    def __init__(self):
        self._placed = {}

    def __call__(self, x: torch.Tensor, dev) -> torch.Tensor:
        key = (view_key(x), canonical_device(dev))
        y = self._placed.get(key)
        if y is None:
            y = self._placed[key] = x.detach().to(key[1])
        return y


def stage_layer_ranges(n_layers: int, pp: int) -> Tuple[Tuple[int, int], ...]:
    """``((start, stop), ...)``: the layers of each pipeline stage.  An
    even split where ``pp`` divides ``n_layers``; otherwise the remainder
    goes to the earliest stages, as the reference answers (the serving
    stage program refuses such a count: ``pp_layers``)."""
    if pp <= 0:
        raise ValueError(f"pp must be positive, got {pp}")
    base, rem = divmod(n_layers, pp)
    out, start = [], 0
    for s in range(pp):
        n = base + (1 if s < rem else 0)
        out.append((start, start + n))
        start += n
    return tuple(out)


def canonical_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index filled in (a bare
    ``cuda`` names the current card), so that two names of one device
    compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes (``shape``, as ``jax.sharding.Mesh``
    gives them) and one device per shard, in row-major order over the
    axes."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]

    def device(self, **index: int) -> torch.device:
        """The device of the shard at ``index`` (``mesh.device(tp=1,
        sp=0)``), row-major over the axes; an axis left out is at 0, so
        ``mesh.device()`` is the first device and ``mesh.device(tp=t)``
        the one of tp shard t's first stripe."""
        for name in index:
            if name not in self.axis_names:
                raise ValueError(f"mesh {self.shape} has no {name!r} axis")
        flat = 0
        for name in self.axis_names:
            i = int(index.get(name, 0))
            if not 0 <= i < self.shape[name]:
                raise IndexError(f"{name}={i} is outside the mesh's "
                                 f"{self.shape[name]}")
            flat = flat * self.shape[name] + i
        return self.devices[flat]

    def submesh(self, **fixed: int) -> "Mesh":
        """The mesh over the other axes with ``fixed`` axes held at the
        given indices: ``{"tp": 2, "sp": 2}.submesh(tp=1)`` is tp shard
        1's two stripes, an ``sp`` mesh; fixing every axis leaves a mesh
        of no axes and one device."""
        names = tuple(n for n in self.axis_names if n not in fixed)
        devs = []
        for flat in range(math.prod(self.shape[n] for n in names)):
            index, rest = dict(fixed), flat
            for n in reversed(names):
                rest, index[n] = divmod(rest, self.shape[n])
            devs.append(self.device(**index))
        return Mesh(names, {n: self.shape[n] for n in names}, tuple(devs))


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a :class:`Mesh` from ``{axis_name: size}``; -1 means "the
    rest".  ``devices`` defaults to the visible CUDA cards, one shard a
    card; a list that repeats a device puts several shards on it (tests,
    one card).  Too few devices raise, as in the JAX package: shards
    never share a card unless the caller says so."""
    for name in axes:
        if name not in PORTED_AXES:
            item = AXES_TO_COME.get(name)
            raise NotImplementedError(
                f"mesh axis {name!r} is not ported yet (the port runs "
                f"{PORTED_AXES}"
                + (f"; {name} waits for ROADMAP {item}" if item else "")
                + ")")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [canonical_device(d) for d in devices]
    names = list(axes.keys())
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if known == 0:
        raise ValueError(f"zero-size axis in {axes}")
    if -1 in sizes:
        if len(devs) % known:
            raise ValueError(
                f"{len(devs)} devices not divisible by {known} for {axes}")
        sizes[sizes.index(-1)] = len(devs) // known
    total = math.prod(sizes)
    if total > len(devs):
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {len(devs)}")
    return Mesh(tuple(names), dict(zip(names, sizes)), tuple(devs[:total]))


def shard_device(mesh: Mesh, **index: int) -> torch.device:
    """:meth:`Mesh.device` with the axes ``mesh`` lacks left out: the
    device of tp shard t on a stage's mesh with or without a tp axis."""
    return mesh.device(**{k: v for k, v in index.items()
                          if k in mesh.axis_names})


def without_ep(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh``'s ep = 0 row, where KV storage, the adapter pool and the
    dense part of a forward lie (None when no axis remains); ``mesh``
    itself without an ep axis."""
    if mesh is None or "ep" not in mesh.axis_names:
        return mesh
    sub = mesh.submesh(ep=0)
    return sub if sub.axis_names else None


def _expert_split(name: str, leaf, mesh: Mesh, put, n_experts: int,
                  axis: str = "ep", **index):
    """Expert leaf ``name`` as :class:`ExpertBlocks` over the mesh's
    ``axis`` (block e on ``shard_device(mesh, axis=e, **index)``), or None
    where it stays whole: not an expert leaf of
    :data:`EXPERT_SHARDING_RULES`, no such axis, or one the expert count
    does not divide."""
    dim = dict(EXPERT_SHARDING_RULES).get(name)
    ep = tp_degree(mesh, axis)
    if (dim is None or ep == 1 or not isinstance(leaf, torch.Tensor)
            or expert_fallback_reason(n_experts, ep)):
        return None
    return ExpertBlocks(put(_split(leaf, dim, e, ep),
                            shard_device(mesh, **{axis: e}, **index))
                        for e in range(ep))


def shard_expert_pool(layers, mesh: Mesh, axis: str = "ep"):
    """The expert leaves of a stacked layers tree (or of one layer's)
    laid over ``mesh``'s ``axis``: ``moe_gate``/``moe_up``/``moe_down``
    as :class:`ExpertBlocks`, block e on ``mesh.device(ep=e)`` (views
    where that is the leaf's device), every other leaf as it is; the
    standalone counterpart of :func:`shard_params`' ep layout.  Without
    the axis, or where it does not divide the expert count (the
    ``ep_experts`` demotion), the tree comes back as it is."""
    e = layers["moe_gate"].shape[ExpertBlocks.dim]
    put = _Placer()
    out = {}
    for name, leaf in layers.items():
        blocks = _expert_split(name, leaf, mesh, put, e, axis)
        out[name] = leaf if blocks is None else blocks
    return out


def _slab(tree, a: int, b: int):
    """Layers ``[a, b)`` of a tree (dicts, tuples) of stacked ``[L, ...]``
    leaves: views."""
    if isinstance(tree, dict):
        return {k: _slab(v, a, b) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_slab(v, a, b) for v in tree)
    return tree[a:b]


def stage_meshes(mesh: Optional[Mesh], n_layers: int, axis: str = "pp"):
    """``[(p, (start, stop), mesh.submesh(pp=p))]`` for each stage of a
    ``pp`` axis of more than one stage, else None."""
    if mesh is None or axis not in mesh.axis_names or mesh.shape[axis] < 2:
        return None
    return [(p, r, mesh.submesh(**{axis: p})) for p, r in
            enumerate(stage_layer_ranges(n_layers, mesh.shape[axis]))]


def _split(x: torch.Tensor, dim: int, t: int, n: int) -> torch.Tensor:
    """Block ``t`` of ``n`` equal blocks of ``x`` along ``dim`` (a view)."""
    size = x.shape[dim] // n
    return x.narrow(dim, t * size, size)


def shard_params(params, mesh: Mesh, cfg):
    """The params laid over the mesh's ``tp``, ``pp``, ``ep``, ``fsdp``
    and ``dp`` axes.

    ``tp``, the Megatron split: ``{"embed", "final_scale", "lm_head",
    "layers": (tree_0, ..., tree_{tp-1})}``, tree t holding tp shard t's
    layer leaves on ``mesh.device(tp=t)``.  The column-parallel leaves
    (``transformer.TP_COL_LEAVES``: wq, wk, wv, w_gate, w_up) take block t
    of their output dim, the row-parallel ones (``TP_ROW_LEAVES``: wo,
    w_down) block t of their input dim; tree 0 also holds the leaves no
    shard splits (the norm scales, an MoE layer's router and experts,
    which never tp-shard) on the first device, where ``embed``, the final
    norm and ``lm_head`` stay whole and the dense part of every forward
    runs (a later multi-card slice may split ``lm_head`` by vocab, as the
    JAX package's rules do).

    An int8 ``{"q","s"}`` or int4 ``{"q4","s"}`` leaf splits by the
    reference's rule for its parent (:func:`_dict_trees`): ``q`` takes
    block t of d_out (column) or d_in (row), int4's ``q4 [L, g,
    group/2, d_out]`` block t of d_out (column) or of the packed-row dim
    ``group/2`` of every group (row), and ``s`` stays whole on every
    shard's device.

    The split is taken only where ``transformer.tp_splits`` holds: tp
    dividing ``n_heads``, ``n_kv_heads``, ``d_model`` and ``d_ff``, and
    ``group/2`` of an int4 row leaf.  Otherwise every tree holds the
    full-width weights, which preserves every value, and the forwards run
    the model as tp = 1 on the first device.

    ``pp`` (more than one stage), the layer-to-stage split:
    ``params["layers"]`` is a :class:`Staged`, stage p's part the tp
    layout above of its layers ``stage_layer_ranges(L, pp)[p]`` on
    ``mesh.submesh(pp=p)``; ``embed``, the final norm and ``lm_head`` stay
    on the first device.

    ``ep``: an MoE layer's ``moe_gate``, ``moe_up`` and ``moe_down``
    (:data:`EXPERT_SHARDING_RULES`) become :class:`ExpertBlocks`, block e
    of ``E/ep`` experts on ``mesh.device(ep=e, tp=t)`` of the tree's tp
    shard (of each stage's mesh under pp); the router and the route flag
    stay whole with the tree.  An ep that does not divide ``n_experts``
    leaves the pool whole (``ep_experts``).

    ``fsdp``: each plain tensor leaf :data:`FSDP_DIMS` names (after its tp
    block is taken; the ``q`` or ``q4`` of a quantized leaf tp splits, on
    its rule's other dim) becomes an :class:`FsdpBlocks` of one block an fsdp
    shard on ``mesh.device(fsdp=f, tp=t)``, ``embed`` and ``lm_head`` on
    ``mesh.device(fsdp=f)``; where fsdp does not divide the dim the leaf
    stays whole on fsdp shard 0's device, the reference's legalization.

    A loraized leaf (``ops.lora``: ``{"w" | "q" | "q4", "s", "a", "b",
    "scale"}``) is laid out member by member by the reference's rule for
    its parent (:func:`lora_member_dims`): a member whose tp dim tp
    divides is a :class:`TpBlocks` every shard's dict holds, one whose
    fsdp dim fsdp divides is split into :class:`FsdpBlocks`, the adapter
    dims falling back to whole where the rule does not divide them;
    ``s`` and ``scale`` stay whole.  The forward joins what a shard's
    product needs (:func:`tp_compute_tree`).

    ``dp``: a :class:`Replicas` of the layout above, replica i on
    ``mesh.submesh(dp=i)``.

    Leaves are sliced, never copied whole: a shard on the params' own
    device holds views of them (a stage's slab and a column block are
    views the matrix products read in place), one on another device a
    copy of its block only; nothing else of the whole tree is kept.  The
    same elements placed on one device twice are one tensor."""
    put = _Placer()
    if "dp" not in mesh.axis_names:
        return _shard_replica(params, mesh, cfg, put)
    subs = [mesh.submesh(dp=i) for i in range(mesh.shape["dp"])]
    trees = [_shard_replica(params, subs[0], cfg, put)]
    for sub in subs[1:]:
        trees.append(trees[0] if sub.devices == subs[0].devices
                     else _shard_replica(params, sub, cfg, put))
    return Replicas(trees)


def _shard_replica(params, mesh: Mesh, cfg, put: _Placer):
    """:func:`shard_params` on a mesh without a ``dp`` axis."""
    out = {}
    for k, v in params.items():
        if k != "layers":
            out[k] = _fsdp_put(k, v, mesh, put)
            continue
        stages = stage_meshes(mesh, cfg.n_layers)
        out[k] = (_tp_trees(v, mesh, cfg, put) if stages is None else
                  Staged(_tp_trees(_slab(v, a, b), sub, cfg, put)
                         for _, (a, b), sub in stages))
    return out


def _fsdp_put(name: str, leaf, mesh: Mesh, put: _Placer, **index):
    """``leaf`` on ``shard_device(mesh, **index)``; a plain tensor that
    :data:`FSDP_DIMS` names split into :class:`FsdpBlocks` over the
    mesh's ``fsdp`` axis where fsdp divides its dim."""
    n = mesh.shape["fsdp"] if "fsdp" in mesh.axis_names else 1
    if isinstance(leaf, dict):
        dev = shard_device(mesh, **index)
        return {k: put(x, dev) for k, x in leaf.items()}
    dim = FSDP_DIMS.get(name)
    if n == 1 or dim is None or leaf.dim() < 2 or leaf.shape[dim] % n:
        return put(leaf, shard_device(mesh, **index))
    blocks = FsdpBlocks if dim == -2 else FsdpBlocksLast
    return blocks(put(_split(leaf, dim, f, n),
                      shard_device(mesh, fsdp=f, **index))
                  for f in range(n))


def is_loraized(leaf) -> bool:
    """A weight dict that carries LoRA adapters (``ops.lora``)."""
    return isinstance(leaf, dict) and "a" in leaf and "b" in leaf


def lora_member_dims(name: str) -> Tuple[int, int]:
    """(tp dim, fsdp dim) of every weight-sized member of target
    ``name``'s loraized dict (the base ``w``, ``q`` or ``q4``, ``a``,
    ``b``): the reference's ``SHARDING_RULES`` entry of the parent,
    right-aligned on the member, ``P("fsdp", "tp")`` for a column target
    and ``P("tp", "fsdp")`` for a row one.  ``s`` and ``scale`` stay
    whole (:data:`LORA_WHOLE_MEMBERS`)."""
    return (-1, -2) if name in ADAPTER_COL_TARGETS else (-2, -1)


#: the members of a loraized dict the reference replicates
LORA_WHOLE_MEMBERS = ("s", "scale")


def _dict_trees(name: str, leaf, mesh: Mesh, put: _Placer, tp: int) -> list:
    """A weight dict (a loraized leaf, or an int8 ``{"q","s"}`` / int4
    ``{"q4","s"}`` one) laid out by the reference's rule for its parent
    (:func:`lora_member_dims`), one dict a tp shard: a member whose tp dim
    tp divides takes block t (a loraized leaf's as a :class:`TpBlocks`,
    the same object in every shard's dict; a quantized leaf's block t
    alone), one fsdp divides splits into :class:`FsdpBlocks` on its fsdp
    dim, each legalized apart as the reference's shardings are; ``s``,
    ``scale`` and what neither divides lie whole on each shard's
    device."""
    n_f = mesh.shape["fsdp"] if "fsdp" in mesh.axis_names else 1
    tp_dim, f_dim = lora_member_dims(name)
    shared = is_loraized(leaf)

    def fsdp_put(y, t):
        if n_f == 1 or y.shape[f_dim] % n_f:
            return put(y, shard_device(mesh, tp=t))
        blocks = FsdpBlocks if f_dim == -2 else FsdpBlocksLast
        return blocks(put(_split(y, f_dim, f, n_f),
                          shard_device(mesh, fsdp=f, tp=t))
                      for f in range(n_f))

    trees = [{} for _ in range(tp)]
    for key, x in leaf.items():
        if key in LORA_WHOLE_MEMBERS:
            for t in range(tp):
                trees[t][key] = put(x, shard_device(mesh, tp=t))
        elif tp > 1 and x.shape[tp_dim] % tp == 0:
            blocks = [fsdp_put(_split(x, tp_dim, t, tp), t)
                      for t in range(tp)]
            if shared:
                blocks = [(TpBlocks if tp_dim == -2 else TpBlocksLast)(
                    blocks)] * tp
            for t in range(tp):
                trees[t][key] = blocks[t]
        else:
            for t in range(tp):
                trees[t][key] = fsdp_put(x, t)
    return trees


def tp_compute_tree(tree, t: Optional[int]):
    """Tp shard t's tree of :func:`shard_params`' layout (its fsdp blocks
    gathered) as the forward computes with it.  Each :class:`TpBlocks`
    member of a loraized leaf is block t where the shard's product splits
    that way (the base, and the adapter half on the split dim: ``b`` of
    a column target, ``a`` of a row one) and the blocks joined on block
    t's device otherwise (the other half, split on the rank: the
    all-gather the reference's program makes).  A quantized column block
    (int8 ``q``, int4 ``q4`` holding d_out columns ``[t*w, (t+1)*w)``)
    takes those columns of the whole ``s``, a view; a row block keeps
    the whole ``s``.  ``t`` None: every member joined whole on block 0's
    device, the model run as tp = 1 (a model :func:`~tpushare_torch.
    models.transformer.tp_splits` refuses; ``ops.lora.
    make_lora_train_step`` refuses to train it).  The join is
    ``torch.cat``, so each block gets its slice of the gradient."""
    if not any(isinstance(v, dict) for v in tree.values()):
        return tree
    out = dict(tree)
    for name, leaf in tree.items():
        if not isinstance(leaf, dict):
            continue
        # the adapter half split on the rank
        ranked = "a" if name in ADAPTER_COL_TARGETS else "b"
        view = {}
        for key, x in leaf.items():
            if not isinstance(x, TpBlocks):
                view[key] = x
            elif t is not None and key != ranked:
                view[key] = x[t]
            else:
                dev = x[0 if t is None else t].device
                view[key] = torch.cat([b.to(dev) for b in x], x.dim)
        base = view.get("q", view.get("q4"))
        if (t is not None and base is not None
                and name in ADAPTER_COL_TARGETS
                and base.shape[-1] != view["s"].shape[-1]):
            w = base.shape[-1]
            view["s"] = view["s"].narrow(-1, t * w, w)
        out[name] = view
    return out


def _tp_trees(layers, mesh: Mesh, cfg, put: _Placer) -> tuple:
    """One tree of layer leaves a tp shard of ``mesh`` (one tree on a
    mesh without a tp axis): :func:`shard_params`' tp layout, each leaf
    split further over ``fsdp``; a loraized leaf, and a quantized one
    where the model takes the split, by :func:`_dict_trees`."""
    from ..models import transformer

    tp = mesh.shape.get("tp", 1)
    split = transformer.tp_splits(layers, cfg, tp)
    trees = [{} for _ in range(tp)]
    for name, leaf in layers.items():
        if is_loraized(leaf) or (split and isinstance(leaf, dict) and name
                                 in transformer.TP_COL_LEAVES
                                 + transformer.TP_ROW_LEAVES):
            for tree, part in zip(trees, _dict_trees(name, leaf, mesh, put,
                                                     tp)):
                tree[name] = part
    for t in range(tp):
        tree = trees[t]
        for name, leaf in layers.items():
            if name in tree:
                continue
            if split and name in transformer.TP_COL_LEAVES:
                leaf = _split(leaf, -1, t, tp)
            elif split and name in transformer.TP_ROW_LEAVES:
                leaf = _split(leaf, -2, t, tp)
            elif split and t > 0:
                continue
            blocks = _expert_split(name, leaf, mesh, put,
                                   getattr(cfg, "n_experts", 0), tp=t)
            tree[name] = (blocks if blocks is not None
                          else _fsdp_put(name, leaf, mesh, put, tp=t))
    return tuple({name: tree[name] for name in layers if name in tree}
                 for tree in trees)


def whole_leaf(leaf, device=None):
    """A leaf of a placed tree whole on ``device`` (default: its first
    block's): an :class:`FsdpBlocks`' (or tp, expert) blocks
    concatenated, a weight dict's tensors moved."""
    if device is None:
        device = _first_device(leaf)
    if isinstance(leaf, (FsdpBlocks, ExpertBlocks, TpBlocks)):
        return torch.cat([whole_leaf(b, device) for b in leaf], leaf.dim)
    if isinstance(leaf, dict):
        return {k: whole_leaf(x, device) for k, x in leaf.items()}
    return leaf.to(device)


def _first_device(x) -> torch.device:
    while isinstance(x, (tuple, dict)):
        x = next(iter(x.values() if isinstance(x, dict) else x))
    return x.device


def _whole_layers(layers, cfg, device):
    """The stacked ``[L, ...]`` layer leaves of a placed ``layers``: a
    :class:`Staged`'s parts concatenated on dim 0, tp trees' blocks on
    the dim their split took."""
    from ..models import transformer

    if isinstance(layers, Staged):
        parts = [_whole_layers(p, cfg, device) for p in layers]

        def cat(xs):
            if isinstance(xs[0], dict):
                return {k: cat([x[k] for x in xs]) for k in xs[0]}
            return torch.cat(xs, 0)

        return {k: cat([p[k] for p in parts]) for k in parts[0]}
    if not isinstance(layers, tuple):
        return {k: whole_leaf(v, device) for k, v in layers.items()}
    split = transformer.tp_splits(layers, cfg, len(layers))
    out = {}
    for name, leaf in layers[0].items():
        if split and not is_loraized(leaf) and name in \
                transformer.TP_COL_LEAVES + transformer.TP_ROW_LEAVES:
            dim = lora_member_dims(name)[0]

            def cat(key=None):
                return torch.cat([whole_leaf(tree[name] if key is None
                                             else tree[name][key], device)
                                  for tree in layers], dim)

            out[name] = ({k: (whole_leaf(x, device)
                              if k in LORA_WHOLE_MEMBERS else cat(k))
                          for k, x in leaf.items()}
                         if isinstance(leaf, dict) else cat())
        else:
            out[name] = whole_leaf(leaf, device)
    return out


@torch.no_grad()
def gather_params(placed, cfg, device=None):
    """The whole tree of a placed one (:func:`shard_params`' layout, or a
    tree of tensors another placement made: the optimizer's moments, an
    adapter dict): replica 0 of :class:`Replicas`, fsdp blocks, tp blocks
    and stage slabs put back together, every tensor on ``device`` (default:
    the first leaf's).  Each tensor is a copy only where a block is
    joined or moved."""
    if isinstance(placed, Replicas):
        placed = placed[0]
    if device is None:
        device = _first_device(placed)
    return {k: (_whole_layers(v, cfg, device) if k == "layers"
                else whole_leaf(v, device)) for k, v in placed.items()}


def gather_fsdp(tree, _memo=None):
    """``tree`` with each :class:`FsdpBlocks` joined into one tensor on
    its first block's device (``torch.cat``, differentiable: the
    backward hands each block its slice of the gradient, the
    reduce-scatter); every other leaf as it is.  A tuple the tree holds
    twice (a :class:`TpBlocks` every tp shard shares) is gathered
    once."""
    memo = {} if _memo is None else _memo
    if isinstance(tree, FsdpBlocks):
        dev = tree[0].device
        return torch.cat([b.to(dev) for b in tree], tree.dim)
    if isinstance(tree, dict):
        return {k: gather_fsdp(v, memo) for k, v in tree.items()}
    if isinstance(tree, tuple):
        if id(tree) not in memo:
            memo[id(tree)] = type(tree)(gather_fsdp(v, memo) for v in tree)
        return memo[id(tree)]
    return tree


def shard_batch(batch, mesh: Mesh, axis: str = "dp"):
    """The batch ``[B, ...]`` split on its leading dim over ``axis``: a
    tuple of one row block a shard, block i on ``mesh.device(axis=i)``.
    Without the axis, or where the axis does not divide B (the
    reference's legalization), the batch stays whole and is returned as
    it is."""
    if axis not in mesh.axis_names:
        return batch
    n, b = mesh.shape[axis], batch.shape[0]
    if b % n:
        return batch
    batch = torch.as_tensor(batch)
    return tuple(batch[i * b // n:(i + 1) * b // n].to(
        mesh.device(**{axis: i})) for i in range(n))


def shard_kv_storage(storage, mesh: Mesh, axis: str = "tp",
                     page_axis: Optional[str] = "sp",
                     layer_axis: Optional[str] = "pp") -> Tuple:
    """KV storage ``(k, v)`` laid over the mesh: one ``(k, v)`` pair a
    shard, in the mesh's row-major order, shard (t, s) on
    ``mesh.device(tp=t, sp=s)``.  A store is a tensor or an int8
    ``{"q","s"}`` dict; dense caches are ``[L, B, Hkv, T, D]`` and paged
    pools ``[L, n_pages, Hkv, page, D]``, so both put the kv heads at
    dim 2.

    ``axis`` (``tp``) splits the kv-head dim, int8 scales with their
    values: shard t holds heads ``[t*Hkv/tp, (t+1)*Hkv/tp)``, whole GQA
    groups, the layout the tp forwards read.  A head count the axis does
    not divide keeps the storage whole on every shard, as the JAX
    package's legalization does.  ``page_axis`` (``sp``, paged pools
    only: dim 1 is the page dim there) splits the pages into equal
    stripes, stripe s holding global pages ``[s*per, (s+1)*per)``, its
    local page 0 its trash page; the port's batcher always rounds to
    equal stripes, so an indivisible page count raises.  An axis the
    mesh lacks splits nothing.  ``layer_axis`` (``pp``, of more than one
    stage) splits dim 0, the stacked layer dim of both layouts: a
    :class:`Staged` whose part p is stage p's layers laid as above on
    ``mesh.submesh(pp=p)``.  Each part is a contiguous copy."""
    leaf = storage[0]["q"] if isinstance(storage[0], dict) else storage[0]
    stages = (stage_meshes(mesh, leaf.shape[0], layer_axis) if layer_axis
              else None)
    if stages is not None:
        return Staged(shard_kv_storage(_slab(tuple(storage), a, b), sub,
                                       axis, page_axis, None)
                      for _, (a, b), sub in stages)
    tp = mesh.shape.get(axis, 1) if axis in mesh.axis_names else 1
    sp = (mesh.shape[page_axis] if page_axis in mesh.axis_names else 1)
    n_pages, hkv = leaf.shape[1], leaf.shape[2]
    if n_pages % sp:
        raise ValueError(f"{n_pages} pages do not split into {sp} equal "
                         f"position stripes")
    heads = tp > 1 and hkv % tp == 0

    def shard(store, t, s):
        index = {}
        if axis in mesh.axis_names:
            index[axis] = t
        if page_axis in mesh.axis_names:
            index[page_axis] = s
        dev = mesh.device(**index)

        def part(x):
            if sp > 1:
                x = _split(x, 1, s, sp)
            if heads:
                x = _split(x, 2, t, tp)
            return x.to(dev, copy=True, memory_format=torch.contiguous_format)
        if isinstance(store, dict):
            return {k: part(v) for k, v in store.items()}
        return part(store)

    return tuple((shard(storage[0], t, s), shard(storage[1], t, s))
                 for t in range(tp) for s in range(sp))


#: adapter targets whose base projection is column-parallel: their ``b``
#: splits its d_out with the base; the row-parallel ones (wo, w_down)
#: split ``a``'s d_in
ADAPTER_COL_TARGETS = ("wq", "wk", "wv", "w_gate", "w_up")


def adapter_split_dim(name: str, key: str) -> Optional[int]:
    """The dim (from the end) along which a tp shard takes its block of
    adapter leaf ``key`` ("a" or "b") of target ``name``: -1 for a column
    target's ``b``, -2 for a row target's ``a``, None (whole) else."""
    if key == "b" and name in ADAPTER_COL_TARGETS:
        return -1
    if key == "a" and name not in ADAPTER_COL_TARGETS:
        return -2
    return None


def adapter_block(name: str, key: str, x: torch.Tensor, t: int,
                  tp: int) -> torch.Tensor:
    """Shard t's block of one adapter leaf (a pool leaf or an entry's):
    split as :func:`adapter_split_dim` says where tp divides that dim,
    else whole (the legalization of :func:`shard_params`)."""
    dim = adapter_split_dim(name, key)
    if tp == 1 or dim is None or x.shape[dim] % tp:
        return x
    return _split(x, dim, t, tp)


def shard_adapter_pool(pool, mesh: Mesh, axis: str = "tp",
                       layer_axis: Optional[str] = "pp"):
    """A stacked serving LoRA pool (``ops.lora.init_adapter_pool_arrays``)
    split like its base projections over ``axis``: one pool a tp shard on
    ``mesh.device(tp=t)``, a column target's ``b`` [L, N, r, d_out]
    holding block t of d_out, a row target's ``a`` [L, N, d_in, r] block
    t of d_in, so each shard's delta is partial exactly where its base
    product is and the one sum folds both.  The rank, the pool axis and
    ``scale`` stay whole on every shard.  ``layer_axis`` (``pp``, of more
    than one stage) splits the stacked layer dim too: a :class:`Staged`
    whose part p is stage p's layers on ``mesh.submesh(pp=p)``, a pool
    (or a tuple of one a tp shard) of their rows alone.  Each part is a
    contiguous copy."""
    leaf = next(v["a"] for k, v in pool.items() if k != "scale")
    stages = (stage_meshes(mesh, leaf.shape[0], layer_axis) if layer_axis
              else None)
    if stages is not None:
        parts = []
        for _, (a, b), sub in stages:
            slab = {k: (v if k == "scale" else _slab(v, a, b))
                    for k, v in pool.items()}
            part = shard_adapter_pool(slab, sub, axis, None)
            parts.append(part if len(part) > 1 else part[0])
        return Staged(parts)
    tp = mesh.shape.get(axis, 1) if axis in mesh.axis_names else 1
    out = []
    for t in range(tp):
        dev = shard_device(mesh, **{axis: t})
        part = {"scale": pool["scale"].to(dev, copy=True)}
        for name, leaves in pool.items():
            if name != "scale":
                part[name] = {
                    k: adapter_block(name, k, x, t, tp).to(
                        dev, copy=True,
                        memory_format=torch.contiguous_format)
                    for k, x in leaves.items()}
        out.append(part)
    return tuple(out)
