"""The device mesh of the port, and how paged KV storage is laid on it.

Counterpart of ``tpushare/parallel/mesh.py``.  The JAX package drives a
pod's devices from one process: ``make_mesh`` lays a ``jax.sharding.Mesh``
over the visible devices and ``shard_map`` runs a program per shard.  Here
a :class:`Mesh` is the same thing for one process: axis names, their sizes
and one ``torch.device`` a shard, and the code that runs per shard loops
over the shards and places each one's tensors on its device.  Several
cards put the shards on different cards; one card (or the CPU) holds every
shard, which is how the tests and the one-card smoke run it.

Two axes are ported: ``tp``, tensor parallelism (the Megatron split of
the layer weights, :func:`shard_params`; KV storage and the adapter pool
split on heads, :func:`shard_kv_storage` and :func:`shard_adapter_pool`),
and ``sp``, position striping of the paged pool.  Shards lie row-major
over the axes, as ``jax.sharding.Mesh`` lays them: on ``{"tp": 2, "sp":
2}`` shard (t, s) is ``devices[t * sp + s]`` (:meth:`Mesh.device`).  The
``pp``, ``ep``, ``dp`` and ``fsdp`` rules wait for later slices
(ROADMAP A.12), and a mesh naming them raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

#: the mesh axes the port runs
PORTED_AXES = ("tp", "sp")


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
            raise NotImplementedError(
                f"mesh axis {name!r} is not ported yet (the port runs "
                f"{PORTED_AXES})")
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


def _split(x: torch.Tensor, dim: int, t: int, n: int) -> torch.Tensor:
    """Block ``t`` of ``n`` equal blocks of ``x`` along ``dim`` (a view)."""
    size = x.shape[dim] // n
    return x.narrow(dim, t * size, size)


def shard_params(params, mesh: Mesh, cfg):
    """The params laid over the mesh's ``tp`` axis, the Megatron split:
    ``{"embed", "final_scale", "lm_head", "layers": (tree_0, ...,
    tree_{tp-1})}``, tree t holding tp shard t's layer leaves on
    ``mesh.device(tp=t)``.  The column-parallel leaves
    (``transformer.TP_COL_LEAVES``: wq, wk, wv, w_gate, w_up) take block t
    of their output dim, the row-parallel ones (``TP_ROW_LEAVES``: wo,
    w_down) block t of their input dim; tree 0 also holds the leaves no
    shard splits (the norm scales, an MoE layer's router and experts,
    which never tp-shard) on the first device, where ``embed``, the final
    norm and ``lm_head`` stay whole and the dense part of every forward
    runs (a later multi-card slice may split ``lm_head`` by vocab, as the
    JAX package's rules do).

    The split is taken only where ``transformer.tp_splits`` holds: tp
    dividing ``n_heads``, ``n_kv_heads``, ``d_model`` and ``d_ff``, and
    every projection a plain tensor.  Otherwise (an int8 or int4
    ``{"q","s"}`` leaf, an indivisible count) every tree holds the
    full-width weights, which preserves every value, and the forwards run
    the model as tp = 1 on the first device.

    Leaves are sliced, never copied whole: a shard on the params' own
    device holds views of them (a column block is a strided view the
    matrix products read in place), one on another device a copy of its
    block only; nothing else of the whole tree is kept."""
    from ..models import transformer

    tp = mesh.shape.get("tp", 1)
    layers = params["layers"]
    split = transformer.tp_splits(layers, cfg, tp)
    dev0 = mesh.device()
    out = {k: v.to(dev0) if isinstance(v, torch.Tensor)
           else {n: t.to(dev0) for n, t in v.items()}
           for k, v in params.items() if k != "layers"}
    trees = []
    for t in range(tp):
        dev = mesh.device(tp=t)
        tree = {}
        for name, leaf in layers.items():
            if split and name in transformer.TP_COL_LEAVES:
                tree[name] = _split(leaf, -1, t, tp).to(dev)
            elif split and name in transformer.TP_ROW_LEAVES:
                tree[name] = _split(leaf, -2, t, tp).to(dev)
            elif t == 0 or not split:
                tree[name] = ({n: x.to(dev) for n, x in leaf.items()}
                              if isinstance(leaf, dict) else leaf.to(dev))
        trees.append(tree)
    out["layers"] = tuple(trees)
    return out


def shard_kv_storage(storage, mesh: Mesh, axis: str = "tp",
                     page_axis: Optional[str] = "sp") -> Tuple:
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
    mesh lacks splits nothing.  Each part is a contiguous copy."""
    tp = mesh.shape.get(axis, 1) if axis in mesh.axis_names else 1
    sp = (mesh.shape[page_axis] if page_axis in mesh.axis_names else 1)
    leaf = storage[0]["q"] if isinstance(storage[0], dict) else storage[0]
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


def shard_adapter_pool(pool, mesh: Mesh, axis: str = "tp") -> Tuple:
    """A stacked serving LoRA pool (``ops.lora.init_adapter_pool_arrays``)
    split like its base projections over ``axis``: one pool a tp shard on
    ``mesh.device(tp=t)``, a column target's ``b`` [L, N, r, d_out]
    holding block t of d_out, a row target's ``a`` [L, N, d_in, r] block
    t of d_in, so each shard's delta is partial exactly where its base
    product is and the one sum folds both.  The rank, the pool axis and
    ``scale`` stay whole on every shard.  Each part is a contiguous
    copy."""
    tp = mesh.shape.get(axis, 1) if axis in mesh.axis_names else 1
    out = []
    for t in range(tp):
        dev = mesh.device(**({axis: t} if axis in mesh.axis_names else {}))
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
