"""Continuous batching: a slot-pooled decode loop for LLM serving.

Counterpart of ``tpushare/serving/continuous.py``: a fixed pool of slots;
admission prefills a request into a free slot and samples its first
token; every tick advances ALL active slots one token in one batched
forward, each at its own depth; finished slots free at once and new
requests join mid-flight.

The storage is pluggable through the hooks ``_init_storage``,
``_reserve``/``_release``, ``_prefill_into``, ``_round_operand``,
``_decode_logits`` and ``_verify_logits``.  This class is the DENSE
storage: one row of
``transformer.init_kv_caches`` a slot, ``[L, n_slots, Hkv, T, D]``,
T = max_seq, or for a sliding-window config a ROLLING ring of ``window``
slots a row (``rolling_slots``, AUTO on), read through
``transformer.cached_attention`` in plain PyTorch as the JAX package
reads it in XLA.  The paged pool
(:class:`tpushare_torch.serving.paged.PagedContinuousBatcher`) overrides
the hooks.

On the dense storage a prompt may also stream in ``chunk``-token pieces
(:meth:`ContinuousBatcher.admit_chunked`, :meth:`advance_prefill`),
``n`` decode steps run in one call (:meth:`tick_fused`), and a MIXED
round (:meth:`tick_mixed`) runs the pending chunks of several prompts as
one batched prefill forward and then the fused decode steps.
:meth:`tick_spec` runs ``n`` rounds of prompt-lookup SPECULATION instead
of decode steps (each round one ``[B, 1+k]`` verify forward through the
storage's ``_verify_logits`` hook, the round body
:func:`tpushare_torch.serving.speculative.spec_scan`), and
:meth:`tick_mixed_spec` the mixed round with spec rounds as its decode
half; greedy streams are exact, so every round interleaves.  Sampling
runs per slot with its own ``torch.Generator`` seeded from the request's
``seed``, one draw a step for a sampled slot, in slot order, whichever
round runs the step: ``tick``, ``tick_fused`` and ``tick_mixed``
interleave into the same streams.  Greedy is an exact argmax, and the
top-k/top-p filter is the reference's (the draw itself cannot match
``jax.random``'s bits).

Telemetry (``tpushare_torch.telemetry``, ``serving/metrics.py``) sits at
the reference's points: every round runs inside one
``MONITOR.dispatch_guard`` — ``prefill`` for an admission's prompt and a
sequential chunk, ``decode`` for ``tick``/``tick_fused``/``tick_spec``,
``mixed`` for a mixed round's prefill block and decode half together —
that closes after the round's host fetch (each round ends in a
``.tolist()`` or ``.cpu()``), so the guard's wall is the round's device
time as the reference defines it; a mid-prompt chunk, which nothing
fetches, is guarded without being observed.  Each guard's device time is
split equally over the requests that rode it and observed per request at
completion; admissions, completions, fused steps, mixed rounds, spec
rounds and tokens, tick time and occupancy are counted where the
reference counts them.

:meth:`ContinuousBatcher.cancel` frees a request wherever it is; the
paged batcher also exports, pops and imports whole sessions
(:mod:`.paged`, on :mod:`.migrate`'s wire format).  On them
:class:`ContinuousService` builds the reference's session lifecycle:
streaming, cancel, the prefill hand-off, import, the drain's hand-off to
a peer and the host-RAM spill tier.

Multi-adapter LoRA serving (``adapter_slots``): an
:class:`~.adapters.AdapterPool` of named adapters, pinned at admission
(``admit(..., adapter=)``) and released with the slot, and every forward
of every round flavor carries the pool and the rows' ids
(:meth:`ContinuousBatcher._adapter_kw`; none without a pool, so a
pool-less batcher runs the pool-less program).

Mixture of experts: an ``n_experts`` config runs unchanged on every
storage and round flavor (the routed FFN is inside the forward).  A
decode round (``tick``, ``tick_fused``, ``tick_mixed``; the dense mixed
round with its prefill block, as the reference's) keeps its summed [E]
expert load on the device in ``_moe_load``; every
``DERIVED_OBSERVE_EVERY`` rounds it is read once, inside the round's
dispatch guard, into ``tpushare_expert_load``.  Speculative rounds and
plain admissions track none, as in the reference.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import logging
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import default_device, telemetry
from ..models import transformer
from ..ops.attention import NEG_INF, tp_degree
from ..ops.experts import expert_pool_bytes
from ..ops.quant import kv_cache_bytes
from ..parallel.mesh import canonical_device, shard_params
from ..telemetry import health
from ..telemetry.events import RECORDER
from . import metrics, migrate
from .adapters import AdapterLoadError, AdapterPool
from .speculative import spec_scan

log = logging.getLogger("tpushare_torch.serving")


@dataclasses.dataclass
class _Slot:
    request_id: int
    length: int          # tokens currently in the slot's cache + pending
    remaining: int       # tokens still to generate
    last_token: int
    output: List[int]    # prompt + generated (completed value)
    prompt_len: int = 0
    temperature: float = 0.0
    generator: Optional[torch.Generator] = None
    eos_id: Optional[int] = None
    top_k: int = 0                  # 0 = off
    top_p: float = 1.0              # 1.0 = off


@dataclasses.dataclass
class _Prefill:
    """A slot mid-prefill (admitted by ``admit_chunked``, not decoding)."""

    request_id: int
    prompt: List[int]
    pos: int             # prompt tokens already in the cache
    max_new: int
    temperature: float
    seed: int
    chunk: int = 64
    eos_id: Optional[int] = None
    top_k: int = 0
    top_p: float = 1.0


def _filter_logits(logits, temps, top_ks=None, top_ps=None):
    """Temperature-scaled f32 logits [B, V] with the per-slot top-k
    (k <= 0 = off) and nucleus (p >= 1 = off) filters applied as NEG_INF,
    the nucleus taken over the renormalized top-k survivors — the
    reference's ``_sample_next`` filter step for step."""
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    lf = logits.float() / safe_t
    if top_ks is None:
        return lf
    v = lf.shape[-1]
    sorted_l = torch.sort(lf, dim=-1, descending=True).values
    kk = top_ks.clamp(1, v)
    kth = sorted_l.gather(1, (kk - 1)[:, None].long())
    on_k = (top_ks > 0)[:, None]
    mask = on_k & (lf < kth)
    idx = torch.arange(v, device=lf.device)[None, :]
    sorted_k = sorted_l.masked_fill(on_k & (idx >= kk[:, None]), NEG_INF)
    probs = torch.softmax(sorted_k, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    # keep tokens whose cumulative mass BEFORE them is < p (the smallest
    # prefix reaching p always includes its last member)
    keep = (csum - probs) < top_ps[:, None]
    cut = torch.where(keep, sorted_k, torch.full_like(sorted_k, float("inf")))
    cut = cut.min(dim=-1).values
    mask |= (top_ps < 1.0)[:, None] & (lf < cut[:, None])
    return lf.masked_fill(mask, NEG_INF)


#: every reason a configured ``spec_k`` falls back to plain decode:
#: ``ring_margin``, the storage cannot contain a k-token verify block (a
#: rolling row without k slots of slack, a windowed page ring whose margin
#: past the window is under k; the service turns speculation off at
#: start), and ``sampling_only``, no greedy slot this round (spec rows
#: exist only for greedy slots, so the round takes the plain path)
SPEC_FALLBACK_REASONS = ("ring_margin", "sampling_only")


def _sample_next(logits, temps, generators, top_ks=None, top_ps=None):
    """Per-slot next token [B] (int64): argmax where temps[i] == 0, else a
    draw from softmax(filtered logits) with slot i's generator.
    ``top_ks``/``top_ps`` come together or not at all."""
    out = torch.argmax(logits, dim=-1)
    if not bool((temps > 0).any()):
        return out
    lf = _filter_logits(logits, temps, top_ks, top_ps)
    for i, t in enumerate(temps.tolist()):
        if t > 0:
            probs = torch.softmax(lf[i], dim=-1)
            out[i] = torch.multinomial(probs, 1, generator=generators[i])[0]
    return out


#: every Nth round runs the derived observations (the device-utilization
#: gauge's re-derivation), as the reference does: cheap at that cadence,
#: a measurable share of a small model's round if run every round
DERIVED_OBSERVE_EVERY = 16


# ---------------------------------------------------------------------------
# The dense storage's device programs (plain functions: there is no jit
# cache to keep; the names are the reference's)
# ---------------------------------------------------------------------------
def _row_view(caches, slot: int):
    """Row ``slot`` of the stacked caches (every tp shard's), as views:
    writes land in the pool."""
    return transformer.kv_tree_map(lambda t: t[:, slot:slot + 1], caches)


@torch.inference_mode()
def _prefill_chunk(params, tokens, caches, slot: int, pos: int,
                   last_idx: int, cfg, ad=None, mesh=None):
    """One prompt chunk [1, C] into row ``slot`` at offset ``pos``;
    returns the [V] logits at ``last_idx``, the chunk's last real token.
    Whole-prompt prefill is the ``pos=0`` single-chunk case.  The caller
    keeps ``pos + C <= max_seq``.  A padded tail of a full-size row lands
    past the real prefix and is overwritten before it is attendable; a
    rolling ring never commits it (``kv_write_len``).  ``ad``: the
    adapter keywords of the forward (:meth:`ContinuousBatcher.
    _adapter_kw`), empty without a pool."""
    logits, _ = transformer.forward_cached(
        params, tokens, cfg, _row_view(caches, slot), pos,
        kv_write_len=last_idx + 1, mesh=mesh, **(ad or {}))
    return logits[0, last_idx]


@torch.inference_mode()
def _tick_mixed(params, p_tokens, p_slots, p_pos, p_last, act_rows,
                act_slots, caches, cfg, key_bound: Optional[int], ad=None,
                forward=transformer.forward_cached, mesh=None):
    """The prefill half of a mixed round: the pending chunks p_tokens
    [R, C] of up to R mid-prefill slots as ONE batched forward.  The
    target rows are gathered out of the pool (``p_slots``), prefilled at
    ``p_pos`` with ``kv_write_len`` ``p_last + 1``, and only the rows
    ``act_rows`` go back, into slots ``act_slots``: a padded row's
    garbage never touches the pool, and prefill draws nothing from any
    slot's generator.  ``forward`` is ``transformer.forward_cached`` or
    a wrapper of it with its signature and return (the batcher's
    :meth:`~ContinuousBatcher._forward_noting_load`).  Returns the
    chunk-final logits [R, V]."""
    rows = transformer.kv_tree_map(lambda t: t[:, p_slots.to(t.device)],
                                   caches)
    logits, rows = forward(
        params, p_tokens, cfg, rows, p_pos, kv_write_len=p_last + 1,
        key_bound=key_bound, mesh=mesh, **(ad or {}))
    for leaf, part in zip(transformer.kv_tree_leaves(caches),
                          transformer.kv_tree_leaves(rows)):
        leaf.index_copy_(1, act_slots.to(leaf.device),
                         part.index_select(1, act_rows.to(part.device)))
    return logits[torch.arange(p_tokens.shape[0], device=logits.device),
                  p_last]


class ContinuousBatcher:
    """Synchronous-core continuous batcher (drive ``admit``/``tick``, or
    ``admit_chunked`` with ``tick_fused``/``tick_mixed``) over the dense
    slot storage.

    Subclasses may swap the storage hooks; the admission protocol,
    per-slot sampling bookkeeping and completion logic live here once."""

    def __init__(self, params, cfg: transformer.ModelConfig, n_slots: int,
                 device=None, mesh=None,
                 rolling_slots: Optional[bool] = None, spec_k: int = 0,
                 adapter_slots: int = 0, adapter_rank: int = 8,
                 adapter_loader=None):
        """``mesh`` (``parallel.mesh.Mesh``): the storage is laid over it,
        and the batcher runs the dense part of every forward on its first
        device, where the params must lie (``device``, if given, must
        name that device).  A ``tp`` axis serves tensor-parallel: the
        params take the Megatron split (``parallel.mesh.shard_params``),
        the adapter pool and the KV storage split on heads, each tp shard
        on its device; a model the split does not fit runs as tp = 1 on
        the first device (``transformer.serving_mesh``), which
        :attr:`mesh` then is.  An ``sp`` axis (position striping) is a
        paged-pool feature.

        ``rolling_slots``: None (AUTO) gives a sliding-window config
        (window < max_seq) a ROLLING pool of window-sized rows (the same
        outputs at max_seq / window times the slots a byte); False forces
        max_seq rows.

        ``spec_k``: the speculation depth the storage must be able to
        verify (0 = none provisioned).  A rolling row takes ``spec_k``
        ring slots of slack (``init_kv_caches(ring_slack=)``), so that a
        verify block's rejected tail evicts only keys outside every later
        window; where window + spec_k would reach max_seq, the rows are
        full-size instead.  :meth:`tick_spec` takes its ``k`` a
        call, up to this bound on a rolling row.

        ``adapter_slots`` > 0 builds the multi-adapter LoRA pool
        (:class:`~.adapters.AdapterPool` of rank ``adapter_rank``, loading
        through ``adapter_loader``, by default the synthetic one):
        requests may name an adapter at admission, and every forward of
        every round gathers each row's adapter.  Without a pool every
        forward runs the pool-less program."""
        if mesh is not None:
            dev0 = mesh.devices[0]
            if device is not None and canonical_device(
                    default_device(device)) != dev0:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {dev0}")
            device = dev0
            mesh = transformer.serving_mesh(mesh, cfg, params["layers"])
            if (tp_degree(mesh) > 1
                    and not isinstance(params["layers"], tuple)):
                params = shard_params(params, mesh, cfg)
        self.spec_k = max(0, int(spec_k))
        if rolling_slots is None:
            rolling_slots = transformer.wants_rolling(cfg)
        if rolling_slots and cfg.window is None:
            raise ValueError("rolling_slots needs a sliding-window cfg")
        if (rolling_slots and self.spec_k
                and cfg.window + self.spec_k >= cfg.max_seq):
            # the slack ring would cover the whole context: full-size
            # rows are that storage
            rolling_slots = False
        self.rolling_slots = bool(rolling_slots)
        self.device = default_device(device)
        self.mesh = mesh
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.slots: Dict[int, _Slot] = {}      # slot index -> live request
        self.prefilling: Dict[int, _Prefill] = {}   # slot -> mid-prefill
        self._prefill_cursor = 0
        self._next_id = 0
        self.completed: Dict[int, List[int]] = {}
        #: request id -> when its slot activated (its prompt prefilled and
        #: its first token sampled; ``time.perf_counter``), kept like
        #: ``completed`` until the caller takes it
        self.activated_at: Dict[int, float] = {}
        #: forwards run so far: prefill (whole prompts, chunks and mixed
        #: blocks) and decode steps; and the prompt tokens prefilled (a
        #: cached prefix's are not)
        self.prefills = 0
        self.decode_steps = 0
        self.prefill_tokens = 0
        #: speculation: calls, verify rounds and tokens committed by them
        #: (tokens / rounds > 1 is what acceptance buys), and each live
        #: greedy row's accepted count a round, up to what it delivered
        self._spec_stats = {"calls": 0, "rounds": 0, "tokens": 0}
        self.spec_accept_depth: "collections.Counter[int]" = \
            collections.Counter()
        # per-request device-time attribution: rid -> accumulated shares
        # by phase and the tokens generated, observed into the request
        # series at completion (_acct_credit / _acct_flush)
        self._req_acct: Dict[int, dict] = {}
        self._tick_count = 0
        # an MoE config's expert load: the last tracked round's summed [E]
        # counts (a device tensor, read on the DERIVED_OBSERVE_EVERY
        # cadence), and the open round's running sum (None outside one)
        self._moe_load: Optional[torch.Tensor] = None
        self._load_acc: Optional[torch.Tensor] = None
        # the multi-adapter pool, loop-owned like the rest: admission
        # pins, release unpins; _slot_adapter maps slot -> pinned pool
        # row (absent = the identity, a base-model request)
        self.adapter_pool: Optional[AdapterPool] = None
        if adapter_slots:
            self.adapter_pool = AdapterPool(
                cfg, adapter_rank, adapter_slots, loader=adapter_loader,
                device=self.device,
                mesh=self.mesh if tp_degree(self.mesh) > 1 else None)
        self._slot_adapter: Dict[int, int] = {}
        self._init_storage()
        self._observe_storage()

    # -- telemetry helpers ---------------------------------------------
    def _observe_storage(self) -> None:
        """Mirror the KV storage's persistent footprint, its dtype and its
        read path into /metrics (the ``_info`` gauges are constant 1, the
        value rides the label)."""
        info = self.storage_info()
        metrics.KV_CACHE_BYTES.set(info["pool_bytes"])
        metrics.KV_DTYPE_INFO.clear()
        metrics.KV_DTYPE_INFO.set(1, kv_dtype=info["kv_dtype"])
        metrics.ATTN_KERNEL_INFO.clear()
        metrics.ATTN_KERNEL_INFO.set(1, attn_kernel=info["attn_kernel"])
        metrics.KV_STRIPE_SHARDS.set(info.get("sp_shards", 1))
        metrics.EXPERT_POOL_BYTES.set(info.get("expert_pool_bytes", 0))
        metrics.MOE_EXPERTS.set(info.get("n_experts", 0))

    def _observe_tick(self, t0: float) -> None:
        """Record one round's wall time and the post-round occupancy;
        flush the completed requests' attribution."""
        metrics.TICK_DURATION.observe(time.perf_counter() - t0)
        metrics.OCCUPANCY.set(
            len(self.slots) / self.n_slots if self.n_slots else 0.0)
        self._acct_flush()
        self._tick_count += 1
        if self._tick_count % DERIVED_OBSERVE_EVERY == 0:
            health.refresh_device_utilization()

    def _observe_prefill(self) -> None:
        """Mirror the mid-prefill queue depth into /metrics (every site
        that grows or shrinks ``self.prefilling`` calls this)."""
        metrics.PREFILL_QUEUE_DEPTH.set(len(self.prefilling))

    def _rids(self) -> List[int]:
        """Request ids of the decoding slots — what a round's dispatch
        guard and span carry, so a stall names its requests."""
        return [s.request_id for s in self.slots.values()]

    def _acct_open(self, rid: int, prompt_len: int) -> None:
        if telemetry.enabled():
            self._req_acct[rid] = {"prefill_s": 0.0, "decode_s": 0.0,
                                   "prompt_len": prompt_len,
                                   "done_tokens": None}

    def _acct_credit(self, device_s: Optional[float],
                     decode_rids: List[int],
                     prefill_rids: List[int] = ()) -> None:
        """Split one guard's measured device time equally across the
        requests that rode the dispatch: decoding ones book it as decode,
        prefilling ones as prefill (a mixed round serves both halves, and
        an exact split does not exist)."""
        if device_s is None:
            return
        n = len(decode_rids) + len(prefill_rids)
        if not n:
            return
        share = device_s / n
        for rid in decode_rids:
            acct = self._req_acct.get(rid)
            if acct is not None:
                acct["decode_s"] += share
        for rid in prefill_rids:
            acct = self._req_acct.get(rid)
            if acct is not None:
                acct["prefill_s"] += share

    def _acct_flush(self) -> None:
        """Observe and drop completed requests' accumulated attribution:
        completion marks, the flush observes, so the completing
        dispatch's own share is included."""
        if not self._req_acct:
            return
        done = [rid for rid, a in self._req_acct.items()
                if a["done_tokens"] is not None]
        for rid in done:
            a = self._req_acct.pop(rid)
            metrics.REQUEST_DEVICE_TIME.observe(a["prefill_s"],
                                                phase="prefill")
            metrics.REQUEST_DEVICE_TIME.observe(a["decode_s"],
                                                phase="decode")
            metrics.GENERATED_TOKENS.inc(a["done_tokens"])

    # -- expert load ---------------------------------------------------
    @contextlib.contextmanager
    def _tracking_load(self):
        """A tracked round (an MoE config's ``tick``, ``tick_fused`` or
        ``tick_mixed``): the forwards inside it add their [E] load to one
        device sum, which becomes ``_moe_load`` when the round ends and,
        on the cadence, the histogram's.  Entered inside the round's
        dispatch guard, so the read counts as device wait."""
        if not self.cfg.n_experts:
            yield
            return
        self._load_acc = torch.zeros((self.cfg.n_experts,),
                                     dtype=torch.float32, device=self.device)
        try:
            yield
            self._moe_load = self._load_acc
        finally:
            self._load_acc = None
        self._maybe_observe_expert_load()

    def _forward_noting_load(self, forward, *args, **kw):
        """``forward(*args, **kw)``, a forward returning (logits, storage);
        inside a tracked round it is asked for its expert load too, which
        joins the round's sum.  Outside one it is the plain call, so a
        dense config runs its old program."""
        if self._load_acc is None:
            return forward(*args, **kw)
        logits, storage, load = forward(*args, return_expert_load=True,
                                        **kw)
        self._load_acc = self._load_acc + load
        return logits, storage

    def _maybe_observe_expert_load(self) -> None:
        """Every ``DERIVED_OBSERVE_EVERY`` rounds, read the last tracked
        round's [E] load (one small transfer) and observe each expert's
        share of its routed tokens into ``tpushare_expert_load``: a
        balanced router puts every sample near 1/E."""
        if self._moe_load is None:
            return
        if self._tick_count % DERIVED_OBSERVE_EVERY:
            return
        load = self._moe_load.cpu()          # f32, as the reference's
        total = float(load.sum())
        if total > 0.0:
            metrics.EXPERT_LOAD.observe_many((load / total).tolist())

    def _expert_storage_info(self) -> dict:
        """The expert pool's keys of ``storage_info`` on an MoE config
        (none on a dense one): the pool is held whole on the one device,
        so ``ep_shards`` is 1."""
        cfg = self.cfg
        if not cfg.n_experts:
            return {}
        pool = expert_pool_bytes(cfg)
        return {"n_experts": int(cfg.n_experts),
                "moe_top_k": int(cfg.moe_top_k),
                "expert_pool_bytes": int(pool), "ep_shards": 1,
                "expert_pool_bytes_per_shard": int(pool)}

    # -- storage hooks -------------------------------------------------
    def _init_storage(self) -> None:
        if tp_degree(self.mesh, "sp") > 1:
            raise ValueError("dense and rolling slot storage takes no sp "
                             "axis (position striping is a paged-pool "
                             "feature)")
        self.caches = transformer.init_kv_caches(
            self.cfg, self.n_slots, rolling=self.rolling_slots,
            ring_slack=self.spec_k, device=self.device, mesh=self.mesh)

    def _reserve(self, slot: int, prompt_len: int, max_new: int,
                 prompt: Optional[List[int]] = None) -> bool:
        """Claim per-request storage; False = backpressure.  ``prompt``
        rides along for a storage that can share it (the paged prefix
        cache).  A dense row is reserved with its slot."""
        return True

    def _prefill_start(self, slot: int) -> int:
        """The first prompt position admission must prefill: a cached
        prefix's length on the paged prefix cache, else 0."""
        return 0

    def _release(self, slot: int) -> None:
        """Return per-request storage on completion (every release path:
        completion, cancel, migration pop); the slot's adapter pin with
        it."""
        self._release_adapter(slot)

    def _prefill_into(self, slot: int, prompt: List[int]):
        """Prefill the prompt; returns [V] f32 logits at its last
        position.  Dense: the whole prompt as one chunk at pos 0."""
        tokens = torch.tensor([prompt], dtype=torch.long, device=self.device)
        return _prefill_chunk(self.params, tokens, self.caches, slot, 0,
                              len(prompt) - 1, self.cfg,
                              self._adapter_kw([slot]), mesh=self.mesh)

    def _read_bound(self, lengths, n_steps: int) -> Optional[int]:
        """The slots a full-size row's decode read must cover over
        ``n_steps`` steps from ``lengths``: past them every key is masked
        for every query, so the read stops there (one host read of the
        longest length)."""
        if self.rolling_slots:
            return None
        return int(lengths.max()) + n_steps

    def _round_operand(self, lengths, n_steps: int):
        """What every decode step of a round reads unchanged: a
        full-size row's read bound (:meth:`_read_bound`)."""
        return self._read_bound(lengths, n_steps)

    def _decode_logits(self, tokens, lengths, operand, ad=None):
        """One decode forward of every slot, tokens [B, 1] at ``lengths``
        [B]; returns the logits [B, V].  ``ad``: the round's adapter
        keywords (:meth:`_adapter_kw`; taken from the slots when None)."""
        logits, _ = self._forward_noting_load(
            transformer.forward_cached,
            self.params, tokens, self.cfg, self.caches, lengths,
            key_bound=operand, mesh=self.mesh,
            **(self._adapter_kw() if ad is None else ad))
        return logits[:, 0]

    def _verify_logits(self, blocks, n_ctxs, live, operand, ad=None):
        """One speculative verify forward of every slot, blocks [B, 1+k]
        at ``n_ctxs`` [B]; returns the logits [B, 1+k, V].  A rolling row
        commits the whole block for a live row (the ring's ``spec_k``
        slots of slack contain a rejected tail) and nothing for the
        others; a full-size row takes every write, a rejected tail past
        the committed length, masked until the next block rewrites it."""
        logits, _ = transformer.forward_cached(
            self.params, blocks, self.cfg, self.caches, n_ctxs,
            kv_write_len=torch.where(live, blocks.shape[1], 0),
            key_bound=operand, mesh=self.mesh,
            **(self._adapter_kw() if ad is None else ad))
        return logits

    @torch.inference_mode()
    def _step_n(self, tokens, lengths, temps, generators, top_ks, top_ps,
                incs, n_steps: int):
        """``n_steps`` decode steps, each a forward and the sampler, over
        one round operand; returns the tokens [B, n_steps].  ``incs`` [B]
        is each row's length step: 1 for a row decoding at the start, 0
        for the others (empty or mid-prefill), which write their one
        garbage K/V at the same position every step.  A wandering write at
        position q would land in ring slot q % W (on the paged ring, the
        lane of q - held * page) and clobber a key a mid-prefill row still
        attends; a write at exactly the aimed position is overwritten by
        that row's next chunk before any query attends it.  The adapter
        ids are the round's too, taken once."""
        operand = self._round_operand(lengths, n_steps)
        ad = self._adapter_kw()
        out = []
        for _ in range(n_steps):
            tokens = _sample_next(
                self._decode_logits(tokens, lengths, operand, ad), temps,
                generators, top_ks, top_ps)[:, None]
            out.append(tokens)
            lengths = lengths + incs
        return torch.cat(out, dim=1)

    def _prefill_chunk_into(self, slot: int, padded_tokens, pos: int,
                            last_idx: int):
        """One padded prompt chunk [1, C] into the slot's row; returns the
        logits at ``last_idx``."""
        return _prefill_chunk(self.params, padded_tokens, self.caches, slot,
                              pos, last_idx, self.cfg,
                              self._adapter_kw([slot]), mesh=self.mesh)

    def _prefill_block(self, block) -> torch.Tensor:
        """The prefill half of a mixed round (:func:`_tick_mixed`);
        returns the chunk-final logits [R, V].  A full-size row's read
        stops at the block's last position."""
        act = np.flatnonzero(block["p_active"])
        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a), device=dev).long()

        bound = (None if self.rolling_slots
                 else int(block["p_pos"].max()) + block["C"])
        return _tick_mixed(self.params, t(block["p_tokens"]),
                           t(block["p_slots"]), t(block["p_pos"]),
                           t(block["p_last"]), t(act),
                           t(block["p_slots"][act]), self.caches, self.cfg,
                           bound, self._adapter_kw(ids=block["p_ads"]),
                           functools.partial(self._forward_noting_load,
                                             transformer.forward_cached),
                           mesh=self.mesh)

    def _mixed_chunk_len(self, chunk: int) -> int:
        """The prefill-window width of chunked admission and of the mixed
        round on this storage (the paged pool rounds it to a page
        multiple)."""
        return max(1, chunk)

    def storage_info(self) -> dict:
        """What a slot costs and how many a GiB buys, through
        ``ops.quant.kv_cache_bytes`` (a rolling row with its ``spec_k``
        slots of slack).  The read is ``cached_attention`` over the dense
        view whatever ``cfg.attn_kernel`` says (the JAX package reports
        it as ``"xla"``), so ``attn_kernel`` is ``"gather"``."""
        cfg = self.cfg
        slot_tokens = (min(cfg.window + self.spec_k, cfg.max_seq)
                       if self.rolling_slots else cfg.max_seq)
        per_slot = kv_cache_bytes(cfg, slot_tokens)
        return {"kind": "rolling" if self.rolling_slots else "dense",
                "attn_kernel": "gather", "kv_dtype": cfg.kv_dtype,
                "slot_tokens": int(slot_tokens),
                "bytes_per_slot": int(per_slot),
                "slots_per_gib": (2 ** 30) // per_slot,
                "pool_bytes": int(per_slot * self.n_slots),
                "spec_k": self.spec_k, **self._adapter_storage(),
                **self._expert_storage_info()}

    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i in range(self.n_slots)
                if i not in self.slots and i not in self.prefilling]

    def validate_request(self, prompt: List[int],
                         max_new_tokens: int) -> None:
        """Raise ValueError for a request this batcher can NEVER serve
        (admission's None means "retry when capacity frees")."""
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.cfg.max_seq:
            raise ValueError("prompt+max_new exceeds max_seq")

    @staticmethod
    def validate_sampling(top_k: int, top_p: float) -> None:
        if top_k < 0:
            raise ValueError("top_k must be >= 0 (0 = off)")
        if not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1] (1 = off)")

    # -- multi-adapter serving -------------------------------------------
    def validate_adapter(self, adapter: Optional[str]) -> None:
        """Raise for an adapter request this batcher can NEVER serve (no
        pool, a malformed name): pure validation, safe from any thread."""
        if adapter is None:
            return
        if not isinstance(adapter, str) or not adapter:
            raise ValueError("adapter must be a non-empty string")
        if self.adapter_pool is None:
            raise ValueError("this server runs without an adapter pool "
                             "(pass adapter_slots / --adapter-slots)")

    def adapter_pressure(self, adapter: Optional[str]) -> bool:
        """Read-only: would an admission naming ``adapter`` refuse right
        now for adapter-pool pressure (a name not resident, every row
        pinned)?  The server's 503 gate."""
        if not adapter or self.adapter_pool is None:
            return False
        return self.adapter_pool.pressure(adapter)

    def adapter_info(self) -> Optional[dict]:
        """The pool's point-in-time snapshot (None without a pool)."""
        if self.adapter_pool is None:
            return None
        return self.adapter_pool.snapshot()

    def _adapter_storage(self) -> dict:
        """The adapter pool's economics for ``storage_info`` (none without
        a pool)."""
        if self.adapter_pool is None:
            return {}
        return self.adapter_pool.storage_info()

    def _acquire_adapter(self, adapter: Optional[str]) -> Optional[int]:
        """Resolve and PIN an adapter at admission: 0 for a base request,
        the pinned pool row otherwise, None on pool pressure."""
        if adapter is None:
            return 0
        return self.adapter_pool.acquire(adapter)

    def _map_adapter(self, slot: int, aidx: int) -> None:
        """Record the slot's pinned pool row (0, the identity, unmapped)."""
        if aidx:
            self._slot_adapter[slot] = aidx
        else:
            self._slot_adapter.pop(slot, None)

    def _release_adapter(self, slot: int) -> None:
        """Unpin the slot's adapter (every release path funnels here)."""
        idx = self._slot_adapter.pop(slot, 0)
        if idx and self.adapter_pool is not None:
            self.adapter_pool.release(idx)

    def _adapter_name_of(self, slot: int) -> Optional[str]:
        """The NAME of the adapter pinned to ``slot`` (None = base): what
        the prefix registry and a migration blob carry (pool rows are
        local to the process)."""
        idx = self._slot_adapter.get(slot, 0)
        if not idx or self.adapter_pool is None:
            return None
        return self.adapter_pool.name_of(idx)

    def adapter_spill_can_help(self) -> bool:
        """Whether exporting a DECODING session could release an adapter
        pin: the only way the spill tier relieves adapter-pool pressure
        (spilling a base-model session frees pages, never pins)."""
        return any(self._slot_adapter.get(i, 0) for i in self.slots)

    def _adapter_kw(self, slots=None, ids=None) -> dict:
        """The adapter keywords of a forward: none without a pool (the
        pool-less program), else the stacked pool and the rows' pool ids
        on the device: ``ids``, or each of ``slots``' (default every
        slot's), 0 (the identity) for base and empty rows."""
        if self.adapter_pool is None:
            return {}
        if ids is None:
            ids = [self._slot_adapter.get(int(i), 0)
                   for i in (range(self.n_slots) if slots is None
                             else slots)]
        return {"adapters": self.adapter_pool.device_operands(),
                "adapter_ids": torch.as_tensor(
                    ids, dtype=torch.long).to(self.device)}

    def _claim(self, prompt: List[int], max_new_tokens: int, top_k: int,
               top_p: float, adapter: Optional[str] = None) -> Optional[int]:
        """Validate and claim a free slot, its adapter pin and its storage
        (None = backpressure): the admission step ``admit`` and
        ``admit_chunked`` share.  A storage refusal rolls the pin back;
        a loader failure raises :class:`~.adapters.AdapterLoadError`."""
        self.validate_request(prompt, max_new_tokens)
        self.validate_sampling(top_k, top_p)
        self.validate_adapter(adapter)
        free = self.free_slots()
        if not free:
            RECORDER.record("admit_refused", reason="no_free_slot",
                            prompt_len=len(prompt))
            return None
        slot = free[0]
        aidx = self._acquire_adapter(adapter)
        if aidx is None:
            RECORDER.record("admit_refused", reason="adapter_pool",
                            prompt_len=len(prompt))
            return None
        # mapped before _reserve: the paged prefix cache's lookup is
        # namespaced by the slot's adapter.  Every admission writes the
        # slot's entry, so a base request never inherits a mapping
        self._map_adapter(slot, aidx)
        if not self._reserve(slot, len(prompt), max_new_tokens,
                             prompt=prompt):
            # storage backpressure: the pool's budget said no
            self._release_adapter(slot)           # the pin rolled back
            RECORDER.record("admit_refused", reason="storage",
                            prompt_len=len(prompt))
            return None
        return slot

    def _admitted(self, rid: int, prompt: List[int],
                  max_new_tokens: int) -> None:
        """The admission's books: counted, recorded, attribution open."""
        metrics.ADMISSIONS.inc()
        RECORDER.record("admit", rid=rid, prompt_len=len(prompt),
                        max_new=max_new_tokens)
        self._acct_open(rid, len(prompt))

    def admit(self, prompt: List[int], max_new_tokens: int,
              temperature: float = 0.0, seed: int = 0,
              eos_id: Optional[int] = None,
              top_k: int = 0, top_p: float = 1.0,
              adapter: Optional[str] = None) -> Optional[int]:
        """Prefill into a free slot; returns the request id, or None when
        the pool is full (backpressure).  Invalid requests raise.
        ``eos_id`` finishes the request early when sampled: the output is
        the prompt + generated tokens up to and including the eos.
        ``adapter`` names the request's LoRA adapter (a pool required;
        pinned until release; None on pool pressure, like every other
        backpressure)."""
        slot = self._claim(prompt, max_new_tokens, top_k, top_p, adapter)
        if slot is None:
            return None
        rid = self._next_id
        self._next_id += 1
        self._admitted(rid, prompt, max_new_tokens)
        self.prefill_tokens += len(prompt) - self._prefill_start(slot)
        try:
            # the guard closes after the first token's host read
            # (_activate)
            with health.MONITOR.dispatch_guard("prefill",
                                               tokens=len(prompt),
                                               rids=[rid]) as g:
                logits_v = self._prefill_into(slot, list(prompt))
                self.prefills += 1
                self._activate(slot, rid, list(prompt), logits_v,
                               max_new_tokens, temperature, seed, eos_id,
                               top_k, top_p)
        except BaseException:
            # a prefill that raised (a device failure) leaves nothing
            # claimed: the slot, its storage and its adapter pin go back
            # before the error reaches the caller
            self._unclaim(slot, rid)
            raise
        self._acct_credit(g.device_s, [], [rid])
        self._acct_flush()
        return rid

    def _unclaim(self, slot: int, rid: int) -> None:
        """Undo an admission whose prefill raised: its books dropped, and
        its slot, storage and pin released (the release is idempotent, so
        an admission that already finished at its first token is safe).
        Counted as a cancellation unless it completed: admissions ==
        completions + cancellations."""
        self._req_acct.pop(rid, None)
        self.activated_at.pop(rid, None)
        s = self.slots.get(slot)
        if s is not None and s.request_id == rid:
            del self.slots[slot]
        self._release(slot)
        if self.completed.pop(rid, None) is None:
            metrics.CANCELLATIONS.inc()

    def admit_chunked(self, prompt: List[int], max_new_tokens: int,
                      temperature: float = 0.0, seed: int = 0,
                      chunk: int = 64, eos_id: Optional[int] = None,
                      top_k: int = 0, top_p: float = 1.0,
                      adapter: Optional[str] = None) -> Optional[int]:
        """Admit with the prompt streamed ``chunk`` tokens at a time by
        later :meth:`advance_prefill` or :meth:`tick_mixed` calls, so a
        long prompt never stalls decoding slots for more than one chunk's
        forward.  Same validation and backpressure as :meth:`admit` (the
        ``adapter`` pin included), and the same streams.  The storage
        sizes the window (:meth:`_mixed_chunk_len`)."""
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        chunk = self._mixed_chunk_len(chunk)
        slot = self._claim(prompt, max_new_tokens, top_k, top_p, adapter)
        if slot is None:
            return None
        rid = self._next_id
        self._next_id += 1
        self._admitted(rid, prompt, max_new_tokens)
        self.prefilling[slot] = _Prefill(
            request_id=rid, prompt=list(prompt),
            pos=self._prefill_start(slot),
            max_new=max_new_tokens, temperature=temperature, seed=seed,
            chunk=chunk, eos_id=eos_id, top_k=top_k, top_p=top_p)
        self._observe_prefill()
        return rid

    def _activate(self, slot: int, rid: int, prompt: List[int], logits_v,
                  max_new_tokens: int, temperature: float, seed: int,
                  eos_id: Optional[int], top_k: int, top_p: float) -> None:
        """Prompt prefilled: sample the first token through the same
        sampler as the ticks, then start (or finish) decoding."""
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            rich = top_k > 0 or top_p < 1.0
            dev = logits_v.device
            first = int(_sample_next(
                logits_v[None, :],
                torch.tensor([temperature], dtype=torch.float32, device=dev),
                [gen],
                torch.tensor([top_k], device=dev) if rich else None,
                torch.tensor([top_p], dtype=torch.float32, device=dev)
                if rich else None)[0])
        else:
            first = int(torch.argmax(logits_v))
        self.activated_at[rid] = time.perf_counter()
        remaining = max_new_tokens - 1
        output = list(prompt) + [first]
        self.slots[slot] = _Slot(request_id=rid, length=len(prompt),
                                 remaining=remaining, last_token=first,
                                 output=output, prompt_len=len(prompt),
                                 temperature=temperature, generator=gen,
                                 eos_id=eos_id, top_k=top_k, top_p=top_p)
        if remaining == 0 or (eos_id is not None and first == eos_id):
            self._finish(slot)

    def _finish(self, slot: int) -> None:
        """The one completion site (every round and the admission that
        finishes at its first token end here)."""
        # storage first: the paged prefix cache reads the finished slot
        self._release(slot)
        s = self.slots.pop(slot)
        self.completed[s.request_id] = s.output
        metrics.COMPLETIONS.inc()
        acct = self._req_acct.get(s.request_id)
        if acct is not None:
            # observed at the next flush: the finishing dispatch is still
            # inside its guard, its share not credited yet
            acct["done_tokens"] = max(0, len(s.output) - acct["prompt_len"])

    def cancel(self, rid: int) -> bool:
        """Release request ``rid`` wherever it lives (a decoding slot,
        mid-prefill, or the completed buffer), freeing its slot and
        storage at once.  False when unknown.  Dropping a completed result
        is not a cancellation: the request already counted as a
        completion, and admissions == completions + cancellations."""
        # a cancelled request's partial attribution is dropped: the
        # request histograms describe completed requests
        self._req_acct.pop(rid, None)
        self.activated_at.pop(rid, None)
        for i, s in list(self.slots.items()):
            if s.request_id == rid:
                self._release(i)
                del self.slots[i]
                metrics.CANCELLATIONS.inc()
                return True
        for i, p in list(self.prefilling.items()):
            if p.request_id == rid:
                self._release(i)
                del self.prefilling[i]
                self._observe_prefill()
                metrics.CANCELLATIONS.inc()
                return True
        return self.completed.pop(rid, None) is not None

    # -- session migration: paged storage only ---------------------------
    def can_migrate(self) -> bool:
        """Whether this storage can export and import sessions: only the
        paged pool can (pages are what the wire format moves; a dense row
        has no page-granular identity to rebuild)."""
        return False

    def export_session(self, rid: int) -> bytes:
        raise ValueError("session migration requires paged storage "
                         "(pass page_size)")

    def import_session(self, blob: bytes,
                       rid: Optional[int] = None) -> Optional[int]:
        raise ValueError("session migration requires paged storage "
                         "(pass page_size)")

    def pop_session(self, rid: int) -> None:
        raise ValueError("session migration requires paged storage "
                         "(pass page_size)")

    # -- chunked prefill ---------------------------------------------------
    def _select_prefill_slots(self, limit: int,
                              eligible=None) -> List[int]:
        """Up to ``limit`` mid-prefill slots in ROUND-ROBIN order from the
        cursor, which then moves past the last slot served: a slot
        skipped this round is first in line next round."""
        pending = sorted(self.prefilling if eligible is None else eligible)
        if not pending or limit <= 0:
            return []
        start = next((i for i, s in enumerate(pending)
                      if s >= self._prefill_cursor), 0)
        picked = (pending[start:] + pending[:start])[:limit]
        self._prefill_cursor = (picked[-1] + 1) % max(1, self.n_slots)
        return picked

    def _advance_one_prefill(self, slot: int) -> None:
        """One prompt chunk for ONE mid-prefill slot, its own forward; the
        window is clamped at max_seq (a write past it would clamp back
        over real positions), so its width is the chunk or what is left
        of max_seq."""
        st = self.prefilling[slot]
        window = min(st.chunk, self.cfg.max_seq - st.pos)
        end = min(st.pos + window, len(st.prompt))
        piece = st.prompt[st.pos:end]
        padded = torch.zeros((1, window), dtype=torch.long)
        padded[0, :len(piece)] = torch.tensor(piece)
        # only the final chunk's _activate reads the host: a mid-prompt
        # chunk is queued and left running, so it is stall-watched but not
        # observed (its wall is launch time, not device time)
        final = end >= len(st.prompt)
        with health.MONITOR.dispatch_guard(
                "prefill", observe=final, tokens=len(piece),
                rids=[st.request_id]) as g:
            logits_v = self._prefill_chunk_into(
                slot, padded.to(self.device), st.pos, len(piece) - 1)
            self.prefills += 1
            self.prefill_tokens += len(piece)
            st.pos = end
            if final:
                del self.prefilling[slot]
                self._activate(slot, st.request_id, st.prompt, logits_v,
                               st.max_new, st.temperature, st.seed,
                               st.eos_id, st.top_k, st.top_p)
        self._acct_credit(g.device_s, [], [st.request_id])
        if final:
            self._acct_flush()

    def advance_prefill(self, max_slots: Optional[int] = None) -> int:
        """One chunk for the mid-prefill slots: every one, or at most
        ``max_slots`` round-robin.  Returns how many still prefill."""
        limit = len(self.prefilling) if max_slots is None else max_slots
        for slot in self._select_prefill_slots(limit):
            self._advance_one_prefill(slot)
        self._observe_prefill()
        return len(self.prefilling)

    # -- decode rounds -----------------------------------------------------
    def _slot_operands(self):
        """The per-slot operands of a decode step on the device: tokens
        [B, 1], lengths [B], temps [B], generators, top_ks/top_ps (None
        unless a live slot filters).  A step writes one garbage K/V at
        ``lengths[i]`` for every slot that is not decoding: an empty row
        takes it anywhere, a mid-prefill row at its next chunk's offset,
        which that chunk overwrites before the position is attendable."""
        n = self.n_slots
        tokens = torch.zeros((n, 1), dtype=torch.long)
        lengths = torch.zeros((n,), dtype=torch.int32)
        temps = torch.zeros((n,), dtype=torch.float32)
        tks = torch.zeros((n,), dtype=torch.long)
        tps = torch.ones((n,), dtype=torch.float32)
        gens: List[Optional[torch.Generator]] = [None] * n
        for i, st in self.prefilling.items():
            lengths[i] = st.pos
        for i, s in self.slots.items():
            tokens[i, 0] = s.last_token
            lengths[i] = s.length
            temps[i] = s.temperature
            tks[i] = s.top_k
            tps[i] = s.top_p
            gens[i] = s.generator
        rich = any(s.top_k > 0 or s.top_p < 1.0 for s in self.slots.values())
        dev = self.device
        return (tokens.to(dev), lengths.to(dev), temps.to(dev), gens,
                tks.to(dev) if rich else None, tps.to(dev) if rich else None)

    def _decode_incs(self) -> torch.Tensor:
        """1 for every decoding slot, 0 for the frozen others."""
        incs = torch.zeros((self.n_slots,), dtype=torch.int32)
        incs[list(self.slots)] = 1
        return incs.to(self.device)

    def tick(self) -> int:
        """One decode step for all active slots; returns #active before."""
        if not self.slots:
            return 0
        t0 = time.perf_counter()
        rids = self._rids() if telemetry.enabled() else []
        with health.MONITOR.dispatch_guard("decode", active=len(self.slots),
                                           rids=rids) as g, \
                telemetry.span("batcher.tick", cat="serving",
                               active=len(self.slots), rids=rids), \
                self._tracking_load():
            nxt = self._step_n(*self._slot_operands(), self._decode_incs(),
                               1)[:, 0].tolist()
        self._acct_credit(g.device_s, rids)
        self.decode_steps += 1
        n_active = len(self.slots)
        for i in list(self.slots):
            s = self.slots[i]
            s.length += 1              # last_token now lives in the cache
            s.last_token = int(nxt[i])
            s.output.append(s.last_token)
            s.remaining -= 1
            if s.remaining <= 0 or (s.eos_id is not None
                                    and s.last_token == s.eos_id):
                self._finish(i)
        self._observe_tick(t0)
        return n_active

    def _fused_tokens(self, n_steps: int):
        """The ``n_steps`` decode steps of a fused call or of a mixed
        round's decode half, read to the host: [B, n_steps] lists."""
        metrics.FUSED_STEPS.inc(n_steps)
        tokens, lengths, temps, gens, tks, tps = self._slot_operands()
        toks = self._step_n(tokens, lengths, temps, gens, tks, tps,
                            self._decode_incs(), n_steps).tolist()
        self.decode_steps += n_steps
        return toks

    def tick_fused(self, n_steps: int) -> int:
        """Up to ``n_steps`` decode steps in one call; returns #active
        slots before.  The streams are those of ``n_steps`` calls of
        :meth:`tick`, and the two interleave freely; a slot finishing
        mid-call completes at its end (its surplus steps decode garbage
        that is never consumed)."""
        if not self.slots:
            return 0
        t0 = time.perf_counter()
        rids = self._rids() if telemetry.enabled() else []
        with health.MONITOR.dispatch_guard("decode", active=len(self.slots),
                                           steps=n_steps, rids=rids) as g, \
                telemetry.span("batcher.tick_fused", cat="serving",
                               active=len(self.slots), steps=n_steps,
                               rids=rids), \
                self._tracking_load():
            toks = self._fused_tokens(n_steps)
        self._acct_credit(g.device_s, rids)
        n_active = len(self.slots)
        self._drain_fused_tokens(toks, n_steps)
        self._observe_tick(t0)
        return n_active

    def _drain_fused_tokens(self, toks, n_steps: int) -> None:
        """Consume a [B, n] token block: extend every decoding slot by its
        first ``remaining`` tokens, finishing at an eos (shared by
        :meth:`tick_fused` and :meth:`tick_mixed`).  A continuing sampled
        slot's generator drew exactly ``n_steps`` times, as ``n_steps``
        ticks draw."""
        for i in list(self.slots):
            s = self.slots[i]
            row = [int(t) for t in toks[i][:min(n_steps, s.remaining)]]
            if s.eos_id is not None and s.eos_id in row:
                row = row[:row.index(s.eos_id) + 1]
            s.output.extend(row)
            s.length += len(row)
            s.last_token = row[-1]
            s.remaining -= len(row)
            if s.remaining <= 0 or (s.eos_id is not None
                                    and s.last_token == s.eos_id):
                self._finish(i)

    # -- mixed prefill + decode round --------------------------------------
    def _plan_mixed_round(self, chunk: int, budget: int):
        """Pack this round's prefill block under the token budget
        (round-robin, a fixed [R, C] shape, R = budget // C clamped to
        [1, n_slots]).  Returns (block or None, overflow): None when no
        pending window fits below max_seq; ``overflow`` are the slots
        whose next window would cross it."""
        c = self._mixed_chunk_len(chunk)
        r_rows = max(1, min(budget // c if budget >= c else 1, self.n_slots))
        limit = self.cfg.max_seq
        eligible = [i for i, st in self.prefilling.items()
                    if st.pos + c <= limit]
        overflow = [i for i, st in self.prefilling.items()
                    if st.pos + c > limit]
        picked = self._select_prefill_slots(r_rows, eligible)
        if not picked:
            return None, overflow
        n_real = 0
        block = {"C": c, "p_tokens": np.zeros((r_rows, c), np.int64),
                 "p_slots": np.zeros((r_rows,), np.int64),
                 "p_active": np.zeros((r_rows,), bool),
                 "p_pos": np.zeros((r_rows,), np.int64),
                 "p_last": np.zeros((r_rows,), np.int64),
                 "p_ads": np.zeros((r_rows,), np.int64), "plan": []}
        for r, i in enumerate(picked):
            st = self.prefilling[i]
            end = min(st.pos + c, len(st.prompt))
            piece = st.prompt[st.pos:end]
            block["p_tokens"][r, :len(piece)] = piece
            block["p_slots"][r] = i
            block["p_active"][r] = True
            block["p_pos"][r] = st.pos
            block["p_last"][r] = len(piece) - 1
            block["p_ads"][r] = self._slot_adapter.get(i, 0)
            block["plan"].append((r, i, st, end))
            n_real += len(piece)
        metrics.MIXED_STEPS.inc()
        metrics.MIXED_PREFILL_TOKENS.inc(n_real)
        metrics.MIXED_BUDGET_UTILIZATION.set(n_real / float(r_rows * c))
        return block, overflow

    def _finish_mixed_round(self, plan, sel, overflow) -> None:
        """After the round: activate the rows whose chunk completed the
        prompt (from the block's chunk-final logits; they decode from the
        NEXT round), then advance the max_seq stragglers one narrow chunk
        each."""
        for r, i, st, end in plan:
            if end >= len(st.prompt):
                del self.prefilling[i]
                self._activate(i, st.request_id, st.prompt, sel[r],
                               st.max_new, st.temperature, st.seed,
                               st.eos_id, st.top_k, st.top_p)
        for i in overflow:
            if i in self.prefilling:
                self._advance_one_prefill(i)
        self._observe_prefill()

    def _mixed_round(self, chunk: int, budget: int, name: str, decode,
                     drain, fallback, track_load: bool = False,
                     **info) -> int:
        """The mixed round with ``decode()`` as its decode half (fused
        steps or spec rounds over every decoding slot, read to the host)
        and ``drain(out)`` consuming what it read: the block's prefill
        forward, the post-chunk offsets and the decode half under one
        ``mixed`` dispatch guard, then the activations.  With no window
        for the fixed-width block, the max_seq stragglers advance one
        narrow chunk each and the slots decode through ``fallback()``
        (the sequential composition).  ``track_load``: the round's
        forwards sum their expert load (:meth:`_tracking_load`).  Returns
        #decoding slots before the round."""
        if not self.prefilling and not self.slots:
            return 0
        t0 = time.perf_counter()
        block, overflow = self._plan_mixed_round(chunk, budget)
        if block is None:
            for i in list(overflow):
                if i in self.prefilling:
                    self._advance_one_prefill(i)
            self._observe_prefill()
            if self.slots:
                return fallback()
            self._observe_tick(t0)
            return 0
        plan = block["plan"]
        if telemetry.enabled():
            decode_rids = self._rids()
            prefill_rids = [st.request_id for _, _, st, _ in plan]
        else:
            decode_rids, prefill_rids = [], []
        rids = decode_rids + prefill_rids
        n_active = len(self.slots)
        out = None
        # the guard spans the prefill forward, the decode half and its
        # host read: the measured wall of the mixed round
        with health.MONITOR.dispatch_guard(
                "mixed", active=n_active, prefilling=len(plan), rids=rids,
                **info) as g, \
                telemetry.span(name, cat="serving", active=n_active,
                               prefilling=len(plan), rids=rids, **info), \
                (self._tracking_load() if track_load
                 else contextlib.nullcontext()):
            sel = self._prefill_block(block)
            self.prefills += 1
            # the post-chunk offsets: the frozen garbage aim of the rows
            # just prefilled, as the sequential advance-then-fuse path
            # aims them
            for _, _, st, end in plan:
                self.prefill_tokens += end - st.pos
                st.pos = end
            if n_active:
                out = decode()
        self._acct_credit(g.device_s, decode_rids, prefill_rids)
        if n_active:
            drain(out)
        self._finish_mixed_round(plan, sel, overflow)
        self._observe_tick(t0)
        return n_active

    def tick_mixed(self, n_steps: int, chunk: int = 64,
                   budget: int = 128) -> int:
        """One token-budget round of prefill and decode: the pending
        chunks of up to ``budget // chunk`` mid-prefill slots
        (round-robin) as one batched prefill forward, then the
        ``n_steps`` fused decode steps over every decoding slot
        (:meth:`tick_fused`).  Returns #decoding slots before the round.
        Streams equal the sequential ``advance_prefill();
        tick_fused(n)`` composition: a slot whose prompt completes here
        joins the NEXT round, and rows prefilled this round stay frozen
        at their post-chunk offset (the aim the sequential path gives
        them).  The block has the fixed shape [R, chunk]; unused rows are
        computed and dropped."""
        return self._mixed_round(
            chunk, budget, "batcher.tick_mixed",
            lambda: self._fused_tokens(n_steps),
            lambda toks: self._drain_fused_tokens(toks, n_steps),
            lambda: self.tick_fused(n_steps), track_load=True,
            steps=n_steps)

    # -- speculation -------------------------------------------------------
    def spec_fallback_reason(self, k: int) -> Optional[str]:
        """Why speculation at depth ``k`` cannot run on this storage (None
        = it can; the reasons are :data:`SPEC_FALLBACK_REASONS`).  A
        full-size row always can (a rejected tail is masked by position);
        a rolling row up to the ``spec_k`` slots of slack it was built
        with: a deeper block would evict keys still in a window."""
        if self.rolling_slots and k > self.spec_k:
            return "ring_margin"
        return None

    def _spec_needs_headroom(self) -> bool:
        """Whether a verify block's tail can clamp onto committed
        positions, so that a request needs ``prompt + max_new + k <=
        max_seq``: only on a full-size dense row, whose block write clamps
        its start into the row.  A rolling row commits per ring slot and
        a page table sends a write past its end to the trash page."""
        return not self.rolling_slots

    def validate_spec_request(self, prompt_len: int, max_new: int,
                              k: int) -> None:
        """Raise for a request this storage could never speculate for
        (the submit-side twin of :meth:`_validate_spec_call`)."""
        if (self._spec_needs_headroom()
                and prompt_len + max_new + k > self.cfg.max_seq):
            raise ValueError(
                f"speculation needs {k} tokens of cache headroom: "
                f"prompt+max_new_tokens+spec_k exceeds "
                f"max_seq={self.cfg.max_seq}")

    def _validate_spec_call(self, k: int) -> None:
        """Raise, before any state changes, for a spec call this storage
        cannot contain: a depth past what it can verify
        (:meth:`spec_fallback_reason`), or on a full-size dense row a
        decoding or mid-prefill request without ``k`` tokens of headroom
        (its block, or a frozen row's garbage block, is 1+k wide)."""
        reason = self.spec_fallback_reason(k)
        if reason is not None:
            raise ValueError(
                f"this {self.storage_info()['kind']} storage cannot "
                f"verify k={k} speculative blocks ({reason}); "
                f"provision the batcher with spec_k >= {k} or lower k")
        if not self._spec_needs_headroom():
            return
        limit = self.cfg.max_seq
        for i, st in self.prefilling.items():
            if len(st.prompt) + st.max_new + k > limit:
                raise ValueError(
                    f"prefilling slot {i}: speculation needs {k} tokens "
                    f"of cache headroom past prompt+max_new (max_seq "
                    f"{limit})")
        for i, s in self.slots.items():
            if len(s.output) + s.remaining + k > limit:
                raise ValueError(
                    f"slot {i}: speculation needs {k} tokens of cache "
                    f"headroom past prompt+max_new (max_seq {limit})")

    def _gather_spec_arrays(self, k: int):
        """What a spec call's operands add to a decode step's
        (:meth:`_slot_operands`), on the device: the token buffers
        [B, max_seq + k] (each decoding slot's history without its
        pending token; the ``+ k`` tail keeps a proposal appended near
        max_seq from clamping back over history), their lengths, what
        each slot has left, and which slots decode."""
        n = self.n_slots
        bufs = np.zeros((n, self.cfg.max_seq + k), np.int64)
        rows = np.zeros((3, n), np.int64)        # buf_lens, remainings, live
        for i, s in self.slots.items():
            bufs[i, :len(s.output) - 1] = s.output[:-1]
            rows[:, i] = len(s.output) - 1, s.remaining, 1
        buf_lens, remainings, actives = torch.from_numpy(rows).to(
            self.device)
        return (torch.from_numpy(bufs).to(self.device), buf_lens,
                remainings, actives.bool())

    @torch.inference_mode()
    def _spec_n(self, k: int, ngram: int, n_rounds: int):
        """``n_rounds`` spec rounds over one round operand (the storage's
        ``_round_operand``, sized for ``n_rounds`` blocks of 1+k), each
        a ``_verify_logits`` forward: THE decode loop of a spec call
        (:func:`~tpushare_torch.serving.speculative.spec_scan`), on a
        decode step's operands (a mid-prefill row aims its frozen
        garbage block at its post-chunk offset) and
        :meth:`_gather_spec_arrays`.  Reads the host once, at its end.
        Returns (bufs, produced, next_toks, accepts [n_rounds, B],
        spec_lives [n_rounds, B]) on the host."""
        tokens, lengths, temps, gens, tks, tps = self._slot_operands()
        bufs, buf_lens, remainings, actives = self._gather_spec_arrays(k)
        operand = self._round_operand(lengths, n_rounds * (1 + k))
        ad = self._adapter_kw()
        # no sampled slot: the argmax, without the sampler's host read
        sample = (_sample_next
                  if any(s.temperature > 0 for s in self.slots.values())
                  else lambda logits, *_: torch.argmax(logits, dim=-1))

        def verify(blocks, ctxs, live, storage):
            return (self._verify_logits(blocks, ctxs, live, operand, ad),
                    storage)

        out = spec_scan(verify, sample, bufs, buf_lens, lengths,
                        tokens[:, 0], remainings, actives, temps, gens, tks,
                        tps, None, k, ngram, n_rounds)
        return tuple(out[i].cpu() for i in (0, 4, 3, 6, 7))

    def _drain_spec(self, bufs, produced, next_toks, accepts, lives,
                    n_rounds: int) -> None:
        """Consume a spec call's outputs (host tensors): extend every
        decoding slot by its committed tokens, at most ``remaining``,
        truncated after an eos; finish the slots that are done.  A live
        greedy row's accepted counts go to ``spec_accept_depth`` only up
        to the tokens delivered (past an eos the device keeps accepting
        tokens the host drops).  A sampled slot's generator drew once a
        round."""
        for i in list(self.slots):
            s = self.slots[i]
            got = int(produced[i])
            if got == 0:
                continue
            old_len = len(s.output) - 1
            # committed[0] re-commits the pending token; the new tokens
            # are the rest and the fresh pending token
            committed = bufs[i, old_len:old_len + got].tolist()
            new = (committed[1:] + [int(next_toks[i])])[:s.remaining]
            if s.eos_id is not None and s.eos_id in new:
                new = new[:new.index(s.eos_id) + 1]
            delivered, depths = 0, []
            for live, depth in zip(lives[:, i].tolist(),
                                   accepts[:, i].tolist()):
                if live and delivered < len(new):
                    self.spec_accept_depth[depth] += 1
                    depths.append(float(depth))
                    delivered += 1 + depth
            metrics.SPEC_ACCEPT_DEPTH.observe_many(depths)
            s.output.extend(new)
            s.remaining -= len(new)
            s.last_token = s.output[-1]
            s.length = len(s.output) - 1
            self._spec_stats["tokens"] += len(new)
            metrics.SPEC_TOKENS.inc(len(new))
            if s.remaining <= 0 or (s.eos_id is not None
                                    and s.last_token == s.eos_id):
                self._finish(i)
        self._spec_stats["rounds"] += n_rounds
        self._spec_stats["calls"] += 1
        metrics.SPEC_ROUNDS.inc(n_rounds)

    def tick_spec(self, n_rounds: int, k: int = 8, ngram: int = 2) -> int:
        """``n_rounds`` rounds of batched prompt-lookup speculation in one
        call; returns #active slots before it.  Each round is one
        ``[B, 1+k]`` verify forward; a greedy slot commits its pending
        token and the longest agreeing prefix of the ``k`` tokens that
        followed the last earlier occurrence of its trailing ``ngram``.
        Greedy streams equal :meth:`tick`'s and :meth:`tick_fused`'s and
        the rounds interleave freely; a sampled slot rides as a plain
        decode row, one draw a round, its stream :meth:`tick_fused`'s.
        Raises (:meth:`_validate_spec_call`) on a storage that cannot
        contain a k-token block."""
        if not self.slots:
            return 0
        t0 = time.perf_counter()
        self._validate_spec_call(k)
        rids = self._rids() if telemetry.enabled() else []
        with health.MONITOR.dispatch_guard("decode", active=len(self.slots),
                                           spec_rounds=n_rounds,
                                           rids=rids) as g:
            out = self._spec_n(k, ngram, n_rounds)
        self._acct_credit(g.device_s, rids)
        n_active = len(self.slots)
        self._drain_spec(*out, n_rounds)
        self._observe_tick(t0)
        return n_active

    def tick_mixed_spec(self, n_rounds: int, chunk: int = 64,
                        budget: int = 128, k: int = 8,
                        ngram: int = 2) -> int:
        """The mixed round with SPECULATION as its decode half: the
        pending chunks of up to ``budget // chunk`` mid-prefill slots as
        one prefill forward, then ``n_rounds`` spec rounds
        (:meth:`tick_spec`) in which the mid-prefill rows ride frozen at
        their post-chunk offset.  Same selection, fallback and activation
        as :meth:`tick_mixed`; validated before any state changes.
        Returns #decoding slots before the round."""
        if not self.prefilling and not self.slots:
            return 0
        self._validate_spec_call(k)
        return self._mixed_round(
            chunk, budget, "batcher.tick_mixed_spec",
            lambda: self._spec_n(k, ngram, n_rounds),
            lambda out: self._drain_spec(*out, n_rounds),
            lambda: self.tick_spec(n_rounds, k=k, ngram=ngram),
            spec_rounds=n_rounds)

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.tick():
                return
        raise RuntimeError("batcher did not drain")


#: the service's prefill window (the paged pool rounds it to a page
#: multiple), the fused decode steps of a round (a spec round verifies
#: half as many blocks) and the n-gram its speculation looks up: the
#: reference's defaults
PREFILL_CHUNK = 64
DECODE_CHUNK = 8
SPEC_NGRAM = 2


@dataclasses.dataclass
class _Request:
    prompt: List[int]
    max_new: int
    temperature: float
    seed: int
    eos_id: Optional[int]
    top_k: int
    top_p: float
    sink: "queue.Queue"
    submitted: float
    #: a stream's sink takes ("delta", tokens) items, then ("done",
    #: output); ``pushed`` is the output's length already pushed and
    #: ``first_at`` when the first delta went out
    stream: bool = False
    pushed: int = 0
    first_at: Optional[float] = None
    #: fires on the loop thread when the batcher finishes the request,
    #: whether or not a stream's consumer is still there
    on_complete: Optional[Callable] = None
    #: prefill hand-off: the sink takes ("handoff", blob) at activation
    handoff: bool = False
    #: a session migrated out: when its slot had activated here
    activated: Optional[float] = None
    #: the request's LoRA adapter (None = the base model)
    adapter: Optional[str] = None


def _sentinel(req: _Request) -> None:
    """What a request's sink gets when the service stops under it."""
    try:
        req.sink.put_nowait(("aborted", None) if req.stream else None)
    except queue.Full:
        pass


#: The service's thread model, checked by ``tpushare.analysis.
#: confinement`` (the reference's schema): the loop thread (``_loop``)
#: owns the batcher and the per-request state, and only the loop's
#: closure, construction and the join-synchronized ``stop`` may mutate
#: ``loop_confined`` attributes; the ``lock_crossed`` queues are touched
#: only under ``self._lock``; another thread calls only the batcher's
#: ``batcher_readonly`` methods (validation and point-in-time views:
#: ``adapter_pressure`` is the server's 503 gate).  The adapter pool is
#: loop-owned state inside the batcher.  Reads of loop state from other
#: threads stay legal: they are the documented snapshots
#: (:meth:`ContinuousService.snapshot`).
_THREAD_MANIFEST = {
    "class": "ContinuousService",
    "loop_roots": ("_loop",),
    "construction": ("__init__", "start"),
    "join_synced": ("stop",),
    "loop_confined": ("_inflight", "_migrated", "_handoff_rids",
                      "_resident_since", "_spill", "_batcher",
                      "_policy_pacer"),
    "lock_crossed": ("_waiting", "_mig_cmds", "_cancels"),
    "batcher_attr": "_batcher",
    "batcher_readonly": ("validate_request", "validate_sampling",
                         "validate_spec_request", "spec_fallback_reason",
                         "can_migrate", "storage_info", "free_slots",
                         "validate_adapter", "adapter_pressure",
                         "adapter_info"),
}


class ContinuousService:
    """Thread-safe front end over a batcher: ``submit`` returns a queue
    that delivers the finished token list (None on shutdown, the
    exception if the loop failed); one loop thread admits waiting
    requests as slots free and runs rounds while work exists.
    ``page_size`` > 0 serves from the paged pool, 0 from the dense slot
    storage (rolling rows for a sliding-window config).

    Admission looks at what it would stall.  A pass that starts with no
    slot decoding admits every request it takes whole (``admit``: one
    prefill forward a prompt, nothing waits behind it but the pass's own
    new slots); a pass that starts while slots decode streams each prompt
    ``PREFILL_CHUNK`` tokens at a time (``admit_chunked``), so that no
    decoding slot waits more than one window's forward.  While anything
    prefills, a round is one MIXED step (``tick_mixed``: the pending
    windows of up to ``prefill_budget // PREFILL_CHUNK`` slots as one
    prefill forward, then ``DECODE_CHUNK`` fused decode steps), or with
    ``mixed_step=False`` the sequential ``advance_prefill`` then
    ``tick_fused`` (the same streams); otherwise ``DECODE_CHUNK`` fused
    steps (``tick_fused``).

    ``spec_k`` > 0 speculates by prompt lookup whenever a greedy slot
    decodes: the mixed round becomes ``tick_mixed_spec`` and the
    decode-only round ``tick_spec``, ``DECODE_CHUNK // 2`` verify rounds
    of depth ``spec_k`` over n-grams of ``SPEC_NGRAM`` (sampled slots
    ride them as decode rows).  With no greedy slot the round takes the plain
    path (counted as ``sampling_only``); a storage that cannot verify
    ``spec_k`` tokens turns speculation off at start (``ring_margin``)
    and serves on; the sequential rounds never speculate.

    ``policy`` (a ``serving.policy.DispatchPacer``, or None): installed on
    the health monitor from :meth:`start` to :meth:`stop`, so every
    dispatch guard of the loop paces against, and debits, this tenant's
    device-time bucket.

    The session lifecycle, as in the reference: :meth:`submit_stream`
    streams deltas, :meth:`cancel` abandons a request wherever it is,
    :meth:`submit_handoff` exports a session the moment it activates,
    :meth:`import_session` decodes a peer's blob to completion, and
    :meth:`migrate_out` / :meth:`deliver_migrated` / :meth:`reimport`
    move live sessions to a peer (``/drain {"migrate_to": ...}``).
    ``spill_bytes`` (paged storage) arms the HOST-RAM SPILL TIER: when
    admission meets backpressure, the longest-resident decoding session
    past ``TPUSHARE_SPILL_IDLE_S`` seconds of residency (default 0)
    exports to a byte-budgeted :class:`~.migrate.HostSpillStore`, freeing
    its slot and pages, and the admission retries; parked sessions fault
    back in, oldest first, only while nothing waits.  Cancels and
    migration commands are taken at the start of every pass; export and
    import run outside the round guards.

    ``adapter_slots`` > 0 serves multi-adapter LoRA (rank
    ``adapter_rank``): a submit may name an ``adapter``; an adapter the
    loader cannot load aborts that one request (its sink gets what
    :meth:`stop` gives), and while adapter-pool pressure refuses an
    admission the spill tier parks a session only if one that decodes
    holds an adapter pin.

    Thread model (``_THREAD_MANIFEST``): the loop thread owns the batcher
    and the per-request state; other threads cross only through the
    lock-guarded queues and the batcher's read-only methods."""

    def __init__(self, params, cfg: transformer.ModelConfig, n_slots: int,
                 page_size: int = 16,
                 n_pages: Optional[int] = None, device=None,
                 pool_bytes: Optional[int] = None, mesh=None,
                 mixed_step: bool = True,
                 prefill_budget: Optional[int] = None,
                 prefix_cache: bool = False, spec_k: int = 0,
                 policy=None, spill_bytes: Optional[int] = None,
                 adapter_slots: int = 0, adapter_rank: int = 8):
        from .paged import PagedContinuousBatcher

        self._policy_pacer = policy
        self.mesh = mesh
        self._mixed_step = bool(mixed_step)
        self._prefill_budget = (int(prefill_budget)
                                if prefill_budget is not None
                                else 2 * PREFILL_CHUNK)
        if page_size > 0:
            self._batcher = PagedContinuousBatcher(
                params, cfg, n_slots, page_size=page_size, n_pages=n_pages,
                device=device, pool_bytes=pool_bytes, mesh=mesh,
                max_prefill_chunk=PREFILL_CHUNK, prefix_cache=prefix_cache,
                spec_k=spec_k, adapter_slots=adapter_slots,
                adapter_rank=adapter_rank)
        else:
            if n_pages or pool_bytes:
                raise ValueError("n_pages and pool_bytes size a paged pool; "
                                 "pass page_size too")
            if prefix_cache:
                raise ValueError("prefix_cache is a paged-pool feature; "
                                 "pass page_size too")
            self._batcher = ContinuousBatcher(params, cfg, n_slots,
                                              device=device, mesh=mesh,
                                              spec_k=spec_k,
                                              adapter_slots=adapter_slots,
                                              adapter_rank=adapter_rank)
        #: speculation: the depth asked for, the one in use (0 once a
        #: storage that cannot verify it turned it off), and the rounds
        #: that fell back to the plain path, by reason
        self.spec_k_asked = int(spec_k)
        self._spec_k = int(spec_k)
        self.spec_fallbacks = dict.fromkeys(SPEC_FALLBACK_REASONS, 0)
        if self._spec_k:
            reason = self._batcher.spec_fallback_reason(self._spec_k)
            if reason is not None:
                log.warning("speculation disabled (%s): spec_k=%d on %s "
                            "storage", reason, self._spec_k,
                            self._batcher.storage_info()["kind"])
                self.spec_fallbacks[reason] += 1
                metrics.SPEC_FALLBACK.inc(reason=reason)
                self._spec_k = 0
        self._spill: Optional[migrate.HostSpillStore] = None
        self._spill_idle_s = float(os.environ.get("TPUSHARE_SPILL_IDLE_S",
                                                  "0"))
        if spill_bytes:
            if not self._batcher.can_migrate():
                log.warning("spill tier disabled: storage cannot migrate "
                            "sessions (needs page_size)")
                metrics.MIGRATION_REFUSED.inc(reason="unsupported_storage")
            else:
                self._spill = migrate.HostSpillStore(int(spill_bytes))
        self._lock = threading.Lock()
        # under the lock: the queue, the cancels and the migration
        # commands handed over from other threads; the rest is the loop's
        self._waiting: "collections.deque[_Request]" = collections.deque()
        self._cancels: List["queue.Queue"] = []
        self._mig_cmds: List[tuple] = []
        self._inflight: Dict[int, _Request] = {}
        #: sessions migrated out, awaiting the peer's finished stream
        self._migrated: Dict[int, _Request] = {}
        self._handoff_rids: set = set()
        self._resident_since: Dict[int, float] = {}
        self._work = threading.Event()
        self._halt = threading.Event()
        self.failure: Optional[BaseException] = None
        #: per finished request: seconds to its first token (its slot
        #: activated: the prompt prefilled and the first token sampled)
        #: and to its last, and its generated tokens
        self.timings: "collections.deque[dict]" = collections.deque(
            maxlen=1024)
        #: rounds the loop has run (mixed, sequential or decode-only), and
        #: the requests it admitted whole and chunked
        self.rounds = 0
        self.admitted_whole = 0
        self.admitted_chunked = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tpushare-torch-service")

    def start(self) -> "ContinuousService":
        if self._policy_pacer is not None:
            health.MONITOR.install_policy(self._policy_pacer)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._halt.set()
        self._work.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=30)
        if self._policy_pacer is not None:
            # disarm exactly this service's pacer, not a successor's
            health.MONITOR.uninstall_policy(self._policy_pacer)
        with self._lock:
            pending = list(self._waiting)
            self._waiting.clear()
            cmds, self._mig_cmds = self._mig_cmds, []
        if self._thread.is_alive():
            # the loop outlived the join: its state is still its own
            log.warning("service loop did not exit within 30s; leaving "
                        "%d in-flight request(s) to their timeouts",
                        len(self._inflight))
        else:
            pending += list(self._inflight.values())
            pending += list(self._migrated.values())
            self._inflight.clear()
            self._migrated.clear()
        for req in pending:
            _sentinel(req)
        for cmd in cmds:
            if cmd[0] == "import":
                cmd[2].put_nowait(None)
            elif cmd[0] == "export":
                cmd[1].put_nowait(None)

    # -- intake (any thread) -------------------------------------------
    def can_migrate(self) -> bool:
        """Whether the storage can export and import sessions."""
        return self._batcher.can_migrate()

    def validate(self, prompt: List[int], max_new_tokens: int,
                 top_k: int = 0, top_p: float = 1.0,
                 adapter: Optional[str] = None) -> None:
        """Raise ValueError for a request the batcher could never serve
        (with speculation on, one without its cache headroom too)."""
        self._batcher.validate_request(prompt, max_new_tokens)
        self._batcher.validate_sampling(top_k, top_p)
        self._batcher.validate_adapter(adapter)
        if self._spec_k:
            self._batcher.validate_spec_request(len(prompt), max_new_tokens,
                                                self._spec_k)

    def adapter_pressure(self, adapter: Optional[str]) -> bool:
        """Read-only adapter-pool pressure verdict (the server's 503
        gate): a point-in-time snapshot, safe from any thread."""
        return self._batcher.adapter_pressure(adapter)

    def validate_adapter(self, adapter: Optional[str]) -> None:
        """Raise for an adapter request this service can never serve."""
        self._batcher.validate_adapter(adapter)

    def _submit(self, prompt, max_new_tokens, temperature, seed, eos_id,
                top_k, top_p, stream=False, on_complete=None,
                handoff=False, adapter=None) -> "queue.Queue":
        self.validate(prompt, max_new_tokens, top_k, top_p, adapter)
        # a stream's sink takes many deltas; every other sink one item
        req = _Request(list(prompt), int(max_new_tokens), float(temperature),
                       int(seed), eos_id, int(top_k), float(top_p),
                       queue.Queue() if stream else queue.Queue(maxsize=1),
                       time.perf_counter(), stream=stream,
                       pushed=len(prompt), on_complete=on_complete,
                       handoff=handoff, adapter=adapter)
        metrics.REQUESTS.inc()
        with self._lock:
            if self.failure is not None:
                raise RuntimeError(f"service loop failed: {self.failure!r}")
            self._waiting.append(req)
            self._work.set()
        return req.sink

    def submit(self, prompt: List[int], max_new_tokens: int,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None, top_k: int = 0,
               top_p: float = 1.0,
               adapter: Optional[str] = None) -> "queue.Queue":
        """Queue a request; raises ValueError (:meth:`validate`) for one
        the batcher could never serve.  ``adapter`` names its LoRA adapter
        (``adapter_slots`` required)."""
        return self._submit(prompt, max_new_tokens, temperature, seed,
                            eos_id, top_k, top_p, adapter=adapter)

    def submit_stream(self, prompt: List[int], max_new_tokens: int,
                      temperature: float = 0.0, seed: int = 0,
                      eos_id: Optional[int] = None, top_k: int = 0,
                      top_p: float = 1.0, on_complete=None,
                      adapter: Optional[str] = None) -> "queue.Queue":
        """Streaming submit: the queue yields ``("delta", [new tokens])``
        after every round that grew the output, then ``("done",
        output)``, or ``("aborted", None)`` on shutdown; the streams are
        :meth:`submit`'s.  ``on_complete(output)`` fires on the loop
        thread when the batcher finishes the request, whether or not the
        consumer still listens."""
        return self._submit(prompt, max_new_tokens, temperature, seed,
                            eos_id, top_k, top_p, stream=True,
                            on_complete=on_complete, adapter=adapter)

    def submit_handoff(self, prompt: List[int], max_new_tokens: int,
                       temperature: float = 0.0, seed: int = 0,
                       eos_id: Optional[int] = None, top_k: int = 0,
                       top_p: float = 1.0,
                       adapter: Optional[str] = None) -> "queue.Queue":
        """PREFILL-ONLY submit (the sender half of disaggregation): at
        the activation boundary (prompt in cache, first token sampled,
        before any decode round) the session exports and the queue yields
        ``("handoff", blob)``.  A request that completes at activation
        (max_new 1, an instant eos) yields its tokens as :meth:`submit`
        would.  Paged storage only."""
        if not self.can_migrate():
            raise ValueError("prefill handoff requires paged storage "
                             "(pass page_size)")
        return self._submit(prompt, max_new_tokens, temperature, seed,
                            eos_id, top_k, top_p, handoff=True,
                            adapter=adapter)

    def import_session(self, blob: bytes) -> "queue.Queue":
        """Import a migration blob on the loop thread; the queue yields
        the session's final token list (as :meth:`submit`'s), or
        ``("refused", reason)`` (a value of
        :data:`~.migrate.MIGRATION_REFUSAL_REASONS`), or None on
        shutdown."""
        sink = queue.Queue(maxsize=1)
        with self._lock:
            if self.failure is not None:
                raise RuntimeError(f"service loop failed: {self.failure!r}")
            self._mig_cmds.append(("import", blob, sink))
        self._work.set()
        return sink

    def migrate_out(self, timeout: float = 30.0):
        """Export ONE decoding session off the pool (on the loop thread):
        returns ``(rid, blob)`` with its slot and pages freed and its
        client still waiting for :meth:`deliver_migrated` or
        :meth:`reimport`, or None when nothing can migrate."""
        reply = queue.Queue(maxsize=1)
        with self._lock:
            if self.failure is not None:
                return None
            self._mig_cmds.append(("export", reply))
        self._work.set()
        try:
            return reply.get(timeout=timeout)
        except queue.Empty:
            return None

    def deliver_migrated(self, rid: int, tokens: List[int]) -> None:
        """The peer finished migrated-out session ``rid``: its final
        token list goes to the local client."""
        with self._lock:
            self._mig_cmds.append(("deliver", rid, tokens))
        self._work.set()

    def reimport(self, rid: int, blob: bytes) -> None:
        """The peer refused migrated-out session ``rid``: scatter its blob
        back into this pool and serve it here (retried while the pool
        is short)."""
        with self._lock:
            self._mig_cmds.append(("reimport", rid, blob, 0))
        self._work.set()

    def cancel(self, sink) -> None:
        """Abandon the request behind ``sink`` (the queue a submit
        returned): dropped if it waits; if admitted, its slot and storage
        are released on the loop's next pass (or its spilled blob
        dropped).  Idempotent; a no-op for a delivered request.  The sink
        takes nothing more."""
        with self._lock:
            self._cancels.append(sink)
        self._work.set()

    def snapshot(self) -> dict:
        with self._lock:
            queued = len(self._waiting)
        b = self._batcher
        snap = {"slots": b.n_slots, "active": len(b.slots),
                "prefilling": len(b.prefilling), "queued": queued,
                "rounds": self.rounds, "admitted_whole": self.admitted_whole,
                "admitted_chunked": self.admitted_chunked,
                "prefills": b.prefills,
                "decode_steps": b.decode_steps,
                "prefill_tokens": b.prefill_tokens}
        if self._spill is not None:
            snap["spilled"] = len(self._spill)
            snap["spill_bytes"] = self._spill.bytes_used
        if self.spec_k_asked:
            st = dict(b._spec_stats)
            st["tokens_per_round"] = (round(st["tokens"] / st["rounds"], 3)
                                      if st["rounds"] else None)
            st.update({"spec_k": self._spec_k,
                       "fallbacks": dict(self.spec_fallbacks),
                       "accept_depth": {str(d): n for d, n in sorted(
                           b.spec_accept_depth.items())}})
            snap["speculation"] = st
        if self._policy_pacer is not None:
            snap["policy"] = self._policy_pacer.snapshot()
        adapters = b.adapter_info()
        if adapters is not None:
            snap["adapters"] = adapters
        return snap

    def storage_info(self) -> dict:
        return self._batcher.storage_info()

    # -- the loop's halves ---------------------------------------------
    def _admit_waiting(self) -> None:
        """Admit queued requests while slots and storage allow: whole if
        no slot was decoding when the pass began, else by
        ``admit_chunked``.  On backpressure the spill tier (when on)
        parks the longest-resident decoding session and the admission
        retries (under adapter-pool pressure only while a decoding session
        holds an adapter pin: spilling frees pages, not pins); a request
        still refused goes back to the FRONT of the queue.  A request whose
        adapter its loader cannot load is aborted alone; any other
        admission failure fails the loop."""
        b = self._batcher
        whole = not b.slots
        while True:
            with self._lock:
                if not self._waiting:
                    return
                req = self._waiting.popleft()
            kw = dict(temperature=req.temperature, seed=req.seed,
                      eos_id=req.eos_id, top_k=req.top_k, top_p=req.top_p,
                      adapter=req.adapter)
            rid = None
            failed = False
            while True:
                if b.free_slots():
                    try:
                        if whole:
                            rid = b.admit(req.prompt, req.max_new, **kw)
                        else:
                            rid = b.admit_chunked(req.prompt, req.max_new,
                                                  chunk=PREFILL_CHUNK, **kw)
                    except AdapterLoadError:
                        # raised before a slot or a page is taken: one
                        # request's failure, never the loop every tenant
                        # rides on
                        log.exception("admission failed for a queued "
                                      "request (adapter=%r); aborting it",
                                      req.adapter)
                        failed = True
                        break
                    except BaseException:
                        # anything else (a device failure in the prefill)
                        # fails the loop; the request goes back to the
                        # queue so the failure path answers it too
                        with self._lock:
                            self._waiting.appendleft(req)
                        raise
                    if rid is not None:
                        break
                if (req.adapter is not None
                        and b.adapter_pressure(req.adapter)
                        and not b.adapter_spill_can_help()):
                    break
                # each spill takes one resident session off the pool
                if not self._spill_one():
                    break
            if failed:
                _sentinel(req)
                continue
            if rid is None:                     # storage backpressure
                with self._lock:
                    self._waiting.appendleft(req)
                return
            # queue wait ends at admission (a slot and storage granted)
            metrics.REQUEST_QUEUE.observe(time.perf_counter() - req.submitted)
            if whole:
                self.admitted_whole += 1
            else:
                self.admitted_chunked += 1
            self._inflight[rid] = req
            self._resident_since[rid] = time.monotonic()
            if req.handoff:
                self._handoff_rids.add(rid)

    def _complete(self, rid: int, req: _Request, out: List[int],
                  first: Optional[float]) -> None:
        """A finished request's books and its sink: the timings, the
        request series (a one-shot request's first output IS its
        result, so its TTFT is the latency; a stream's TTFT was taken at
        its first delta and its TPOT spans the rest), then the result."""
        self._resident_since.pop(rid, None)
        now = time.perf_counter()
        n_new = len(out) - len(req.prompt)
        self.timings.append({
            "ttft_s": (first if first is not None else now) - req.submitted,
            "total_s": now - req.submitted, "new_tokens": n_new})
        total = now - req.submitted
        metrics.REQUEST_LATENCY.observe(total)
        if req.first_at is not None:
            if n_new > 1:
                metrics.TPOT.observe((now - req.first_at) / (n_new - 1))
        else:
            metrics.TTFT.observe(total)
            metrics.TPOT.observe(total / max(1, n_new))
        if req.on_complete is not None:
            try:
                req.on_complete(out)
            except Exception:
                log.exception("on_complete raised; continuing")
        if req.stream:
            if len(out) > req.pushed:
                req.sink.put(("delta", out[req.pushed:]))
                req.pushed = len(out)
            req.sink.put(("done", out))
        else:
            req.sink.put_nowait(out)

    def _push_streams(self) -> None:
        """Each live stream's new tokens since its last delta."""
        b = self._batcher
        by_rid = {s.request_id: s for s in b.slots.values()}
        for rid, req in self._inflight.items():
            if not req.stream:
                continue
            s = by_rid.get(rid)
            out = s.output if s is not None else b.completed.get(rid)
            if out is not None and len(out) > req.pushed:
                if req.first_at is None:
                    req.first_at = time.perf_counter()
                    metrics.TTFT.observe(req.first_at - req.submitted)
                req.sink.put(("delta", out[req.pushed:]))
                req.pushed = len(out)

    def _deliver(self) -> None:
        b = self._batcher
        for rid in [r for r in b.completed if r in self._inflight]:
            out = b.completed.pop(rid)
            self._handoff_rids.discard(rid)
            self._complete(rid, self._inflight.pop(rid), out,
                           b.activated_at.pop(rid, None))

    def _drain_cancels(self) -> None:
        """The loop's half of :meth:`cancel`."""
        with self._lock:
            cancels, self._cancels = self._cancels, []
            for sink in cancels:
                self._waiting = collections.deque(
                    r for r in self._waiting if r.sink is not sink)
        for sink in cancels:
            for rid, req in list(self._inflight.items()):
                if req.sink is sink:
                    self._batcher.cancel(rid)
                    del self._inflight[rid]
                    self._forget_session(rid)
                    break
            else:
                # migrated out: the peer finishes it for nobody
                for rid, req in list(self._migrated.items()):
                    if req.sink is sink:
                        del self._migrated[rid]

    def _forget_session(self, rid: int) -> None:
        """A cancelled request's migration state: a SPILLED session's blob
        (the batcher's cancel found no slot) and its hand-off and
        residency books."""
        self._resident_since.pop(rid, None)
        self._handoff_rids.discard(rid)
        if self._spill is not None and self._spill.take(rid) is not None:
            metrics.CANCELLATIONS.inc()
            self._observe_spill()

    def _observe_spill(self) -> None:
        if self._spill is not None:
            metrics.SPILL_BYTES.set(self._spill.bytes_used)
            metrics.SPILL_SESSIONS.set(len(self._spill))

    def _abort_rid(self, rid: int) -> None:
        """Terminal failure of an in-flight request: its sink gets what
        :meth:`stop` would give it."""
        self._handoff_rids.discard(rid)
        self._resident_since.pop(rid, None)
        req = self._inflight.pop(rid, None)
        if req is not None:
            _sentinel(req)

    def _spill_one(self) -> bool:
        """Export the longest-resident decoding session past its
        residency quantum into the host-RAM store, freeing its slot and
        pages.  False when nothing is eligible, or when the store's budget
        refuses (the victim then stays resident; counted)."""
        if self._spill is None:
            return False
        b = self._batcher
        now = time.monotonic()
        cands = sorted(
            (self._resident_since.get(s.request_id, 0.0), s.request_id)
            for s in b.slots.values()
            if s.request_id not in self._handoff_rids)
        for since, rid in cands:
            if now - since < self._spill_idle_s:
                break       # the longest-resident is still in its quantum
            blob = b.export_session(rid)
            if not self._spill.put(rid, blob):
                metrics.MIGRATION_REFUSED.inc(reason="spill_budget")
                return False
            b.pop_session(rid)
            self._resident_since.pop(rid, None)
            metrics.MIGRATIONS_OUT.inc(kind="spill")
            RECORDER.record("session_spilled", rid=rid, bytes=len(blob))
            self._observe_spill()
            return True
        return False

    def _restore_spilled(self) -> None:
        """Fault parked sessions back into the pool, oldest first, only
        while nothing waits (new admissions keep their FIFO priority, and
        a restored session would otherwise be spilled again before it
        decodes a token)."""
        if self._spill is None or not len(self._spill):
            return
        with self._lock:
            if self._waiting:
                return
        b = self._batcher
        while b.free_slots():
            rid = self._spill.oldest()
            if rid is None:
                return
            blob = self._spill.take(rid)
            t0 = time.perf_counter()
            try:
                got = b.import_session(blob, rid=rid)
            except Exception:
                log.exception("restoring spilled session %d failed; "
                              "aborting it", rid)
                self._abort_rid(rid)
                self._observe_spill()
                continue
            if got is None:
                # pages still short: back to the FRONT, retried later
                self._spill.put(rid, blob, front=True)
                return
            metrics.SPILL_RESTORE.observe(time.perf_counter() - t0)
            metrics.MIGRATIONS_IN.inc(kind="restore")
            RECORDER.record("session_restored", rid=rid)
            self._resident_since[rid] = time.monotonic()
            self._observe_spill()

    def _sweep_handoffs(self) -> None:
        """Export the hand-off submits that have activated: the slot is
        released and the sink takes ``("handoff", blob)``.  One that
        completed at activation is delivered as tokens."""
        if not self._handoff_rids:
            return
        b = self._batcher
        live = {s.request_id for s in b.slots.values()}
        for rid in list(self._handoff_rids):
            if rid in b.completed:
                self._handoff_rids.discard(rid)     # nothing to hand off
                continue
            if rid not in live:
                continue                            # still prefilling
            self._handoff_rids.discard(rid)
            blob = b.export_session(rid)
            b.pop_session(rid)
            b.activated_at.pop(rid, None)
            self._resident_since.pop(rid, None)
            metrics.MIGRATIONS_OUT.inc(kind="handoff")
            req = self._inflight.pop(rid, None)
            if req is not None:
                req.sink.put(("handoff", blob))

    def _drain_migrations(self) -> None:
        """The loop's half of the migration commands."""
        with self._lock:
            if not self._mig_cmds:
                return
            cmds, self._mig_cmds = self._mig_cmds, []
        retry = []
        for cmd in cmds:
            try:
                if cmd[0] == "export":
                    self._mig_export(cmd[1])
                elif cmd[0] == "import":
                    self._mig_import(cmd[1], cmd[2])
                elif cmd[0] == "deliver":
                    self._mig_deliver(cmd[1], cmd[2])
                elif not self._mig_reimport(cmd[1], cmd[2]):
                    if cmd[3] >= 10_000:
                        log.error("reimport of session %d starved; "
                                  "aborting it", cmd[1])
                        req = self._migrated.pop(cmd[1], None)
                        if req is not None:
                            _sentinel(req)
                    else:
                        retry.append(cmd[:3] + (cmd[3] + 1,))
            except Exception:
                # one poisoned command must never kill the loop every
                # request rides on: the handlers map the expected
                # failures to counted refusals, this is the backstop
                log.exception("migration command %r failed; dropped",
                              cmd[0])
        if retry:
            with self._lock:
                self._mig_cmds.extend(retry)

    def _mig_export(self, reply) -> None:
        b = self._batcher
        rid = None
        if b.can_migrate():
            rid = next((s.request_id for s in b.slots.values()
                        if s.request_id not in self._handoff_rids
                        and s.request_id in self._inflight), None)
        if rid is None:
            reply.put(None)
            return
        blob = b.export_session(rid)
        b.pop_session(rid)
        self._resident_since.pop(rid, None)
        # the client stays wired: the peer's finished stream
        # (deliver_migrated) or a reimport comes back to it
        req = self._inflight.pop(rid)
        req.activated = b.activated_at.pop(rid, None)
        self._migrated[rid] = req
        metrics.MIGRATIONS_OUT.inc(kind="drain")
        RECORDER.record("session_migrated_out", rid=rid, bytes=len(blob))
        reply.put((rid, blob))

    def _mig_import(self, blob, sink) -> None:
        b = self._batcher

        def refuse(reason):
            metrics.MIGRATION_REFUSED.inc(reason=reason)
            RECORDER.record("migration_refused", reason=reason)
            sink.put(("refused", reason))

        if not b.can_migrate():
            refuse("unsupported_storage")
            return
        try:
            rid = b.import_session(blob)
            # capacity backpressure: the spill tier makes room as it does
            # for an admission
            while rid is None and self._spill_one():
                rid = b.import_session(blob)
        except migrate.ConfigMismatch:
            refuse("config_mismatch")
            return
        except migrate.BlobError:
            refuse("bad_blob")
            return
        if rid is None:
            refuse("pool_full")
            return
        s = next(s for s in b.slots.values() if s.request_id == rid)
        self._inflight[rid] = _Request(
            s.output[:s.prompt_len], len(s.output) - s.prompt_len
            + s.remaining, s.temperature, 0, s.eos_id, s.top_k, s.top_p,
            sink, time.perf_counter())
        self._resident_since[rid] = time.monotonic()
        metrics.MIGRATIONS_IN.inc(kind="import")
        RECORDER.record("session_migrated_in", rid=rid, bytes=len(blob))

    def _mig_deliver(self, rid: int, tokens: List[int]) -> None:
        req = self._migrated.pop(rid, None)
        if req is not None:
            self._complete(rid, req, list(tokens), req.activated)

    def _mig_reimport(self, rid: int, blob) -> bool:
        b = self._batcher
        try:
            got = b.import_session(blob, rid=rid)
        except Exception:
            log.exception("reimport of session %d failed; aborting it", rid)
            req = self._migrated.pop(rid, None)
            if req is not None:
                _sentinel(req)
            return True
        if got is None:
            return False
        req = self._migrated.pop(rid, None)
        if req is not None:
            self._inflight[rid] = req
            if req.activated is not None:
                b.activated_at[rid] = req.activated
        self._resident_since[rid] = time.monotonic()
        metrics.MIGRATIONS_IN.inc(kind="import")
        return True

    def _spec_route(self) -> bool:
        """Speculate this round?  Only while a greedy slot decodes (spec
        rows exist only for greedy slots); with decoding slots that all
        sample, the round takes the plain path and counts
        ``sampling_only``."""
        slots = self._batcher.slots
        if not self._spec_k or not slots:
            return False
        if any(s.temperature == 0.0 for s in slots.values()):
            return True
        self.spec_fallbacks["sampling_only"] += 1
        metrics.SPEC_FALLBACK.inc(reason="sampling_only")
        return False

    def _round(self) -> None:
        """One round of the loop (see the class docstring)."""
        b = self._batcher
        spec = self._spec_route()
        spec_rounds = max(1, DECODE_CHUNK // 2)
        kw = dict(k=self._spec_k, ngram=SPEC_NGRAM)
        if b.prefilling:
            if self._mixed_step and spec:
                b.tick_mixed_spec(spec_rounds, chunk=PREFILL_CHUNK,
                                  budget=self._prefill_budget, **kw)
            elif self._mixed_step:
                b.tick_mixed(DECODE_CHUNK, chunk=PREFILL_CHUNK,
                             budget=self._prefill_budget)
            else:
                b.advance_prefill()
                b.tick_fused(DECODE_CHUNK)
        elif spec:
            b.tick_spec(spec_rounds, **kw)
        else:
            b.tick_fused(DECODE_CHUNK)
        self.rounds += 1

    def _pass(self) -> None:
        """One pass of the loop: cancels and migration commands, the
        spilled sessions' restore, admission, a round, then what the pass
        finished.  A hand-off exports at activation: right after a whole
        admission, before any round decodes it, and after the round that
        activated a chunked one."""
        b = self._batcher
        self._drain_cancels()
        self._drain_migrations()
        self._restore_spilled()
        self._admit_waiting()
        self._sweep_handoffs()
        if b.prefilling or b.slots:
            self._round()
        self._sweep_handoffs()
        self._push_streams()
        self._deliver()

    def _loop(self) -> None:
        b = self._batcher
        while not self._halt.is_set():
            if not self._work.wait(timeout=0.5):
                continue
            try:
                self._pass()
            except Exception as e:     # keep the server answering
                log.exception("service loop failed")
                with self._lock:
                    self.failure = e
                    failed = list(self._waiting) + list(
                        self._inflight.values()) + list(
                        self._migrated.values())
                    self._waiting.clear()
                    self._inflight.clear()
                    self._migrated.clear()
                for req in failed:
                    if req.stream:
                        _sentinel(req)
                    else:
                        req.sink.put_nowait(e)
                return
            with self._lock:
                queued = len(self._waiting)
                if (not queued and not b.slots and not b.prefilling
                        and not self._mig_cmds and not self._cancels
                        and not (self._spill is not None
                                 and len(self._spill))):
                    self._work.clear()
            # the backpressure gauge: the demand signal the daemon's slack
            # reallocation reads from the usage report
            metrics.REQUEST_QUEUE_DEPTH.set(queued)
