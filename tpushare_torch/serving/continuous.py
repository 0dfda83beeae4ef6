"""Continuous batching: a slot-pooled decode loop for LLM serving.

Counterpart of ``tpushare/serving/continuous.py``: a fixed pool of slots;
admission prefills a request into a free slot and samples its first
token; every tick advances ALL active slots one token in one batched
forward, each at its own depth; finished slots free at once and new
requests join mid-flight.

The storage is pluggable through the hooks ``_init_storage``,
``_reserve``/``_release``, ``_prefill_into``, ``_round_operand`` and
``_decode_logits``.  This class is the DENSE storage: one row of
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
one batched prefill forward and then the fused decode steps.  Sampling
runs per slot with its own ``torch.Generator`` seeded from the request's
``seed``, one draw a step for a sampled slot, in slot order, whichever
round runs the step: ``tick``, ``tick_fused`` and ``tick_mixed``
interleave into the same streams.  Greedy is an exact argmax, and the
top-k/top-p filter is the reference's (the draw itself cannot match
``jax.random``'s bits).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import default_device
from ..models import transformer
from ..ops.attention import NEG_INF
from ..ops.quant import kv_cache_bytes
from ..parallel.mesh import canonical_device

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


# ---------------------------------------------------------------------------
# The dense storage's device programs (plain functions: there is no jit
# cache to keep; the names are the reference's)
# ---------------------------------------------------------------------------
def _row_view(caches, slot: int):
    """Row ``slot`` of the stacked caches, as views: writes land in the
    pool."""
    return tuple(transformer._kv_map(lambda t: t[:, slot:slot + 1], c)
                 for c in caches)


@torch.inference_mode()
def _prefill_chunk(params, tokens, caches, slot: int, pos: int,
                   last_idx: int, cfg):
    """One prompt chunk [1, C] into row ``slot`` at offset ``pos``;
    returns the [V] logits at ``last_idx``, the chunk's last real token.
    Whole-prompt prefill is the ``pos=0`` single-chunk case.  The caller
    keeps ``pos + C <= max_seq``.  A padded tail of a full-size row lands
    past the real prefix and is overwritten before it is attendable; a
    rolling ring never commits it (``kv_write_len``)."""
    logits, _ = transformer.forward_cached(
        params, tokens, cfg, _row_view(caches, slot), pos,
        kv_write_len=last_idx + 1)
    return logits[0, last_idx]


@torch.inference_mode()
def _tick_mixed(params, p_tokens, p_slots, p_pos, p_last, act_rows,
                act_slots, caches, cfg, key_bound: Optional[int]):
    """The prefill half of a mixed round: the pending chunks p_tokens
    [R, C] of up to R mid-prefill slots as ONE batched forward.  The
    target rows are gathered out of the pool (``p_slots``), prefilled at
    ``p_pos`` with ``kv_write_len`` ``p_last + 1``, and only the rows
    ``act_rows`` go back, into slots ``act_slots``: a padded row's
    garbage never touches the pool, and prefill draws nothing from any
    slot's generator.  Returns the chunk-final logits [R, V]."""
    rows = tuple(transformer._kv_map(lambda t: t[:, p_slots], c)
                 for c in caches)
    logits, rows = transformer.forward_cached(
        params, p_tokens, cfg, rows, p_pos, kv_write_len=p_last + 1,
        key_bound=key_bound)
    for store, row in zip(caches, rows):
        for leaf, part in zip(transformer._kv_leaves(store),
                              transformer._kv_leaves(row)):
            leaf.index_copy_(1, act_slots, part.index_select(1, act_rows))
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
                 rolling_slots: Optional[bool] = None):
        """``mesh`` (``parallel.mesh.Mesh``, paged storage only): the
        storage is laid over it, and the batcher runs the dense part of
        every forward on its first device, where the params must lie
        (``device``, if given, must name that device).

        ``rolling_slots``: None (AUTO) gives a sliding-window config
        (window < max_seq) a ROLLING pool of window-sized rows (the same
        outputs at max_seq / window times the slots a byte); False forces
        max_seq rows."""
        if mesh is not None:
            dev0 = mesh.devices[0]
            if device is not None and canonical_device(
                    default_device(device)) != dev0:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {dev0}")
            device = dev0
        if rolling_slots is None:
            rolling_slots = transformer.wants_rolling(cfg)
        if rolling_slots and cfg.window is None:
            raise ValueError("rolling_slots needs a sliding-window cfg")
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
        self._init_storage()

    # -- storage hooks -------------------------------------------------
    def _init_storage(self) -> None:
        if self.mesh is not None:
            raise ValueError("dense and rolling slot storage takes no mesh "
                             "(position striping is a paged-pool feature)")
        self.caches = transformer.init_kv_caches(
            self.cfg, self.n_slots, rolling=self.rolling_slots,
            device=self.device)

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
        """Return per-request storage on completion."""

    def _prefill_into(self, slot: int, prompt: List[int]):
        """Prefill the prompt; returns [V] f32 logits at its last
        position.  Dense: the whole prompt as one chunk at pos 0."""
        tokens = torch.tensor([prompt], dtype=torch.long, device=self.device)
        return _prefill_chunk(self.params, tokens, self.caches, slot, 0,
                              len(prompt) - 1, self.cfg)

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

    def _decode_logits(self, tokens, lengths, operand):
        """One decode forward of every slot, tokens [B, 1] at ``lengths``
        [B]; returns the logits [B, V]."""
        logits, _ = transformer.forward_cached(self.params, tokens, self.cfg,
                                               self.caches, lengths,
                                               key_bound=operand)
        return logits[:, 0]

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
        that row's next chunk before any query attends it."""
        operand = self._round_operand(lengths, n_steps)
        out = []
        for _ in range(n_steps):
            tokens = _sample_next(
                self._decode_logits(tokens, lengths, operand), temps,
                generators, top_ks, top_ps)[:, None]
            out.append(tokens)
            lengths = lengths + incs
        return torch.cat(out, dim=1)

    def _prefill_chunk_into(self, slot: int, padded_tokens, pos: int,
                            last_idx: int):
        """One padded prompt chunk [1, C] into the slot's row; returns the
        logits at ``last_idx``."""
        return _prefill_chunk(self.params, padded_tokens, self.caches, slot,
                              pos, last_idx, self.cfg)

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
                           bound)

    def _mixed_chunk_len(self, chunk: int) -> int:
        """The prefill-window width of chunked admission and of the mixed
        round on this storage (the paged pool rounds it to a page
        multiple)."""
        return max(1, chunk)

    def storage_info(self) -> dict:
        """What a slot costs and how many a GiB buys, through
        ``ops.quant.kv_cache_bytes``.  The read is ``cached_attention``
        over the dense view whatever ``cfg.attn_kernel`` says (the JAX
        package reports it as ``"xla"``), so ``attn_kernel`` is
        ``"gather"``."""
        cfg = self.cfg
        slot_tokens = (min(cfg.window, cfg.max_seq) if self.rolling_slots
                       else cfg.max_seq)
        per_slot = kv_cache_bytes(cfg, slot_tokens)
        return {"kind": "rolling" if self.rolling_slots else "dense",
                "attn_kernel": "gather", "kv_dtype": cfg.kv_dtype,
                "slot_tokens": int(slot_tokens),
                "bytes_per_slot": int(per_slot),
                "slots_per_gib": (2 ** 30) // per_slot,
                "pool_bytes": int(per_slot * self.n_slots)}

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

    def _claim(self, prompt: List[int], max_new_tokens: int, top_k: int,
               top_p: float) -> Optional[int]:
        """Validate and claim a free slot and its storage (None =
        backpressure): the admission step ``admit`` and
        ``admit_chunked`` share."""
        self.validate_request(prompt, max_new_tokens)
        self.validate_sampling(top_k, top_p)
        free = self.free_slots()
        if not free:
            return None
        slot = free[0]
        if not self._reserve(slot, len(prompt), max_new_tokens,
                             prompt=prompt):
            return None
        return slot

    def admit(self, prompt: List[int], max_new_tokens: int,
              temperature: float = 0.0, seed: int = 0,
              eos_id: Optional[int] = None,
              top_k: int = 0, top_p: float = 1.0) -> Optional[int]:
        """Prefill into a free slot; returns the request id, or None when
        the pool is full (backpressure).  Invalid requests raise.
        ``eos_id`` finishes the request early when sampled: the output is
        the prompt + generated tokens up to and including the eos."""
        slot = self._claim(prompt, max_new_tokens, top_k, top_p)
        if slot is None:
            return None
        rid = self._next_id
        self._next_id += 1
        self.prefill_tokens += len(prompt) - self._prefill_start(slot)
        logits_v = self._prefill_into(slot, list(prompt))
        self.prefills += 1
        self._activate(slot, rid, list(prompt), logits_v, max_new_tokens,
                       temperature, seed, eos_id, top_k, top_p)
        return rid

    def admit_chunked(self, prompt: List[int], max_new_tokens: int,
                      temperature: float = 0.0, seed: int = 0,
                      chunk: int = 64, eos_id: Optional[int] = None,
                      top_k: int = 0, top_p: float = 1.0) -> Optional[int]:
        """Admit with the prompt streamed ``chunk`` tokens at a time by
        later :meth:`advance_prefill` or :meth:`tick_mixed` calls, so a
        long prompt never stalls decoding slots for more than one chunk's
        forward.  Same validation and backpressure as :meth:`admit`, and
        the same streams.  The storage sizes the window
        (:meth:`_mixed_chunk_len`)."""
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        chunk = self._mixed_chunk_len(chunk)
        slot = self._claim(prompt, max_new_tokens, top_k, top_p)
        if slot is None:
            return None
        rid = self._next_id
        self._next_id += 1
        self.prefilling[slot] = _Prefill(
            request_id=rid, prompt=list(prompt),
            pos=self._prefill_start(slot),
            max_new=max_new_tokens, temperature=temperature, seed=seed,
            chunk=chunk, eos_id=eos_id, top_k=top_k, top_p=top_p)
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
        # storage first: the paged prefix cache reads the finished slot
        self._release(slot)
        s = self.slots.pop(slot)
        self.completed[s.request_id] = s.output

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
        logits_v = self._prefill_chunk_into(
            slot, padded.to(self.device), st.pos, len(piece) - 1)
        self.prefills += 1
        self.prefill_tokens += len(piece)
        st.pos = end
        if end >= len(st.prompt):
            del self.prefilling[slot]
            self._activate(slot, st.request_id, st.prompt, logits_v,
                           st.max_new, st.temperature, st.seed, st.eos_id,
                           st.top_k, st.top_p)

    def advance_prefill(self, max_slots: Optional[int] = None) -> int:
        """One chunk for the mid-prefill slots: every one, or at most
        ``max_slots`` round-robin.  Returns how many still prefill."""
        limit = len(self.prefilling) if max_slots is None else max_slots
        for slot in self._select_prefill_slots(limit):
            self._advance_one_prefill(slot)
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
        nxt = self._step_n(*self._slot_operands(), self._decode_incs(),
                           1)[:, 0].tolist()
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
        return n_active

    def tick_fused(self, n_steps: int) -> int:
        """Up to ``n_steps`` decode steps in one call; returns #active
        slots before.  The streams are those of ``n_steps`` calls of
        :meth:`tick`, and the two interleave freely; a slot finishing
        mid-call completes at its end (its surplus steps decode garbage
        that is never consumed)."""
        if not self.slots:
            return 0
        tokens, lengths, temps, gens, tks, tps = self._slot_operands()
        toks = self._step_n(tokens, lengths, temps, gens, tks, tps,
                            self._decode_incs(), n_steps).tolist()
        self.decode_steps += n_steps
        n_active = len(self.slots)
        self._drain_fused_tokens(toks, n_steps)
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
        block = {"C": c, "p_tokens": np.zeros((r_rows, c), np.int64),
                 "p_slots": np.zeros((r_rows,), np.int64),
                 "p_active": np.zeros((r_rows,), bool),
                 "p_pos": np.zeros((r_rows,), np.int64),
                 "p_last": np.zeros((r_rows,), np.int64), "plan": []}
        for r, i in enumerate(picked):
            st = self.prefilling[i]
            end = min(st.pos + c, len(st.prompt))
            piece = st.prompt[st.pos:end]
            block["p_tokens"][r, :len(piece)] = piece
            block["p_slots"][r] = i
            block["p_active"][r] = True
            block["p_pos"][r] = st.pos
            block["p_last"][r] = len(piece) - 1
            block["plan"].append((r, i, st, end))
        return block, overflow

    def _mixed_fallback(self, overflow, n_steps: int) -> int:
        """No window for the fixed-width block: advance the max_seq
        stragglers one narrow chunk each, then decode as
        :meth:`tick_fused` (the sequential composition)."""
        for i in list(overflow):
            if i in self.prefilling:
                self._advance_one_prefill(i)
        return self.tick_fused(n_steps) if self.slots else 0

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

    def tick_mixed(self, n_steps: int, chunk: int = 64,
                   budget: int = 128) -> int:
        """One token-budget round of prefill and decode: the pending
        chunks of up to ``budget // chunk`` mid-prefill slots
        (round-robin) as one batched prefill forward, then the
        ``n_steps`` fused decode steps over every decoding slot.  Returns
        #decoding slots before the round.  Streams equal the sequential
        ``advance_prefill(); tick_fused(n)`` composition: a slot whose
        prompt completes here joins the NEXT round, and rows prefilled
        this round stay frozen at their post-chunk offset (the aim the
        sequential path gives them).  The block has the fixed shape
        [R, chunk]; unused rows are computed and dropped."""
        if not self.prefilling and not self.slots:
            return 0
        block, overflow = self._plan_mixed_round(chunk, budget)
        if block is None:
            return self._mixed_fallback(overflow, n_steps)
        plan = block["plan"]
        sel = self._prefill_block(block)
        self.prefills += 1
        # the post-chunk offsets: the frozen garbage aim of the rows just
        # prefilled, as the sequential advance-then-fuse path aims them
        for _, _, st, end in plan:
            self.prefill_tokens += end - st.pos
            st.pos = end
        n_active = len(self.slots)
        if n_active:
            tokens, lengths, temps, gens, tks, tps = self._slot_operands()
            toks = self._step_n(tokens, lengths, temps, gens, tks, tps,
                                self._decode_incs(), n_steps).tolist()
            self.decode_steps += n_steps
            self._drain_fused_tokens(toks, n_steps)
        self._finish_mixed_round(plan, sel, overflow)
        return n_active

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.tick():
                return
        raise RuntimeError("batcher did not drain")


#: the service's prefill window (the paged pool rounds it to a page
#: multiple) and the fused decode steps of a round: the reference's
#: defaults
PREFILL_CHUNK = 64
DECODE_CHUNK = 8


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
    steps (``tick_fused``)."""

    def __init__(self, params, cfg: transformer.ModelConfig, n_slots: int,
                 page_size: int = 16,
                 n_pages: Optional[int] = None, device=None,
                 pool_bytes: Optional[int] = None, mesh=None,
                 mixed_step: bool = True,
                 prefill_budget: Optional[int] = None,
                 prefix_cache: bool = False):
        from .paged import PagedContinuousBatcher

        self.mesh = mesh
        self._mixed_step = bool(mixed_step)
        self._prefill_budget = (int(prefill_budget)
                                if prefill_budget is not None
                                else 2 * PREFILL_CHUNK)
        if page_size > 0:
            self._batcher = PagedContinuousBatcher(
                params, cfg, n_slots, page_size=page_size, n_pages=n_pages,
                device=device, pool_bytes=pool_bytes, mesh=mesh,
                max_prefill_chunk=PREFILL_CHUNK, prefix_cache=prefix_cache)
        else:
            if n_pages or pool_bytes:
                raise ValueError("n_pages and pool_bytes size a paged pool; "
                                 "pass page_size too")
            if prefix_cache:
                raise ValueError("prefix_cache is a paged-pool feature; "
                                 "pass page_size too")
            self._batcher = ContinuousBatcher(params, cfg, n_slots,
                                              device=device, mesh=mesh)
        self._lock = threading.Lock()
        self._waiting: "collections.deque[_Request]" = collections.deque()
        self._inflight: Dict[int, _Request] = {}      # loop thread only
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
        self._thread.start()
        return self

    def stop(self) -> None:
        self._halt.set()
        self._work.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=30)
        with self._lock:
            pending = list(self._waiting) + list(self._inflight.values())
            self._waiting.clear()
        for req in pending:
            req.sink.put_nowait(None)

    def validate(self, prompt: List[int], max_new_tokens: int,
                 top_k: int = 0, top_p: float = 1.0) -> None:
        """Raise ValueError for a request the batcher could never serve."""
        self._batcher.validate_request(prompt, max_new_tokens)
        self._batcher.validate_sampling(top_k, top_p)

    def submit(self, prompt: List[int], max_new_tokens: int,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None, top_k: int = 0,
               top_p: float = 1.0) -> "queue.Queue":
        """Queue a request; raises ValueError (:meth:`validate`) for one
        the batcher could never serve."""
        self.validate(prompt, max_new_tokens, top_k, top_p)
        req = _Request(list(prompt), int(max_new_tokens), float(temperature),
                       int(seed), eos_id, int(top_k), float(top_p),
                       queue.Queue(maxsize=1), time.perf_counter())
        with self._lock:
            if self.failure is not None:
                raise RuntimeError(f"service loop failed: {self.failure!r}")
            self._waiting.append(req)
            self._work.set()
        return req.sink

    def snapshot(self) -> dict:
        with self._lock:
            queued = len(self._waiting)
        b = self._batcher
        return {"slots": b.n_slots, "active": len(b.slots),
                "prefilling": len(b.prefilling), "queued": queued,
                "rounds": self.rounds, "admitted_whole": self.admitted_whole,
                "admitted_chunked": self.admitted_chunked,
                "prefills": b.prefills,
                "decode_steps": b.decode_steps,
                "prefill_tokens": b.prefill_tokens}

    def storage_info(self) -> dict:
        return self._batcher.storage_info()

    def _admit_waiting(self) -> None:
        """Admit queued requests while slots and storage allow: whole if
        no slot was decoding when the pass began, else by
        ``admit_chunked``.  A refused one goes back to the FRONT of the
        queue."""
        b = self._batcher
        whole = not b.slots
        while b.free_slots():
            with self._lock:
                if not self._waiting:
                    return
                req = self._waiting.popleft()
            kw = dict(temperature=req.temperature, seed=req.seed,
                      eos_id=req.eos_id, top_k=req.top_k, top_p=req.top_p)
            if whole:
                rid = b.admit(req.prompt, req.max_new, **kw)
            else:
                rid = b.admit_chunked(req.prompt, req.max_new,
                                      chunk=PREFILL_CHUNK, **kw)
            if rid is None:                     # storage backpressure
                with self._lock:
                    self._waiting.appendleft(req)
                return
            if whole:
                self.admitted_whole += 1
            else:
                self.admitted_chunked += 1
            self._inflight[rid] = req

    def _deliver(self) -> None:
        b = self._batcher
        for rid in [r for r in b.completed if r in self._inflight]:
            out = b.completed.pop(rid)
            first = b.activated_at.pop(rid)
            req = self._inflight.pop(rid)
            now = time.perf_counter()
            self.timings.append({
                "ttft_s": first - req.submitted,
                "total_s": now - req.submitted,
                "new_tokens": len(out) - len(req.prompt)})
            req.sink.put_nowait(out)

    def _round(self) -> None:
        """One round of the loop (see the class docstring)."""
        b = self._batcher
        if b.prefilling:
            if self._mixed_step:
                b.tick_mixed(DECODE_CHUNK, chunk=PREFILL_CHUNK,
                             budget=self._prefill_budget)
            else:
                b.advance_prefill()
                b.tick_fused(DECODE_CHUNK)
        else:
            b.tick_fused(DECODE_CHUNK)
        self.rounds += 1

    def _loop(self) -> None:
        b = self._batcher
        while not self._halt.is_set():
            if not self._work.wait(timeout=0.5):
                continue
            try:
                self._admit_waiting()
                if b.prefilling or b.slots:
                    self._round()
                self._deliver()
            except Exception as e:     # keep the server answering
                log.exception("service loop failed")
                with self._lock:
                    self.failure = e
                    failed = list(self._waiting) + list(
                        self._inflight.values())
                    self._waiting.clear()
                    self._inflight.clear()
                for req in failed:
                    req.sink.put_nowait(e)
                return
            with self._lock:
                if not self._waiting and not b.slots and not b.prefilling:
                    self._work.clear()
