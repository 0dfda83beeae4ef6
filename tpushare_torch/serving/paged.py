"""Paged-KV continuous batching: block-pooled cache storage for serving.

Counterpart of ``tpushare/serving/paged.py``.  The persistent cache is a
pool of fixed-size pages (:func:`tpushare_torch.models.transformer.
init_paged_kv`) and each admission reserves, worst case, the pages it
will hold at once, so a slot never starves for a page mid-decode:
``ceil((prompt + max_new) / page)`` for a full-causal config, and for a
sliding-window config (window < max_seq) at most a RING of
``ceil(window / page) + ceil(max_prefill_chunk / page) + 1`` pages,
position range j mapped statically to ring page ``j % held``.  Page
allocation is host-side bookkeeping (free lists), touched only at admit
and completion.  Page 0 is the trash page: inactive slots and unowned
table entries write and read it, the position mask keeps it out of every
softmax, and the allocator never hands it out.  On the ring, every read
derives a key's position from its table index (K2 and its plain version
alike), so a page that holds a newer range where an older one is mapped
sits past the query (causal mask) and one holding an older range sits at
least ``held * page`` > window positions back (window mask): neither
enters a softmax.

Position striping: under a mesh with an ``sp`` axis of size > 1 the pool
splits into ``sp`` equal stripes, stripe s owning global pages
``[s*per, (s+1)*per)`` on the mesh's device s with its local page 0
(global ``s*per``) as its trash page, and a sequence's page range j comes
from stripe ``j % sp``: one sequence's pages, and so its context, span
every stripe.  Capacity is checked per stripe.  Full-causal configs only,
as in the JAX package.

Prefill runs through ``forward_paged_prefill`` and each decode step
through ``forward_paged_decode``; both read the pool through K2 when
``cfg.attn_kernel == "kernel"``.  A windowed prompt longer than its ring
prefills in windows of ``max_prefill_chunk`` tokens through
``forward_paged_prefill_chunk`` (a whole-prompt walk would write a ring
page twice): the ring's chunk margin keeps every page a window writes
older than what its first query may attend.  ``cfg.kv_dtype="int8"``
keeps the pool as int8 ``{"q","s"}`` stores, read through K2's int8
entry point; every byte of the pool is priced by
``ops.quant.kv_cache_bytes``, so a ``pool_bytes`` budget buys about twice
the pages under int8.

The rounds of the base class run on the pool: ``admit_chunked`` streams a
prompt in page-multiple windows (``forward_paged_prefill_chunk``),
``tick_fused`` runs n decode steps over one page table fixed for the
round (a reservation is worst case, so no slot needs a page mid-round),
and ``tick_mixed`` runs the pending windows of several slots as one
``forward_paged_prefill_batch`` (K2's S > 1 arm once a layer for all
rows; a padded row rides an all-zero table onto the trash page) before
the fused steps.  A prefix cache (``prefix_cache=True``, full causal)
maps a registered prompt head's pages into later requests, which
prefill only past it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import transformer
from ..ops.attention import tp_degree
from ..ops.quant import kv_cache_bytes
from .continuous import ContinuousBatcher


@dataclasses.dataclass
class _CachedPrefix:
    """A registered prompt prefix whose K/V pages live in the pool.

    ``pages`` belong to the REGISTRY, not to a slot: admitted requests map
    them read-only into their page tables and bump ``active``; nothing
    writes a registered page (every prefill, decode and garbage write of
    a mapping slot starts at or past the shared region).  Evictable only
    at ``active == 0``."""

    tokens: tuple          # the full-page prefix, exactly
    pages: list            # physical pages, in position order
    active: int = 0        # slots currently mapping these pages
    last_used: float = 0.0


class PagedContinuousBatcher(ContinuousBatcher):
    """The batcher with its storage hooks on a paged pool.  The pool holds
    ``n_pages`` pages, or as many as ``pool_bytes`` buys (trash pages
    included); by default every slot can hold a full max_seq sequence.

    ``prefix_cache`` (full-causal configs only): a completed request
    donates its prompt's whole pages to a registry, and a later request
    whose prompt starts with a registered prefix maps those pages into
    its table and prefills only the rest.  Exact: a position's K/V
    depends only on its causal prefix.  The registry holds at most two
    slots' worth of pages, evicted least recently used at zero active."""

    def __init__(self, params, cfg: transformer.ModelConfig, n_slots: int,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 device=None, pool_bytes: Optional[int] = None, mesh=None,
                 max_prefill_chunk: int = 64, prefix_cache: bool = False):
        if cfg.max_seq % page_size:
            raise ValueError("max_seq must be a multiple of page_size")
        if prefix_cache and transformer.wants_rolling(cfg):
            raise ValueError("prefix_cache requires a full-causal config "
                             "(the windowed page ring recycles pages)")
        self.sp_shards = sp = tp_degree(mesh, "sp")
        if sp > 1 and transformer.wants_rolling(cfg):
            raise ValueError("position striping (sp mesh axis) requires a "
                             "full-causal config: the windowed page ring "
                             "recycles pages in place")
        if pool_bytes is not None:
            if n_pages is not None:
                raise ValueError("pass n_pages or pool_bytes, not both")
            # a byte budget rounds DOWN to equal stripes (never past it)
            n_pages = int(pool_bytes) // kv_cache_bytes(cfg, page_size)
            n_pages = n_pages // sp * sp
        self.page_size = page_size
        self.pages_per_slot = cfg.max_seq // page_size
        # the longest prefill window, a page multiple of at least a page;
        # it sizes the windowed page ring's margin
        self.max_prefill_chunk = max(
            page_size, -(-max_prefill_chunk // page_size) * page_size)
        self.prefix_cache_enabled = bool(prefix_cache)
        self._prefixes: Dict[tuple, _CachedPrefix] = {}
        self._slot_prefix: Dict[int, tuple] = {}   # slot -> registry key
        self._slot_shared: Dict[int, int] = {}     # slot -> shared tokens
        #: the registry's budget: at most this many pages parked on
        #: cached prefixes
        self.max_cached_pages = 2 * self.pages_per_slot
        # default: every slot can hold a full max_seq sequence, + a trash
        # page per stripe; an explicit count rounds UP to equal stripes
        self.n_pages = (n_pages if n_pages is not None
                        else n_slots * self.pages_per_slot + sp)
        self.n_pages = -(-self.n_pages // sp) * sp
        if sp > 1 and self.n_pages < 2 * sp:
            raise ValueError("need at least one non-trash page per "
                             "position stripe")
        if self.n_pages < 2:
            raise ValueError("need at least one non-trash page")
        super().__init__(params, cfg, n_slots, device=device, mesh=mesh)

    def _held_pages(self, prompt_len: int, max_new: int) -> int:
        """The pages a request holds at once: every page of its sequence
        (full causal), or at most the windowed page ring."""
        n_ranges = -(-(prompt_len + max_new) // self.page_size)
        if transformer.wants_rolling(self.cfg):
            return min(n_ranges, self._ring_held_pages())
        return n_ranges

    def _ring_held_pages(self) -> int:
        """The windowed page ring: the window's pages plus one whole
        prefill chunk's plus one.  A chunk writes all its pages before its
        attention runs, so a write at position p evicts p - held * page,
        which the chunk margin keeps older than the window behind the
        chunk's first query; a decode step writes one position."""
        w_pages = -(-self.cfg.window // self.page_size)
        c_pages = -(-self.max_prefill_chunk // self.page_size)
        return w_pages + c_pages + 1

    def validate_request(self, prompt: List[int],
                         max_new_tokens: int) -> None:
        super().validate_request(prompt, max_new_tokens)
        need = self._held_pages(len(prompt), max_new_tokens)
        sp = self.sp_shards
        if sp > 1:
            # range j draws from stripe j % sp, each holding n_pages/sp - 1
            # usable pages; stripe 0 carries the ceil
            usable = self.n_pages // sp - 1
            worst = -(-need // sp)
            if worst > usable:
                raise ValueError(
                    f"request needs {worst} pages on a position stripe "
                    f"but each of the {sp} stripes holds only {usable} "
                    f"usable pages")
            return
        if need > self.n_pages - 1:     # page 0 is never allocatable
            raise ValueError(
                f"request needs {need} pages but the pool holds only "
                f"{self.n_pages - 1} usable pages")

    def _mixed_chunk_len(self, chunk: int) -> int:
        """The prefill window of chunked admission and of the mixed round:
        rounded UP to a page multiple (paged writes are whole pages, so
        ``pos`` stays a page multiple, and so does the max_seq clamp) and,
        on a windowed ring, clamped to ``max_prefill_chunk``, the chunk
        its margin is sized for."""
        c = -(-max(1, chunk) // self.page_size) * self.page_size
        if transformer.wants_rolling(self.cfg):
            c = min(c, self.max_prefill_chunk)
        return max(self.page_size, c)

    def storage_info(self) -> dict:
        cfg = self.cfg
        bytes_per_page = kv_cache_bytes(cfg, self.page_size)
        pool_bytes = bytes_per_page * self.n_pages
        sp = self.sp_shards
        info = {"kind": "paged", "kv_dtype": cfg.kv_dtype,
                "attn_kernel": cfg.attn_kernel,
                "page_tokens": self.page_size,
                "bytes_per_page": bytes_per_page, "n_pages": self.n_pages,
                "free_pages": self.free_page_count(),
                "pool_bytes": pool_bytes,
                # the stripes one sequence's pages span, and what each
                # stripe's device holds
                "sp_shards": sp, "pool_bytes_per_shard": pool_bytes // sp,
                # the prefix registry: its prefixes, the pages they hold
                # (out of every slot's reach until evicted) and its budget
                "prefix_cache": self.prefix_cache_enabled,
                "cached_prefixes": len(self._prefixes),
                "cached_pages": self._cached_pages(),
                "max_cached_pages": self.max_cached_pages}
        if sp > 1:
            # the f32 (out, m, l) partials each stripe hands the merge per
            # layer of a decode step, counted as the JAX package counts
            # them (one query row per slot and kv head)
            info["sp_merge_transient_bytes"] = (
                self.n_slots * cfg.n_kv_heads * (cfg.head_dim + 2) * 4)
        return info

    # -- storage hooks -------------------------------------------------
    def _init_storage(self) -> None:
        self.pools = transformer.init_paged_kv(
            self.cfg, self.n_pages, self.page_size, device=self.device,
            mesh=self.mesh)
        self.page_table = np.zeros((self.n_slots, self.pages_per_slot),
                                   np.int32)
        # one free list per stripe (one list, page 0 the trash page,
        # unstriped); stripe s never hands out its trash page s*per
        per = self.n_pages // self.sp_shards
        self._pages_per_stripe = per
        self._free_by_stripe: List[List[int]] = [
            list(range(s * per + 1, (s + 1) * per))
            for s in range(self.sp_shards)]
        self._slot_pages: Dict[int, List[int]] = {}

    def _stripe_of_page(self, p: int) -> int:
        return int(p) // self._pages_per_stripe

    def _free_pages_return(self, pages) -> None:
        for p in pages:
            self._free_by_stripe[self._stripe_of_page(p)].append(int(p))

    def free_page_count(self) -> int:
        return sum(len(s) for s in self._free_by_stripe)

    def _stripe_need(self, ranges) -> List[int]:
        need = [0] * self.sp_shards
        for j in ranges:
            need[j % self.sp_shards] += 1
        return need

    def _stripes_short(self, need: List[int]) -> bool:
        return any(n > len(self._free_by_stripe[s])
                   for s, n in enumerate(need))

    # -- the prefix registry -------------------------------------------
    def _cached_pages(self) -> int:
        return sum(len(e.pages) for e in self._prefixes.values())

    def _lookup_prefix(self, prompt) -> Optional[_CachedPrefix]:
        """The longest registered prefix this prompt starts with, capped
        one token short of it (admission must still prefill a position to
        produce the first logits)."""
        if not self.prefix_cache_enabled or prompt is None:
            return None
        usable = (len(prompt) - 1) // self.page_size * self.page_size
        best = None
        for entry in self._prefixes.values():
            n = len(entry.tokens)
            if (n <= usable and tuple(prompt[:n]) == entry.tokens
                    and (best is None or n > len(best.tokens))):
                best = entry
        return best

    def _evict_prefixes(self, need, registry_room: int = 0) -> None:
        """Free least-recently-used zero-active prefixes until the stripes
        hold ``need`` free pages (a count a stripe) and ``registry_room``
        more cached pages fit the budget, or nothing idle is left.  A
        matched prefix bumps ``active`` before this runs, so it is never
        its own victim."""
        def over():
            return (self._stripes_short(need) or self._cached_pages()
                    + registry_room > self.max_cached_pages)

        while over():
            idle = [e for e in self._prefixes.values() if e.active == 0]
            if not idle:
                return
            victim = min(idle, key=lambda e: e.last_used)
            del self._prefixes[victim.tokens]
            self._free_pages_return(victim.pages)

    def _reserve(self, slot: int, prompt_len: int, max_new: int,
                 prompt: Optional[List[int]] = None) -> bool:
        n_ranges = -(-(prompt_len + max_new) // self.page_size)
        held = self._held_pages(prompt_len, max_new)
        shared = (self._lookup_prefix(prompt) if held == n_ranges
                  else None)
        n_shared = len(shared.pages) if shared is not None else 0
        if shared is not None:
            # claimed BEFORE any eviction: it must not be its own victim
            shared.active += 1
            shared.last_used = time.monotonic()
        # range j draws from stripe j % sp (one list unstriped); a
        # windowed ring (never striped) holds `held` pages for every range
        own = (range(n_shared, n_ranges) if held == n_ranges
               else range(held))
        need = self._stripe_need(own)
        if self._stripes_short(need):
            self._evict_prefixes(need)
        if self._stripes_short(need):
            if shared is not None:
                shared.active -= 1      # the claim rolled back
            return False                # page backpressure
        self.page_table[slot, :] = 0
        # popped in the JAX batcher's order
        pages = [self._free_by_stripe[j % self.sp_shards].pop()
                 for j in own]
        if held == n_ranges:
            # full causal: range j on its own page; a cached prefix's
            # registry pages map read-only over the shared head
            self.page_table[slot, n_shared:n_ranges] = pages
            if shared is not None:
                self.page_table[slot, :n_shared] = shared.pages
                self._slot_prefix[slot] = shared.tokens
                self._slot_shared[slot] = n_shared * self.page_size
        else:
            # the windowed ring: range j on pages[j % held] for the
            # request's life
            self.page_table[slot, :n_ranges] = [pages[j % held]
                                                 for j in range(n_ranges)]
        self._slot_pages[slot] = pages
        return True

    def _prefill_start(self, slot: int) -> int:
        return self._slot_shared.get(slot, 0)

    def _release(self, slot: int) -> None:
        key = self._slot_prefix.pop(slot, None)
        self._slot_shared.pop(slot, None)
        if key is not None:
            entry = self._prefixes.get(key)
            if entry is not None:
                entry.active -= 1
                entry.last_used = time.monotonic()
        elif self.prefix_cache_enabled:
            self._maybe_register(slot)
        self.page_table[slot, :] = 0
        self._free_pages_return(self._slot_pages.pop(slot, []))

    def _maybe_register(self, slot: int) -> None:
        """Donate a finished request's pure-prompt whole pages to the
        registry instead of freeing them.  Only a decoding slot donates
        (a mid-prefill slot's pages are part garbage), only a prefix not
        yet registered, and only pages holding nothing but prompt
        positions (the page holding ``prompt_len`` has decode writes).
        A slot that mapped a cached prefix only lets go of it."""
        s = self.slots.get(slot)
        if s is None or s.prompt_len <= 1:
            return
        k_pure = s.prompt_len // self.page_size
        if k_pure < 1:
            return
        tokens = tuple(s.output[:k_pure * self.page_size])
        if tokens in self._prefixes:
            return
        self._evict_prefixes([0] * self.sp_shards, registry_room=k_pure)
        if self._cached_pages() + k_pure > self.max_cached_pages:
            return                      # nothing idle to evict
        donated = [int(p) for p in self.page_table[slot, :k_pure]]
        own = self._slot_pages.get(slot, [])
        if 0 in donated or len(own) < k_pure:
            return                      # never donate the trash page
        self._prefixes[tokens] = _CachedPrefix(
            tokens=tokens, pages=donated, last_used=time.monotonic())
        gone = set(donated)
        self._slot_pages[slot] = [p for p in own if p not in gone]

    def _table(self, rows) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)

    def _prefill_into(self, slot: int, prompt: List[int]):
        table = self._table(self.page_table[slot])
        span = len(self._slot_pages[slot]) * self.page_size
        start = self._prefill_start(slot)
        if start or (transformer.wants_rolling(self.cfg)
                     and len(prompt) > span):
            # the chunk body from `start`.  Past a cached prefix (a
            # whole-prompt walk would rewrite the registry's pages): the
            # rest as ONE window rounded up to whole pages, its padded
            # tail inside the reservation.  A prompt that outruns its
            # windowed ring (never cached): windows of a fixed width
            # (max_prefill_chunk, or what is left of max_seq), each
            # written and attended before the next
            pos = start
            while pos < len(prompt):
                width = (-(-(len(prompt) - pos) // self.page_size)
                         * self.page_size if start else
                         min(self.max_prefill_chunk, self.cfg.max_seq - pos))
                piece = prompt[pos:pos + width]
                tokens = torch.zeros((1, width), dtype=torch.long,
                                     device=self.device)
                tokens[0, :len(piece)] = torch.tensor(piece)
                logits_v = self._prefill_chunk_into(slot, tokens, pos,
                                                    len(piece) - 1)
                pos += len(piece)
                if pos < len(prompt):
                    self.prefills += 1      # admit counts the last one
            return logits_v
        tokens = torch.tensor([prompt], dtype=torch.long, device=self.device)
        logits, self.pools = transformer.forward_paged_prefill(
            self.params, tokens, self.cfg, self.pools, table, len(prompt),
            mesh=self.mesh)
        return logits[0]      # [V]: the prompt's last-position logits

    def _round_operand(self, lengths, n_steps: int):
        """The page table on the device, copied once a round and fixed
        for it (a reservation is worst case at admission, so no slot
        needs a new page mid-round)."""
        return self._table(self.page_table)

    def _decode_logits(self, tokens, lengths, table):
        logits, self.pools = transformer.forward_paged_decode(
            self.params, tokens, self.cfg, self.pools, table, lengths,
            mesh=self.mesh)
        return logits[:, 0]

    def _prefill_chunk_into(self, slot: int, padded_tokens, pos: int,
                            last_idx: int):
        logits_v, self.pools = transformer.forward_paged_prefill_chunk(
            self.params, padded_tokens, self.cfg, self.pools,
            self._table(self.page_table[slot]), pos, last_idx,
            mesh=self.mesh)
        return logits_v

    def _prefill_tables(self, p_slots, p_active) -> np.ndarray:
        """The page-table rows of a prefill block: a live row its slot's,
        a padded row all zeros (every write on the masked trash page)."""
        tables = np.zeros((len(p_slots), self.pages_per_slot), np.int32)
        for r in np.flatnonzero(p_active):
            tables[r] = self.page_table[p_slots[r]]
        return tables

    def _prefill_block(self, block) -> torch.Tensor:
        """The prefill half of a mixed round: the block's rows through
        ``forward_paged_prefill_batch``; returns the chunk-final logits
        [R, V]."""
        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        tables = self._prefill_tables(block["p_slots"], block["p_active"])
        logits, self.pools = transformer.forward_paged_prefill_batch(
            self.params, t(block["p_tokens"]).long(), self.cfg, self.pools,
            self._table(tables), t(block["p_pos"]), t(block["p_last"]),
            mesh=self.mesh)
        return logits

