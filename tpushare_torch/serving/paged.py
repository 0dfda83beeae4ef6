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

Prefill runs through ``forward_paged_prefill`` and each tick through
``forward_paged_decode``; both read the pool through K2 when
``cfg.attn_kernel == "kernel"``.  A windowed prompt longer than its ring
prefills in windows of ``max_prefill_chunk`` tokens through
``forward_paged_prefill_chunk`` (a whole-prompt walk would write a ring
page twice): the ring's chunk margin keeps every page a window writes
older than what its first query may attend.  ``cfg.kv_dtype="int8"``
keeps the pool as int8 ``{"q","s"}`` stores, read through K2's int8
entry point; every byte of the pool is priced by
``ops.quant.kv_cache_bytes``, so a ``pool_bytes`` budget buys about twice
the pages under int8.  The prefix cache waits for a later slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import transformer
from ..ops.attention import tp_degree
from ..ops.quant import kv_cache_bytes
from .continuous import ContinuousBatcher, _sample_next


class PagedContinuousBatcher(ContinuousBatcher):
    """The batcher with its storage hooks on a paged pool.  The pool holds
    ``n_pages`` pages, or as many as ``pool_bytes`` buys (trash pages
    included); by default every slot can hold a full max_seq sequence."""

    def __init__(self, params, cfg: transformer.ModelConfig, n_slots: int,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 device=None, pool_bytes: Optional[int] = None, mesh=None,
                 max_prefill_chunk: int = 64):
        if cfg.max_seq % page_size:
            raise ValueError("max_seq must be a multiple of page_size")
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
                "sp_shards": sp, "pool_bytes_per_shard": pool_bytes // sp}
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

    def _reserve(self, slot: int, prompt_len: int, max_new: int) -> bool:
        n_ranges = -(-(prompt_len + max_new) // self.page_size)
        held = self._held_pages(prompt_len, max_new)
        if self._stripes_short(self._stripe_need(range(held))):
            return False                # page backpressure
        self.page_table[slot, :] = 0
        # page j from stripe j % sp (unstriped: the one list, popped in the
        # JAX batcher's order); range j maps to pages[j % held], which a
        # windowed ring (never striped) recycles for the request's life
        pages = [self._free_by_stripe[j % self.sp_shards].pop()
                 for j in range(held)]
        self.page_table[slot, :n_ranges] = [pages[j % held]
                                             for j in range(n_ranges)]
        self._slot_pages[slot] = pages
        return True

    def _release(self, slot: int) -> None:
        self.page_table[slot, :] = 0
        self._free_pages_return(self._slot_pages.pop(slot, []))

    def _table(self, rows) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)

    def _prefill_into(self, slot: int, prompt: List[int]):
        table = self._table(self.page_table[slot])
        span = len(self._slot_pages[slot]) * self.page_size
        if transformer.wants_rolling(self.cfg) and len(prompt) > span:
            # the prompt outruns its ring: windows of a fixed width
            # (max_prefill_chunk, or what is left of max_seq), each
            # written and attended before the next
            pos = 0
            while pos < len(prompt):
                width = min(self.max_prefill_chunk, self.cfg.max_seq - pos)
                piece = prompt[pos:pos + width]
                tokens = torch.zeros((1, width), dtype=torch.long,
                                     device=self.device)
                tokens[0, :len(piece)] = torch.tensor(piece)
                logits_v, self.pools = transformer.forward_paged_prefill_chunk(
                    self.params, tokens, self.cfg, self.pools, table, pos,
                    len(piece) - 1, mesh=self.mesh)
                pos += len(piece)
                if pos < len(prompt):
                    self.prefills += 1      # admit counts the last one
            return logits_v
        tokens = torch.tensor([prompt], dtype=torch.long, device=self.device)
        logits, self.pools = transformer.forward_paged_prefill(
            self.params, tokens, self.cfg, self.pools, table, len(prompt),
            mesh=self.mesh)
        return logits[0]      # [V]: the prompt's last-position logits

    def _step(self, tokens, lengths, temps, generators, top_ks, top_ps):
        logits, self.pools = transformer.forward_paged_decode(
            self.params, tokens, self.cfg, self.pools,
            self._table(self.page_table), lengths, mesh=self.mesh)
        return _sample_next(logits[:, 0], temps, generators, top_ks, top_ps)
