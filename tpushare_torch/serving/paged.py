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

Tensor parallelism: under a mesh with a ``tp`` axis the pool splits its
kv heads over the tp shards as well (``[L, n_pages / sp, Hkv / tp, page,
D]`` a shard, ``transformer.init_paged_kv``); page ids, the tables and
the allocator are the same for every tp shard, and every forward reads
each shard's stores from that shard (the base class lays out the params
and the adapter pool).

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

Speculation (``tick_spec``, ``tick_mixed_spec``) verifies each round's
``[B, 1+k]`` blocks through ``forward_paged_verify`` over the round's
table (K2's S > 1 arm once a layer for all rows): the block's writes land
per position through the row's own pages, a rejected tail past the
committed length (masked until rewritten) or past the reservation (on the
trash page), never on a registered prefix page, which holds only
positions before the prompt's end.  Every storage verifies any ``k`` but
the windowed page ring, whose margin past the window must cover it.

Session migration (:meth:`PagedContinuousBatcher.export_session`,
``pop_session``, ``import_session``) moves a decoding session between
pools as one blob of :mod:`tpushare_torch.serving.migrate`'s wire format:
the pages holding committed positions, the table's structure (range ->
the blob's local page) and the slot state.  A blob's arrays are the
pool's leaves at the session's pages, ``[L, n, Hkv, page, D]`` a leaf
(an int8 store ships ``k.q``/``k.s``), the JAX pool's layout, so a blob
crosses between the two packages.  A blob carries no striping and no
head split: export gathers every tp shard's kv heads back into the whole
leaf, and import places every page on the stripe its range asks for and
each tp shard's block of the heads on that shard, so a session moves
between pools of different striping and tp degrees.  A blob names the
session's LoRA adapter, which the receiver re-acquires into its own
adapter pool by name; the prefix registry keys a prefix donated under an
adapter by the adapter's name, so only that adapter reuses it.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import transformer
from ..ops.attention import tp_degree
from ..ops.quant import kv_cache_bytes
from . import metrics, migrate
from .continuous import ContinuousBatcher, _Slot


def _store_arrays(prefix: str, store) -> list:
    """(name, leaf) pairs of one K or V store under the wire's naming: a
    plain store is one ``k``/``v`` array, an int8 store ships its values
    and scales as ``k.q``/``k.s`` (etc.)."""
    if isinstance(store, dict):
        return [(f"{prefix}.q", store["q"]), (f"{prefix}.s", store["s"])]
    return [(prefix, store)]


def _key_data(state: torch.Tensor) -> List[int]:
    """Two uint32 words drawn deterministically from a generator's state:
    the ``key_data`` a JAX receiver wraps as its threefry key."""
    digest = hashlib.sha256(state.numpy().tobytes()).digest()
    return [int.from_bytes(digest[i:i + 4], "big") for i in (0, 4)]


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
    #: the LoRA adapter the donor ran with (None = base): its pages hold
    #: that adapter's K/V, so only requests of the same adapter reuse them
    adapter: Optional[str] = None


class PagedContinuousBatcher(ContinuousBatcher):
    """The batcher with its storage hooks on a paged pool.  The pool holds
    ``n_pages`` pages, or as many as ``pool_bytes`` buys (trash pages
    included); by default every slot can hold a full max_seq sequence.

    ``prefix_cache`` (full-causal configs only): a completed request
    donates its prompt's whole pages to a registry, and a later request
    whose prompt starts with a registered prefix maps those pages into
    its table and prefills only the rest.  Exact: a position's K/V
    depends only on its causal prefix.  The registry holds at most two
    slots' worth of pages, evicted least recently used at zero active.

    ``spec_k``: the speculation depth the pool is provisioned for, as in
    the reference.  A page table verifies a block of any depth, so it
    only prices the striped merge (:meth:`storage_info`: a verify read's
    ``n_rep * (1 + spec_k)`` query rows a kv head); the depth a round
    runs is ``tick_spec``'s ``k``, gated by :meth:`spec_fallback_reason`
    (the windowed page ring's margin).

    ``adapter_slots``, ``adapter_rank``, ``adapter_loader``: the
    multi-adapter pool of the base class; a prefix donated under an
    adapter is reused only under that adapter, and a session blob names
    its adapter, which the receiver re-acquires into its own pool."""

    def __init__(self, params, cfg: transformer.ModelConfig, n_slots: int,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 device=None, pool_bytes: Optional[int] = None, mesh=None,
                 max_prefill_chunk: int = 64, prefix_cache: bool = False,
                 spec_k: int = 0, adapter_slots: int = 0,
                 adapter_rank: int = 8, adapter_loader=None):
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
        # no dense rows: a windowed config's pages form the ring instead
        super().__init__(params, cfg, n_slots, device=device, mesh=mesh,
                         rolling_slots=False, spec_k=spec_k,
                         adapter_slots=adapter_slots,
                         adapter_rank=adapter_rank,
                         adapter_loader=adapter_loader)

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

    def spec_fallback_reason(self, k: int) -> Optional[str]:
        """A paged pool verifies k-token blocks without reserving more (a
        rejected tail lands past the committed length on the slot's own
        pages, or past its reservation on the trash page), but for the
        windowed page ring, whose verify writes recycle ring pages in
        place: its margin past the window (:meth:`_ring_held_pages`
        pages, less the window) must cover ``k``, so that a write at q
        evicts only a position at or before q - window."""
        if transformer.wants_rolling(self.cfg):
            margin = (self._ring_held_pages() * self.page_size
                      - self.cfg.window)
            if k > margin:
                return "ring_margin"
        return None

    def _spec_needs_headroom(self) -> bool:
        """Never: the table walk sends a write past its end to the trash
        page (``forward_paged_verify``)."""
        return False

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
                "max_cached_pages": self.max_cached_pages,
                "spec_k": self.spec_k, **self._adapter_storage(),
                **self._expert_storage_info()}
        if sp > 1:
            # the f32 (out, m, l) partials each stripe hands the merge per
            # layer of a step, counted as the JAX package counts them:
            # one query row per slot and kv head, a verify read's
            # n_rep * (1 + spec_k) once provisioned for speculation
            rows = ((cfg.n_heads // cfg.n_kv_heads) * (1 + self.spec_k)
                    if self.spec_k else 1)
            info["sp_merge_transient_bytes"] = (
                self.n_slots * cfg.n_kv_heads * rows * (cfg.head_dim + 2)
                * 4)
        return info

    # -- session migration (export / pop / import) ---------------------
    def can_migrate(self) -> bool:
        return True

    def _leaves(self, which: int, prefix: str) -> list:
        """[(wire name, [[that leaf of every tp shard] for every stripe])]
        of the K (0) or V (1) stores (one stripe unstriped, one tp shard
        without tp: a tp shard holds a block of the kv heads, dim 2)."""
        pairs = transformer._pool_stripes(self.pools)
        sp = self.sp_shards
        tp = len(pairs) // sp
        named = [_store_arrays(prefix, pair[which]) for pair in pairs]
        return [(name, [[named[t * sp + s][i][1] for t in range(tp)]
                        for s in range(sp)])
                for i, (name, _) in enumerate(named[0])]

    def _by_stripe(self, pages: List[int]) -> list:
        """Global page ids -> [(stripe, positions in ``pages``, local
        ids)] for each stripe that holds any of them."""
        per = self._pages_per_stripe
        out = []
        for s in range(self.sp_shards):
            pos = [i for i, p in enumerate(pages) if int(p) // per == s]
            if pos:
                out.append((s, pos, [int(pages[i]) % per for i in pos]))
        return out

    @torch.inference_mode()
    def _gather_pages(self, pages: List[int]) -> Dict[str, torch.Tensor]:
        """The wire arrays of ``pages`` (global ids, in blob order): each
        leaf's ``[L, len(pages), ...]`` on the host, every page read from
        its own stripe."""
        parts = self._by_stripe(pages)
        arrays = {}

        def heads(shards, ids):
            # every tp shard's block of the kv heads, whole again
            got = [x.index_select(1, torch.tensor(ids, device=x.device))
                   .cpu() for x in shards]
            return got[0] if len(got) == 1 else torch.cat(got, dim=2)

        for which, prefix in ((0, "k"), (1, "v")):
            for name, leaves in self._leaves(which, prefix):
                got = [(pos, heads(leaves[s], ids)) for s, pos, ids in parts]
                if len(got) == 1:       # one stripe holds every page
                    arrays[name] = got[0][1]
                    continue
                shape = got[0][1].shape
                out = torch.empty((shape[0], len(pages)) + tuple(shape[2:]),
                                  dtype=got[0][1].dtype)
                for pos, part in got:
                    out[:, pos] = part
                arrays[name] = out
        return arrays

    @torch.inference_mode()
    def _scatter_pages(self, pages: List[int],
                       arrays: Dict[str, torch.Tensor]) -> None:
        """Write the wire arrays into the pool pages ``pages`` (global
        ids, in blob order), each page on its own stripe, cast to the
        pool's dtype as the reference's scatter casts.  Every array is
        checked against the pool's layout before any page is written;
        a mismatch raises :class:`~.migrate.BlobError`."""
        plan = []
        for which, prefix in ((0, "k"), (1, "v")):
            for name, leaves in self._leaves(which, prefix):
                blk = arrays.get(name)
                shape = leaves[0][0].shape
                want = (shape[0], len(pages),
                        shape[2] * len(leaves[0])) + tuple(shape[3:])
                if blk is None or tuple(blk.shape) != want:
                    raise migrate.BlobError(
                        f"blob array {name!r} of shape "
                        f"{None if blk is None else tuple(blk.shape)} does "
                        f"not match the pool's {want}")
                plan.append((leaves, blk))
        parts = self._by_stripe(pages)
        for leaves, blk in plan:
            for s, pos, ids in parts:
                part = blk if len(pos) == len(pages) else blk[:, pos]
                for t, leaf in enumerate(leaves[s]):
                    h = leaf.shape[2]   # tp shard t's block of the heads
                    leaf.index_copy_(
                        1, torch.tensor(ids, device=leaf.device),
                        part[:, :, t * h:(t + 1) * h].to(device=leaf.device,
                                                         dtype=leaf.dtype))

    def export_session(self, rid: int) -> bytes:
        """Serialize DECODING request ``rid`` into one migration blob: the
        distinct pages its table references (content only for pages
        holding a COMMITTED position; a page reserved past the write
        frontier is overwritten before it is attendable, so its bytes
        never travel), the table's structure (range -> the blob's local
        page, which rebuilds full-causal, ring and prefix-mapped layouts
        alike) and the slot state.  The random state travels twice: as
        ``key_data`` (two uint32 words drawn from the generator's state,
        what a JAX receiver wraps as its key) and as the generator's own
        state under ``torch_rng``, which a torch receiver on the same
        device type resumes exactly.  Read-only: the slot serves on until
        :meth:`pop_session`.  Raises ``KeyError`` for an unknown rid and
        ``ValueError`` for a mid-prefill one (its pages are part
        garbage)."""
        slot = self._slot_of(rid)
        s = self.slots[slot]
        row = self.page_table[slot]
        page = self.page_size
        ids: List[int] = []
        local: Dict[int, int] = {}
        ranges: List[int] = []
        content = set()
        for j in range(int(np.count_nonzero(row))):
            p = int(row[j])
            if p not in local:
                local[p] = len(ids)
                ids.append(p)
            ranges.append(local[p])
            if j * page < s.length:
                content.add(local[p])
        content_idx = sorted(content)
        arrays = self._gather_pages([ids[i] for i in content_idx])
        key_data = rng = None
        if s.generator is not None:
            state = s.generator.get_state()
            key_data = _key_data(state)
            rng = {"device": s.generator.device.type,
                   "state": base64.b64encode(
                       state.numpy().tobytes()).decode("ascii")}
        meta = {
            "fingerprint": migrate.config_fingerprint(self.cfg,
                                                      self.page_size),
            # fleet trace propagation is not ported: the session goes
            # untraced, as an old sender's would
            "trace": None,
            "n_pages": len(ids),
            "content_pages": content_idx,
            "ranges": ranges,
            "slot": {
                "length": int(s.length),
                "remaining": int(s.remaining),
                "last_token": int(s.last_token),
                "output": [int(t) for t in s.output],
                "prompt_len": int(s.prompt_len),
                "temperature": float(s.temperature),
                "eos_id": (int(s.eos_id) if s.eos_id is not None
                           else None),
                "top_k": int(s.top_k),
                "top_p": float(s.top_p),
                "key_data": key_data,
                # the port's own: a JAX receiver reads named keys only
                "torch_rng": rng,
                # the adapter travels by NAME (pool rows are local); the
                # receiver re-acquires it into its own pool
                "adapter": self._adapter_name_of(slot),
            },
        }
        blob = migrate.pack_session(meta, arrays)
        metrics.MIGRATION_BYTES.inc(len(blob), direction="out")
        return blob

    def _slot_of(self, rid: int) -> int:
        for i, s in self.slots.items():
            if s.request_id == rid:
                return i
        for p in self.prefilling.values():
            if p.request_id == rid:
                raise ValueError(f"request {rid} is mid-prefill; "
                                 f"sessions migrate at/after activation")
        raise KeyError(f"no decoding request {rid}")

    def pop_session(self, rid: int) -> None:
        """Release request ``rid``'s slot and pages WITHOUT completing or
        cancelling it: the sender's end of a migration (the stream lives
        on in the exported blob; the caller delivers its result)."""
        slot = self._slot_of(rid)
        self._req_acct.pop(rid, None)
        self._release(slot)
        del self.slots[slot]

    def _generator_of(self, st: dict) -> Optional[torch.Generator]:
        """The imported slot's generator: the sender's own state when it
        is a torch generator of this device type, else one seeded from
        ``key_data`` (a JAX sender's key); None for a greedy slot."""
        rng, key = st.get("torch_rng"), st.get("key_data")
        if rng is None and key is None:
            return None
        gen = torch.Generator(device=self.device)
        if isinstance(rng, dict) and rng.get("device") == self.device.type:
            gen.set_state(torch.frombuffer(
                bytearray(base64.b64decode(rng["state"], validate=True)),
                dtype=torch.uint8))
            return gen
        if key is None:
            raise ValueError("a sampled slot without key_data")
        k0, k1 = (int(w) & 0xFFFFFFFF for w in key)
        return gen.manual_seed((k0 << 32) | k1)

    def import_session(self, blob: bytes,
                       rid: Optional[int] = None) -> Optional[int]:
        """Scatter a migration blob into free pages and resume the session
        as a DECODING slot; returns its request id, or None on capacity
        backpressure (no free slot, or the pool cannot fit it: the
        ``pool_full`` refusal).  Raises :class:`~.migrate.BlobError` or
        :class:`~.migrate.ConfigMismatch` for a blob that can never import
        here; nothing changes then.  ``rid`` pins the request id (the
        spill tier restores under the original id); by default a fresh
        one."""
        meta, arrays = migrate.unpack_session(blob)
        fp = migrate.config_fingerprint(self.cfg, self.page_size)
        if meta.get("fingerprint") != fp:
            raise migrate.ConfigMismatch(
                f"blob fingerprint {meta.get('fingerprint')} != "
                f"receiver {fp}")
        # every field checked BEFORE any state changes: a malformed but
        # parsable header is the bad_blob refusal, never an escaping error
        try:
            need = int(meta["n_pages"])
            ranges = [int(li) for li in meta["ranges"]]
            content_idx = [int(i) for i in meta["content_pages"]]
            st = dict(meta["slot"])
            st_ints = {k: int(st[k]) for k in
                       ("length", "remaining", "last_token",
                        "prompt_len", "top_k")}
            st_out = [int(t) for t in st["output"]]
            st_temp = float(st["temperature"])
            st_top_p = float(st["top_p"])
            st_eos = (int(st["eos_id"]) if st.get("eos_id") is not None
                      else None)
            gen = self._generator_of(st)
            if not (1 <= need <= len(ranges) <= self.pages_per_slot):
                raise ValueError(f"{need} pages over {len(ranges)} "
                                 f"ranges does not fit the table")
            if any(li < 0 or li >= need for li in ranges) or \
                    any(i < 0 or i >= need for i in content_idx):
                raise ValueError("range/content index out of bounds")
        except (KeyError, TypeError, ValueError, RuntimeError) as e:
            raise migrate.BlobError(
                f"malformed session meta: {e}") from None
        ad_name = st.get("adapter")
        if ad_name is not None and not isinstance(ad_name, str):
            raise migrate.BlobError("session adapter must be a string")
        if ad_name and self.adapter_pool is None:
            # it could never decode correctly here
            raise migrate.ConfigMismatch(
                f"session rides adapter {ad_name!r} but the receiver has "
                f"no adapter pool")
        # each blob page goes to the stripe its ranges ask for; one page
        # at ranges on different stripes (only a ring makes multi-range
        # pages, and rings are never striped) cannot be placed
        stripe_of_local: Dict[int, int] = {}
        for j, li in enumerate(ranges):
            s = j % self.sp_shards
            if stripe_of_local.setdefault(li, s) != s:
                raise migrate.BlobError(
                    "session blob maps one page at ranges on different "
                    "position stripes; it cannot import into this "
                    "striped pool")
        need_by_stripe = [0] * self.sp_shards
        for li in range(need):
            need_by_stripe[stripe_of_local.get(li, 0)] += 1
        free = self.free_slots()
        if not free:
            return None
        # the session's adapter re-acquired into THIS pool by name; a full
        # pool is capacity backpressure like pages and slots (pool_full)
        aidx = self._acquire_adapter(ad_name or None)
        if aidx is None:
            return None
        slot = free[0]
        self._map_adapter(slot, aidx)
        if self._stripes_short(need_by_stripe):
            self._evict_prefixes(need_by_stripe)
        if self._stripes_short(need_by_stripe):
            self._release_adapter(slot)           # the pin rolled back
            return None
        pages = [self._free_by_stripe[stripe_of_local.get(li, 0)].pop()
                 for li in range(need)]
        try:
            self._scatter_pages([pages[i] for i in content_idx], arrays)
        except migrate.BlobError:
            self._free_pages_return(pages)
            self._release_adapter(slot)
            raise
        self.page_table[slot, :] = 0
        for j, li in enumerate(ranges):
            self.page_table[slot, j] = pages[li]
        self._slot_pages[slot] = pages
        self._update_page_gauges()
        if rid is None:
            rid = self._next_id
            self._next_id += 1
        else:
            self._next_id = max(self._next_id, rid + 1)
        self.slots[slot] = _Slot(
            request_id=rid, length=st_ints["length"],
            remaining=st_ints["remaining"],
            last_token=st_ints["last_token"], output=st_out,
            prompt_len=st_ints["prompt_len"], temperature=st_temp,
            generator=gen, eos_id=st_eos, top_k=st_ints["top_k"],
            top_p=st_top_p)
        # a restored session keeps its activation time; an imported one
        # activates here
        self.activated_at.setdefault(rid, time.perf_counter())
        self._acct_open(rid, st_ints["prompt_len"])
        metrics.MIGRATION_BYTES.inc(len(blob), direction="in")
        return rid

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
        self._update_page_gauges()

    def _stripe_of_page(self, p: int) -> int:
        return int(p) // self._pages_per_stripe

    def _free_pages_return(self, pages) -> None:
        for p in pages:
            self._free_by_stripe[self._stripe_of_page(p)].append(int(p))

    def free_page_count(self) -> int:
        return sum(len(s) for s in self._free_by_stripe)

    def _update_page_gauges(self) -> None:
        """The pool's pages for /metrics, as the reference counts them:
        the trash pages (one a stripe) are never allocatable, so used +
        free == n_pages - sp_shards; a cached prefix's pages are used."""
        free = self.free_page_count()
        metrics.KV_PAGES_FREE.set(free)
        metrics.KV_PAGES_USED.set(self.n_pages - self.sp_shards - free)

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

    @staticmethod
    def _registry_key(adapter: Optional[str], tokens: tuple):
        """A prefix's registry key: the token tuple for a base request (the
        pool-less registry's key), namespaced by the adapter's name
        otherwise: the same tokens under two adapters are different
        K/V."""
        return tokens if adapter is None else (adapter, tokens)

    def _lookup_prefix(self, prompt, adapter: Optional[str] = None
                       ) -> Optional[_CachedPrefix]:
        """The longest registered prefix this prompt starts with UNDER THIS
        ADAPTER, capped one token short of it (admission must still
        prefill a position to produce the first logits)."""
        if not self.prefix_cache_enabled or prompt is None:
            return None
        usable = (len(prompt) - 1) // self.page_size * self.page_size
        best = None
        for entry in self._prefixes.values():
            n = len(entry.tokens)
            if (entry.adapter == adapter and n <= usable
                    and tuple(prompt[:n]) == entry.tokens
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
            del self._prefixes[self._registry_key(victim.adapter,
                                                  victim.tokens)]
            self._free_pages_return(victim.pages)

    def _reserve(self, slot: int, prompt_len: int, max_new: int,
                 prompt: Optional[List[int]] = None) -> bool:
        n_ranges = -(-(prompt_len + max_new) // self.page_size)
        held = self._held_pages(prompt_len, max_new)
        # the slot's adapter is pinned and mapped before _reserve: only a
        # donation of the same adapter matches
        shared = (self._lookup_prefix(prompt, self._adapter_name_of(slot))
                  if held == n_ranges else None)
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
                self._slot_prefix[slot] = self._registry_key(
                    shared.adapter, shared.tokens)
                self._slot_shared[slot] = n_shared * self.page_size
        else:
            # the windowed ring: range j on pages[j % held] for the
            # request's life
            self.page_table[slot, :n_ranges] = [pages[j % held]
                                                 for j in range(n_ranges)]
        self._slot_pages[slot] = pages
        self._update_page_gauges()
        if self.prefix_cache_enabled and prompt is not None \
                and held == n_ranges:
            # counted on a SUCCESSFUL reservation only: a refused one is
            # retried every round of the pressure window
            (metrics.PREFIX_HITS if shared is not None
             else metrics.PREFIX_MISSES).inc()
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
        # the adapter pin LAST: _maybe_register reads the slot's adapter
        self._release_adapter(slot)
        self.page_table[slot, :] = 0
        self._free_pages_return(self._slot_pages.pop(slot, []))
        self._update_page_gauges()

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
        ad_name = self._adapter_name_of(slot)
        key = self._registry_key(ad_name, tokens)
        if key in self._prefixes:
            return
        self._evict_prefixes([0] * self.sp_shards, registry_room=k_pure)
        if self._cached_pages() + k_pure > self.max_cached_pages:
            return                      # nothing idle to evict
        donated = [int(p) for p in self.page_table[slot, :k_pure]]
        own = self._slot_pages.get(slot, [])
        if 0 in donated or len(own) < k_pure:
            return                      # never donate the trash page
        self._prefixes[key] = _CachedPrefix(
            tokens=tokens, pages=donated, last_used=time.monotonic(),
            adapter=ad_name)
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
            mesh=self.mesh, **self._adapter_kw([slot]))
        return logits[0]      # [V]: the prompt's last-position logits

    def _round_operand(self, lengths, n_steps: int):
        """The page table on the device, copied once a round and fixed
        for it (a reservation is worst case at admission, so no slot
        needs a new page mid-round)."""
        return self._table(self.page_table)

    def _decode_logits(self, tokens, lengths, table, ad=None):
        logits, self.pools = self._forward_noting_load(
            transformer.forward_paged_decode,
            self.params, tokens, self.cfg, self.pools, table, lengths,
            mesh=self.mesh, **(self._adapter_kw() if ad is None else ad))
        return logits[:, 0]

    def _verify_logits(self, blocks, n_ctxs, live, table, ad=None):
        logits, self.pools = transformer.forward_paged_verify(
            self.params, blocks, self.cfg, self.pools, table, n_ctxs,
            mesh=self.mesh, **(self._adapter_kw() if ad is None else ad))
        return logits

    def _prefill_chunk_into(self, slot: int, padded_tokens, pos: int,
                            last_idx: int):
        logits_v, self.pools = transformer.forward_paged_prefill_chunk(
            self.params, padded_tokens, self.cfg, self.pools,
            self._table(self.page_table[slot]), pos, last_idx,
            mesh=self.mesh, **self._adapter_kw([slot]))
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
        [R, V].  Its expert load is not tracked: the reference's paged
        mixed round counts its decode steps only."""
        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        tables = self._prefill_tables(block["p_slots"], block["p_active"])
        logits, self.pools = transformer.forward_paged_prefill_batch(
            self.params, t(block["p_tokens"]).long(), self.cfg, self.pools,
            self._table(tables), t(block["p_pos"]), t(block["p_last"]),
            mesh=self.mesh, **self._adapter_kw(ids=block["p_ads"]))
        return logits

