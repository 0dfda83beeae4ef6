"""The serving adapter pool: multi-tenant LoRA residency.

Counterpart of ``tpushare/serving/adapters.py``.  Per-customer fine-tunes
cost ADAPTER bytes, not model replicas: one base model stays resident and
every adapter is one row of the stacked device pool
(:func:`tpushare_torch.ops.lora.init_adapter_pool_arrays`; row 0 is the
all-zero identity adapter, never allocated, so base traffic rides the
same forward), and every batched forward gathers each row's adapter
(``models.transformer._mm_ad``).

This module is the host-side residency manager, the adapter analogue of
the paged batcher's page free list:

* byte-priced capacity: the pool holds ``n_slots`` named adapters (plus
  the identity) at ``adapter_entry_bytes`` each, the second device pool
  beside the KV cache, reported by ``storage_info()`` and
  ``tpushare_adapter_pool_bytes``;
* LRU residency: acquiring a name that is not resident loads it into a
  free row, or EVICTS the least recently used row that no request pins
  (``tpushare_adapter_evictions_total{reason="capacity"}``); a pinned
  row is never a victim, so a forward never gathers an evicted row;
* pins: every admitted request naming adapter idx pins it until its slot
  is released (completion, cancel, migration pop); the batcher's
  ``_slot_adapter`` map owns the release calls.

Thread model: the pool is LOOP-OWNED state like the batcher that holds
it.  Every mutation (acquire, load, evict, release) runs on the service
loop thread; the reads (:meth:`AdapterPool.pressure`, :meth:`snapshot`,
:meth:`storage_info`) are point-in-time views, safe from handler threads,
which the server's 503 gate and ``/stats`` use.

Default loader: a DETERMINISTIC synthetic adapter drawn from the name
(sha256-seeded ``ops.lora.make_adapter``), so every replica builds the
same weights for the same name.  A deployment passes a ``loader`` that
reads trained weights (``models.bridge.adapter_from_numpy`` carries a
JAX-package adapter across).
"""

from __future__ import annotations

import hashlib
import logging
import time
from typing import Callable, Dict, Optional

import torch

from .. import default_device
from ..ops import lora as ops_lora
from ..parallel.mesh import adapter_block, shard_adapter_pool
from . import metrics

log = logging.getLogger("tpushare_torch.serving")

#: why an adapter LOAD ran, the values of
#: ``tpushare_adapter_loads_total{reason=}``: ``miss`` = the name was not
#: resident (cold, or evicted before) and a pool row was written
ADAPTER_LOAD_REASONS = ("miss",)

#: why a resident adapter was EVICTED, the values of
#: ``tpushare_adapter_evictions_total{reason=}``: ``capacity`` = the pool
#: was full and an unpinned LRU row made way for a load
ADAPTER_EVICTION_REASONS = ("capacity",)


class AdapterLoadError(RuntimeError):
    """The adapter LOADER failed for a name (missing weights, a bad file):
    one request's failure, never the pool's or the service's.  Admission
    aborts the request naming the adapter and the loop serves on."""


@torch.no_grad()
def _write_adapter(pool, idx: int, entry, scale: float) -> None:
    """Write one adapter's a/b/scale into pool row ``idx`` in place (the
    counterpart of the reference's donated ``.at[:, idx].set``): stream-
    ordered after every forward already queued, and no forward in flight
    reads an unpinned row.  A pool split on tp (a tuple of one pool a
    shard) takes each shard's block of the entry
    (``parallel.mesh.adapter_block``)."""
    shards = pool if isinstance(pool, tuple) else (pool,)
    for t, part in enumerate(shards):
        for name, leaves in part.items():
            if name == "scale":
                continue
            for k in ("a", "b"):
                dst = leaves[k]
                src = adapter_block(name, k, entry[name][k], t, len(shards))
                dst[:, idx] = src.to(device=dst.device, dtype=dst.dtype)
        part["scale"][idx] = float(scale)


def _name_seed(name: str) -> int:
    """A deterministic seed for a named synthetic adapter, free of any
    per-process salt (``hash()`` is salted: replicas would build different
    weights for one name)."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big")


class AdapterPool:
    """Host-side residency manager over the stacked device pool."""

    def __init__(self, cfg, rank: int, n_slots: int,
                 loader: Optional[Callable[[str], Dict]] = None,
                 dtype=None, device=None, mesh=None):
        """``mesh`` with a tp axis splits the pool like its base
        projections, one pool a tp shard on its device
        (``parallel.mesh.shard_adapter_pool``); every write goes to each
        shard's block."""
        if n_slots < 1:
            raise ValueError("adapter pool needs >= 1 named slot")
        self.cfg = cfg
        self.rank = int(rank)
        self.n_slots = int(n_slots)
        self._dtype = dtype or cfg.dtype
        self.device = default_device(device)
        # +1: row 0 is the identity adapter (all zero, never allocated)
        self._pool = ops_lora.init_adapter_pool_arrays(
            cfg, self.rank, self.n_slots + 1, dtype=self._dtype,
            device=self.device)
        if mesh is not None and "tp" in mesh.axis_names:
            self._pool = shard_adapter_pool(self._pool, mesh)
        self._by_name: Dict[str, int] = {}
        #: idx -> {"name", "refs", "last_used"} for rows 1..n_slots
        self._rows: Dict[int, dict] = {
            i: {"name": None, "refs": 0, "last_used": 0.0}
            for i in range(1, self.n_slots + 1)}
        self._loader = loader or self._synthetic_loader
        self.loads = 0
        self.evictions = 0
        metrics.ADAPTER_POOL_BYTES.set(
            ops_lora.adapter_pool_bytes(cfg, self.rank, self.n_slots + 1,
                                        dtype=self._dtype))
        metrics.ADAPTER_RESIDENT.set(0)

    # -- loaders -------------------------------------------------------
    def _synthetic_loader(self, name: str) -> Dict:
        return ops_lora.make_adapter(self.cfg, self.rank,
                                     seed=_name_seed(name),
                                     dtype=self._dtype)

    # -- device operands (loop thread) ---------------------------------
    def device_operands(self):
        """The stacked pool the forwards gather from (one a tp shard
        under a tp mesh).  Loads and evictions touch only rows no live
        slot references (pins gate eviction)."""
        return self._pool

    # -- residency (MUTATIONS: service loop thread only) ---------------
    def acquire(self, name: str) -> Optional[int]:
        """Pin ``name`` and return its pool row, loading (and evicting the
        LRU unpinned row) as needed; None = pressure (every row pinned by
        a request in flight), the admission's backpressure verdict."""
        idx = self._by_name.get(name)
        if idx is not None:
            row = self._rows[idx]
            row["refs"] += 1
            row["last_used"] = time.monotonic()
            return idx
        idx = self._free_row()
        if idx is None:
            return None
        try:
            entry = self._loader(name)
        except Exception as e:
            # the loader runs on the serving loop (admission): a bad name
            # is one request's problem, never every tenant's
            raise AdapterLoadError(
                f"adapter {name!r} failed to load: {e}") from e
        _write_adapter(self._pool, idx, entry, entry.get("scale", 1.0))
        self._by_name[name] = idx
        self._rows[idx] = {"name": name, "refs": 1,
                           "last_used": time.monotonic()}
        self.loads += 1
        metrics.ADAPTER_LOADS.inc(reason="miss")
        metrics.ADAPTER_RESIDENT.set(len(self._by_name))
        return idx

    def _free_row(self) -> Optional[int]:
        free = [i for i, r in self._rows.items() if r["name"] is None]
        if free:
            return free[0]
        idle = [i for i, r in self._rows.items() if r["refs"] <= 0]
        if not idle:
            return None
        victim = min(idle, key=lambda i: self._rows[i]["last_used"])
        name = self._rows[victim]["name"]
        del self._by_name[name]
        self._rows[victim] = {"name": None, "refs": 0, "last_used": 0.0}
        self.evictions += 1
        metrics.ADAPTER_EVICTIONS.inc(reason="capacity")
        metrics.ADAPTER_RESIDENT.set(len(self._by_name))
        log.info("adapter %r evicted (capacity)", name)
        # the stale row stays on the device until the load overwrites
        # it: nothing references an unpinned, unnamed row
        return victim

    def release(self, idx: int) -> None:
        """Drop one pin (a slot released its request)."""
        row = self._rows.get(idx)
        if row is not None and row["refs"] > 0:
            row["refs"] -= 1
            row["last_used"] = time.monotonic()

    def name_of(self, idx: int) -> Optional[str]:
        """The name resident at ``idx`` (migration metadata: the NAME
        travels in a session blob, and the receiver re-acquires it)."""
        row = self._rows.get(idx)
        return row["name"] if row else None

    # -- read-only views (any thread: point-in-time snapshots) ---------
    def pressure(self, name: str) -> bool:
        """Would an acquire of ``name`` refuse right now?  The server's 503
        verdict: a name not resident against a fully pinned pool."""
        if name in self._by_name:
            return False
        return all(r["name"] is not None and r["refs"] > 0
                   for r in self._rows.values())

    def snapshot(self) -> dict:
        return {"slots": self.n_slots, "resident": len(self._by_name),
                "loads": self.loads, "evictions": self.evictions}

    def storage_info(self) -> dict:
        """The pool's device economics: what it costs, and what the same
        tenants would cost as merged per-adapter models."""
        per = ops_lora.adapter_entry_bytes(self.cfg, self.rank,
                                           dtype=self._dtype)
        return {
            "adapter_slots": self.n_slots,
            "adapter_rank": self.rank,
            "adapters_resident": len(self._by_name),
            "bytes_per_adapter": int(per),
            "adapter_pool_bytes": int(ops_lora.adapter_pool_bytes(
                self.cfg, self.rank, self.n_slots + 1, dtype=self._dtype)),
            "merged_bytes_per_adapter": int(ops_lora.merged_adapter_bytes(
                self.cfg, dtype=self._dtype)),
        }
