"""Query-result cache of the serving engine (see ``serving.scheduler``).

Serving traffic repeats itself: RAG front ends re-issue the same question
verbatim and popular queries dominate open-loop traces.  The index is
deterministic, so the same query under the same plan against the same
index state returns the same ids and distances bit for bit; the cache
answers such repeats at admission, before the request reaches the
coalescer.

Keying.  An entry is keyed on ``(query_key(q), resolved QueryPlan, index
generation)``:

* ``query_key`` encodes the query with the level-0 ternary encoder the
  index uses for its rows (``core.ternary``, then ``core.packing``) and
  keeps the packed bytes and the float32 scale pair (norm, rho).  Two
  queries whose packed codes differ miss each other.
* The resolved plan is part of the key, so a degraded request (a lower
  ``refine_budget``, see ``scheduler.TokenBucket``) never serves a
  full-service entry or the reverse.
* The generation is part of the key, so a mutation can never serve stale
  results.

Invalidation.  ``attach(index)`` registers ``_on_mutation`` as a
generation hook of a ``StreamingIndex`` or ``TieredIndex``: every
mutation or migration bumps the generation and the hook purges every
entry of an older one.  Static and sharded indexes never change and need
no hook.

Eviction is LRU over an ``OrderedDict``; hits refresh recency.  All
counters live in ``CacheStats``.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.packing import pack_ternary
from repro_torch.core.ternary import ternary_encode
from repro_torch.obs import trace


def query_keys(queries) -> list[bytes]:
    """``query_key`` of every row of ``queries`` (N, D), from one batched
    encode.

    The encode runs on the CPU, from the requests' host copy (device
    tensors are copied to the host first, once for the batch).  This
    hashes host data; it is not a fallback for a kernel: on the card the
    same encode would cost several launches and a synchronize per
    request, on an admission path that the host already bounds."""
    v = torch.as_tensor(queries, dtype=torch.float32).detach().cpu()
    tc = ternary_encode(v.reshape(v.shape[0], -1))
    packed = pack_ternary(tc.code).numpy()
    scale = torch.stack([tc.norm, tc.rho], dim=1).numpy()   # float32
    return [p.tobytes() + s.astype("<f4").tobytes()
            for p, s in zip(packed, scale)]


def query_key(q) -> bytes:
    """Byte key of one query vector: its packed level-0 ternary code, then
    (norm, rho) as float32 little-endian bytes (see ``query_keys``)."""
    return query_keys(torch.as_tensor(q, dtype=torch.float32)
                      .reshape(1, -1))[0]


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evictions: int = 0
    invalidations: int = 0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "inserts": self.inserts, "evictions": self.evictions,
                "invalidations": self.invalidations}


@dataclass(frozen=True)
class CacheEntry:
    """One cached answer: ids and exact distances as host numpy copies,
    and whether the batch that produced it ran degraded."""

    ids: np.ndarray
    distances: np.ndarray
    degraded: bool


@dataclass
class ResultCache:
    """LRU result cache keyed on (query bytes, plan, index generation).

    ``hit_latency_us`` is the virtual-clock service time the scheduler
    charges a hit: a hit skips the datapath, so its latency is a small
    fixed lookup cost, not a tier ledger."""

    capacity: int = 1024
    hit_latency_us: float = 1.0
    stats: CacheStats = field(default_factory=CacheStats)
    _entries: OrderedDict = field(default_factory=OrderedDict)

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, qkey: bytes, plan, generation: int) -> CacheEntry | None:
        key = (qkey, plan, generation)
        entry = self._entries.get(key)
        if entry is None:
            self.stats.misses += 1
            trace.event("cache.miss", track="cache", generation=generation)
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        trace.event("cache.hit", track="cache", generation=generation)
        return entry

    def insert(self, qkey: bytes, plan, generation: int, ids, distances,
               *, degraded: bool = False) -> None:
        key = (qkey, plan, generation)
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        while len(self._entries) >= self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
            trace.event("cache.evict", track="cache")
        self._entries[key] = CacheEntry(
            ids=np.array(ids), distances=np.array(distances),
            degraded=degraded)
        self.stats.inserts += 1

    def attach(self, index) -> None:
        """Subscribe to ``index``'s mutations where it publishes a
        generation hook (``StreamingIndex``, ``TieredIndex``)."""
        hook = getattr(index, "add_generation_hook", None)
        if hook is not None:
            hook(self._on_mutation)

    def _on_mutation(self, index, generation: int) -> None:
        """A mutation or migration fired: purge every older entry."""
        stale = [k for k in self._entries if k[2] != generation]
        for k in stale:
            del self._entries[k]
        self.stats.invalidations += len(stale)
        if stale:
            trace.event("cache.invalidate", track="cache",
                        generation=generation, purged=len(stale))

    def bind_metrics(self, registry) -> None:
        """Mirror ``CacheStats`` and the size into ``registry`` as the
        ``serving_cache{field=...}`` gauge family, refreshed at export
        time (a collector: lookups and inserts stay untouched)."""
        g = registry.gauge("serving_cache", "result-cache counters",
                           labelnames=("field",))

        def _collect():
            for name, v in self.stats.as_dict().items():
                g.labels(field=name).set(v)
            g.labels(field="size").set(len(self._entries))

        registry.add_collector(_collect)

    def clear(self) -> None:
        self._entries.clear()
