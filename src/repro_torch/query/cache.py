"""Fingerprint-keyed result cache with journal-driven invalidation (torch
port of ``repro.query.cache``; host numpy only).

Repeated queries are the norm at a recommendation front door: the same
hot profiles descend the same graph again and again. The cache sits in
front of a plan's serving paths (``DescentPlan.search`` for waves and the
raw batch API, admission for continuous slots) and keys on the EXACT
query fingerprint plus the knobs that determine the computation: ``(words
bytes, card, k, hops)``. A descent is a deterministic function of (index
state, fingerprint, k, hops), so an exact hit is bitwise what a fresh
descent would return. The keys are the bytes of the host fingerprints
(``router.fingerprint_profiles``, the reference's uint32 words), so a
lookup never copies a device tensor back.

Invalidation rides on the index's mutation journals
(``KNNIndex.rows_changed_since`` / ``tombstones_since`` /
``members_added_since``): a version bump whose journals prove nothing
changed keeps the cache; any real mutation flushes it wholesale. A single
new edge can reroute a descent whose result never held the touched row,
so per-entry invalidation would serve results a fresh descent no longer
gives. As a second guard, :meth:`ResultCache.get` drops any entry naming
a tombstoned id (counted, never served).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch.types import PAD_ID


class ResultCache:
    """LRU cache of (ids, sims) results keyed by exact query fingerprint.

    ``capacity`` bounds the entry count (LRU eviction). The cache tracks
    the index version it was filled at; :meth:`sync` runs before a batch
    of lookups (the plan calls it once per wave or tick).
    """

    def __init__(self, index, capacity: int):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.index = index
        self.capacity = capacity
        self.version = index.version
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.flushes = 0
        self.stale_drops = 0
        # Results computed on a degraded (shard-masked) fleet are served
        # but never stored: cached, they would outlive the failure window.
        # The plan counts the skips here.
        self.degraded_skips = 0

    @staticmethod
    def key(words_row: np.ndarray, card: int, k: int, hops: int) -> tuple:
        """Cache key: exact fingerprint bytes + the serving knobs."""
        return (np.asarray(words_row).tobytes(), int(card), int(k),
                int(hops))

    def __len__(self) -> int:
        return len(self._entries)

    def sync(self):
        """Reconcile with the index's version before a lookup batch: keep
        the entries only when the journals PROVE the bump changed nothing
        a descent could observe; flush wholesale otherwise (a journal
        that no longer reaches back answers None, which reads as
        "changed")."""
        ix = self.index
        if ix.version == self.version:
            return
        changed = ix.rows_changed_since(self.version)
        tombs = ix.tombstones_since(self.version)
        members = ix.members_added_since(self.version)
        if changed is not None and not changed \
                and tombs is not None and not tombs \
                and members is not None and not members:
            self.version = ix.version  # provably a no-op bump
            return
        self._entries.clear()
        self.flushes += 1
        self.version = ix.version

    def invalidate(self):
        """Flush unconditionally, for events the journals cannot see: a
        shard re-balance swap changes no index content but every sharded
        result. Counts as a flush, so in-flight requests that straddled
        it fail the flush-count check at completion and are not stored."""
        self._entries.clear()
        self.flushes += 1
        self.version = self.index.version

    def get(self, key: tuple):
        """(ids, sims) copies for ``key``, or None; counts hits and misses.
        An entry naming a tombstoned id is dropped and counts as a miss."""
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        ids, sims = entry
        live = ids[ids != PAD_ID]
        if live.size and self.index.tombstone[live].any():
            del self._entries[key]
            self.stale_drops += 1
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return ids.copy(), sims.copy()

    def put(self, key: tuple, ids: np.ndarray, sims: np.ndarray):
        """Store a result computed entirely at the cache's current index
        version (the caller checks that no flush fell inside it); refused
        when the index moved past the cache's version since."""
        if self.index.version != self.version:
            return
        self._entries[key] = (np.array(ids, copy=True),
                              np.array(sims, copy=True))
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def stats(self) -> dict:
        lookups = self.hits + self.misses
        return {
            "capacity": self.capacity,
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / lookups, 4) if lookups else 0.0,
            "flushes": self.flushes,
            "stale_drops": self.stale_drops,
            "degraded_skips": self.degraded_skips,
        }
