"""Serving-level lifecycle operations over a live query engine (port of
``repro.lifecycle.manager``).

:class:`LifecycleManager` is host bookkeeping between the engine's steps:
the logical clock TTL expiry runs on, the churn-touched cohort the repair
pass re-links, and the calls into the index's mutation primitives. It
holds the engine, not just the index, so update and repair descents run
through the engine's own :class:`~repro_torch.query.plan.DescentPlan`:
the same device tables, scorer and tombstone mask that serve queries.

All maintenance fires from :meth:`maintain`, which the engine calls after
every step (one logical tick per step). A delete landing between two ticks
reaches in-flight slots as the tombstone mask of their next hop.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.query.router import fingerprint_profiles, profiles_to_csr
from repro_torch.sched import Cadence
from repro_torch.types import PAD_ID


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """Knobs for churn maintenance (all off by default)."""

    ttl: int = 0             # logical ticks a row may go untouched
                             # (0 = never expire)
    repair_every: int = 0    # repair-pass cadence in ticks (0 = off)
    repair_hops: int = 2     # descent depth for update/repair re-linking
    repair_beam: int = 16    # frontier width for update/repair descents
    repair_batch: int = 32   # cohort rows re-linked per descent
    expire_batch: int = 64   # max TTL expirations per maintain() call


class LifecycleManager:
    """Deletes, updates, TTL expiry, and online repair for one engine."""

    def __init__(self, engine, cfg: LifecycleConfig | None = None):
        self.engine = engine
        self.cfg = cfg or LifecycleConfig()
        self.clock = 0                      # logical ticks (maintain calls)
        self._repair_cadence = Cadence(self.cfg.repair_every)
        self._touched: set[int] = set()     # churn-touched repair cohort
        self.n_removed = 0
        self.n_updated = 0
        self.n_expired = 0
        self.n_repairs = 0
        self.n_relinked = 0

    # -- activity ----------------------------------------------------------

    def touch(self, u: int):
        """Record user activity: resets ``u``'s TTL clock."""
        self.engine.index.touch_row(int(u), self.clock)

    def note_insert(self, u: int):
        """Stamp a freshly inserted row, so its TTL window starts now."""
        self.engine.index.touch_row(int(u), self.clock)

    # -- mutation ----------------------------------------------------------

    def _ring(self, u: int) -> set[int]:
        """Live forward+reverse neighbors of ``u`` (its 1-hop ring)."""
        ix = self.engine.index
        tomb = ix.tombstone
        ring = set()
        for v in np.concatenate([ix.graph_ids[u], ix.rev_ids[u]]):
            if v != PAD_ID and not tomb[int(v)]:
                ring.add(int(v))
        ring.discard(int(u))
        return ring

    def remove(self, u: int):
        """Delete ``u``: tombstone, edge patch, deregistration from
        routing. The survivors that lost an edge join the repair cohort."""
        u = int(u)
        ring = self._ring(u)
        self.engine.index.remove_user(u)
        self._touched |= ring
        self._touched.discard(u)
        self.n_removed += 1

    def update(self, u: int, profile) -> tuple[np.ndarray, np.ndarray]:
        """Replace ``u``'s profile and re-link it into the graph.

        Re-sketches the profile, swaps it in (re-scoring every incident
        edge), then descends from ``u``'s neighbours-of-neighbours (no
        routing, so the cost is bounded by the neighbourhood) and rewrites
        ``u``'s forward row from the result. Returns that (ids, sims) row.
        """
        u = int(u)
        ix = self.engine.index
        cfg = self.cfg
        items, offsets = profiles_to_csr([profile])
        qgf = fingerprint_profiles(items, offsets, ix.n_bits, ix.fp_seed)
        before = self._ring(u)
        ix.swap_profile(u, np.asarray(qgf.words)[0], int(qgf.card[0]))
        seeds = self._neighborhood_seeds([u])
        ids, sims = self.engine.plan.descend_rows(
            np.asarray(qgf.words), np.asarray(qgf.card), seeds,
            k=ix.k + 1, hops=cfg.repair_hops, beam=cfg.repair_beam)
        ix.relink_user(u, ids[0], sims[0])
        ix.touch_row(u, self.clock)
        # Old and new neighborhoods both shifted under the swap.
        self._touched |= before | self._ring(u)
        self._touched.discard(u)
        self.n_updated += 1
        return ids[0], sims[0]

    # -- TTL expiry --------------------------------------------------------

    def expire_stale(self) -> int:
        """Remove rows untouched for more than ``cfg.ttl`` ticks, lowest
        id first, at most ``cfg.expire_batch`` per call."""
        cfg = self.cfg
        if cfg.ttl <= 0:
            return 0
        ix = self.engine.index
        stale = np.flatnonzero(
            ~ix.tombstone & (self.clock - ix.last_touch > cfg.ttl))
        n = 0
        for u in stale[: cfg.expire_batch]:
            self.remove(int(u))
            n += 1
        self.n_expired += n
        return n

    # -- repair ------------------------------------------------------------

    def _neighborhood_seeds(self, users) -> np.ndarray:
        """int32[len(users), W] descent seeds: each user's live 1-hop ring
        first, then its neighbors-of-neighbors (first-seen order, deduped),
        truncated or PAD-padded to the fixed width W. Users whose ring died
        entirely fall back to an id-strided sample of live rows."""
        ix = self.engine.index
        graph, rev, tomb = ix.graph_ids, ix.rev_ids, ix.tombstone
        W = self.seed_width
        out = np.full((len(users), W), PAD_ID, dtype=np.int32)
        alive = None
        for i, u in enumerate(users):
            u = int(u)
            ring = [int(v) for v in np.concatenate([graph[u], rev[u]])
                    if v != PAD_ID]
            non = [int(x) for v in ring for x in graph[v] if x != PAD_ID]
            seen, cand = set(), []
            for v in ring + non:
                if v == u or v in seen or tomb[v]:
                    continue
                seen.add(v)
                cand.append(v)
            if not cand:
                if alive is None:
                    alive = ix.alive_ids()
                pool = alive[alive != u]
                take = np.linspace(0, len(pool) - 1,
                                   num=min(W, len(pool)), dtype=np.int64)
                cand = [int(v) for v in pool[take]]
            out[i, : min(len(cand), W)] = cand[:W]
        return out

    @property
    def seed_width(self) -> int:
        """Seed columns of update/repair descents: 2·(k + reverse width)."""
        ix = self.engine.index
        return 2 * (ix.k + ix.rev_ids.shape[1])

    def repair(self) -> int:
        """Re-link the churn-touched survivors whose forward rows lost
        edges (PAD holes from delete patching), by a descent seeded from
        their current ring, in batches of ``cfg.repair_batch``. Rows that
        kept full degree are left alone. Returns rows re-linked."""
        ix = self.engine.index
        cfg = self.cfg
        tomb = ix.tombstone
        graph = ix.graph_ids
        cohort = sorted(v for v in self._touched
                        if 0 <= v < ix.n and not tomb[v]
                        and (graph[v] == PAD_ID).any())
        self._touched.clear()
        if not cohort:
            return 0
        B = max(cfg.repair_batch, 1)
        for lo in range(0, len(cohort), B):
            chunk = cohort[lo: lo + B]
            seeds = self._neighborhood_seeds(chunk)
            ids, sims = self.engine.plan.descend_rows(
                ix.words[chunk], ix.card[chunk], seeds,
                k=ix.k + 1, hops=cfg.repair_hops, beam=cfg.repair_beam)
            for j, u in enumerate(chunk):
                ix.relink_user(u, ids[j], sims[j])
        self.n_repairs += 1
        self.n_relinked += len(cohort)
        return len(cohort)

    # -- the between-steps hook --------------------------------------------

    def maintain(self) -> dict:
        """One maintenance tick: advance the clock, expire stale rows, and
        fire the repair cadence. While the engine reports ``degraded``
        only the clock advances (deferred work fires on the first healthy
        tick)."""
        self.clock += 1
        if getattr(self.engine, "degraded", False):
            return {"clock": self.clock, "expired": 0, "relinked": 0,
                    "deferred": True}
        n_expired = self.expire_stale()
        n_relinked = 0
        if self._repair_cadence.tick() and self._touched:
            n_relinked = self.repair()
        return {"clock": self.clock, "expired": n_expired,
                "relinked": n_relinked}

    def stats(self) -> dict:
        return {"clock": self.clock, "removed": self.n_removed,
                "updated": self.n_updated, "expired": self.n_expired,
                "repairs": self.n_repairs, "relinked": self.n_relinked,
                "pending_repair": len(self._touched)}
