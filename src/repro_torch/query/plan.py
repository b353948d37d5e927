"""Descent plans: placement × batching × scorer (torch port of
``repro.query.plan``).

A :class:`PlanSpec` names the three serving axes of the reference:

* **placement** — ``1`` (the whole index on one device) or ``S`` LPT
  cluster shards (``query/sharded.py``: owner-partitioned seeds, per-shard
  local subgraphs, a cross-shard top-k merge): stacked on one device
  with one hop launch for every shard, or one device per shard
  (``DescentPlan(shard_devices=)``, opt-in) with one launch per shard;
* **batching** — ``"wave"`` (closed waves) or ``"continuous"`` (a slot
  scheduler, streaming admission, per-request hop budgets);
* **scorer** — ``"jnp"`` (the plain unfused hop), ``"pallas"`` (the fused
  CUDA hop) or ``"pallas_dma"`` (the DMA hop); the scorer names are the
  reference's, so specs and CLI flags carry over.

For a fixed placement, batching and scorer never change a result: every
combination gives bitwise-identical ids and sims. Placement is the one
axis that changes results (disjoint seed basins, dropped cross-shard
edges), identically under every batching and scorer, and bitwise as the
reference's sharded placement does.

A :class:`DescentPlan` owns its device state and serves through
``step(queue, done)``: one closed wave, or one continuous tick. The single
placement keeps padded copies of the index tables on the plan's device,
kept current by :meth:`DescentPlan.sync` from the index's row journal; the
sharded placement keeps a :class:`~repro_torch.query.sharded.
ShardedDescent`, delta-resharded from the index's journals, and never a
full-index copy. Continuous plans add the slot arrays (under sharding,
every shard's beams ``[n_slots, shard_beam]`` on its tables' device, as
the reference pins them to its mesh). Every wave, seeded descent and
tick syncs first, so an index mutation between two steps reaches
in-flight slots as the tombstone mask of their next hop.

Four knobs ride on every combination, as the reference's do:
``admission="slo"`` (priority classes and deadlines, expired and overflow
requests shed with a ``rejected`` marker: ``sched.shed_and_select``);
``adaptive`` (continuous: a slot frees once its top-k prefix held that
many hops: ``search.slot_prefix_stable``); ``cache`` (exact-fingerprint
results served without a descent: ``query/cache.py``); and
``resident_configs`` (sharded: tiered residency). Every time stamp reads
the injectable ``clock`` (default ``time.perf_counter``), so deadlines and
latencies can be driven by a ``sched.ManualClock``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.local_knn import capacity_of
from repro_torch.device import resolve_device
from repro_torch.query.cache import ResultCache
from repro_torch.query.index import KNNIndex
from repro_torch.query.router import fingerprint_profiles, profiles_to_csr, route
from repro_torch.query.search import (batched_descent, new_slot_part,
                                      slot_admit, slot_hop,
                                      slot_prefix_stable)
from repro_torch.sched import (ADMISSION_POLICIES, SlotScheduler,
                               shed_and_select)
from repro_torch.sketch.goldfinger import words_tensor
from repro_torch.types import PAD_ID

BATCHINGS = ("wave", "continuous")
SCORERS = ("jnp", "pallas", "pallas_dma")


def _csr_subset(items: np.ndarray, offsets: np.ndarray,
                idxs) -> tuple[np.ndarray, np.ndarray]:
    """CSR rows ``idxs`` of an (items, offsets) profile batch."""
    rows = [items[offsets[i]:offsets[i + 1]] for i in idxs]
    sizes = np.array([len(r) for r in rows], dtype=np.int64)
    out_offsets = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(sizes, out=out_offsets[1:])
    out_items = (np.concatenate(rows) if rows
                 else np.zeros((0,), np.int32)).astype(np.int32)
    return out_items, out_offsets


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Static description of a descent plan (hashable, validated)."""

    placement: int = 1          # shards (1 = single device)
    batching: str = "wave"      # "wave" | "continuous"
    scorer: str = "jnp"         # "jnp" | "pallas" | "pallas_dma"
    k: int = 10
    beam: int = 32
    hops: int = 3
    max_wave: int = 256         # wave batching: queries per descent
    slots: int = 32             # continuous batching: in-flight capacity
    seeds_per_config: int = 16
    shard_oversample: float = 1.5  # sharded: the fleet's frontier vs the
                                   # single placement's beam
    admission: str = "fifo"     # "fifo" | "slo" (priority + deadline
                                # admission with explicit shedding)
    max_pending: int = 0        # slo: pending-queue bound (0 = unbounded)
    adaptive: int = 0           # continuous: free a slot once its top-k
                                # prefix held this many hops (0 = off)
    cache: int = 0              # fingerprint result-cache capacity (0=off)
    resident_configs: int = 0   # tiered residency: clusters of the first
                                # m hash configurations contribute shard
                                # residents (0 = all t; sharded only)

    def __post_init__(self):
        if self.placement < 1:
            raise ValueError(
                f"plan placement must be >= 1 shard, got {self.placement}")
        if self.batching not in BATCHINGS:
            raise ValueError(f"unknown batching {self.batching!r}; "
                             f"supported: {BATCHINGS}")
        if self.scorer not in SCORERS:
            raise ValueError(
                f"unknown scorer {self.scorer!r}; supported: {SCORERS}")
        if self.batching == "continuous" and self.slots < 1:
            raise ValueError(f"continuous plans need slots >= 1, "
                             f"got {self.slots}")
        if self.batching == "wave" and self.max_wave < 1:
            raise ValueError(f"wave plans need max_wave >= 1, "
                             f"got {self.max_wave}")
        if self.k < 1 or self.hops < 0:
            raise ValueError(f"invalid k={self.k} / hops={self.hops}")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission {self.admission!r}; supported: "
                f"{ADMISSION_POLICIES}")
        if self.max_pending < 0:
            raise ValueError(
                f"max_pending must be >= 0, got {self.max_pending}")
        if self.max_pending > 0 and self.admission != "slo":
            raise ValueError(
                "max_pending bounds the slo admission queue; FIFO never "
                "sheds (set admission='slo' to bound the queue)")
        if self.adaptive < 0:
            raise ValueError(f"adaptive patience must be >= 0, "
                             f"got {self.adaptive}")
        if self.adaptive > 0 and self.batching != "continuous":
            raise ValueError(
                "adaptive hop budgets free continuous slots on top-k "
                "prefix stability; wave batching has no per-request "
                "termination (use batching='continuous')")
        if self.cache < 0:
            raise ValueError(f"cache capacity must be >= 0, "
                             f"got {self.cache}")
        if self.resident_configs < 0:
            raise ValueError(f"resident_configs must be >= 0, "
                             f"got {self.resident_configs}")
        if self.resident_configs > 0 and self.placement == 1:
            raise ValueError(
                "resident_configs restricts SHARD residency to a subset "
                "of hash configurations; the single placement hosts every "
                "row (use placement > 1)")

    @property
    def kernel(self) -> bool:
        return self.scorer in ("pallas", "pallas_dma")

    @property
    def dma(self) -> bool:
        """The DMA hop (``ops.descent_hop(dma=True)``)."""
        return self.scorer == "pallas_dma"

    def describe(self) -> str:
        place = ("single" if self.placement == 1
                 else f"sharded({self.placement})")
        batch = ("wave" if self.batching == "wave"
                 else f"continuous(slots={self.slots})")
        base = f"{place} x {batch} x {self.scorer}"
        extras = []
        if self.admission != "fifo":
            extras.append(f"slo(max_pending={self.max_pending})")
        if self.adaptive:
            extras.append(f"adaptive({self.adaptive})")
        if self.cache:
            extras.append(f"cache({self.cache})")
        if self.resident_configs:
            extras.append(f"resident_configs({self.resident_configs})")
        return base + (" + " + ", ".join(extras) if extras else "")


class _SlotState:
    """Device-resident per-slot state of a continuous plan: the query
    fingerprints and beams of the ``n_slots`` rows, and on the host each
    slot's hops done and hop budget. :attr:`parts` holds the device arrays
    (``search.new_slot_part``): one set of ``[n_slots, beam]`` beams for
    the single placement; under sharding one set per part of the shard
    tables, on its device (``ShardedDescent.new_slots``), beams ``[shards
    of the part, n_slots, shard_beam]``: every shard advances its own beam
    per slot, merged across shards at release.

    Adaptive budgets add, per slot, the count of consecutive hops whose
    top-k prefix held (``streak``), the prefix it is compared with (each
    part's ``prefix_ids``, on the device) and a ``fresh`` flag, so a
    re-admitted slot never compares against its previous occupant's
    prefix."""

    def __init__(self, index: KNNIndex, spec: PlanSpec, beam: int, device,
                 clock, sd=None):
        n_slots = spec.slots
        self.beam = beam
        self.sched = SlotScheduler(n_slots, policy=spec.admission,
                                   max_pending=spec.max_pending, clock=clock)
        W = index.words.shape[1]
        k_prefix = spec.k if spec.adaptive > 0 else 0
        self.parts = ([new_slot_part(n_slots, W, beam, k_prefix, device)]
                      if sd is None
                      else sd.new_slots(n_slots, W, beam, k_prefix))
        self.hops_done = np.zeros(n_slots, np.int64)
        self.budget = np.full(n_slots, spec.hops, np.int64)
        self.streak = np.zeros(n_slots, np.int64)
        self.fresh = np.ones(n_slots, bool)

    @property
    def beam_ids(self) -> torch.Tensor:
        """The slot beams, ``[S, n_slots, beam]`` under sharding (gathered
        on the first part's device), for inspection."""
        if len(self.parts) == 1:
            return self.parts[0].beam_ids
        dev = self.parts[0].beam_ids.device
        return torch.cat([p.beam_ids.to(dev) for p in self.parts])


class DescentPlan:
    """One placement × batching × scorer combination on one device,
    owning its device state and serving loop."""

    def __init__(self, index: KNNIndex, spec: PlanSpec, device="cuda",
                 clock=None, shard_devices=None):
        self.index = index
        self.spec = spec
        self.device = resolve_device(device)
        # Sharded placement: one device per shard (None: the reference's
        # rule, ShardedDescent(devices=None)).
        self.shard_devices = shard_devices
        # Every completion, shed and deadline stamp reads this clock.
        self.clock = clock or time.perf_counter
        self.beam = max(spec.beam, spec.k)
        self._single = None     # (version, capacity, device tables)
        self._sharded = None    # ShardedDescent (delta-synced)
        self._slots: Optional[_SlotState] = None
        self.n_ticks = 0
        # Hop accounting over every hop this plan ran, real query rows
        # only (inactive slots are masked out before they land here):
        # candidate lanes scored, fingerprint bytes the DMA hop gathered
        # and those its suppression skipped, and the query rows noted —
        # one per query of a wave, one per active slot of a tick, as the
        # reference counts them.
        self.descent_stats = {"scored_lanes": 0, "dma_bytes": 0,
                              "bytes_saved": 0, "hop_queries": 0}
        # Device syncs. Single placement: full uploads, journal scatters
        # and the rows they scattered. Sharded: the results of the shard
        # state's sync() after its first build (ShardedDescent.sync).
        self.sync_stats = (
            {"noop": 0, "delta": 0, "rebuild": 0} if spec.placement > 1
            else {"full_uploads": 0, "scatters": 0, "rows_scattered": 0})
        # Exact-fingerprint result cache, flushed by any index mutation the
        # journals show and by re-balance swaps (note_replan).
        self.cache = ResultCache(index, spec.cache) if spec.cache else None

    def describe(self) -> str:
        return self.spec.describe()

    def _note_stats(self, stats: torch.Tensor) -> None:
        """Fold int32[rows, 3] of ``(n_scored, dma_bytes, bytes_saved)``,
        already masked to real rows, into :attr:`descent_stats`."""
        s = stats.cpu().numpy().astype(np.int64)
        if s.size == 0:
            return
        self.descent_stats["scored_lanes"] += int(s[:, 0].sum())
        self.descent_stats["dma_bytes"] += int(s[:, 1].sum())
        self.descent_stats["bytes_saved"] += int(s[:, 2].sum())
        self.descent_stats["hop_queries"] += int(s.shape[0])

    def sync(self):
        """Repair this plan's device state to the index's version and
        return it. The sharded placement delegates to its
        :class:`~repro_torch.query.sharded.ShardedDescent` (delta reshard,
        :meth:`sharded_state`) and returns it. The single placement
        returns the index on the plan's device: (graph_ids, rev_ids, words
        bit-views, card, tombstone), padded to ``capacity_of(n,
        minimum=64)`` rows (PAD adjacency, zero words and cards, live
        flags past n; no id names them).

        A stale copy is repaired in place when it can be: the rows the
        index journalled since the copy's version
        (:meth:`KNNIndex.rows_changed_since`) are scattered into the
        resident tensors. The whole index is uploaded on first use, when
        n crosses the padded capacity, when the journal no longer reaches
        back, or when more than ``max(64, n // 8)`` rows changed."""
        if self.spec.placement > 1:
            return self._sync_sharded()
        ix = self.index
        if self._single is not None and self._single[0] == ix.version:
            return self._single[2]
        n, cap = ix.n, capacity_of(ix.n, minimum=64)
        dev = self.device
        if self._single is not None and self._single[1] == cap:
            changed = ix.rows_changed_since(self._single[0])
            if changed is not None and len(changed) <= max(64, n // 8):
                tables = self._single[2]
                if changed:
                    rows = np.fromiter(sorted(changed), dtype=np.int64,
                                       count=len(changed))
                    idx = torch.from_numpy(rows).to(dev)
                    g, r, w, c, t = tables
                    g.index_copy_(0, idx, torch.from_numpy(
                        ix.graph_ids[rows]).to(dev))
                    r.index_copy_(0, idx, torch.from_numpy(
                        ix.rev_ids[rows]).to(dev))
                    w.index_copy_(0, idx, words_tensor(ix.words[rows], dev))
                    c.index_copy_(0, idx, torch.from_numpy(
                        ix.card[rows]).to(dev))
                    t.index_copy_(0, idx, torch.from_numpy(
                        ix.tombstone[rows]).to(dev))
                    self.sync_stats["scatters"] += 1
                    self.sync_stats["rows_scattered"] += len(rows)
                self._single = (ix.version, cap, tables)
                return tables
        pad = cap - n
        tables = (
            torch.from_numpy(np.pad(ix.graph_ids, ((0, pad), (0, 0)),
                                    constant_values=PAD_ID)).to(dev),
            torch.from_numpy(np.pad(ix.rev_ids, ((0, pad), (0, 0)),
                                    constant_values=PAD_ID)).to(dev),
            words_tensor(np.pad(ix.words, ((0, pad), (0, 0))), dev),
            torch.from_numpy(np.pad(ix.card, (0, pad))).to(dev),
            torch.from_numpy(np.pad(ix.tombstone, (0, pad))).to(dev),
        )
        self._single = (ix.version, cap, tables)
        self.sync_stats["full_uploads"] += 1
        return tables

    def _sync_sharded(self):
        from repro_torch.query.sharded import ShardedDescent

        if (self._sharded is None
                or self._sharded.n_shards != self.spec.placement):
            self._sharded = ShardedDescent(
                self.index, self.spec.placement,
                oversample=self.spec.shard_oversample,
                resident_configs=self.spec.resident_configs,
                device=self.device, devices=self.shard_devices)
        else:
            self.sync_stats[self._sharded.sync()] += 1
        return self._sharded

    def sharded_state(self, build: bool = True):
        """The delta-synced ShardedDescent, or None for the single
        placement. ``build=False`` only peeks: it returns the state as it
        stands (None until something built it) without building or
        syncing it."""
        if not build:
            return self._sharded
        return self._sync_sharded() if self.spec.placement > 1 else None

    def restore_sharded(self, base_plan) -> None:
        """Resume a frozen partition lineage (crash recovery): the sharded
        state extends ``base_plan`` over the current index instead of
        partitioning it afresh. A no-op unless the placement has
        ``base_plan.n_shards`` shards."""
        if self.spec.placement != base_plan.n_shards:
            return
        from repro_torch.query.sharded import ShardedDescent, extend_plan
        self._sharded = ShardedDescent(
            self.index, base_plan.n_shards,
            plan=extend_plan(base_plan, self.index),
            oversample=self.spec.shard_oversample,
            resident_configs=self.spec.resident_configs,
            device=self.device, devices=self.shard_devices)

    def _degraded(self) -> bool:
        """True while any shard is masked out of serving (the fault layer,
        ``faults/failover.py``). Completions in a degraded window carry
        ``req.degraded = True`` and are never cached."""
        sd = self._sharded
        return sd is not None and bool(sd.dead.any())

    def mask_shard_slots(self, down) -> None:
        """Wipe the in-flight slot beams of newly downed shards (bool[S]),
        in place on the device: their lanes drop to PAD / -inf, so a dead
        shard's beam from before the failure cannot win a release-time
        merge. The survivors' beams are untouched. No-op for wave plans
        and the single placement."""
        if self._slots is None or self.spec.placement <= 1:
            return
        down = np.asarray(down, dtype=bool)
        if not down.any():
            return
        st = self._slots
        self._sharded.mask_slots(st.parts, down)
        if self.spec.adaptive > 0:
            # The stored prefixes were taken on the whole fleet: restart
            # every streak rather than free a slot on such a comparison.
            st.streak[:] = 0
            st.fresh[:] = True

    def note_replan(self):
        """A re-balance swap replaced the shard partition
        (``query/rebalance.py``). No index content changed, so no journal
        shows it, but placement changes results: flush the cache. The
        flush count also keeps continuous requests admitted before the
        swap and completed after it out of the cache."""
        if self.cache is not None:
            self.cache.invalidate()

    # -- one closed wave -----------------------------------------------------

    def search(self, items, offsets, qgf, k: int, *,
               hops: int | None = None, placed=None):
        """Route + beam-descend already-fingerprinted query profiles (one
        closed wave, whatever the plan's batching; inserts search through
        it). ``placed`` reuses :func:`router.placements` already computed.

        With a result cache, exact-fingerprint hits are served from it
        (bitwise what the descent gives: the cache flushes on any index
        mutation the journals show) and only the misses route and descend.
        """
        hops = self.spec.hops if hops is None else hops
        if self.cache is None:
            with obs.span("serve.admit.route"):
                seeds = route(self.index, items, offsets,
                              self.spec.seeds_per_config, placed=placed)
            return self.descend_rows(qgf.words, qgf.card, seeds, k,
                                     hops=hops)
        self.cache.sync()
        qw, qc = qgf.words, qgf.card
        qn = qw.shape[0]
        keys = [self.cache.key(qw[i], qc[i], k, hops) for i in range(qn)]
        out_ids = np.empty((qn, k), np.int32)
        out_sims = np.empty((qn, k), np.float32)
        miss = []
        for i, cache_key in enumerate(keys):
            hit = self.cache.get(cache_key)
            if hit is None:
                miss.append(i)
            else:
                out_ids[i], out_sims[i] = hit
        if miss:
            m_items, m_offsets = _csr_subset(items, offsets, miss)
            m_placed = ([placed[i] for i in miss]
                        if placed is not None else None)
            with obs.span("serve.admit.route"):
                seeds = route(self.index, m_items, m_offsets,
                              self.spec.seeds_per_config, placed=m_placed)
            m_ids, m_sims = self.descend_rows(qw[miss], qc[miss], seeds, k,
                                              hops=hops)
            degraded = self._degraded()
            for j, i in enumerate(miss):
                out_ids[i], out_sims[i] = m_ids[j], m_sims[j]
                if degraded:
                    self.cache.degraded_skips += 1
                else:
                    self.cache.put(keys[i], m_ids[j], m_sims[j])
        return out_ids, out_sims

    def descend_rows(self, q_words, q_card, seeds, k: int, *,
                     hops: int | None = None, beam: int | None = None):
        """Beam-descend from explicit seed rows, with no routing; host
        arrays in and out. The lifecycle's updates and repairs seed it
        from a user's graph neighbourhood, with their own ``beam``."""
        with obs.span("serve.descend"):
            spec = self.spec
            beam = max(self.beam if beam is None else beam, k)
            hops = spec.hops if hops is None else hops
            dev = self.device
            if spec.placement > 1:
                sd = self._sync_sharded()
                ids, sims = sd.descend(q_words, q_card, seeds, k=k,
                                       beam=beam, hops=hops,
                                       kernel=spec.kernel, dma=spec.dma)
                self._note_stats(torch.from_numpy(sd.last_hop_stats))
                return ids.cpu().numpy(), sims.cpu().numpy()
            graph_ids, rev_ids, words, card, tomb = self.sync()
            ids, sims, stats = batched_descent(
                graph_ids, rev_ids, words, card, words_tensor(q_words, dev),
                torch.from_numpy(np.asarray(q_card, dtype=np.int32)).to(dev),
                torch.from_numpy(np.asarray(seeds, dtype=np.int32)).to(dev),
                k=k, beam=beam, hops=hops, kernel=spec.kernel,
                dma=spec.dma, tomb=tomb)
            self._note_stats(stats)
            return ids.cpu().numpy(), sims.cpu().numpy()

    def query_batch(self, profiles, k: int | None = None,
                    hops: int | None = None):
        """Answer raw profiles: (ids int32[q, k], sims float32[q, k])."""
        with obs.span("serve.admit.fingerprint"):
            items, offsets = profiles_to_csr(profiles)
            qgf = fingerprint_profiles(items, offsets, self.index.n_bits,
                                       self.index.fp_seed)
        return self.search(items, offsets, qgf, k or self.spec.k, hops=hops)

    # -- the serving loop ------------------------------------------------------

    @property
    def scheduler(self) -> Optional[SlotScheduler]:
        """The continuous slot scheduler (None for wave plans)."""
        return self._slots.sched if self._slots is not None else None

    def busy(self) -> bool:
        """True while this plan holds in-flight work (continuous slots)."""
        return self._slots is not None and self._slots.sched.has_work()

    def step(self, queue, done) -> int:
        """Serve one step, a wave or a continuous tick, from ``queue`` (a
        deque of requests); append the completed requests to ``done`` with
        results and ``t_done`` stamped; return how many completed."""
        if self.spec.batching == "continuous":
            return self._step_continuous(queue, done)
        return self._step_wave(queue, done)

    def _reject(self, shed, done) -> int:
        """Complete shed requests with the ``rejected`` marker: they enter
        ``done`` (counted, excluded from latency) with no result."""
        if not shed:
            return 0
        now = self.clock()
        for r in shed:
            r.status = "rejected"
            r.t_done = now
            done.append(r)
        return len(shed)

    def _step_wave(self, queue, done) -> int:
        """Close one wave. It runs to the largest hop budget of its
        members (one deep request convoys the shallow ones; per-slot
        budgets under continuous batching are the fix). Under slo
        admission the wave closes over the best (class, deadline)
        requests, and expired and overflow requests are shed."""
        spec = self.spec
        n_done = 0
        with obs.span("serve.schedule"):
            if spec.admission == "slo":
                wave, shed = shed_and_select(queue, spec.max_wave,
                                             self.clock(), spec.max_pending)
                n_done = self._reject(shed, done)
            else:
                wave = []
                while queue and len(wave) < spec.max_wave:
                    wave.append(queue.popleft())
            if not wave:
                return n_done
            self._note_admitted(wave)
        hops = max(r.hops if r.hops is not None else spec.hops
                   for r in wave)
        ids, sims = self.query_batch([r.profile for r in wave], hops=hops)
        with obs.span("serve.complete"):
            now = self.clock()
            degraded = self._degraded()
            for j, r in enumerate(wave):
                r.ids, r.sims = ids[j], sims[j]
                r.t_done = now
                r.status = "done"
                r.degraded = degraded
                done.append(r)
        return len(wave) + n_done

    def _note_admitted(self, reqs) -> None:
        """Stamp each request's ``t_admit``; while a profiler records, count
        the admissions and their seconds from submission to admission."""
        now = self.clock()
        for r in reqs:
            r.t_admit = now
        if obs.enabled():
            obs.count("serve.admitted", len(reqs))
            obs.count("serve.queue_wait_s",
                      sum(now - r.t_submit for r in reqs))

    # -- continuous batching ---------------------------------------------------

    def _slot_state(self) -> _SlotState:
        if self._slots is None:
            beam, sd = self.beam, None
            if self.spec.placement > 1:
                sd = self._sync_sharded()
                beam = sd.shard_beam(self.beam, self.spec.k)
            self._slots = _SlotState(self.index, self.spec, beam,
                                     self.device, self.clock, sd=sd)
        return self._slots

    def _slot_results(self, st: _SlotState):
        """(ids int32[n_slots, k], sims f32[n_slots, k]) host snapshots:
        the beam is sorted, so the top k is its prefix; under sharding the
        shards' prefixes merged in global ids
        (:meth:`ShardedDescent.slot_topk`)."""
        k = self.spec.k
        if self.spec.placement > 1:
            ids, sims = self._sharded.slot_topk(st.parts, k=k)
            return ids.cpu().numpy(), sims.cpu().numpy()
        p = st.parts[0]
        return (p.beam_ids[:, :k].cpu().numpy(),
                p.beam_sims[:, :k].cpu().numpy())

    def _admit(self, st: _SlotState, admitted, done) -> int:
        """Fingerprint, route and scatter one admission generation into
        the slot arrays.

        With a result cache each request is looked up first: a hit
        completes at once and releases its slot, which stays out of the
        scatter; only the misses are routed and scattered. Returns the
        hits, so the tick can admit into the slots they freed.
        """
        spec = self.spec
        dev = self.device
        with obs.span("serve.admit.fingerprint"):
            items, offsets = profiles_to_csr([r.profile for _, r in admitted])
            qgf = fingerprint_profiles(items, offsets, self.index.n_bits,
                                       self.index.fp_seed)
        qw, qc = qgf.words, qgf.card
        n_hit = 0
        if self.cache is None:
            rows = list(range(len(admitted)))
        else:
            with obs.span("serve.admit.cache"):
                rows = []
                now = self.clock()
                for j, (slot, req) in enumerate(admitted):
                    budget = req.hops if req.hops is not None else spec.hops
                    ck = self.cache.key(qw[j], qc[j], spec.k, budget)
                    hit = self.cache.get(ck)
                    if hit is not None:
                        st.sched.release(slot)
                        req.ids, req.sims = hit
                        req.t_done = now
                        req.status = "done"
                        done.append(req)
                        n_hit += 1
                    else:
                        # The completion is stored only if no flush fell
                        # while the request was in flight (flush count
                        # unchanged).
                        req._cache_key = ck
                        req._cache_flushes = self.cache.flushes
                        rows.append(j)
                if not rows:
                    return n_hit
                items, offsets = _csr_subset(items, offsets, rows)
                qw, qc = qw[rows], qc[rows]
        with obs.span("serve.admit.route"):
            seeds = route(self.index, items, offsets, spec.seeds_per_config)
        with obs.span("serve.admit.scatter"):
            slots = np.array([admitted[j][0] for j in rows], dtype=np.int64)
            for j in rows:
                slot, req = admitted[j]
                st.hops_done[slot] = 0
                st.budget[slot] = (req.hops if req.hops is not None
                                   else spec.hops)
                st.streak[slot] = 0
                st.fresh[slot] = True
            if spec.placement > 1:
                self._sync_sharded().slot_admit(st.parts, qw, qc, seeds,
                                                slots, beam=st.beam)
                return n_hit
            words, card, tomb = self.sync()[2:5]
            p = st.parts[0]
            slot_admit(words, card, words_tensor(qw, dev),
                       torch.from_numpy(np.asarray(qc, np.int32)).to(dev),
                       torch.from_numpy(np.asarray(seeds, np.int32)).to(dev),
                       torch.from_numpy(slots).to(dev), p.q_words, p.q_card,
                       p.beam_ids, p.beam_sims, beam=st.beam, tomb=tomb)
        return n_hit

    def _step_continuous(self, queue, done) -> int:
        """One continuous tick: admit into free slots, advance every
        in-flight beam one hop, complete the slots whose budget is spent
        or whose beam reached its fixed point (no later hop could change
        it, so the result is the full-budget one). Admission is
        mid-flight: rows freed by an earlier tick take fresh requests
        while the others keep descending, with no wave barrier.

        Returns the requests completed this tick: cache hits, rejections
        and descents. Only exact completions are cached (budget spent, or
        the full beam at its fixed point); an adaptive early free (top-k
        prefix stable for ``adaptive`` hops) is served but never stored,
        and neither is a result whose flight straddled a cache flush.
        """
        spec = self.spec
        with obs.span("serve.sync"):
            self.sync()  # mutations since the last tick reach this one's hop
            had_state = self._slots is not None
            st = self._slot_state()
            if spec.placement > 1:
                # A reshard or a re-balance swap since the last tick may
                # have relabelled shard-local ids; in-flight beams hold
                # local ids, so relabel them before the next hop.
                remap = self._sharded.take_beam_remap()
                if remap is not None and had_state:
                    # Lanes the map sends to PAD (rows a swap evicted from
                    # their shard) lose their sims; under the frozen-base
                    # extension no live lane maps to PAD.
                    self._sharded.remap_slots(st.parts, remap)
                    if spec.adaptive > 0:
                        # Stored prefixes hold the old local ids: restart
                        # every streak rather than compare across labels.
                        st.streak[:] = 0
                        st.fresh[:] = True
        sched = st.sched
        with obs.span("serve.schedule"):
            while queue:
                sched.submit(queue.popleft())
            if self.cache is not None:
                self.cache.sync()
            admitted = sched.admit()
            self._note_admitted([r for _, r in admitted])
        n_done = 0
        while admitted:
            freed = self._admit(st, admitted, done)
            n_done += freed
            if not freed:
                break
            # Cache hits released their slots: admit into them.
            with obs.span("serve.schedule"):
                admitted = sched.admit()
                self._note_admitted([r for _, r in admitted])
        with obs.span("serve.schedule"):
            n_done += self._reject(sched.drain_shed(), done)
            active = sched.active_mask()
        if not active.any():
            return n_done
        # Zero-budget slots never enter the hop (a hops=0 wave runs no
        # hop); they complete at the snapshot below.
        hop_active = active & (st.hops_done < st.budget)
        changed = np.zeros(active.shape[0], bool)
        if hop_active.any():
            with obs.span("serve.hop"):
                changed = self._hop(st, hop_active)
        with obs.span("serve.complete"):
            return n_done + self._complete(st, active, hop_active, changed,
                                           done)

    def _hop(self, st: _SlotState, hop_active: np.ndarray) -> np.ndarray:
        """Advance the ``hop_active`` slots one hop; fold the hop's counts
        into :attr:`descent_stats` and return ``changed`` (bool[n_slots]):
        the rows whose beam moved."""
        spec = self.spec
        if spec.placement > 1:
            sd = self._sync_sharded()
            changed_t, stats = sd.slot_hop(
                st.parts, hop_active, kernel=spec.kernel, dma=spec.dma)
            if spec.adaptive > 0:
                stable_t = sd.slot_prefix_stable(st.parts, k=spec.k)
        else:
            graph_ids, rev_ids, words, card, tomb = self.sync()
            p = st.parts[0]
            p.beam_ids, p.beam_sims, changed_t, stats = slot_hop(
                graph_ids, rev_ids, words, card, p.q_words, p.q_card,
                p.beam_ids, p.beam_sims,
                torch.from_numpy(hop_active).to(self.device),
                kernel=spec.kernel, dma=spec.dma, tomb=tomb)
            if spec.adaptive > 0:
                stable_t, p.prefix_ids = slot_prefix_stable(
                    p.beam_ids, p.prefix_ids, k=spec.k)
        # The hop's counts, `changed` and (adaptive) `stable` reach the
        # host in one copy.
        cols = [stats.to(torch.int32), changed_t[:, None].to(torch.int32)]
        if spec.adaptive > 0:
            cols.append(stable_t[:, None].to(torch.int32))
        host = torch.cat(cols, dim=1).cpu().numpy()
        # The hop ran every slot row; count only the active ones.
        self._note_stats(torch.from_numpy(host[hop_active, :3]))
        st.hops_done[hop_active] += 1
        self.n_ticks += 1
        if spec.adaptive > 0:
            # A slot's first hop compares against its previous occupant's
            # prefix: `fresh` keeps it out of the streak.
            gained = hop_active & host[:, 4].astype(bool) & ~st.fresh
            st.streak[gained] += 1
            st.streak[hop_active & ~gained] = 0
            st.fresh[hop_active] = False
        return host[:, 3].astype(bool)

    def _complete(self, st: _SlotState, active, hop_active, changed,
                  done) -> int:
        """Release the slots whose request finished this tick, their
        results stamped and appended to ``done``; returns how many."""
        spec = self.spec
        exact = (st.hops_done >= st.budget) | (hop_active & ~changed)
        finished = active & exact
        if spec.adaptive > 0:
            finished |= hop_active & (st.streak >= spec.adaptive)
        if not finished.any():
            return 0
        ids, sims = self._slot_results(st)
        now = self.clock()
        degraded = self._degraded()
        slots = np.flatnonzero(finished)
        for slot, req in zip(slots, st.sched.release_many(slots)):
            req.ids = ids[slot].copy()
            req.sims = sims[slot].copy()
            req.t_done = now
            req.status = "done"
            req.degraded = degraded
            done.append(req)
            if (self.cache is not None and exact[slot]
                    and getattr(req, "_cache_flushes", -1)
                    == self.cache.flushes):
                if degraded:
                    # A masked fleet's answer is not what a healthy descent
                    # gives: cached, it would outlive the failure window.
                    self.cache.degraded_skips += 1
                else:
                    self.cache.put(req._cache_key, req.ids, req.sims)
        return len(slots)
