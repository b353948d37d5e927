"""Plan-driven query engine over a :class:`~repro_torch.query.index.KNNIndex`
(torch port of ``repro.query.engine``'s serving surface).

The engine is host bookkeeping around one
:class:`~repro_torch.query.plan.DescentPlan`: every request takes the path
``submit → plan.step → collect`` (a step is a closed wave, or a continuous
tick), and :meth:`QueryEngine.run` drains the queue and reports QPS and
latency percentiles with the reference's stats keys.
:meth:`QueryEngine.recall_vs_brute_force` scores served results against
the exact KNN over the index.

Online mutation: :meth:`QueryEngine.insert` searches for the new profile's
neighbours through the engine's own plan, appends its row to the index,
registers it with the router in each configuration's deepest matching
cluster, and adds it to a cohort that is re-clustered every
``QueryConfig.refresh_every`` inserts (:meth:`KNNIndex.refresh_cohort`).
Deletes, profile updates, TTL expiry and churn repair go through
:class:`~repro_torch.lifecycle.LifecycleManager`, whose ``maintain`` runs
after every step. The plan follows each mutation by a journal-driven row
scatter into its device tables.

``QueryConfig.shards`` > 1 serves the sharded placement
(``query/sharded.py``); with ``rebalance_every`` the engine's
:class:`~repro_torch.query.rebalance.Rebalancer` measures the shards'
imbalance after lifecycle maintenance and swaps in a fresh partition past
``rebalance_threshold``. SLO admission (``admission``, ``max_pending``,
per-request ``priority`` and ``deadline``), adaptive hop budgets and the
result cache are the plan's (``query/plan.py``). Every time stamp reads
the injectable ``clock``.

Faults (``repro_torch/faults``): ``faults=`` takes a
:class:`~repro_torch.faults.FaultInjector`, which brackets every step
(``begin_step`` first, which may raise ``EngineCrash``; the failover
manager's probe masks unhealthy shards before the plan step and swaps in
a fresh partition after maintenance), and completions served while a
shard is masked carry ``degraded``. ``store=`` takes a
:class:`~repro_torch.faults.CrashStore`: a snapshot at attach, the
index's mutations write-ahead logged, snapshots on its cadence after
every step; :meth:`QueryEngine.recover` rebuilds an engine from one.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.eval.metrics import knn_recall
from repro_torch.lifecycle import LifecycleConfig, LifecycleManager
from repro_torch.query.index import KNNIndex
from repro_torch.query.plan import DescentPlan, PlanSpec
from repro_torch.query.rebalance import RebalanceConfig, Rebalancer
from repro_torch.query.router import (fingerprint_profiles, placements,
                                      profiles_to_csr)
from repro_torch.query.search import exact_knn


@dataclasses.dataclass
class QueryRequest:
    rid: int
    profile: np.ndarray                  # int32[|P|] item ids
    hops: Optional[int] = None           # per-request hop budget
                                         # (None → QueryConfig.hops)
    priority: int = 0                    # SLO class (0 = highest; higher
                                         # classes are shed first)
    deadline: Optional[float] = None     # absolute clock() expiry (None =
                                         # never; expired pending requests
                                         # are shed under slo admission)
    # Filled by the engine:
    ids: Optional[np.ndarray] = None     # int32[k] neighbor ids
    sims: Optional[np.ndarray] = None    # float32[k] similarities
    t_submit: float = 0.0
    t_admit: float = 0.0                 # clock() when a wave or slot took it
    t_done: float = 0.0
    status: str = "pending"              # pending | done | rejected
    degraded: bool = False               # served while >=1 shard was
                                         # masked out (bounded recall
                                         # loss; never cached)

    @property
    def rejected(self) -> bool:
        """True when admission shed this request (deadline expired or
        queue overflow): it completed without a result."""
        return self.status == "rejected"

    @property
    def latency(self) -> Optional[float]:
        """Seconds from submit to completion, or None while unserved."""
        if self.t_done == 0.0 or self.t_submit == 0.0:
            return None
        return self.t_done - self.t_submit


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    k: int = 10                # neighbors returned per query
    beam: int = 32             # descent frontier width
    hops: int = 3              # descent depth
    max_wave: int = 256        # queries per wave
    shards: int = 1            # >1: LPT cluster shards + cross-shard merge
    shard_oversample: float = 1.5  # fleet frontier vs single-device beam
    seeds_per_config: int = 16 # routed seed candidates per hash config
    refresh_every: int = 64    # cohort size triggering re-clustering
    continuous: bool = False   # slot-based streaming admission (sched/)
    slots: int = 32            # in-flight capacity in continuous mode
    kernel: bool = False       # fused descent hop (scorer "pallas"):
                               # the CUDA kernel on a GPU; identical
                               # results to the plain hop
    dma: bool = False          # with kernel: the DMA hop (scorer
                               # "pallas_dma"); identical results, and
                               # reports fingerprint bytes moved/skipped
    ttl: int = 0               # lifecycle: ticks before an untouched row
                               # expires (0 = never)
    repair_every: int = 0      # lifecycle: churn-repair cadence in ticks
                               # (0 = off)
    admission: str = "fifo"    # "slo": priority classes + deadline-aware
                               # admission, explicit shedding (sched/)
    max_pending: int = 0       # pending-queue bound under slo admission
                               # (0 = unbounded; overflow is shed)
    adaptive: int = 0          # >0: free continuous slots once the top-k
                               # prefix held for this many hops
    cache: int = 0             # >0: fingerprint-keyed result-cache
                               # capacity (journal-invalidated)
    resident_configs: int = 0  # tiered residency: only clusters of the
                               # first m hash configurations contribute
                               # shard residents (0 = all t; shards > 1)
    rebalance_every: int = 0   # re-balance check cadence in scheduler
                               # steps (0 = off; shards > 1)
    rebalance_threshold: float = 1.25  # measured imbalance that triggers
                               # a blue/green plan swap

    def spec(self) -> PlanSpec:
        """Map the flags onto a validated plan on the three axes."""
        if self.dma and not self.kernel:
            raise ValueError(
                "dma selects the DMA placement of the fused kernel hop; it "
                "needs kernel=True")
        scorer = ("pallas_dma" if self.dma
                  else "pallas" if self.kernel else "jnp")
        return PlanSpec(placement=self.shards,
                        batching="continuous" if self.continuous else "wave",
                        scorer=scorer, k=self.k, beam=self.beam,
                        hops=self.hops, max_wave=self.max_wave,
                        slots=self.slots,
                        seeds_per_config=self.seeds_per_config,
                        shard_oversample=self.shard_oversample,
                        admission=self.admission,
                        max_pending=self.max_pending,
                        adaptive=self.adaptive, cache=self.cache,
                        resident_configs=self.resident_configs)


class QueryEngine:
    def __init__(self, index: KNNIndex, qc: QueryConfig | None = None, *,
                 device="cuda", clock=None, faults=None, store=None,
                 shard_devices=None):
        self.index = index
        self.qc = qc or QueryConfig()
        if self.qc.rebalance_every > 0 and self.qc.shards <= 1:
            raise ValueError(
                "rebalance_every re-balances the SHARD partition; the "
                "single placement has nothing to re-balance (use shards > 1)")
        # Injectable clock (a sched.ManualClock makes latencies and
        # deadline shedding deterministic).
        self.clock = clock or time.perf_counter
        self.plan = DescentPlan(index, self.qc.spec(), device=device,
                                clock=self.clock,
                                shard_devices=shard_devices)
        self.device = self.plan.device
        self.queue: deque[QueryRequest] = deque()
        self.done: list[QueryRequest] = []
        self.n_inserted = 0
        self.n_refreshes = 0
        self._cohort: list[tuple[int, np.ndarray]] = []  # (uid, profile)
        self.lifecycle = LifecycleManager(
            self, LifecycleConfig(ttl=self.qc.ttl,
                                  repair_every=self.qc.repair_every))
        self.rebalance = Rebalancer(
            self.plan, RebalanceConfig(
                every=self.qc.rebalance_every,
                threshold=self.qc.rebalance_threshold))
        # Fault pipeline: injector → health and failover → crash store.
        self.faults = faults
        self.failover = None
        if faults is not None:
            from repro_torch.faults.failover import FailoverManager
            self.failover = FailoverManager(self.plan, faults)
        self.store = store
        if store is not None:
            store.attach(self)

    def submit(self, req: QueryRequest):
        req.t_submit = self.clock()
        self.queue.append(req)

    @property
    def n_ticks(self) -> int:
        """Continuous ticks that ran a hop (0 for wave plans)."""
        return self.plan.n_ticks

    @property
    def degraded(self) -> bool:
        """True while the fleet serves with >=1 shard masked out."""
        return self.failover is not None and self.failover.degraded

    def busy(self) -> bool:
        """True while requests are queued or (continuous) in flight."""
        return bool(self.queue) or self.plan.busy()

    def query_batch(self, profiles, k: int | None = None,
                    hops: int | None = None):
        """Answer a batch of raw profiles: (ids int32[q, k], sims f32[q, k])."""
        return self.plan.query_batch(profiles, k=k, hops=hops)

    def sharded_state(self):
        """The plan's delta-synced ShardedDescent (built on demand), or
        None when it serves the single placement."""
        return self.plan.sharded_state()

    def step(self) -> int:
        """Serve one step, a wave or a continuous tick; returns requests
        completed. Lifecycle maintenance (TTL expiry, churn repair) runs
        after it, between steps, so in-flight slots never see a
        half-applied mutation; the shard re-balancer runs after it, so it
        measures the step's mutations and any swap lands before the next
        step.

        The fault pipeline brackets all of it: the injector's
        ``begin_step`` first (a ``crash@T`` lands before any work of step
        T, the boundary the WAL is consistent at), then the failover probe
        masks newly unhealthy shards before the plan step; the failover
        swap and the crash store run last, so they see the step's
        mutations journaled."""
        with obs.span("serve.step"):
            obs.count("serve.steps", 1)
            if self.faults is not None:
                with obs.span("serve.maintain"):
                    self.faults.begin_step()  # may raise EngineCrash
                    if self.failover is not None:
                        self.failover.observe()
            n = self.plan.step(self.queue, self.done)
            with obs.span("serve.maintain"):
                self.lifecycle.maintain()
                self.rebalance.maintain()
                if self.failover is not None:
                    self.failover.maintain()
                if self.store is not None:
                    self.store.maintain(self)
        return n

    def tick(self) -> int:
        """One continuous tick (the step of a slot plan)."""
        if not self.qc.continuous:
            raise ValueError("tick() is the continuous step; this engine "
                             f"serves {self.plan.describe()}")
        return self.step()

    def run(self, on_tick=None) -> dict:
        """Drain the queue through the plan; returns aggregate stats.

        ``on_tick`` (continuous plans only): ``f(engine, tick)`` called
        between steps, e.g. to submit arrivals while slots are in flight.
        """
        t0 = self.clock()
        n_steps = 0
        n_new_done = 0
        continuous = self.qc.continuous
        while self.busy():
            if continuous and on_tick is not None:
                on_tick(self, n_steps)
            n_new_done += self.step()
            n_steps += 1
        dt = max(self.clock() - t0, 1e-9)
        recent = self.done[-n_new_done:] if n_new_done else []
        # Latency covers served requests only: a shed request's interval
        # is queueing, not service.
        lats = [r.latency for r in recent
                if r.status == "done" and r.latency is not None]
        n_shed = sum(1 for r in recent if r.rejected)
        stats = {
            "requests": n_new_done,
            "served": n_new_done - n_shed,
            "shed": n_shed,
            "mode": "continuous" if continuous else "wave",
            "plan": self.plan.describe(),
            "waves": n_steps,
            "qps": (n_new_done - n_shed) / dt,
            "mean_latency_s": float(np.mean(lats)) if lats else 0.0,
            "p50_latency_s": float(np.percentile(lats, 50)) if lats else 0.0,
            "p95_latency_s": float(np.percentile(lats, 95)) if lats else 0.0,
            "inserted": self.n_inserted,
            "shards": self.qc.shards,
            "refreshes": self.n_refreshes,
            "lifecycle": self.lifecycle.stats(),
        }
        if self.plan.spec.kernel:
            stats["descent"] = dict(self.plan.descent_stats)
        if self.plan.cache is not None:
            stats["cache"] = self.plan.cache.stats()
        if self.rebalance.active:
            stats["rebalance"] = self.rebalance.stats()
        if self.faults is not None:
            faults = dict(self.faults.stats())
            if self.failover is not None:
                faults.update(self.failover.stats())
            faults["degraded_served"] = sum(1 for r in recent if r.degraded)
            stats["faults"] = faults
        if self.store is not None:
            stats["store"] = self.store.stats()
        return stats

    # -- online insertion --------------------------------------------------

    def insert(self, profile) -> int:
        """Add a new user online; returns its id in the index.

        Links the user through its own search result (k neighbours,
        searched through this engine's plan), then registers it in each
        configuration's deepest matching cluster so later queries seed
        from it.
        """
        ix = self.index
        items, offsets = profiles_to_csr([profile])
        qgf = fingerprint_profiles(items, offsets, ix.n_bits, ix.fp_seed)
        placed = placements(ix, items, offsets)
        ids, sims = self.plan.search(items, offsets, qgf, ix.k,
                                     placed=placed)
        u = ix.append_user(np.asarray(qgf.words)[0], int(qgf.card[0]),
                           ids[0], sims[0])
        for matched in placed[0]:
            if matched:  # deepest matching cluster of this configuration
                ix.add_cluster_member(matched[0], u)
        self.n_inserted += 1
        self._cohort.append((u, items[offsets[0]:offsets[1]].copy()))
        self.lifecycle.note_insert(u)
        if len(self._cohort) >= self.qc.refresh_every:
            self.flush_cohort()
        return u

    def flush_cohort(self) -> int:
        """Re-run C² clustering on the accumulated insert cohort (see
        :meth:`KNNIndex.refresh_cohort`); returns new clusters registered."""
        if not self._cohort:
            return 0
        uids = np.array([u for u, _ in self._cohort], dtype=np.int32)
        items, offsets = profiles_to_csr([p for _, p in self._cohort])
        n_new = self.index.refresh_cohort(items, offsets, uids)
        self._cohort = []  # drained only after the refresh succeeded
        self.n_refreshes += 1
        return n_new

    # -- lifecycle (deletes / updates / TTL — repro_torch/lifecycle) -------

    def remove_user(self, u: int):
        """Delete user ``u`` online: tombstone, patch incident edges,
        deregister from routing. Queries in flight and later never see it
        (the tombstone mask is threaded through every hop)."""
        self.lifecycle.remove(u)

    def update_user(self, u: int, profile):
        """Replace ``u``'s profile online: re-sketch, re-score incident
        edges, and re-link through a neighbourhood descent."""
        return self.lifecycle.update(u, profile)

    def touch(self, u: int):
        """Record activity on ``u`` (resets its TTL window)."""
        self.lifecycle.touch(u)

    # -- crash recovery (snapshot + WAL replay: repro_torch/faults/wal) -----

    @classmethod
    def recover(cls, path, qc: QueryConfig | None = None, *, device="cuda",
                clock=None, faults=None, store=None,
                shard_devices=None) -> "QueryEngine":
        """Rebuild an engine from a :class:`~repro_torch.faults.CrashStore`
        directory (written by either package): load the last snapshot,
        replay the WAL suffix, and, for a sharded config whose shard count
        matches the store's, restore the frozen base plan from its sidecar,
        so the partition extends the same lineage the crashed engine was
        on (``extend_plan`` of the restored base over the replayed index
        lands where the live plan was). ``store`` re-attaches persistence
        after the plan restore: the recovered engine's first act is a fresh
        snapshot, so a second crash replays from there.
        """
        from repro_torch.faults.wal import CrashStore
        index, base_plan, manifest = CrashStore.load(path)
        eng = cls(index, qc, device=device, clock=clock, faults=faults,
                  shard_devices=shard_devices)
        eng.lifecycle.clock = int(manifest.get("lifecycle_clock", 0))
        if base_plan is not None:
            eng.plan.restore_sharded(base_plan)
        if store is not None:
            eng.store = store
            store.attach(eng)  # snapshot after the plan restore
        return eng

    # -- quality -----------------------------------------------------------

    def recall_vs_brute_force(self, requests: list[QueryRequest] | None = None,
                              ) -> float:
        """Mean recall@k of served results vs brute force over the index.

        Unserved requests are excluded; results are grouped by their k and
        each group is scored against its own brute-force truth.
        """
        reqs = requests if requests is not None else self.done
        reqs = [r for r in reqs if r.ids is not None]
        if not reqs:
            return 0.0
        by_k: dict[int, list[QueryRequest]] = {}
        for r in reqs:
            by_k.setdefault(len(r.ids), []).append(r)
        total = 0.0
        for k, group in sorted(by_k.items()):
            items, offsets = profiles_to_csr([r.profile for r in group])
            qgf = fingerprint_profiles(items, offsets, self.index.n_bits,
                                       self.index.fp_seed)
            exact_ids, _ = exact_knn(self.index.words, self.index.card,
                                     qgf.words, qgf.card, k,
                                     tomb=self.index.tombstone,
                                     device=self.device)
            total += knn_recall(np.stack([r.ids for r in group]),
                                exact_ids) * len(group)
        return total / len(reqs)
