"""Background shard re-balance: a blue/green plan swap of the shard
tables (torch port of ``repro.query.rebalance``).

The frozen-base shard plan never re-balances: ``extend_plan`` sends new
clusters round-robin and new users to ``u % S``, so the measured
imbalance (max/mean resident cluster mass per shard) drifts under
sustained inserts. This module closes that gap without taking the index
offline:

* **Trigger.** A :class:`~repro_torch.sched.Cadence` fires every
  ``RebalanceConfig.every`` scheduler steps, between steps as lifecycle
  maintenance does; each firing measures the imbalance from the CURRENT
  cluster sizes (the delta sync leaves ``ShardPlan.imbalance`` stale).
* **Re-derive.** Past ``RebalanceConfig.threshold``, a fresh
  :func:`~repro_torch.query.sharded.plan_shards` is derived from the
  current index (the LPT packing a cold start would get, tiered residency
  included).
* **Rebuild and merge audit.** The reference rebuilds the new shard
  tables from the OLD shard tables' rows by symmetric merge ("On the
  Merge of k-NN Graph", Zhao et al.): every shard's local row is the
  global row with non-resident lanes dropped to PAD, so uniting the
  copies of all shards hosting a user gives back the global row lane by
  lane, and lanes no shard kept (an edge whose endpoints never shared a
  shard) are patched from the index. The port keeps the host index
  beside the shard tables in both layouts (stacked on one device, or one
  device per shard), and the index holds that merged content already, so
  the swap rebuilds from the index and reads no table back from a device.
  :func:`merge_audit` counts, from the old partition's residency alone,
  the lanes the merge would have had to patch (``merge_coverage``), with
  the reference's figures.
* **Swap.** :meth:`ShardedDescent.adopt_plan` installs plan, tables and
  the old → new local-id beam map in one host-side call between steps:
  in-flight continuous slots keep descending (rows evicted from their
  shard drop to PAD with their sims masked). The plan's result cache is
  flushed (``DescentPlan.note_replan``): a swap changes no index content,
  so no journal shows it, but placement changes results.

While any shard is dead (``ShardedDescent.dead``, set by the fault
layer's ``faults/failover.py``) a check is deferred and counted
(``deferred``); the failover's own swap audits the merge with the
unhealthy shards excluded (:func:`merge_audit` ``exclude=``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.distributed import lpt_loads
from repro_torch.query.sharded import ShardedDescent, ShardPlan, plan_shards
from repro_torch.sched import Cadence
from repro_torch.types import PAD_ID


@dataclasses.dataclass(frozen=True)
class RebalanceConfig:
    """Knobs of the background re-balancer (from the engine's config)."""

    every: int = 0          # check cadence in scheduler steps (0 = off)
    threshold: float = 1.25  # measured imbalance that triggers a swap


def measured_imbalance(index, plan: ShardPlan) -> float:
    """Max/mean resident cluster mass per shard at CURRENT sizes.
    Non-resident configurations under tiered residency carry no rows and
    no load."""
    sizes = index.cluster_sizes().astype(np.float64)
    if plan.resident_configs:
        sizes = np.where(
            np.asarray(index.cluster_config) < plan.resident_configs,
            sizes, 0.0)
    nc = min(len(sizes), len(plan.cluster_shard))
    loads = lpt_loads(sizes[:nc], plan.cluster_shard[:nc], plan.n_shards)
    return float(loads.max() / max(loads.mean(), 1e-9))


def merge_audit(sd: ShardedDescent, exclude=()) -> dict:
    """The merge audit of the (synced) shard partition: how much of the
    index's adjacency a symmetric merge of the shard tables recovers.

    A shard's copy of lane ``u → v`` holds ``v`` exactly when both ``u``
    and ``v`` are resident there, so the lanes the merge must patch from
    the index are those whose endpoints share no shard. Read from the
    residency (``g2l``) on the host, never from the device tables.
    Returns ``rows``, ``lanes``, ``lanes_patched`` and ``merge_coverage``,
    the recovered share of the index's lanes.

    ``exclude`` names shards whose tables the merge must not read (the
    failover passes the unhealthy set): their residency is dropped, and
    rows resident on no other shard are counted as ``rows_unseen`` (the
    reference patches them whole from the index) beside the sorted
    ``excluded`` shards. With an empty ``exclude`` the residency must
    cover every user.
    """
    ix = sd.index
    n = ix.n
    exclude = frozenset(int(s) for s in exclude)
    on = sd._g2l[:, :n] != PAD_ID  # [S, n] residency
    if exclude:
        on[sorted(exclude)] = False
    elif not on.any(axis=0).all():
        raise AssertionError("shard residency no longer covers every user")
    total = patched = 0
    for ids in (ix.graph_ids, ix.rev_ids):
        live = ids != PAD_ID
        safe = np.where(live, ids, 0)
        kept = np.zeros(ids.shape, dtype=bool)
        for s in range(on.shape[0]):
            kept |= on[s][:, None] & on[s][safe]
        total += int(live.sum())
        patched += int((live & ~kept).sum())
    stats = {
        "rows": int(n),
        "lanes": total,
        "lanes_patched": patched,
        "merge_coverage": round(1.0 - patched / max(total, 1), 4),
    }
    if exclude:
        stats["excluded"] = sorted(exclude)
        stats["rows_unseen"] = int((~on.any(axis=0)).sum())
    return stats


class Rebalancer:
    """Cadence-gated background re-balancer owned by a QueryEngine.

    ``maintain()`` runs after every scheduler step, after lifecycle
    maintenance, so the step's mutations are journaled and measured. It
    does nothing for the single placement or while the cadence is cold; a
    firing measures the imbalance and swaps only past the threshold.
    ``swap()`` may also be called directly, to force a swap.
    """

    def __init__(self, plan, cfg: RebalanceConfig):
        self.plan = plan        # the DescentPlan (owns the sharded state)
        self.cfg = cfg
        self.cadence = Cadence(cfg.every)
        self.n_checks = 0
        self.n_swaps = 0
        self.n_deferred = 0  # checks skipped while a shard is dead
        self.last_imbalance: float | None = None
        self.merge_stats: dict = {}

    @property
    def active(self) -> bool:
        return self.cfg.every > 0 and self.plan.spec.placement > 1

    def maintain(self) -> float | None:
        """One between-steps tick; returns the post-swap imbalance when a
        swap fired, else None."""
        if not self.active or not self.cadence.tick():
            return None
        return self.check()

    def check(self) -> float | None:
        """Measure the imbalance; swap past the threshold."""
        sd = self.plan.sharded_state()  # delta sync: journals consumed
        if sd.dead.any():
            # Degraded fleet: a swap would reset the dead mask and rebuild
            # around a shard the failover manager owns. Re-balancing
            # resumes once every shard is healthy again.
            self.n_deferred += 1
            return None
        imb = measured_imbalance(sd.index, sd.plan)
        self.n_checks += 1
        self.last_imbalance = imb
        sd.plan.imbalance = imb  # refresh the delta path's stale figure
        if imb <= self.cfg.threshold:
            return None
        return self.swap(sd)

    def swap(self, sd: ShardedDescent | None = None) -> float:
        """Blue/green swap to a fresh ``plan_shards`` partition; returns
        the new plan's imbalance."""
        spec = self.plan.spec
        if sd is None:
            sd = self.plan.sharded_state()
        new_plan = plan_shards(sd.index, spec.placement,
                               resident_configs=spec.resident_configs)
        self.merge_stats = merge_audit(sd)
        sd.adopt_plan(new_plan)
        self.plan.note_replan()  # placement changed: flush cached results
        self.n_swaps += 1
        self.last_imbalance = new_plan.imbalance
        return new_plan.imbalance

    def stats(self) -> dict:
        out = {
            "every": self.cfg.every,
            "threshold": self.cfg.threshold,
            "checks": self.n_checks,
            "swaps": self.n_swaps,
            "deferred": self.n_deferred,
            "imbalance": (round(self.last_imbalance, 4)
                          if self.last_imbalance is not None else None),
        }
        if self.merge_stats:
            out["merge"] = dict(self.merge_stats)
        return out
