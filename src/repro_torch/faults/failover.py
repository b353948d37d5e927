"""Degraded serving and failover for the sharded placement (torch port of
``repro.faults.failover``).

One manager per engine glues three mechanisms together around the
scheduler-step boundary:

* **Detection** (:meth:`FailoverManager.observe`, BEFORE the plan step)
  asks the injector which shards are down this step, feeds the per-shard
  health machine (healthy → suspect → dead, with capped exponential-
  backoff probing: ``faults/health.py``), and masks every non-healthy
  shard out of serving: its owned seeds are dropped
  (``ShardedDescent.set_dead``), its merge lanes are wiped, and its
  in-flight continuous beams are cleared
  (``DescentPlan.mask_shard_slots``), so the survivors keep answering
  with a bounded recall loss instead of the fleet stalling.
* **Recovery** (:meth:`FailoverManager.maintain`, AFTER lifecycle and
  re-balance maintenance): once a dead shard's ``recover_after`` dwell
  elapses, a fresh ``plan_shards`` partition is derived and
  :meth:`ShardedDescent.adopt_plan` blue/green-swaps it in between
  steps: beams remapped, the result cache flushed through
  ``note_replan``, as a re-balance swap does. The reference rebuilds
  the tables from the SURVIVORS' subgraphs; the port's host index holds
  the same rows in either shard layout, so the swap rebuilds from it and
  keeps the merge's audit with the unhealthy shards excluded
  (``rebalance.merge_audit``).
* **Isolation**: while any shard is unhealthy the re-balancer defers
  (``Rebalancer.check`` reads ``sd.dead``) and lifecycle maintenance
  stands down (``LifecycleManager.maintain`` reads the engine's
  ``degraded``): neither may bake degraded descents or a dead shard's
  tables into the graph.

The single placement has no shards to fail: the manager stays inert
(``active`` False) and every hook is a no-op.
"""
from __future__ import annotations

import numpy as np

from repro_torch.faults.health import FleetHealth, HealthConfig
from repro_torch.query.rebalance import merge_audit
from repro_torch.query.sharded import plan_shards


class FailoverManager:
    """Owns fleet health and the recovery swap for one DescentPlan."""

    def __init__(self, plan, injector):
        self.plan = plan
        self.injector = injector
        cfg = injector.health or HealthConfig()
        self.health = (FleetHealth(plan.spec.placement, cfg)
                       if plan.spec.placement > 1 else None)
        self.n_failovers = 0
        self.recovery_steps: list[int] = []
        self.last_merge_stats: dict = {}

    @property
    def active(self) -> bool:
        return self.health is not None

    @property
    def degraded(self) -> bool:
        """True while any shard is masked out of serving."""
        return self.active and bool(self.health.serving_mask().any())

    # -- before the plan step ------------------------------------------------

    def observe(self):
        """Probe the injector, advance health, mask unhealthy shards."""
        if not self.active:
            return
        h = self.health
        down = np.array([self.injector.shard_down(s)
                         for s in range(h.n_shards)], dtype=bool)
        h.observe(down)
        mask = h.serving_mask()
        sd = self.plan.sharded_state()
        if not np.array_equal(mask, sd.dead):
            newly = mask & ~sd.dead
            sd.set_dead(mask)
            if newly.any():
                # Wipe the downed shards' in-flight beams now: their
                # candidates came from tables no longer trusted.
                self.plan.mask_shard_slots(newly)

    # -- after lifecycle and re-balance maintenance ---------------------------

    def maintain(self):
        """Swap in a fresh partition for shards whose recovery dwell
        elapsed; returns the merge audit, or None when nothing fired."""
        if not self.active:
            return None
        h = self.health
        ready = h.ready_for_recovery()
        if not ready:
            return None
        for s in ready:
            h.mark_recovering(s)
        sd = self.plan.sharded_state()
        spec = self.plan.spec
        # The audit reads survivors only: every non-healthy shard (the
        # recovering ones included: theirs are the tables being replaced)
        # is excluded.
        exclude = np.flatnonzero(h.serving_mask())
        self.last_merge_stats = merge_audit(sd, exclude=exclude)
        new_plan = plan_shards(sd.index, spec.placement,
                               resident_configs=spec.resident_configs)
        sd.adopt_plan(new_plan)          # resets sd.dead to all False
        self.plan.note_replan()          # placement changed: flush the cache
        for s in ready:
            self.injector.clear_shard(s)
            self.recovery_steps.append(int(h.step - h.dead_since[s]))
            h.mark_healthy(s)
        self.n_failovers += 1
        # Shards still unhealthy after this swap (a second failure during
        # the first one's recovery) stay masked in the new generation.
        mask = h.serving_mask()
        if mask.any():
            sd.set_dead(mask)
            self.plan.mask_shard_slots(mask)
        return self.last_merge_stats

    def stats(self) -> dict:
        out = {
            "active": self.active,
            "failovers": self.n_failovers,
            "recovery_steps": list(self.recovery_steps),
        }
        if self.active:
            out.update(self.health.stats())
        if self.last_merge_stats:
            out["merge"] = dict(self.last_merge_stats)
        return out
