"""Fault injection, degraded serving, failover, and crash recovery (torch
port of ``repro.faults``; host numpy and JSON around the sharded descent).

Submodules (importable individually to keep import graphs shallow):

* ``plan``     — :class:`FaultPlan` / :class:`FaultInjector` /
  :class:`EngineCrash`: seeded, scheduled faults at the plan-step
  boundary (``kill:S@T``, ``fail:S@T+D``, ``slow:S@T+D:MS``,
  ``crash@T``).
* ``health``   — per-shard health state machine (healthy → suspect →
  dead → recovering) with capped exponential-backoff probing.
* ``failover`` — :class:`FailoverManager`: masks dead shards out of
  serving, then swaps in a freshly derived partition.
* ``wal``      — :class:`WriteAheadLog` / :class:`CrashStore`: snapshot
  + journal replay, bitwise crash recovery.
"""
from repro_torch.faults.failover import FailoverManager
from repro_torch.faults.health import (DEAD, HEALTHY, RECOVERING, SUSPECT,
                                       FleetHealth, HealthConfig)
from repro_torch.faults.plan import (EngineCrash, FaultEvent, FaultInjector,
                                     FaultPlan)
from repro_torch.faults.wal import CrashStore, WriteAheadLog, replay

__all__ = [
    "EngineCrash", "FaultEvent", "FaultPlan", "FaultInjector",
    "HEALTHY", "SUSPECT", "DEAD", "RECOVERING",
    "HealthConfig", "FleetHealth", "FailoverManager",
    "WriteAheadLog", "CrashStore", "replay",
]
