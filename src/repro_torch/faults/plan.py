"""Deterministic, seeded fault injection at the plan-step boundary (a copy
of ``repro.faults.plan``).

Fault tolerance is only testable if the failures themselves are
reproducible, so every fault here is *scheduled*, never sampled at
serve time: a :class:`FaultPlan` is an explicit list of
:class:`FaultEvent` rows (parsed from a compact spec string or
generated from a seed), and a :class:`FaultInjector` replays it against
a monotone step counter that the engine advances once per scheduler
step (``engine.step → injector.begin_step → plan.step``). Running the
same plan against the same engine twice produces the same probe
outcomes, the same health transitions, and the same degraded answers —
which is what lets the test batteries pin failover behavior bitwise.

Event kinds:

* ``kill:S@T``      — shard S fails permanently from step T (until a
  failover rebuild clears it via :meth:`FaultInjector.clear_shard`);
* ``fail:S@T+D``    — shard S fails transiently for D steps starting
  at T, then comes back on its own (exercises the suspect → healthy
  path of the health machine without a rebuild);
* ``slow:S@T+D:MS`` — shard S is slow for D steps: MS milliseconds of
  injected latency per step (advances an injected ``ManualClock``
  (``repro_torch.sched``) deterministically, falls back to
  ``time.sleep`` on a real clock);
* ``crash@T``       — raise :class:`EngineCrash` at the *start* of
  step T, before any descent work: the crash always lands between
  scheduler steps, which is the granularity the WAL + snapshot
  recovery path guarantees consistency at.

Events are separated by ``;`` or ``,``: ``"fail:0@3+2;kill:1@8"``.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.faults.health import HealthConfig

KINDS = ("kill", "fail", "slow", "crash")

_EVENT_RE = re.compile(
    r"^(?:"
    r"kill:(?P<kshard>\d+)@(?P<kstep>\d+)"
    r"|fail:(?P<fshard>\d+)@(?P<fstep>\d+)\+(?P<fdur>\d+)"
    r"|slow:(?P<sshard>\d+)@(?P<sstep>\d+)\+(?P<sdur>\d+):(?P<sms>\d+(?:\.\d+)?)"
    r"|crash@(?P<cstep>\d+)"
    r")$")


class EngineCrash(RuntimeError):
    """Injected process death between scheduler steps.

    Raised by :meth:`FaultInjector.begin_step` before any work of the
    step runs. Whatever mutations the engine applied in earlier steps
    are already in the write-ahead log; in-flight continuous slots and
    the pending insert cohort are lost (documented failure model —
    clients re-submit), and ``QueryEngine.recover`` restores everything
    durable bitwise.
    """


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``step`` counts armed scheduler steps from
    0; ``duration`` is in steps (ignored for kill/crash); ``latency_s``
    is per-step injected latency (slow only)."""
    kind: str
    step: int
    shard: int = -1
    duration: int = 0
    latency_s: float = 0.0

    def active(self, step: int) -> bool:
        if self.kind == "kill":
            return step >= self.step
        if self.kind in ("fail", "slow"):
            return self.step <= step < self.step + self.duration
        return step == self.step  # crash

    def describe(self) -> str:
        if self.kind == "kill":
            return f"kill:{self.shard}@{self.step}"
        if self.kind == "fail":
            return f"fail:{self.shard}@{self.step}+{self.duration}"
        if self.kind == "slow":
            return (f"slow:{self.shard}@{self.step}+{self.duration}"
                    f":{self.latency_s * 1e3:g}")
        return f"crash@{self.step}"


@dataclass(frozen=True)
class FaultPlan:
    """An explicit, ordered fault schedule (pure data, reusable)."""
    events: tuple[FaultEvent, ...] = ()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse a compact spec: ``kill:S@T``, ``fail:S@T+D``,
        ``slow:S@T+D:MS``, ``crash@T``, separated by ``;`` or ``,``."""
        events = []
        for part in re.split(r"[;,]", spec):
            part = part.strip()
            if not part:
                continue
            m = _EVENT_RE.match(part)
            if m is None:
                raise ValueError(
                    f"bad fault event {part!r}; expected kill:S@T, "
                    f"fail:S@T+D, slow:S@T+D:MS or crash@T")
            g = m.groupdict()
            if g["kshard"] is not None:
                events.append(FaultEvent("kill", int(g["kstep"]),
                                         shard=int(g["kshard"])))
            elif g["fshard"] is not None:
                events.append(FaultEvent("fail", int(g["fstep"]),
                                         shard=int(g["fshard"]),
                                         duration=int(g["fdur"])))
            elif g["sshard"] is not None:
                events.append(FaultEvent("slow", int(g["sstep"]),
                                         shard=int(g["sshard"]),
                                         duration=int(g["sdur"]),
                                         latency_s=float(g["sms"]) / 1e3))
            else:
                events.append(FaultEvent("crash", int(g["cstep"])))
        return cls(events=tuple(sorted(events, key=lambda e: (e.step,
                                                              e.kind,
                                                              e.shard))))

    @classmethod
    def random(cls, n_shards: int, n_steps: int, seed: int,
               n_events: int = 3,
               kinds: Sequence[str] = ("kill", "fail", "slow")) -> "FaultPlan":
        """Seeded random schedule — same (seed, shape) ⇒ same plan."""
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_events):
            kind = kinds[int(rng.integers(len(kinds)))]
            step = int(rng.integers(1, max(2, n_steps)))
            if kind == "crash":
                events.append(FaultEvent("crash", step))
                continue
            shard = int(rng.integers(n_shards))
            dur = int(rng.integers(1, 5))
            if kind == "kill":
                events.append(FaultEvent("kill", step, shard=shard))
            elif kind == "fail":
                events.append(FaultEvent("fail", step, shard=shard,
                                         duration=dur))
            else:
                events.append(FaultEvent(
                    "slow", step, shard=shard, duration=dur,
                    latency_s=float(rng.integers(1, 20)) / 1e3))
        return cls(events=tuple(sorted(events, key=lambda e: (e.step,
                                                              e.kind,
                                                              e.shard))))

    def describe(self) -> str:
        return ";".join(e.describe() for e in self.events) or "(empty)"


@dataclass
class FaultInjector:
    """Replays a :class:`FaultPlan` against the engine's step counter.

    The engine calls :meth:`begin_step` once per scheduler step (before
    descent work) and the failover manager probes shard liveness with
    :meth:`shard_down`. ``armed=False`` constructs the injector inert —
    warm-up and pre-failure measurement run fault-free, then
    :meth:`arm` starts the schedule from step 0 (benchmarks use this so
    event steps count from the measured window, not from compilation
    waves).

    ``health`` carries the :class:`~repro_torch.faults.health.HealthConfig`
    the engine's failover manager should run with, so one CLI flag /
    one constructor argument configures the whole failure pipeline.
    """
    plan: FaultPlan
    clock: Optional[Callable[[], float]] = None
    armed: bool = True
    health: Optional[HealthConfig] = None
    step: int = field(default=-1, init=False)
    injected_latency_s: float = field(default=0.0, init=False)
    n_slow_steps: int = field(default=0, init=False)
    n_crashes: int = field(default=0, init=False)
    _cleared: set = field(default_factory=set, init=False)

    def arm(self) -> None:
        """(Re)start the schedule: step counting begins at the next
        ``begin_step`` and previously cleared events stay cleared only
        if they already fired — a fresh arm replays everything."""
        self.armed = True
        self.step = -1
        self._cleared.clear()

    def begin_step(self) -> None:
        """Advance the fault clock; raise :class:`EngineCrash` or
        inject slow-shard latency if the schedule says so."""
        if not self.armed:
            return
        self.step += 1
        lat = 0.0
        for ev in self.plan.events:
            if ev.kind == "crash" and ev.active(self.step):
                self.n_crashes += 1
                raise EngineCrash(
                    f"injected crash at step {self.step} "
                    f"({ev.describe()})")
            if ev.kind == "slow" and ev.active(self.step):
                lat += ev.latency_s
        if lat > 0.0:
            self.n_slow_steps += 1
            self.injected_latency_s += lat
            advance = getattr(self.clock, "advance", None)
            if advance is not None:
                advance(lat)
            else:
                time.sleep(lat)

    def shard_down(self, shard: int) -> bool:
        """Liveness probe: True while any uncleared kill or an active
        transient failure covers ``shard`` at the current step."""
        if not self.armed:
            return False
        for ev in self.plan.events:
            if ev.shard != shard:
                continue
            if ev.kind == "kill" and ev.active(self.step) \
                    and ev not in self._cleared:
                return True
            if ev.kind == "fail" and ev.active(self.step):
                return True
        return False

    def clear_shard(self, shard: int) -> None:
        """Failover completed: permanent kills of ``shard`` that already
        fired stop applying (a later kill event re-kills it)."""
        for ev in self.plan.events:
            if ev.kind == "kill" and ev.shard == shard \
                    and ev.step <= self.step:
                self._cleared.add(ev)

    def stats(self) -> dict:
        return {
            "plan": self.plan.describe(),
            "step": self.step,
            "armed": self.armed,
            "crashes": self.n_crashes,
            "slow_steps": self.n_slow_steps,
            "injected_latency_s": round(self.injected_latency_s, 6),
            "cleared": sorted(e.describe() for e in self._cleared),
        }
