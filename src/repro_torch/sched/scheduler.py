"""Slot-based continuous-batching scheduler with FIFO and SLO admission
(torch port of ``repro.sched.scheduler``), the maintenance
:class:`Cadence` and the injectable :class:`ManualClock`.

Wave batching closes a batch before admitting new requests, so one slow
request stalls everything queued behind it. Continuous batching bounds
that cost with *slots*: the descent always runs over a fixed array of
``n_slots`` rows, each slot carries one in-flight request, and a slot frees
the moment its request completes. Freed slots are refilled from the
pending queue mid-flight; admission never waits for the rest of the batch.

The scheduler is host bookkeeping: the pending queue, the slot → request
assignment and the active mask, with the invariants
:meth:`SlotScheduler.check_invariants` asserts:

* a slot is never double-assigned (``admit`` only hands out free slots);
* under FIFO, requests enter slots in submission order;
* every submitted request is admitted once and released once, or shed
  once (``n_submitted == n_admitted + len(pending) + n_shed``);
* the active mask equals the set of occupied slots.

Freed slots are reused lowest-index-first, so admission is a function of
the submit/complete interleaving alone, which is what makes the
continuous-vs-wave equivalence exact.

SLO admission (``policy="slo"``) layers priority classes and deadlines on
the same slots: requests may carry ``priority`` (int, 0 = highest class)
and ``deadline`` (absolute clock time, None = never expires), and
:meth:`SlotScheduler.admit` picks by class, then earliest deadline, then
submission order (:func:`shed_and_select`). Expired requests, and with
``max_pending`` > 0 the worst-ranked overflow, are shed into
:attr:`SlotScheduler.shed` for the engine to complete with a ``rejected``
marker. The FIFO path is the scheduler's behaviour without SLO.
"""
from __future__ import annotations

import heapq
import math
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np

ADMISSION_POLICIES = ("fifo", "slo")


def _priority_of(item: Any) -> int:
    """SLO class of a request (0 = highest); items without one are all
    top-class, which makes the slo policy deadline-then-FIFO."""
    p = getattr(item, "priority", 0)
    return 0 if p is None else int(p)


def _deadline_of(item: Any) -> float:
    """Absolute expiry time of a request; None (or absent) = +inf."""
    d = getattr(item, "deadline", None)
    return math.inf if d is None else float(d)


def shed_and_select(pending, n: int, now: float,
                    max_pending: int = 0) -> tuple[list, list]:
    """SLO admission over a pending queue: pick ``n``, shed the hopeless.

    ``pending`` (a deque or list in submission order, mutated in place) is
    split three ways: *expired* requests (deadline before ``now``) are
    shed; the best ``n`` survivors by (priority class, earliest deadline,
    submission order) are *selected*; with ``max_pending`` > 0 the
    worst-ranked survivors beyond that bound are shed as *overflow*.
    Returns ``(selected, shed)``; what remains in ``pending`` keeps
    submission order. Waves and the slot scheduler both admit through it.
    """
    shed: list = []
    keep: list[tuple[int, Any]] = []
    for seq, item in enumerate(pending):
        if _deadline_of(item) < now:
            shed.append(item)
        else:
            keep.append((seq, item))
    keep.sort(key=lambda si: (_priority_of(si[1]), _deadline_of(si[1]),
                              si[0]))
    selected = [item for _, item in keep[:n]]
    rest = keep[n:]
    if max_pending > 0 and len(rest) > max_pending:
        shed.extend(item for _, item in rest[max_pending:])
        rest = rest[:max_pending]
    rest.sort(key=lambda si: si[0])
    pending.clear()
    pending.extend(item for _, item in rest)
    return selected, shed


class ManualClock:
    """Deterministic clock for engines and schedulers: it moves only when
    :meth:`advance` is called, so latencies and deadline shedding are pure
    functions of the caller's script."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a clock backwards ({dt})")
        self.now += float(dt)
        return self.now


class Cadence:
    """Deterministic periodic trigger for between-step maintenance.

    Serving loops call :meth:`tick` once per scheduler step; it returns
    True every ``every``-th call, so the lifecycle's repair passes and the
    shard re-balancer land between steps and fire as a pure function of
    the step count. ``every <= 0`` disables the trigger.
    """

    def __init__(self, every: int):
        self.every = every
        self._count = 0
        self.n_fired = 0

    def tick(self) -> bool:
        """Advance one step; True when this step is a fire boundary."""
        if self.every <= 0:
            return False
        self._count += 1
        if self._count < self.every:
            return False
        self._count = 0
        self.n_fired += 1
        return True


class SlotScheduler:
    """Admission queue + fixed-capacity slot assignment.

    ``policy="fifo"`` admits in submission order with an unbounded queue.
    ``policy="slo"`` admits by (priority class, earliest deadline,
    submission order), sheds expired requests and, with ``max_pending`` >
    0, the worst-ranked overflow; shed items wait in :attr:`shed` until
    the engine drains them (:meth:`drain_shed`). ``clock`` (default
    ``time.perf_counter``) is the time deadlines are compared with.
    """

    def __init__(self, n_slots: int, *, policy: str = "fifo",
                 max_pending: int = 0,
                 clock: Optional[Callable[[], float]] = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"supported: {ADMISSION_POLICIES}")
        if max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        self.n_slots = n_slots
        self.policy = policy
        self.max_pending = max_pending
        self.clock = clock or time.perf_counter
        self.pending: deque[Any] = deque()
        self.shed: list[Any] = []  # the engine drains these (drain_shed)
        self._occupant: list[Optional[Any]] = [None] * n_slots
        self._free: list[int] = list(range(n_slots))  # min-heap
        self.n_submitted = 0
        self.n_admitted = 0
        self.n_completed = 0
        self.n_shed = 0

    def submit(self, item: Any):
        """Enqueue a request; it enters a slot at a later ``admit``."""
        self.pending.append(item)
        self.n_submitted += 1

    def admit(self) -> list[tuple[int, Any]]:
        """Move queued requests into free slots, lowest slot first: in
        submission order under FIFO; by (class, deadline, submission
        order) under SLO, which first sheds expired and overflow requests
        into :attr:`shed`. Returns the ``(slot, item)`` pairs admitted."""
        if self.policy == "slo":
            selected, shed = shed_and_select(
                self.pending, len(self._free), self.clock(),
                self.max_pending)
            self.n_shed += len(shed)
            self.shed.extend(shed)
            return [self._occupy(item) for item in selected]
        admitted: list[tuple[int, Any]] = []
        while self.pending and self._free:
            admitted.append(self._occupy(self.pending.popleft()))
        return admitted

    def _occupy(self, item: Any) -> tuple[int, Any]:
        slot = heapq.heappop(self._free)
        if self._occupant[slot] is not None:
            raise RuntimeError(f"slot {slot} double-assignment")
        self._occupant[slot] = item
        self.n_admitted += 1
        return slot, item

    def drain_shed(self) -> list[Any]:
        """Hand over every request shed since the last drain (the engine
        completes them with a rejected marker)."""
        out, self.shed = self.shed, []
        return out

    def release(self, slot: int) -> Any:
        """Free a slot whose request completed; returns the occupant."""
        item = self._occupant[slot]
        if item is None:
            raise RuntimeError(f"release of free slot {slot}")
        self._occupant[slot] = None
        heapq.heappush(self._free, slot)
        self.n_completed += 1
        return item

    def release_many(self, slots) -> list[Any]:
        """Free several completed slots; returns their occupants in the
        given slot order (one completion batch of a continuous tick)."""
        return [self.release(int(s)) for s in slots]

    def occupant(self, slot: int) -> Optional[Any]:
        """The request in ``slot``, or None when the slot is free."""
        return self._occupant[slot]

    @property
    def active_slots(self) -> list[int]:
        return [s for s, it in enumerate(self._occupant) if it is not None]

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    def active_mask(self) -> np.ndarray:
        """bool[n_slots]: True where a request is in flight."""
        return np.array([it is not None for it in self._occupant], dtype=bool)

    def has_work(self) -> bool:
        """True while anything is queued or in flight."""
        return bool(self.pending) or self.n_active > 0

    def check_invariants(self):
        """Structural consistency; raises AssertionError on a breach."""
        occupied = set(self.active_slots)
        free = set(self._free)
        if not occupied.isdisjoint(free):
            raise AssertionError(f"slots both free and occupied: "
                                 f"{occupied & free}")
        if occupied | free != set(range(self.n_slots)):
            raise AssertionError("a slot is neither free nor occupied")
        if len(self._free) != len(free):
            raise AssertionError("free-heap duplicate")
        if self.n_admitted != self.n_completed + self.n_active:
            raise AssertionError("admitted != completed + active")
        if self.n_submitted != (self.n_admitted + len(self.pending)
                                + self.n_shed):
            raise AssertionError("submitted != admitted + pending + shed")
