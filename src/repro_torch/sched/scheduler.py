"""Slot-based continuous-batching scheduler (the FIFO policy of
``repro.sched.scheduler``) and the maintenance :class:`Cadence`.

Wave batching closes a batch before admitting new requests, so one slow
request stalls everything queued behind it. Continuous batching bounds
that cost with *slots*: the descent always runs over a fixed array of
``n_slots`` rows, each slot carries one in-flight request, and a slot frees
the moment its request completes. Freed slots are refilled from the FIFO
queue mid-flight; admission never waits for the rest of the batch.

The scheduler is host bookkeeping: the pending FIFO, the slot → request
assignment and the active mask, with the invariants
:meth:`SlotScheduler.check_invariants` asserts:

* a slot is never double-assigned (``admit`` only hands out free slots);
* admission is FIFO: requests enter slots in submission order;
* every submitted request is admitted once and released once;
* the active mask equals the set of occupied slots.

Freed slots are reused lowest-index-first, so admission is a function of
the submit/complete interleaving alone, which is what makes the
continuous-vs-wave equivalence exact.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Any, Optional

import numpy as np

ADMISSION_POLICIES = ("fifo",)

_NOT_PORTED = ("SLO admission (policy='slo', max_pending) is ROADMAP queue 1 "
               "item 7")


class Cadence:
    """Deterministic periodic trigger for between-step maintenance.

    Serving loops call :meth:`tick` once per scheduler step; it returns
    True every ``every``-th call, so the lifecycle's repair passes land
    between steps and fire as a pure function of the step count.
    ``every <= 0`` disables the trigger.
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
    """Admission queue + fixed-capacity slot assignment, FIFO policy."""

    def __init__(self, n_slots: int, *, policy: str = "fifo",
                 max_pending: int = 0):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if policy == "slo" or max_pending > 0:
            raise NotImplementedError(_NOT_PORTED)
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"supported: {ADMISSION_POLICIES}")
        if max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        self.n_slots = n_slots
        self.pending: deque[Any] = deque()
        self._occupant: list[Optional[Any]] = [None] * n_slots
        self._free: list[int] = list(range(n_slots))  # min-heap
        self.n_submitted = 0
        self.n_admitted = 0
        self.n_completed = 0

    def submit(self, item: Any):
        """Enqueue a request; it enters a slot at a later ``admit``."""
        self.pending.append(item)
        self.n_submitted += 1

    def admit(self) -> list[tuple[int, Any]]:
        """Move queued requests into free slots, lowest slot first, in
        submission order. Returns the ``(slot, item)`` pairs admitted."""
        admitted: list[tuple[int, Any]] = []
        while self.pending and self._free:
            slot = heapq.heappop(self._free)
            if self._occupant[slot] is not None:
                raise RuntimeError(f"slot {slot} double-assignment")
            item = self.pending.popleft()
            self._occupant[slot] = item
            self.n_admitted += 1
            admitted.append((slot, item))
        return admitted

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
        if self.n_submitted != self.n_admitted + len(self.pending):
            raise AssertionError("submitted != admitted + pending")
