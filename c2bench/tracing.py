"""Spans, counters and the device trace of a ``--trace 1`` run.

Spans are host-clock intervals that the benchmark records around its own
calls into the program's layers; each is also a ``record_function`` range,
so the profiler's timeline says what the host was doing while the device
sat idle. Counters are numbers the drivers note (work done, program
counters read at the window's edges). The device trace is one
``torch.profiler`` capture over a steady part of the window, reduced here
to plain event tuples that the per-layer readers and the result's
``breakdown`` read.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch

PREFIX = "c2bench."


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    start_us: float
    end_us: float
    on_device: bool

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


class Trace:
    """What a traced run recorded; per-layer readers take it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.spans: dict[str, list[float]] = {}
        self.counters: dict[str, float] = {}
        self.events: list[Event] | None = None
        self.window_s: float | None = None
        self.captures: list = []   # inputs a driver kept for a roofline

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """Time the block on the host clock; ``sync`` ends it with a device
        synchronise, so the span holds the device work it queued."""
        with torch.profiler.record_function(PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync:
                    self._sync()
                self.spans.setdefault(name, []).append(
                    time.perf_counter() - t0)

    def wrap(self, module, attr: str, name: str, sync: bool = False):
        """Replace ``module.attr`` by a version recorded as span ``name``;
        returns a function that puts the original back."""
        original = getattr(module, attr)

        def traced(*args, **kwargs):
            with self.span(name, sync=sync):
                return original(*args, **kwargs)

        setattr(module, attr, traced)
        return lambda: setattr(module, attr, original)

    def total_ms(self, name: str) -> float:
        return 1e3 * sum(self.spans.get(name, ()))

    def count(self, name: str) -> int:
        return len(self.spans.get(name, ()))

    def ms_per(self, name: str, per: str) -> float | None:
        """Ms of span ``name`` per span ``per``; None where either never
        fired (a layer the program no longer reaches through the wrapped
        name reads nothing, not 0)."""
        n = self.count(per)
        return self.total_ms(name) / n if n and self.count(name) else None

    def warm_profiler(self):
        """Start and stop the profiler once, so that its own start-up
        (seconds, the first time in a process) falls in set-up."""
        with self.profile():
            pass
        self.events = self.window_s = None

    @contextlib.contextmanager
    def profile(self):
        """Capture the device trace of the block (one capture a run)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            yield
            self._sync()
            self.window_s = time.perf_counter() - t0
        dev = torch.autograd.DeviceType.CUDA
        # A record_function range also shows on the device's timeline, as
        # a user annotation: it is no device work.
        self.events = [Event(e.name, e.time_range.start, e.time_range.end,
                             e.device_type == dev
                             and not getattr(e, "is_user_annotation", False)
                             and not e.name.startswith(PREFIX))
                       for e in prof.events()]


def device_intervals(events) -> list[tuple[float, float]]:
    """Device events merged into disjoint busy intervals (µs)."""
    spans = sorted((e.start_us, e.end_us) for e in events if e.on_device)
    merged: list[list[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(events) -> float:
    """Seconds in which at least one operation ran on the device."""
    return sum(e - s for s, e in device_intervals(events)) / 1e6


def kernel_s(events, name_part: str) -> float | None:
    """Device seconds of the kernels whose name contains ``name_part``;
    None where none ran."""
    hits = [e.us for e in events if e.on_device and name_part in e.name]
    return sum(hits) / 1e6 if hits else None


def top_device_ops(events, n: int = 10) -> list[list]:
    """The ``n`` device operations that took the most time: [name, s]."""
    tot: dict[str, float] = {}
    for e in events:
        if e.on_device:
            tot[e.name] = tot.get(e.name, 0.0) + e.us / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events, window_s: float, n: int = 10) -> list[list]:
    """Device idle time inside the capture, summed by what the host was
    doing: each idle stretch is split at the benchmark's span edges and
    each piece goes to the innermost span around it (``host: other``
    where none). The largest ``n`` totals: [name, s]."""
    ranges = sorted({(e.start_us, e.end_us, e.name[len(PREFIX):])
                     for e in events if not e.on_device
                     and e.name.startswith(PREFIX)})
    edges = sorted({t for r in ranges for t in r[:2]})
    busy = device_intervals(events)
    cpu = [e for e in events if not e.on_device]
    if not cpu:
        return []
    t0 = min(e.start_us for e in cpu)
    t1 = max(t0 + window_s * 1e6, max(e.end_us for e in cpu))
    gaps, cur = [], t0
    for s, e in busy + [(t1, t1)]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)

    def label(t: float) -> str:
        best, width = "host: other", None
        for rs, re_, name in ranges:
            if rs <= t <= re_ and (width is None or re_ - rs < width):
                best, width = name, re_ - rs
        return best

    tot: dict[str, float] = {}
    for s, e in gaps:
        cuts = edges[bisect.bisect_right(edges, s):bisect.bisect_left(edges, e)]
        for a, b in zip([s] + cuts, cuts + [e]):
            name = label((a + b) / 2)
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
