"""The program's own spans and counters in a traced run.

``repro_torch.obs`` opens a ``repro_torch.<name>`` range at each layer
boundary of the build and serve paths while a profiler records, and
counts bytes copied, builds, steps and admissions. This module reads them
for the per-layer readers: the ranges from the capture's events (the
profiled build, or the profiled ticks), the counters from
``repro_torch.obs.counters()``. Where the program has no such span or
counter (a tree without ``repro_torch.obs``), every reader gets None and
nothing raises.

    python3 -m c2bench.program_spans --workload ml10M.build --seed 7

runs a cell's set-up and traced window on the card (no judge) and prints,
as one JSON line, the device's idle time in the capture by the innermost
program range around it, and the shares of it under a leaf (a range
other than the roots ``build`` and ``serve.step``), over the whole
capture and over the roots' time, and outside every program range.
"""
from __future__ import annotations

import bisect
import importlib

PREFIX = "repro_torch."
OUTSIDE = "outside"     # idle under no program range
ROOTS = ("build", "serve.step")


def ranges(events) -> list[tuple[str, float, float]]:
    """The program's ranges in the capture, host side, as (name without
    the prefix, start µs, end µs), ordered by start. A range that queued
    device work also shows on the device's timeline, as an annotation
    from the start of its first device operation to the end of its last;
    that copy is left out."""
    if not events:
        return []
    starts = {e.start_us for e in events if e.on_device}
    ends = {e.end_us for e in events if e.on_device}
    return sorted(
        ((e.name[len(PREFIX):], e.start_us, e.end_us) for e in events
         if not e.on_device and e.name.startswith(PREFIX)
         and not (e.start_us in starts and e.end_us in ends)),
        key=lambda r: (r[1], -r[2]))


def span_ms(trace, name: str, per: str) -> float | None:
    """Ms the program spent in span ``name`` over the capture, per span
    ``per`` (a root: ``build``, ``serve.step``); None where either never
    fired."""
    rs = ranges(trace.events)
    n = sum(1 for r in rs if r[0] == per)
    hits = [r[2] - r[1] for r in rs if r[0] == name]
    if not n or not hits:
        return None
    return sum(hits) / 1e3 / n


def counters() -> dict | None:
    """The program's counters (what ran while the profiler recorded);
    None where the program has none."""
    try:
        obs = importlib.import_module("repro_torch.obs")
    except ImportError:
        return None
    return obs.counters()


def counter_per(names, per: str, scale: float = 1.0) -> float | None:
    """Σ of the counters ``names`` over counter ``per``, times ``scale``;
    None where ``per`` or every one of ``names`` is missing or ``per`` is
    0."""
    c = counters()
    if not c or not c.get(per) or not any(n in c for n in names):
        return None
    return scale * sum(c.get(n, 0) for n in names) / c[per]


def idle_by_span(events, window_s: float) -> dict[str, float]:
    """Device idle seconds in the capture, by the innermost program range
    around each idle piece (``outside`` where none): each idle stretch is
    split at the ranges' edges. The capture runs from its first host event
    for ``window_s`` seconds, or to its last host event if later."""
    from c2bench import tracing

    rs = ranges(events)
    host = [e for e in events if not e.on_device]
    if not host:
        return {}
    t0 = min(e.start_us for e in host)
    t1 = max(t0 + window_s * 1e6, max(e.end_us for e in host))
    gaps, cur = [], t0
    for s, e in tracing.device_intervals(events) + [(t1, t1)]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    edges = sorted({t for r in rs for t in r[1:]})

    def label(t: float) -> str:
        best, width = OUTSIDE, None
        for name, s, e in rs:
            if s > t:
                break
            if t <= e and (width is None or e - s < width):
                best, width = name, e - s
        return best

    out: dict[str, float] = {}
    for s, e in gaps:
        lo, hi = bisect.bisect_right(edges, s), bisect.bisect_left(edges, e)
        cuts = edges[lo:hi]
        for a, b in zip([s] + cuts, cuts + [e]):
            name = label((a + b) / 2)
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    import time
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root / "src"), str(root)]
    from c2bench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    bench = harness.load_json(root / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.load_json(harness.BENCH / "configs"
                            / f"{cell['config']}.json")
    mix = harness.load_json(harness.BENCH / "traffic"
                            / f"{cell['traffic']}.json")
    driver = harness.make_driver(cell, cfg, mix, args.seed, args.device,
                                 trace=True)
    driver.setup()
    t0 = time.perf_counter()
    driver.window(args.seconds)
    window_s = time.perf_counter() - t0
    driver.release()
    tr = driver.ctx.trace
    rs = ranges(tr.events)
    idle = idle_by_span(tr.events, tr.window_s)
    counts: dict[str, int] = {}
    for name, _, _ in rs:
        counts[name] = counts.get(name, 0) + 1
    annotations = sum(1 for e in tr.events
                      if not e.on_device and e.name.startswith(PREFIX)) \
        - len(rs)
    total = sum(idle.values())
    inside = total - idle.get(OUTSIDE, 0.0)
    leaf = inside - sum(idle.get(r, 0.0) for r in ROOTS)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "window_s": window_s, "capture_s": tr.window_s,
                      "idle_s": idle, "idle_total_s": total,
                      "leaf_share": leaf / total if total else None,
                      "leaf_share_inside": leaf / inside if inside else None,
                      "outside_share": 1 - inside / total if total else None,
                      "spans": counts,
                      "device_annotations_left_out": annotations,
                      "counters": counters()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
