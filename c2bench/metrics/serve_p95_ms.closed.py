"""The 95th percentile of the latencies of the queries submitted and
completed in the traced window, each from submission to completion, under
the closed loop: about three ticks, so it follows the tick time. Queries in
flight while the profiler ran are left out: its cost is no serving time."""
LAYER = "batching"
UNIT = "ms"
MOVES = "serve_qps"


def read(trace, ctx):
    return trace.counters.get("serve_p95_ms")
