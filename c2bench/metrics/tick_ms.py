"""Host ms per ``QueryEngine.step`` (one continuous tick: admission with
routing and fingerprints, slot batching, the hop), over the traced window's
ticks that the profiler did not hold (those are ``tick.profiled``)."""
LAYER = "batching"
UNIT = "ms"
MOVES = "serve_qps"


def read(trace, ctx):
    return trace.ms_per("tick", "tick")
