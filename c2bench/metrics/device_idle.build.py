"""Percent of the profiled build in which no operation ran on the device."""
LAYER = "device"
UNIT = "%"
MOVES = "build_s"


def read(trace, ctx):
    from c2bench import tracing

    if not trace.events or not trace.window_s:
        return None
    busy = tracing.busy_s(trace.events)
    return 100.0 * (1.0 - busy / trace.window_s) if busy else None
