"""Ms an admitted query waited from its submission to the tick that took
it into a slot, from the program's counters over the profiled ticks
(``serve.queue_wait_s`` over ``serve.admitted``)."""
LAYER = "batching"
UNIT = "ms"
MOVES = "serve_qps"


def read(trace, ctx):
    from c2bench import program_spans

    return program_spans.counter_per(("serve.queue_wait_s",),
                                      "serve.admitted", 1e3)
