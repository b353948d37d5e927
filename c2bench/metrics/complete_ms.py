"""Ms a tick spends completing requests: the finished slots' results copied
to the host and each request stamped and released (``query/plan``), from
the program's ``serve.complete`` spans over the profiled ticks."""
LAYER = "batching"
UNIT = "ms"
MOVES = "serve_qps"


def read(trace, ctx):
    from c2bench import program_spans

    return program_spans.span_ms(trace, "serve.complete", "serve.step")
