"""Ms a tick spends from the slot hop's launch to its counts on the host
(``query/plan``: ``slot_hop`` and the hop's statistics), from the
program's ``serve.hop`` spans over the profiled ticks."""
LAYER = "descent"
UNIT = "ms"
MOVES = "serve_qps"


def read(trace, ctx):
    from c2bench import program_spans

    return program_spans.span_ms(trace, "serve.hop", "serve.step")
