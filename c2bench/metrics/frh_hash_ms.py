"""Host ms a build spends hashing items and users under the t FastRandomHash
functions (``core/clustering.build_plan``: ``core/hashing``), from the
program's span ``clustering.hash`` in the profiled build."""
LAYER = "clustering"
UNIT = "ms"
MOVES = "build_s"


def read(trace, ctx):
    from c2bench import program_spans

    return program_spans.span_ms(trace, "clustering.hash", "build")
