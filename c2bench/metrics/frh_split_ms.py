"""Host ms a build spends in the recursive split of the t configurations and
the plan's assembly (``core/clustering.build_plan``: ``core/splitting``),
from the program's span ``clustering.split`` in the profiled build."""
LAYER = "clustering"
UNIT = "ms"
MOVES = "build_s"


def read(trace, ctx):
    from c2bench import program_spans

    return program_spans.span_ms(trace, "clustering.split", "build")
