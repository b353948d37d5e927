"""Host ms a build spends scattering Step 2's batch results into the
per-configuration arrays (``core/local_knn``), summed over the program's
``step2.scatter`` spans in the profiled build."""
LAYER = "step2"
UNIT = "ms"
MOVES = "build_s"


def read(trace, ctx):
    from c2bench import program_spans

    return program_spans.span_ms(trace, "step2.scatter", "build")
