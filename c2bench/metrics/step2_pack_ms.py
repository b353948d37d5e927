"""Ms a build spends packing Step 2's batches: each batch's member matrix and
its device inputs (``core/local_knn``: ``member_matrix``,
``batch_inputs``), summed over the program's ``step2.pack`` spans in the
profiled build."""
LAYER = "step2"
UNIT = "ms"
MOVES = "build_s"


def read(trace, ctx):
    from c2bench import program_spans

    return program_spans.span_ms(trace, "step2.pack", "build")
