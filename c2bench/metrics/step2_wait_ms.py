"""Ms a build spends from each cluster-KNN call to its results on the host
(``core/local_knn``: ``cluster_knn`` and the copy back), summed over the
program's ``step2.wait`` spans in the profiled build."""
LAYER = "step2"
UNIT = "ms"
MOVES = "build_s"


def read(trace, ctx):
    from c2bench import program_spans

    return program_spans.span_ms(trace, "step2.wait", "build")
