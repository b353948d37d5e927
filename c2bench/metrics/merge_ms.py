"""Ms a build spends merging the t partial graphs
(``core/merge.merge_partial``), over the traced window's builds."""
LAYER = "merge"
UNIT = "ms"
MOVES = "build_s"


def read(trace, ctx):
    return trace.ms_per("merge", "build")
