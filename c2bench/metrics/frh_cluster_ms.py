"""Host ms a build spends in FastRandomHash clustering and recursive
splitting (``core/clustering.build_plan``: ``core/hashing``,
``core/splitting``), over the traced window's builds."""
LAYER = "clustering"
UNIT = "ms"
MOVES = "build_s"


def read(trace, ctx):
    return trace.ms_per("frh_cluster", "build")
