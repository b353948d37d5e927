"""Ms a build spends in Step 2 (``core/local_knn.local_knn`` over all t
configurations), host clock ending in a device synchronise, over the traced
window's builds."""
LAYER = "step2"
UNIT = "ms"
MOVES = "build_s"


def read(trace, ctx):
    return trace.ms_per("step2", "build")
