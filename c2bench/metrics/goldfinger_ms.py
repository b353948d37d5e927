"""Host ms a build spends making the GoldFinger fingerprints
(``sketch/goldfinger.fingerprint_dataset``), over the traced window's builds."""
LAYER = "sketch"
UNIT = "ms"
MOVES = "build_s"


def read(trace, ctx):
    return trace.ms_per("goldfinger", "build")
