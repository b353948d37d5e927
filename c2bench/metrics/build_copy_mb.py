"""Megabytes (10^6 bytes) a build copies between host and device: Step 2's
and the merge's uploads and read-backs, each counted by the program where
it copies (``step2.h2d_bytes``, ``step2.d2h_bytes``, ``merge.h2d_bytes``,
``merge.d2h_bytes``), over its ``build.calls``, in the profiled build."""
LAYER = "copies"
UNIT = "MB"
MOVES = "build_s"


def read(trace, ctx):
    from c2bench import program_spans

    return program_spans.counter_per(
        ("step2.h2d_bytes", "step2.d2h_bytes", "merge.h2d_bytes",
         "merge.d2h_bytes"), "build.calls", 1e-6)
