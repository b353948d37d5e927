"""Ms per ``QueryEngine.step`` (one continuous tick: scheduling, admission,
the hop, completions, maintenance) inside the program, its own
``serve.step`` span over the profiled ticks: the benchmark's bookkeeping
around each step is left out."""
LAYER = "batching"
UNIT = "ms"
MOVES = "serve_qps"


def read(trace, ctx):
    from c2bench import program_spans

    return program_spans.span_ms(trace, "serve.step", "serve.step")
