"""Host ms a tick spends routing admitted profiles to their seed candidates
(``query/router.route``), from the program's ``serve.admit.route`` spans
over the profiled ticks."""
LAYER = "admission"
UNIT = "ms"
MOVES = "serve_qps"


def read(trace, ctx):
    from c2bench import program_spans

    return program_spans.span_ms(trace, "serve.admit.route", "serve.step")
