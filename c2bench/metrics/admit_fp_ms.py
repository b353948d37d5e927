"""Host ms a tick spends turning admitted profiles into CSR rows and
GoldFinger fingerprints (``query/router``: ``profiles_to_csr``,
``fingerprint_profiles``), from the program's
``serve.admit.fingerprint`` spans over the profiled ticks."""
LAYER = "admission"
UNIT = "ms"
MOVES = "serve_qps"


def read(trace, ctx):
    from c2bench import program_spans

    return program_spans.span_ms(trace, "serve.admit.fingerprint",
                                 "serve.step")
