"""Fingerprint kilobytes (1,000 bytes) that the DMA hop moved per query
completed in the window, from the plan's ``descent_stats`` counter read at the
window's edges."""
LAYER = "descent"
UNIT = "KB/query"
MOVES = "serve_qps"


def read(trace, ctx):
    c = trace.counters
    if not c.get("window_queries") or "dma_bytes_end" not in c:
        return None
    return ((c["dma_bytes_end"] - c["dma_bytes_start"])
            / c["window_queries"] / 1e3)
