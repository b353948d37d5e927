"""Share of its roofline that the DMA descent hop
(``csrc/descent_hop_dma.cu``) reached over the profiled ticks: the least time
of the hops' work (``c2bench/roofline.hop_work`` on each hop's beams, counted
over the reference's index) over the kernel's device time."""
LAYER = "kernels"
UNIT = "%"
MOVES = "serve_qps"


def read(trace, ctx):
    from c2bench import roofline, tracing

    if trace.events is None or "hop_ops" not in trace.counters:
        return None
    device_s = tracing.kernel_s(trace.events, "descent_hop_dma_kernel")
    if not device_s:
        return None
    return roofline.share(trace.counters["hop_ops"],
                          trace.counters["hop_bytes"], device_s)
