"""Share of its roofline that the cluster-KNN kernel
(``csrc/goldfinger_knn.cu``) reached in the profiled build: the least time
of the build's member pairs and bytes (``c2bench/roofline.cluster_knn_work``,
counted on the reference's plan of the same dataset) over the kernel's device
time."""
LAYER = "kernels"
UNIT = "%"
MOVES = "build_s"


def read(trace, ctx):
    from c2bench import roofline, tracing

    if trace.events is None or "cluster_knn_ops" not in trace.counters:
        return None
    device_s = tracing.kernel_s(trace.events, "goldfinger_knn_kernel")
    if not device_s:
        return None
    return roofline.share(trace.counters["cluster_knn_ops"],
                          trace.counters["cluster_knn_bytes"], device_s)
