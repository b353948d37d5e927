"""PyTorch + CUDA port of the C² KNN system.

A second package beside ``repro`` (the JAX reference): it builds C² KNN
graphs and serves beam-descent queries on one NVIDIA GPU, with the
cluster-KNN sweep and the fused descent hop as hand-written CUDA C++
kernels (``repro_torch/csrc``). It imports nothing of ``repro`` or JAX;
its tests hold it bitwise against the reference.
"""
