"""Hand-written CUDA C++ kernels and their plain PyTorch versions.

Each kernel package has a ``ref`` module (the plain PyTorch version: what
CPU tensors run and what the kernel is checked against) and an ``ops``
module (the wrapper: CPU tensor → plain version, CUDA tensor → the kernel,
anything else raises). The sources live in ``repro_torch/csrc`` and are
built by :mod:`repro_torch.kernels.build`.
"""
