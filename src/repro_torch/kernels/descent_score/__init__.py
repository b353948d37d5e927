"""Fused descent hop (serving's hot loop): ``ops`` + plain ``ref``, and the
DMA hop's launch parameters (``tune``)."""
from repro_torch.kernels.descent_score import ops, ref, tune  # noqa: F401
