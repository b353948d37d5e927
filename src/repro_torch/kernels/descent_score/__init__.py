"""Fused descent hop (serving's hot loop): ``ops`` + plain ``ref``."""
from repro_torch.kernels.descent_score import ops, ref  # noqa: F401
