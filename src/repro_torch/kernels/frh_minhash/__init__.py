"""Fused multi-seed FastRandomHash: ``ops`` + plain ``ref``."""
from repro_torch.kernels.frh_minhash import ops, ref  # noqa: F401
