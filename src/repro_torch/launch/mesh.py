"""One card's published peaks, and the production mesh (counterpart of
``repro.launch.mesh``, whose constants are a TPU v5e's).

The port runs on one NVIDIA H100 SXM5 80GB. Its peaks, from NVIDIA's
H100 Tensor Core GPU data sheet (SXM form factor, dense rates, 700 W),
are the only hardware constants the roofline and the on-card bounds
use. f32 products run on the CUDA cores: the port keeps f32 operands in
full f32, with TF32 off, so TF32's rate is listed for the record only.
"""
from __future__ import annotations

# Dense tensor-core rates (FLOP/s; int8: operations/s).
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_TF32 = 495e12
PEAK_OPS_INT8 = 1979e12
# f32 outside the tensor cores (CUDA cores), FLOP/s.
PEAK_FLOPS_F32 = 67e12
# HBM3: bytes/s and capacity.
HBM_BW = 3.35e12
HBM_BYTES = 80e9

# The rate a dot product runs at, by its operands' dtype as
# ``op_analysis`` names it.
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float16": PEAK_FLOPS_BF16,
              "float32": PEAK_FLOPS_F32}


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 256- and 512-chip meshes have no one-card
    counterpart."""
    raise NotImplementedError(
        f"the production mesh (multi_pod={multi_pod}) spans many cards; "
        "the port runs on one H100 until ROADMAP item 5 (rest), the mesh")
