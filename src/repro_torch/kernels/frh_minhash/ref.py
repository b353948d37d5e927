"""Plain PyTorch version of the FastRandomHash kernel
(``csrc/frh_minhash.cu``), the counterpart of
``repro.kernels.frh_minhash.ref``.

torch's uint32 has no ``>>`` or ``min`` on the CPU, so the murmur3
finalizer runs in int64 holding uint32 values: every shift and xor stays
inside 32 bits, and each multiply by a 32-bit constant is split so no
product leaves int64 before it is masked back to 32 bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import NO_HASH
from repro_torch.types import PAD_ID

_M32 = 0xFFFF_FFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 x holding uint32 values and a 32-bit c."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EB_CA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2_AE35)
    return x ^ (x >> 16)


def minhash_ref(padded_items: torch.Tensor, seeds, b: int) -> torch.Tensor:
    """H_i(u) for every (user, seed): int32[n, t].

    padded_items int32[n, P] (PAD_ID padded); seeds int32[t] (a tensor or
    a sequence); b the hash space size. Empty profiles yield NO_HASH.
    """
    dev = padded_items.device
    items = padded_items.to(torch.int64) & _M32
    pad = padded_items == PAD_ID
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=dev).reshape(-1)
    mixes = _mul32(((seeds & _M32) + 1) & _M32, 0x9E37_79B9)
    out = torch.empty((padded_items.shape[0], len(mixes)), dtype=torch.int32,
                      device=dev)
    for i, mix in enumerate(mixes):  # one [n, P] pass per seed
        h = fmix32(items ^ mix) % b
        h = torch.where(pad, int(NO_HASH), h)
        out[:, i] = h.min(dim=1).values.to(torch.int32)
    return out
