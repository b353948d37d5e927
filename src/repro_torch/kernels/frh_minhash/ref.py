"""Plain PyTorch versions of the FastRandomHash kernel's three entries
(``csrc/frh_minhash.cu``): :func:`minhash_ref` over padded profiles, the
counterpart of ``repro.kernels.frh_minhash.ref``, :func:`minhash_csr_ref`
over CSR profiles, and :func:`distinct_csr_ref`, the counterpart of
``core.hashing.user_distinct_hashes_np`` over ``item_hashes``.

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


def _mixes(seeds, dev) -> torch.Tensor:
    """(seed + 1) · 0x9E3779B9 mod 2³² per seed, as int64."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=dev).reshape(-1)
    return _mul32(((seeds & _M32) + 1) & _M32, 0x9E37_79B9)


def minhash_ref(padded_items: torch.Tensor, seeds, b: int) -> torch.Tensor:
    """H_i(u) for every (user, seed): int32[n, t].

    padded_items int32[n, P] (PAD_ID padded); seeds int32[t] (a tensor or
    a sequence); b the hash space size. Empty profiles yield NO_HASH.
    """
    dev = padded_items.device
    items = padded_items.to(torch.int64) & _M32
    pad = padded_items == PAD_ID
    mixes = _mixes(seeds, dev)
    out = torch.empty((padded_items.shape[0], len(mixes)), dtype=torch.int32,
                      device=dev)
    for i, mix in enumerate(mixes):  # one [n, P] pass per seed
        h = fmix32(items ^ mix) % b
        h = torch.where(pad, int(NO_HASH), h)
        out[:, i] = h.min(dim=1).values.to(torch.int32)
    return out


def minhash_csr_ref(offsets: torch.Tensor, items: torch.Tensor, seeds,
                    b: int) -> torch.Tensor:
    """H_i(u) for every (user, seed) of CSR profiles: int32[n, t].

    offsets int64[n + 1], items int32[nnz] (user u's items are
    ``items[offsets[u]:offsets[u + 1]]``, no PAD); seeds int32[t]; b the
    hash space size. Empty profiles yield NO_HASH.
    """
    dev = items.device
    n = offsets.numel() - 1
    x = items.to(torch.int64) & _M32
    user = torch.repeat_interleave(torch.arange(n, device=dev),
                                   torch.diff(offsets.to(torch.int64)))
    mixes = _mixes(seeds, dev)
    out = torch.full((n, len(mixes)), int(NO_HASH), dtype=torch.int64,
                     device=dev)
    for i, mix in enumerate(mixes):  # one pass over the items per seed
        out[:, i].scatter_reduce_(0, user, fmix32(x ^ mix) % b, "amin")
    return out.to(torch.int32)


def distinct_csr_ref(offsets: torch.Tensor, items: torch.Tensor, seeds,
                     b: int, depth: int) -> torch.Tensor:
    """Per (seed, user) of CSR profiles, the ``depth`` smallest distinct
    hash values, ascending, padded with NO_HASH: int32[t, n, depth].

    Same inputs as :func:`minhash_csr_ref`. Per seed, the (user, hash)
    pairs as one int64 key each, made unique and sorted; a pair's rank
    among its user's distinct hashes places it. A hash equal to NO_HASH
    (b = 2³¹) lands where the padding would.
    """
    dev = items.device
    n = offsets.numel() - 1
    x = items.to(torch.int64) & _M32
    user = torch.repeat_interleave(torch.arange(n, device=dev),
                                   torch.diff(offsets.to(torch.int64)))
    mixes = _mixes(seeds, dev)
    out = torch.full((len(mixes), n, depth), int(NO_HASH), dtype=torch.int32,
                     device=dev)
    for i, mix in enumerate(mixes):
        key = torch.unique((user << 32) | (fmix32(x ^ mix) % b))  # sorted
        u = key >> 32
        per_user = torch.bincount(u, minlength=n)
        first = torch.cumsum(per_user, 0) - per_user  # u's first key
        rank = torch.arange(len(key), device=dev) - first[u]
        keep = rank < depth
        out[i, u[keep], rank[keep]] = (key[keep] & _M32).to(torch.int32)
    return out
