"""GoldFinger compact profile fingerprints (paper §II-F, refs [19]/[40]).

GoldFinger summarizes each user's profile into a B-bit vector (the paper's
experiments use 1024 bits). Bit ``hash(item) mod B`` is set for every
item in the profile, and the Jaccard similarity of two profiles is
estimated from the fingerprints as::

    J(u, v) ≈ popcount(fp_u & fp_v) / (card_u + card_v − popcount(fp_u & fp_v))

with ``card_u = popcount(fp_u)`` precomputed once per user.

Fingerprints are built on the host (numpy uint32, exactly as
``repro.sketch.goldfinger``). On their way into torch they become int32
*bit-views* of the same words (torch has no uint32 shift or popcount):
:func:`words_tensor` reinterprets, :func:`popcount32` counts with a SWAR
reduction over int64, and the f32 epilogue ``inter / max(union, 1)`` is
computed in the reference's order, so every sim is bitwise the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.hashing import fmix32
from repro_torch.types import Dataset

DEFAULT_BITS = 1024

# The reference scores sketches at least this many uint32 words wide
# through an int8 bit-plane matmul instead of popcount
# (``jaccard_pairwise_mxu`` / ``jaccard_pairwise_auto``, bitwise its
# popcount form by its own docstring). The intersection is an exact
# integer either way, so the port has one plain form,
# :func:`jaccard_pairwise`, and the cluster-KNN kernel, both popcount at
# every width; their sims match the reference on both sides of this width.
MXU_MIN_WORDS = 64

# Elements of the [..., n_a, n_b, words] AND tensor that
# :func:`jaccard_pairwise` materializes at a time.
PAIR_WORDS_BUDGET = 1 << 22

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


@dataclasses.dataclass(frozen=True)
class GoldFinger:
    """Fingerprints for a set of users: ``words`` uint32[n, W], ``card`` int32[n]."""

    words: np.ndarray  # uint32[n, W]
    card: np.ndarray   # int32[n]  (popcount of each row)

    @property
    def n(self) -> int:
        return self.words.shape[0]

    @property
    def n_bits(self) -> int:
        return self.words.shape[1] * 32


def item_bit_positions(items: np.ndarray, n_bits: int, seed: int) -> np.ndarray:
    """Map item ids to bit positions in [0, n_bits) with a mixed hash."""
    x = (items.astype(np.uint32) + np.uint32(0x9E3779B9)) ^ np.uint32(seed * 0x85EBCA6B + 1)
    return (fmix32(x) % np.uint32(n_bits)).astype(np.int64)


def fingerprint_dataset(ds: Dataset, n_bits: int = DEFAULT_BITS, seed: int = 0) -> GoldFinger:
    """Build GoldFinger fingerprints for every user of ``ds`` (host-side)."""
    if n_bits % 32:
        raise ValueError(f"n_bits must be a multiple of 32, got {n_bits}")
    W = n_bits // 32
    with obs.span("sketch.fingerprint"):
        pos = item_bit_positions(ds.items, n_bits, seed)
        word_idx = (pos // 32).astype(np.int64)
        bit = np.uint32(1) << (pos % 32).astype(np.uint32)
        words = np.zeros((ds.n_users, W), dtype=np.uint32)
        # Scatter-OR each item's bit into its user's row.
        user_of = np.repeat(np.arange(ds.n_users, dtype=np.int64),
                            ds.profile_sizes)
        np.bitwise_or.at(words, (user_of, word_idx), bit)
        card = popcount_rows(words)
    return GoldFinger(words=words, card=card)


def popcount_rows(words: np.ndarray) -> np.ndarray:
    """Row-wise popcount on host (numpy)."""
    return np.unpackbits(words.view(np.uint8), axis=-1).sum(axis=-1).astype(np.int32)


def incidence_fingerprint(ds: Dataset) -> GoldFinger:
    """Full-universe incidence vectors ("raw data" mode, Table V).

    One bit per item of the universe, so the popcount Jaccard over these
    rows is the *exact* set Jaccard (no hash collisions), at |I|/n_bits
    times a GoldFinger sketch's memory and work: W = ceil(|I| / 32) words,
    5,355 on AM. The cluster-KNN kernel streams such rows in chunks.
    """
    W = (ds.n_items + 31) // 32
    words = np.zeros((ds.n_users, W), dtype=np.uint32)
    user_of = np.repeat(np.arange(ds.n_users, dtype=np.int64),
                        ds.profile_sizes)
    pos = ds.items.astype(np.int64)
    np.bitwise_or.at(words, (user_of, pos // 32),
                     np.uint32(1) << (pos % 32).astype(np.uint32))
    return GoldFinger(words=words, card=popcount_rows(words))


# --------------------------------------------------------------------------
# Torch side: int32 bit-views, SWAR popcount, the shared f32 epilogue.
# --------------------------------------------------------------------------

def words_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32[..., W] numpy words → int32 bit-view tensor on ``device``."""
    w = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(w).to(device)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of 32-bit words held as int32 (or int64 holding
    a uint32 value) → int32. SWAR over int64, so no shift sees a sign bit
    and no sum overflows."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F).to(torch.int32)


def jaccard_epilogue(inter: torch.Tensor, card_a: torch.Tensor,
                     card_b: torch.Tensor) -> torch.Tensor:
    """``inter / max(card_a + card_b − inter, 1)`` where the union is
    positive, else 0 — f32, in the reference's order. Arguments broadcast;
    ``inter`` is an exact integer count."""
    inter = inter.to(torch.float32)
    union = card_a.to(torch.float32) + card_b.to(torch.float32) - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                       torch.zeros((), dtype=torch.float32,
                                   device=inter.device))


def jaccard_pairwise(words_a: torch.Tensor, card_a: torch.Tensor,
                     words_b: torch.Tensor, card_b: torch.Tensor) -> torch.Tensor:
    """Estimated Jaccard sims for all pairs: float32[..., n_a, n_b].

    ``words_*`` int32[..., n, W] bit-views with matching leading (batch)
    dims; ``card_*`` int32[..., n]. The intersection is accumulated over
    chunks of words, each chunk's AND tensor [..., n_a, n_b, chunk] held
    to ``PAIR_WORDS_BUDGET`` elements, so wide rows (raw incidence: W in
    the thousands) never materialize [..., n_a, n_b, W]. The count is an
    exact integer whatever the chunking.
    """
    W = words_a.shape[-1]
    shape = torch.broadcast_shapes(words_a.shape[:-2], words_b.shape[:-2]) \
        + (words_a.shape[-2], words_b.shape[-2])
    inter = torch.zeros(shape, dtype=torch.int32, device=words_a.device)
    pairs = max(1, inter.numel())
    chunk = max(1, min(W, PAIR_WORDS_BUDGET // pairs))
    for w0 in range(0, W, chunk):
        a = words_a[..., :, None, w0:w0 + chunk]
        b = words_b[..., None, :, w0:w0 + chunk]
        inter += popcount32(a & b).sum(-1, dtype=torch.int32)
    return jaccard_epilogue(inter, card_a[..., :, None], card_b[..., None, :])


def unpack_bits_int8(words: torch.Tensor) -> torch.Tensor:
    """int32[n, W] bit-views → int8[n, W·32] {0,1} bit planes (LSB-first
    per word), the reference's MXU layout."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = ((words.to(torch.int64) & 0xFFFFFFFF)[..., :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1).to(torch.int8)
