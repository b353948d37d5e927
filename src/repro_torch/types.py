"""Core data types shared across the port (numpy copy of ``repro.types``).

The KNN side of the framework operates on *item-based datasets*: a set of
users, each associated with a sparse set of items (its *profile*), per the
paper's §II-A. Profiles are stored CSR on host (numpy) and padded/packed on
their way into torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

PAD_ID = -1  # padding sentinel for user/item ids
NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class Dataset:
    """An item-based dataset (users × items) in CSR form.

    ``items[offsets[u]:offsets[u+1]]`` is user ``u``'s profile P_u
    (sorted, deduplicated item ids in ``[0, n_items)``).
    """

    name: str
    n_users: int
    n_items: int
    items: np.ndarray    # int32[nnz]
    offsets: np.ndarray  # int64[n_users + 1]

    def __post_init__(self):
        assert self.offsets.shape == (self.n_users + 1,)
        assert self.offsets[0] == 0 and self.offsets[-1] == len(self.items)

    @property
    def nnz(self) -> int:
        return int(len(self.items))

    @property
    def profile_sizes(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    @property
    def density(self) -> float:
        return self.nnz / (self.n_users * self.n_items)

    def profile(self, u: int) -> np.ndarray:
        return self.items[self.offsets[u]:self.offsets[u + 1]]

    def padded_profiles(self, pad_to: Optional[int] = None):
        """Return ``(padded int32[n_users, P], mask bool[n_users, P])``.

        Padded entries hold ``PAD_ID``. Rows are sorted ascending (CSR order),
        which downstream exact-Jaccard evaluation relies on.
        """
        sizes = self.profile_sizes
        P = int(pad_to if pad_to is not None else (sizes.max() if len(sizes) else 1))
        P = max(P, 1)
        out = np.full((self.n_users, P), PAD_ID, dtype=np.int32)
        for u in range(self.n_users):
            p = self.profile(u)[:P]
            out[u, : len(p)] = p
        return out, out != PAD_ID

    def subset(self, user_ids: np.ndarray, name: Optional[str] = None) -> "Dataset":
        """Restrict to a subset of users (item universe unchanged)."""
        user_ids = np.asarray(user_ids)
        sizes = self.profile_sizes[user_ids]
        offsets = np.zeros(len(user_ids) + 1, dtype=np.int64)
        np.cumsum(sizes, out=offsets[1:])
        items = np.concatenate(
            [self.profile(int(u)) for u in user_ids]
            or [np.zeros((0,), np.int32)]
        ).astype(np.int32)
        return Dataset(
            name=name or f"{self.name}:subset{len(user_ids)}",
            n_users=len(user_ids),
            n_items=self.n_items,
            items=items,
            offsets=offsets,
        )


def dataset_from_profiles(name: str, profiles, n_items: int) -> Dataset:
    """Build a Dataset from a list of item-id iterables."""
    rows = [np.unique(np.asarray(sorted(set(int(i) for i in p)), dtype=np.int32))
            for p in profiles]
    sizes = np.array([len(r) for r in rows], dtype=np.int64)
    offsets = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    items = (np.concatenate(rows) if rows else np.zeros((0,), np.int32)).astype(np.int32)
    return Dataset(name=name, n_users=len(rows), n_items=n_items,
                   items=items, offsets=offsets)


@dataclasses.dataclass(frozen=True)
class KNNGraph:
    """An (approximate) KNN graph: for each user, k neighbor ids + similarities.

    ``ids[u, j] == PAD_ID`` marks an absent edge; its sim is ``-inf``.
    Neighbors are sorted by decreasing similarity.
    """

    ids: np.ndarray   # int32[n, k]
    sims: np.ndarray  # float32[n, k]

    @property
    def n(self) -> int:
        return self.ids.shape[0]

    @property
    def k(self) -> int:
        return self.ids.shape[1]

    def avg_sim(self) -> float:
        """Paper Eq. (1): mean similarity over the graph's edges (absent
        edges contribute 0, divisor is k·n, matching the paper)."""
        s = np.where(self.ids != PAD_ID, self.sims, 0.0)
        return float(s.sum() / (self.n * self.k))
