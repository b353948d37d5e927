"""Recursive cluster splitting (paper §II-D, Fig. 3).

FastRandomHash's min introduces a bias towards low cluster indices; clusters
larger than N are recursively split with H\\η (min over item hashes > η).

Key observation: a user u in a depth-d cluster followed the
path (η₁ < η₂ < … < η_d) of its d smallest *distinct* item-hash values, so
every split decision is determined by the per-user ascending distinct-hash
table computed once on device. The split loop below is therefore pure
bookkeeping (host-side scheduling), with zero re-hashing.

Paper's two exceptions are honored: users with no next hash value
("single item" users) and users alone in their tentative child cluster
remain in the parent.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hashing import NO_HASH


@dataclasses.dataclass
class SplitResult:
    """Clusters of ONE hash configuration after recursive splitting.

    ``members[c]`` — user ids of cluster c; ``paths[c]`` — the (η₁..η_d)
    split path identifying it.
    """

    members: list[np.ndarray]
    paths: list[tuple[int, ...]]

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(m) for m in self.members], dtype=np.int64)


def split_config(cands: np.ndarray, max_cluster: int) -> SplitResult:
    """Split one configuration.

    cands: int32[n_users, depth] — ascending distinct item-hash values per
    user (NO_HASH padded), from ``user_distinct_hashes_np``.
    """
    n, depth = cands.shape
    valid = cands[:, 0] != NO_HASH  # users with non-empty profiles
    members: list[np.ndarray] = []
    paths: list[tuple[int, ...]] = []

    # Initial clustering: bucket by H(u) = first distinct hash.
    users = np.arange(n, dtype=np.int64)[valid]
    order = np.argsort(cands[valid, 0], kind="stable")
    sorted_users = users[order]
    sorted_h = cands[valid, 0][order]
    bounds = np.flatnonzero(np.diff(sorted_h, prepend=-1) != 0)
    queue: list[tuple[np.ndarray, tuple[int, ...], int]] = []  # (members, path, depth)
    for s, e in zip(bounds, np.append(bounds[1:], len(sorted_users))):
        queue.append((sorted_users[s:e], (int(sorted_h[s]),), 1))

    while queue:
        mem, path, d = queue.pop()
        if len(mem) <= max_cluster or d >= depth:
            members.append(mem)
            paths.append(path)
            continue
        nxt = cands[mem, d]  # next distinct hash above path[-1]
        movable = nxt != NO_HASH
        # Group movers by their next hash; singleton children stay (§II-D).
        mv = mem[movable]
        mh = nxt[movable]
        stay = [mem[~movable]]
        if len(mv):
            o = np.argsort(mh, kind="stable")
            mv, mh = mv[o], mh[o]
            b2 = np.flatnonzero(np.diff(mh, prepend=-1) != 0)
            ends = np.append(b2[1:], len(mv))
            for s, e in zip(b2, ends):
                child = mv[s:e]
                if len(child) == 1:
                    stay.append(child)
                else:
                    queue.append((child, path + (int(mh[s]),), d + 1))
        remaining = np.concatenate(stay)
        if len(remaining) == len(mem):
            # No progress possible — accept the oversized cluster.
            members.append(mem)
            paths.append(path)
        elif len(remaining):
            # The parent keeps its stayers; it cannot shrink further by
            # re-splitting (stayers are exhausted or singleton-children).
            members.append(remaining)
            paths.append(path)
    return SplitResult(members=members, paths=paths)
