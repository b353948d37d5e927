"""Plain reference of a C² build: FastRandomHash clustering with recursive
splitting (paper §II-D, Alg. 1), GoldFinger fingerprints (§II-F), Step 2's
brute-force KNN inside every cluster (Alg. 2) and the merge of the t
partial graphs (Alg. 3).

It is written from the paper and from the semantics the port guarantees,
and imports nothing of the program. Where the paper leaves an order free,
the port fixes it, and so does this file, since ties between equal
similarities are broken by it:

* a cluster's members are in ascending user id, except that a cluster that
  was split keeps first its members with no next hash value and then its
  singleton children, in ascending order of their next hash value;
* a user's neighbours are ranked by similarity, ties to the earlier member
  of the cluster; the merge ranks the t lists' candidates by similarity,
  ties to the earlier configuration and rank.

Step 2 counts intersections as exact integers through a float32 product of
unpacked bits (0/1 products summed below 2**24), then applies the
estimator's epilogue ``inter / max(union, 1)`` in ``dtype``: float32, as
the configuration states, or a lower precision for the control.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

PAD = -1
NO_HASH = 2**31 - 1
GOLDEN = 0x9E3779B9


def fmix32(x: np.ndarray) -> np.ndarray:
    """Murmur3's 32-bit finalizer (uint32, wrapping)."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def hash_seeds(c2: dict) -> np.ndarray:
    """The t FastRandomHash seeds: ``seed * 1009 + i``."""
    return np.arange(c2["t"], dtype=np.int64) + c2["seed"] * 1009


def item_hashes(items: np.ndarray, seeds: np.ndarray, b: int) -> np.ndarray:
    """h_i(item) in [0, b) for every seed i: int64[t, nnz]."""
    mix = ((seeds.astype(np.uint32) + np.uint32(1))
           * np.uint32(GOLDEN)).astype(np.uint32)
    x = items.astype(np.uint32)[None, :] ^ mix[:, None]
    return (fmix32(x) % np.uint32(b)).astype(np.int64)


def distinct_hashes(item_h: np.ndarray, offsets: np.ndarray, b: int,
                    depth: int) -> np.ndarray:
    """Each user's ``depth`` smallest distinct item hashes per function,
    ascending, NO_HASH padded: int64[t, n, depth]."""
    t = item_h.shape[0]
    n = len(offsets) - 1
    dtype = np.int32 if n * b < 2**31 else np.int64
    user = np.repeat(np.arange(n, dtype=dtype), np.diff(offsets)) * b
    out = np.full((t, n, depth), NO_HASH, dtype=np.int64)
    for i in range(t):
        key = np.sort(user + item_h[i].astype(dtype))
        key = key[np.r_[True, key[1:] != key[:-1]]]
        u, h = key // b, key % b                  # by (user, hash)
        count = np.bincount(u, minlength=n)
        rank = np.arange(len(key)) - np.repeat(np.cumsum(count) - count,
                                               count)
        keep = rank < depth
        out[i, u[keep], rank[keep]] = h[keep]
    return out


def split(cands: np.ndarray, max_cluster: int):
    """Recursive splitting of one configuration. ``cands`` int64[n, depth]
    from :func:`distinct_hashes`. Returns ``[(members, path)]`` of every
    final cluster (singletons included)."""
    n, depth = cands.shape
    out = []

    def groups(mem: np.ndarray, h: np.ndarray):
        """(hash, members) of ``mem`` by hash ascending, each group in
        ``mem``'s order."""
        o = np.argsort(h, kind="stable")
        mem, h = mem[o], h[o]
        cut = np.flatnonzero(np.diff(h)) + 1
        return zip(h[np.r_[0, cut]] if len(h) else [], np.split(mem, cut))

    def visit(mem: np.ndarray, path: tuple, d: int):
        if len(mem) <= max_cluster or d >= depth:
            out.append((mem, path))
            return
        nxt = cands[mem, d]
        movable = nxt != NO_HASH
        stay = [mem[~movable]]
        children = []
        for h, child in groups(mem[movable], nxt[movable]):
            if len(child) == 1:
                stay.append(child)
            else:
                children.append((child, path + (int(h),)))
        remaining = np.concatenate(stay)
        if len(remaining) == len(mem):   # nothing moves: keep it whole
            out.append((mem, path))
            return
        for child, cpath in children:
            visit(child, cpath, d + 1)
        if len(remaining):
            out.append((remaining, path))

    users = np.flatnonzero(cands[:, 0] != NO_HASH)
    for h, mem in groups(users, cands[users, 0]):
        visit(mem, (int(h),), 1)
    return out


@dataclasses.dataclass
class Plan:
    members: list          # int64 arrays, one per cluster of >= 2 users
    config: np.ndarray     # int64[n_clusters]
    paths: list            # split path of each cluster
    n_users: int
    t: int

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(m) for m in self.members], dtype=np.int64)


def cluster_plan(items: np.ndarray, offsets: np.ndarray, c2: dict) -> Plan:
    """Step 1: every configuration's clusters of two users or more."""
    item_h = item_hashes(items, hash_seeds(c2), c2["b"])
    cands = distinct_hashes(item_h, offsets, c2["b"], c2["split_depth"])
    members, config, paths = [], [], []
    for i in range(c2["t"]):
        for mem, path in split(cands[i], c2["max_cluster"]):
            if len(mem) >= 2:
                members.append(mem)
                config.append(i)
                paths.append(path)
    return Plan(members=members, config=np.array(config, dtype=np.int64),
                paths=paths, n_users=len(offsets) - 1, t=c2["t"])


def fingerprints(items: np.ndarray, offsets: np.ndarray, n_bits: int,
                 seed: int):
    """GoldFinger: bit ``fmix32((item + golden) ^ (seed * 0x85EBCA6B + 1))
    mod n_bits`` set per item. Returns (bits bool[n, n_bits], card
    int64[n])."""
    n = len(offsets) - 1
    salt = np.uint32((seed * 0x85EBCA6B + 1) & 0xFFFFFFFF)
    x = (items.astype(np.uint32) + np.uint32(GOLDEN)) ^ salt
    pos = (fmix32(x) % np.uint32(n_bits)).astype(np.int64)
    bits = np.zeros((n, n_bits), dtype=bool)
    bits[np.repeat(np.arange(n), np.diff(offsets)), pos] = True
    return bits, bits.sum(axis=1).astype(np.int64)


def to_words(bits: np.ndarray) -> np.ndarray:
    """bool[n, n_bits] → uint32[n, n_bits / 32], bit i of word j = bit
    32 j + i (the layout a program's fingerprints are compared in)."""
    return np.packbits(bits, axis=1, bitorder="little").view("<u4")


def epilogue(inter: torch.Tensor, card_a: torch.Tensor,
             card_b: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """GoldFinger's estimate ``inter / max(union, 1)`` (0 where the union
    is empty), computed in ``dtype`` and returned as float32."""
    inter = inter.to(dtype)
    union = card_a.to(dtype) + card_b.to(dtype) - inter
    one = torch.ones((), dtype=dtype, device=inter.device)
    sims = torch.where(union > 0, inter / torch.maximum(union, one),
                       torch.zeros((), dtype=dtype, device=inter.device))
    return sims.to(torch.float32)


def _capacity(size: int) -> int:
    c = 32
    while c < size:
        c *= 2
    return c


def step2(plan: Plan, bits: np.ndarray, card: np.ndarray, k: int, device,
          dtype=torch.float32, budget: int = 2 << 30):
    """Every user's k nearest neighbours inside its cluster of each
    configuration: (ids int64[t, n, k], sims float32[t, n, k]), PAD/−inf
    where a cluster has fewer than k other members."""
    t, n = plan.t, plan.n_users
    out_ids = torch.full((t, n, k), PAD, dtype=torch.int64, device=device)
    out_sims = torch.full((t, n, k), float("-inf"), device=device)
    fbits = torch.from_numpy(bits).to(device).to(torch.float32)
    fcard = torch.from_numpy(card).to(device)
    sizes = plan.sizes
    caps = np.array([_capacity(int(s)) for s in sizes])
    for cap in np.unique(caps):
        idx = np.flatnonzero(caps == cap)
        per = max(1, budget // (cap * cap * 32 + cap * bits.shape[1] * 4))
        for s in range(0, len(idx), per):
            batch = idx[s:s + per]
            mem = np.full((len(batch), cap), PAD, dtype=np.int64)
            for j, ci in enumerate(batch):
                mem[j, :sizes[ci]] = plan.members[ci]
            ids = torch.from_numpy(mem).to(device)
            pad = ids == PAD
            safe = torch.where(pad, 0, ids)
            x = fbits[safe]                                  # [m, cap, B]
            inter = torch.bmm(x, x.transpose(1, 2))          # exact ints
            c = torch.where(pad, 0, fcard[safe])
            sims = epilogue(inter, c[:, :, None], c[:, None, :], dtype)
            eye = torch.eye(cap, dtype=torch.bool, device=device)[None]
            sims = sims.masked_fill(pad[:, None, :] | pad[:, :, None] | eye,
                                    float("-inf"))
            top, pos = torch.sort(sims, dim=2, descending=True, stable=True)
            top, pos = top[:, :, :k], pos[:, :, :k]
            nbr = torch.gather(ids[:, None, :].expand(-1, cap, -1), 2, pos)
            nbr = torch.where(top == float("-inf"), PAD, nbr)
            cfg = torch.from_numpy(plan.config[batch]).to(device)
            rows = ~pad
            out_ids[cfg[:, None].expand(-1, cap)[rows], ids[rows]] = nbr[rows]
            out_sims[cfg[:, None].expand(-1, cap)[rows], ids[rows]] = top[rows]
    return out_ids, out_sims


def topk_unique(ids: torch.Tensor, sims: torch.Tensor, k: int,
                self_ids: torch.Tensor | None = None):
    """Per row: the k best distinct ids by similarity, ties to the earlier
    column; PAD lanes, repeats of an earlier lane's id and (given
    ``self_ids``) self edges left out. Rows are padded with PAD/−inf."""
    if ids.shape[1] < k:
        extra = k - ids.shape[1]
        ids = torch.nn.functional.pad(ids, (0, extra), value=PAD)
        sims = torch.nn.functional.pad(sims, (0, extra),
                                       value=float("-inf"))
    order = torch.argsort(ids, dim=1, stable=True)
    sid = torch.gather(ids, 1, order)
    first = torch.ones_like(sid, dtype=torch.bool)
    first[:, 1:] = sid[:, 1:] != sid[:, :-1]
    keep = torch.empty_like(first).scatter_(1, order, first)
    keep &= ids != PAD
    if self_ids is not None:
        keep &= ids != self_ids[:, None]
    masked = torch.where(keep, sims, float("-inf"))
    top, pos = torch.sort(masked, dim=1, descending=True, stable=True)
    top, pos = top[:, :k], pos[:, :k]
    out = torch.gather(ids, 1, pos)
    return torch.where(top == float("-inf"), PAD, out), top


def merge(ids: torch.Tensor, sims: torch.Tensor, k: int, rows: int = 8192):
    """Alg. 3: each user's t·k candidates (configuration order) → its k
    best distinct neighbours other than itself."""
    t, n, kk = ids.shape
    out_ids = torch.empty((n, k), dtype=torch.int64, device=ids.device)
    out_sims = torch.empty((n, k), dtype=torch.float32, device=ids.device)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        cid = ids[:, r0:r1].permute(1, 0, 2).reshape(r1 - r0, t * kk)
        cs = sims[:, r0:r1].permute(1, 0, 2).reshape(r1 - r0, t * kk)
        self_ids = torch.arange(r0, r1, device=ids.device)
        out_ids[r0:r1], out_sims[r0:r1] = topk_unique(cid, cs, k, self_ids)
    return out_ids, out_sims


@dataclasses.dataclass
class Build:
    plan: Plan
    bits: np.ndarray     # bool[n, n_bits]
    card: np.ndarray     # int64[n]
    ids: np.ndarray      # int64[n, k]
    sims: np.ndarray     # float32[n, k]


def build(items: np.ndarray, offsets: np.ndarray, c2: dict, device,
          dtype=torch.float32) -> Build:
    """The whole C² build of a dataset, from its CSR profiles."""
    plan = cluster_plan(items, offsets, c2)
    bits, card = fingerprints(items, offsets, c2["n_bits"], c2["seed"])
    big = plan.sizes >= c2["rho"] * c2["k"] ** 2
    if big.any():
        raise ValueError(
            f"{int(big.sum())} clusters reach rho*k^2 members, where Alg. 2 "
            "switches to Hyrec; this reference brute-forces every cluster")
    pid, psims = step2(plan, bits, card, c2["k"], device, dtype)
    gid, gsims = merge(pid, psims, c2["k"])
    return Build(plan=plan, bits=bits, card=card, ids=gid.cpu().numpy(),
                 sims=gsims.cpu().numpy())
