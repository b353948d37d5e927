"""The servable KNN index artifact (build output → query input).

Port of ``repro.query.index``. A :class:`KNNIndex` bundles what the online
query path needs:

* the merged C² graph (forward adjacency) and its reverse adjacency,
* the GoldFinger fingerprints of every indexed user,
* the FastRandomHash routing tables — per-configuration hash seeds plus
  the split-path → cluster-members mapping of the build's plan — so an
  unseen profile can be placed in its cluster per configuration
  (repro_torch/query/router.py).

The artifact is the reference's single ``.npz`` layout, both ways:
:meth:`KNNIndex.load` reads a file written by either package (lifecycle
columns and mutation journals included) and :meth:`KNNIndex.save` writes
one the reference loads back.

Online growth: per-row state lives in capacity buffers with spare rows
(geometric doubling), so :meth:`KNNIndex.append_user` writes one row and
patches its neighbours' rows in place; the public row attributes
(``graph_ids`` …) are views of the first ``n`` rows.
:meth:`refresh_cohort` re-runs C² clustering on an inserted cohort to
register new routable clusters.

Lifecycle (repro_torch/lifecycle/): rows can be removed
(:meth:`remove_user`: tombstone plus best-effort edge patching; the
tombstone mask threaded through descent is what keeps a dead id out of
every result) and updated (:meth:`swap_profile` re-scores incident edges,
:meth:`relink_user` replaces the forward row). Removed rows join a free
list and are reused lowest id first. Cluster membership stays
append-only; the router filters dead members at seed time.

Three journals record the mutations — rows changed, liveness flips and
cluster registrations, each stamped with the index version — so a
serving plan scatters only the changed rows into its device copies
(``query/plan.py``). Over their caps the oldest half is merged into one
superset entry at the drop boundary; only when that entry would exceed
``_LOG_MERGE_MAX`` rows does the journal drop it and advance its base
(readers below it resync in full).

Write-ahead logging (``faults/wal.py``): with a WAL attached
(:meth:`attach_wal`), every public mutator records its arguments, as host
numpy, before it changes any state, so a crash between scheduler steps
leaves each mutation in the journal whole or not at all, and the JSON
lines match the reference's record for record. ``refresh_cohort``
records its resolved ``max_cluster`` and suspends the WAL for its body.

All of it is host numpy, copied from the reference so that every edge
and sim it writes is bitwise the reference's.
"""
from __future__ import annotations

import heapq
from pathlib import Path

import numpy as np

from repro_torch.core import hashing
from repro_torch.core.clustering import ClusterPlan, build_plan, frh_seeds
from repro_torch.core.hashing import NO_HASH
from repro_torch.core.local_knn import local_knn
from repro_torch.core.merge import merge_partial
from repro_torch.core.params import C2Params
from repro_torch.core.splitting import split_config
from repro_torch.knn.greedy import reverse_neighbors_np
from repro_torch.sketch.goldfinger import (GoldFinger, fingerprint_dataset,
                                           popcount_rows)
from repro_torch.types import NEG_INF, PAD_ID, Dataset, KNNGraph

_ROWS = ("graph_ids", "graph_sims", "words", "card", "rev_ids",
         "tombstone", "last_touch")
_TABLES = ("hash_seeds", "cluster_paths", "cluster_config",
           "cluster_members", "cluster_offsets")
_META = ("b", "n_bits", "fp_seed", "split_depth", "version")

_ROW_DTYPES = {"graph_ids": np.int32, "graph_sims": np.float32,
               "words": np.uint32, "card": np.int32, "rev_ids": np.int32,
               "tombstone": np.bool_, "last_touch": np.int64}
_ROW_FILL = {"graph_ids": PAD_ID, "graph_sims": NEG_INF, "words": 0,
             "card": 0, "rev_ids": PAD_ID, "tombstone": False,
             "last_touch": 0}


class KNNIndex:
    """A built C² graph packaged for online query serving (host numpy).

    Row arrays live in over-allocated buffers; ``index.graph_ids`` etc.
    are length-``n`` views.
    """

    # Journal bounds (see the module docstring).
    _ROW_LOG_CAP = 2048
    _MEMBER_LOG_CAP = 8192
    _TOMB_LOG_CAP = 2048
    _LOG_MERGE_MAX = 4096

    def __init__(self, *, graph_ids, graph_sims, words, card, rev_ids,
                 hash_seeds, cluster_paths, cluster_config, cluster_members,
                 cluster_offsets, b, n_bits, fp_seed, split_depth,
                 version: int = 0, tombstone=None, last_touch=None):
        self._n = int(np.asarray(graph_ids).shape[0])
        self._bufs: dict[str, np.ndarray] = {}
        row_args = {"graph_ids": graph_ids, "graph_sims": graph_sims,
                    "words": words, "card": card, "rev_ids": rev_ids,
                    "tombstone": tombstone, "last_touch": last_touch}
        for name in _ROWS:
            arr = row_args[name]
            if arr is None:  # pre-lifecycle artifact: all rows live/untouched
                arr = np.full((self._n,), _ROW_FILL[name],
                              dtype=_ROW_DTYPES[name])
            buf = np.ascontiguousarray(arr, _ROW_DTYPES[name])
            if not buf.flags.writeable:
                buf = buf.copy()
            self._bufs[name] = buf
        self.hash_seeds = np.asarray(hash_seeds, dtype=np.int32)
        self.cluster_paths = np.asarray(cluster_paths, dtype=np.int32)
        self.cluster_config = np.asarray(cluster_config, dtype=np.int32)
        self.cluster_members = np.asarray(cluster_members, dtype=np.int32)
        self.cluster_offsets = np.asarray(cluster_offsets, dtype=np.int64)
        self.b = int(b)
        self.n_bits = int(n_bits)
        self.fp_seed = int(fp_seed)
        self.split_depth = int(split_depth)
        self.version = int(version)  # bumped on every mutation
        self._lut: dict | None = None
        # Members appended online, per cluster index (folded into the CSR
        # by consolidate()).
        self._extra_members: dict[int, list[int]] = {}
        # Row journal: (version, rows touched) per mutation; replay is
        # strictly after the reader's version.
        self._row_log: list[tuple[int, tuple[int, ...]]] = []
        self._row_log_base = self.version
        # Membership journal: (version, cluster, uid) per registration.
        # Registration does not bump the version by itself, so readers
        # replay entries >= their version and the floor sits one below.
        self._member_log: list[tuple[int, int, int]] = []
        self._member_log_base = self.version - 1
        # Deletion journal: (version, rows whose liveness flipped).
        self._tomb_log: list[tuple[int, tuple[int, ...]]] = []
        self._tomb_log_base = self.version
        # Free list of tombstoned rows, reused lowest id first.
        self._free_rows: list[int] = [
            int(i) for i in np.flatnonzero(self._bufs["tombstone"][:self._n])]
        heapq.heapify(self._free_rows)
        # Write-ahead log (faults/wal.py): records every mutation first.
        self._wal = None

    # -- row buffers (views over spare capacity) ---------------------------

    def __getattr__(self, name):
        bufs = self.__dict__.get("_bufs")
        if bufs is not None and name in bufs:
            return bufs[name][: self.__dict__["_n"]]
        raise AttributeError(name)

    @property
    def capacity(self) -> int:
        """Allocated user rows (≥ n; grows by doubling, never per insert)."""
        return self._bufs["graph_ids"].shape[0]

    def _ensure_capacity(self, n_needed: int):
        cap = self.capacity
        if n_needed <= cap:
            return
        new_cap = max(cap, 64)
        while new_cap < n_needed:
            new_cap *= 2
        for name, buf in self._bufs.items():
            grown = np.full((new_cap,) + buf.shape[1:], _ROW_FILL[name],
                            dtype=buf.dtype)
            grown[: self._n] = buf[: self._n]
            self._bufs[name] = grown

    # -- shape accessors ---------------------------------------------------

    @property
    def n(self) -> int:
        return self._n

    @property
    def n_live(self) -> int:
        """Rows that are not tombstoned (n counts dead rows too)."""
        return self._n - int(self._bufs["tombstone"][: self._n].sum())

    def alive_ids(self) -> np.ndarray:
        """int64 ids of live rows, ascending."""
        return np.flatnonzero(~self.tombstone)

    @property
    def k(self) -> int:
        return self._bufs["graph_ids"].shape[1]

    @property
    def t(self) -> int:
        return len(self.hash_seeds)

    @property
    def n_clusters(self) -> int:
        return len(self.cluster_config)

    @property
    def row_bytes(self) -> int:
        """Serving bytes one resident row costs a shard: adjacency +
        reverse adjacency + fingerprint words (all 4-byte) + card +
        local→global id + tombstone flag
        (``ShardedDescent.resident_bytes``)."""
        kg = self._bufs["graph_ids"].shape[1]
        kr = self._bufs["rev_ids"].shape[1]
        w = self._bufs["words"].shape[1]
        return 4 * (kg + kr + w) + 4 + 4 + 1

    # -- routing tables ----------------------------------------------------

    def path_lut(self) -> dict:
        """(config, split-path tuple) → cluster index."""
        if self._lut is None:
            lut = {}
            for ci in range(self.n_clusters):
                path = tuple(int(h) for h in self.cluster_paths[ci]
                             if h != NO_HASH)
                lut[(int(self.cluster_config[ci]), path)] = ci
            self._lut = lut
        return self._lut

    def cluster_users(self, ci: int) -> np.ndarray:
        """Members of cluster ``ci``, including users inserted online."""
        base = self.cluster_members[
            self.cluster_offsets[ci]:self.cluster_offsets[ci + 1]]
        extra = self._extra_members.get(ci)
        if not extra:
            return base
        return np.concatenate([base, np.asarray(extra, dtype=np.int32)])

    def cluster_sizes(self) -> np.ndarray:
        """int64[n_clusters] member counts, online extras included."""
        sizes = np.diff(self.cluster_offsets)
        for ci, extra in self._extra_members.items():
            sizes[ci] += len(extra)
        return sizes

    def attach_wal(self, wal) -> None:
        """Start write-ahead logging every mutation into ``wal`` (an object
        with ``record(op, **args)``: ``faults/wal.WriteAheadLog``)."""
        self._wal = wal

    def detach_wal(self):
        """Stop logging; returns the detached WAL (or None)."""
        wal, self._wal = self._wal, None
        return wal

    def add_cluster_member(self, ci: int, user: int):
        if self._wal is not None:
            self._wal.record("add_cluster_member", ci=int(ci),
                             user=int(user))
        self._extra_members.setdefault(ci, []).append(int(user))
        self._log_member(ci, user)

    def _log_member(self, ci: int, user: int):
        self._member_log.append((self.version, int(ci), int(user)))
        if len(self._member_log) > self._MEMBER_LOG_CAP:
            half = self._MEMBER_LOG_CAP // 2
            drop, keep = self._member_log[:half], self._member_log[half:]
            boundary = drop[-1][0]
            # Re-stamp the dropped registrations at the boundary,
            # deduplicated in their original order.
            seen: set[tuple[int, int]] = set()
            merged: list[tuple[int, int, int]] = []
            for _, mci, mu in drop:
                if (mci, mu) not in seen:
                    seen.add((mci, mu))
                    merged.append((boundary, mci, mu))
            if len(merged) <= self._LOG_MERGE_MAX:
                self._member_log = merged + keep
            else:  # merged entry too big: drop and advance the floor
                self._member_log = keep
                self._member_log_base = boundary

    def members_added_since(self, version: int
                            ) -> list[tuple[int, int]] | None:
        """(cluster, uid) registrations at or after ``version`` in order,
        or None when the membership journal no longer reaches back that
        far (entries logged at ``version`` itself are included: see
        ``_log_member``)."""
        if version <= self._member_log_base:
            return None
        return [(ci, u) for v, ci, u in self._member_log if v >= version]

    # -- online insertion --------------------------------------------------

    def append_user(self, words_row: np.ndarray, card_row: int,
                    nbr_ids: np.ndarray, nbr_sims: np.ndarray) -> int:
        """Append one user and link it into the graph; returns its id.

        ``nbr_ids``/``nbr_sims`` are the user's search result (its forward
        edges, ≤ k entries, PAD_ID allowed). Each neighbour takes the new
        user into its forward row iff it beats the row's worst edge (or
        the row has a free lane), and the reverse rows follow. Tombstoned
        rows are recycled lowest id first.
        """
        if self._wal is not None:
            self._wal.record("append_user", words_row=np.asarray(words_row),
                             card_row=card_row, nbr_ids=np.asarray(nbr_ids),
                             nbr_sims=np.asarray(nbr_sims))
        reused = bool(self._free_rows)
        if reused:
            u = heapq.heappop(self._free_rows)
        else:
            u = self._n
            self._ensure_capacity(u + 1)
        bufs = self._bufs
        k, r = self.k, bufs["rev_ids"].shape[1]
        row_ids = np.full(k, PAD_ID, dtype=np.int32)
        row_sims = np.full(k, NEG_INF, dtype=np.float32)
        valid = np.flatnonzero(np.asarray(nbr_ids) != PAD_ID)[:k]
        order = valid[np.argsort(-np.asarray(nbr_sims, dtype=np.float32)[valid],
                                 kind="stable")]
        row_ids[: len(order)] = np.asarray(nbr_ids)[order]
        row_sims[: len(order)] = np.asarray(nbr_sims)[order]

        bufs["words"][u] = np.asarray(words_row, np.uint32)
        bufs["card"][u] = card_row
        bufs["graph_ids"][u] = row_ids
        bufs["graph_sims"][u] = row_sims

        graph_ids, graph_sims = bufs["graph_ids"], bufs["graph_sims"]
        rev_ids = bufs["rev_ids"]
        rev_row = np.full(r, PAD_ID, dtype=np.int32)
        n_rev = 0
        for v, s in zip(row_ids, row_sims):
            if v == PAD_ID:
                break
            v = int(v)
            # u → v exists, so u joins rev(v) (replace the tail if full).
            free = np.flatnonzero(rev_ids[v] == PAD_ID)
            rev_ids[v, free[0] if len(free) else r - 1] = u
            # Bounded-heap insert of u into v's forward neighborhood.
            eff = np.where(graph_ids[v] == PAD_ID, NEG_INF, graph_sims[v])
            j = int(np.argmin(eff))
            if s > eff[j]:
                graph_ids[v, j] = u
                graph_sims[v, j] = s
                o = np.argsort(-graph_sims[v], kind="stable")
                graph_ids[v] = graph_ids[v, o]
                graph_sims[v] = graph_sims[v, o]
                if n_rev < r:  # v → u now exists, so v joins rev(u)
                    rev_row[n_rev] = v
                    n_rev += 1
        rev_ids[u] = rev_row
        bufs["tombstone"][u] = False
        bufs["last_touch"][u] = 0
        if not reused:
            self._n = u + 1
        self.version += 1
        touched = (u,) + tuple(int(v) for v in row_ids if v != PAD_ID)
        self._journal_rows(touched)
        if reused:
            self._journal_tomb((u,))
        return u

    def _journal_rows(self, touched: tuple[int, ...]):
        self._row_log.append((self.version, tuple(touched)))
        if len(self._row_log) > self._ROW_LOG_CAP:
            self._row_log, self._row_log_base = self._compact_touched_log(
                self._row_log, self._ROW_LOG_CAP // 2, self._row_log_base)

    def _journal_tomb(self, rows: tuple[int, ...]):
        self._tomb_log.append((self.version, tuple(rows)))
        if len(self._tomb_log) > self._TOMB_LOG_CAP:
            self._tomb_log, self._tomb_log_base = self._compact_touched_log(
                self._tomb_log, self._TOMB_LOG_CAP // 2, self._tomb_log_base)

    def _compact_touched_log(self, log, half, base):
        """Merge the oldest ``half`` entries of a (version, rows) journal
        into one superset entry at the drop boundary, keeping the base; or
        drop them and advance the base when that entry would be oversized."""
        drop, keep = log[:half], log[half:]
        boundary = drop[-1][0]
        merged: set[int] = set()
        for _, rows in drop:
            merged.update(rows)
        if len(merged) <= self._LOG_MERGE_MAX:
            return [(boundary, tuple(sorted(merged)))] + keep, base
        return keep, boundary

    def rows_changed_since(self, version: int) -> set[int] | None:
        """Row indices mutated after ``version``, or None when the
        journal no longer reaches back that far (caller must resync)."""
        if version < self._row_log_base:
            return None
        rows: set[int] = set()
        for v, touched in reversed(self._row_log):
            if v <= version:
                break
            rows.update(touched)
        return rows

    def tombstones_since(self, version: int) -> set[int] | None:
        """Rows whose liveness flipped after ``version`` (removal or
        free-row reuse), or None when the deletion journal no longer
        reaches back; consumers scatter each row's current value."""
        if version < self._tomb_log_base:
            return None
        rows: set[int] = set()
        for v, rs in reversed(self._tomb_log):
            if v <= version:
                break
            rows.update(rs)
        return rows

    # -- lifecycle mutations (repro_torch/lifecycle drives these) ----------

    def _check_live(self, u: int) -> int:
        u = int(u)
        if not 0 <= u < self._n:
            raise IndexError(f"user {u} out of range [0, {self._n})")
        if self._bufs["tombstone"][u]:
            raise ValueError(f"user {u} is tombstoned")
        return u

    def _pair_sim(self, a: int, b: int) -> np.float32:
        """Host GoldFinger Jaccard estimate in the scorers' f32 epilogue
        (``inter / max(union, 1)``), so host-written edge sims are bitwise
        those the descent and the kernels produce."""
        bufs = self._bufs
        inter = np.float32(int(popcount_rows(
            (bufs["words"][a] & bufs["words"][b])[None, :])[0]))
        union = np.float32(bufs["card"][a]) + np.float32(bufs["card"][b]) \
            - inter
        if not union > 0:
            return np.float32(0.0)
        return np.float32(inter / max(union, np.float32(1.0)))

    def _resort_row(self, u: int):
        """Restore row ``u``'s by-similarity order after an in-place lane
        edit (stable: equal-sim lanes keep their relative order)."""
        bufs = self._bufs
        o = np.argsort(-bufs["graph_sims"][u], kind="stable")
        bufs["graph_ids"][u] = bufs["graph_ids"][u][o]
        bufs["graph_sims"][u] = bufs["graph_sims"][u][o]

    def _drop_from_rev(self, v: int, u: int) -> bool:
        """Remove ``u`` from rev(v), shift-compacting so free lanes stay
        at the tail (where append_user's patch expects them)."""
        rev = self._bufs["rev_ids"]
        keep = rev[v] != u
        if keep.all():
            return False
        row = rev[v][keep]
        rev[v] = PAD_ID
        rev[v, : len(row)] = row
        return True

    def remove_user(self, u: int):
        """Tombstone ``u`` and patch its known incident edges out.

        The reverse table is bounded, so the patch is best effort: the
        tombstone mask is what keeps a dead id from being seeded, scored
        or returned. Cluster memberships are kept; the router filters dead
        members. The freed row joins the reuse list.
        """
        if self._wal is not None:
            self._wal.record("remove_user", u=int(u))
        u = self._check_live(u)
        bufs = self._bufs
        graph_ids, graph_sims = bufs["graph_ids"], bufs["graph_sims"]
        touched = {u}
        for w in bufs["rev_ids"][u]:  # u leaves in-neighbors' forward rows
            if w == PAD_ID:
                continue
            w = int(w)
            lanes = graph_ids[w] == u
            if lanes.any():
                graph_ids[w][lanes] = PAD_ID
                graph_sims[w][lanes] = NEG_INF
                self._resort_row(w)
                touched.add(w)
        for v in graph_ids[u]:  # u leaves out-neighbors' reverse rows
            if v == PAD_ID:
                continue
            if self._drop_from_rev(int(v), u):
                touched.add(int(v))
        graph_ids[u] = PAD_ID
        graph_sims[u] = NEG_INF
        bufs["rev_ids"][u] = PAD_ID
        bufs["words"][u] = 0
        bufs["card"][u] = 0
        bufs["tombstone"][u] = True
        bufs["last_touch"][u] = 0
        heapq.heappush(self._free_rows, u)
        self.version += 1
        self._journal_rows(tuple(sorted(touched)))
        self._journal_tomb((u,))

    def swap_profile(self, u: int, words_row: np.ndarray, card_row: int):
        """Replace ``u``'s fingerprint and re-score every edge incident to
        it; the topology is untouched (:meth:`relink_user` moves it)."""
        if self._wal is not None:
            self._wal.record("swap_profile", u=int(u),
                             words_row=np.asarray(words_row),
                             card_row=card_row)
        u = self._check_live(u)
        bufs = self._bufs
        bufs["words"][u] = np.asarray(words_row, np.uint32)
        bufs["card"][u] = card_row
        graph_ids, graph_sims = bufs["graph_ids"], bufs["graph_sims"]
        touched = {u}
        for j, v in enumerate(graph_ids[u]):
            if v != PAD_ID:
                graph_sims[u, j] = self._pair_sim(u, int(v))
        self._resort_row(u)
        for w in bufs["rev_ids"][u]:  # in-neighbors' lanes pointing at u
            if w == PAD_ID:
                continue
            w = int(w)
            lanes = graph_ids[w] == u
            if lanes.any():
                graph_sims[w][lanes] = self._pair_sim(w, u)
                self._resort_row(w)
                touched.add(w)
        self.version += 1
        self._journal_rows(tuple(sorted(touched)))

    def relink_user(self, u: int, nbr_ids: np.ndarray,
                    nbr_sims: np.ndarray):
        """Replace ``u``'s forward row with a fresh search result and
        restore mutuality; ``u`` itself and tombstoned ids are dropped."""
        if self._wal is not None:
            self._wal.record("relink_user", u=int(u),
                             nbr_ids=np.asarray(nbr_ids),
                             nbr_sims=np.asarray(nbr_sims))
        u = self._check_live(u)
        bufs = self._bufs
        graph_ids, graph_sims = bufs["graph_ids"], bufs["graph_sims"]
        rev_ids = bufs["rev_ids"]
        k, r = self.k, rev_ids.shape[1]
        nbr_ids = np.asarray(nbr_ids)
        nbr_sims = np.asarray(nbr_sims, dtype=np.float32)
        ok = (nbr_ids != PAD_ID) & (nbr_ids != u) \
            & ~bufs["tombstone"][np.clip(nbr_ids, 0, self._n - 1)]
        valid = np.flatnonzero(ok)[:k]
        order = valid[np.argsort(-nbr_sims[valid], kind="stable")]
        row_ids = np.full(k, PAD_ID, dtype=np.int32)
        row_sims = np.full(k, NEG_INF, dtype=np.float32)
        row_ids[: len(order)] = nbr_ids[order]
        row_sims[: len(order)] = nbr_sims[order]

        touched = {u}
        new_set = set(int(v) for v in row_ids if v != PAD_ID)
        for v in graph_ids[u]:  # detach from dropped out-neighbors
            if v == PAD_ID or int(v) in new_set:
                continue
            if self._drop_from_rev(int(v), u):
                touched.add(int(v))
        graph_ids[u] = row_ids
        graph_sims[u] = row_sims
        for v, s in zip(row_ids, row_sims):
            if v == PAD_ID:
                break
            v = int(v)
            touched.add(v)
            if u not in rev_ids[v]:  # u → v now exists
                free = np.flatnonzero(rev_ids[v] == PAD_ID)
                rev_ids[v, free[0] if len(free) else r - 1] = u
            # Mutual bounded-heap insert of u into v's forward row (or a
            # sim refresh when the edge already exists).
            lanes = graph_ids[v] == u
            if lanes.any():
                graph_sims[v][lanes] = s
                self._resort_row(v)
                continue
            eff = np.where(graph_ids[v] == PAD_ID, NEG_INF, graph_sims[v])
            j = int(np.argmin(eff))
            if s > eff[j]:
                graph_ids[v, j] = u
                graph_sims[v, j] = s
                self._resort_row(v)
                if v not in rev_ids[u]:  # v → u now exists
                    free = np.flatnonzero(rev_ids[u] == PAD_ID)
                    rev_ids[u, free[0] if len(free) else r - 1] = v
        self.version += 1
        self._journal_rows(tuple(sorted(touched)))

    def touch_row(self, u: int, clock: int):
        """Stamp ``u``'s TTL clock (host-only state: no journal entry and
        no version bump, but write-ahead logged, since TTL expiry after a
        recovery must match the engine that never crashed)."""
        if self._wal is not None:
            self._wal.record("touch_row", u=int(u), clock=int(clock))
        self._bufs["last_touch"][self._check_live(u)] = clock

    # -- cohort refresh (amortized re-clustering) --------------------------

    def refresh_cohort(self, items: np.ndarray, offsets: np.ndarray,
                       user_ids: np.ndarray,
                       max_cluster: int | None = None) -> int:
        """Re-run C² clustering on an inserted cohort; returns the number
        of new routable clusters registered.

        ``items``/``offsets`` are the cohort profiles in CSR form, one row
        per user of ``user_ids``. The cohort is hashed with the index's
        FRH seeds on the host and split as the build splits; a cohort
        cluster whose path names a known cluster folds its members into
        it, and unseen paths with two or more members become new clusters.
        """
        user_ids = np.asarray(user_ids, dtype=np.int32)
        if len(user_ids) == 0:
            return 0
        if max_cluster is None:
            base_sizes = np.diff(self.cluster_offsets)
            max_cluster = int(base_sizes.max()) if len(base_sizes) else 64
        # The WAL records the resolved max_cluster (the default depends on
        # consolidation, which a snapshot normalises) and is suspended for
        # the body: its add_cluster_member calls follow from this record.
        if self._wal is not None:
            self._wal.record("refresh_cohort", items=np.asarray(items),
                             offsets=np.asarray(offsets), user_ids=user_ids,
                             max_cluster=int(max_cluster))
        wal, self._wal = self._wal, None
        try:
            return self._refresh_cohort(items, offsets, user_ids,
                                        max_cluster)
        finally:
            self._wal = wal

    def _refresh_cohort(self, items, offsets, user_ids: np.ndarray,
                        max_cluster: int) -> int:
        item_h = hashing.item_hashes(np.asarray(items, np.int32),
                                     self.hash_seeds, self.b)
        cands = hashing.user_distinct_hashes_np(
            item_h, np.asarray(offsets, np.int64), self.split_depth)
        lut = self.path_lut()
        new_paths: list[tuple[int, tuple[int, ...]]] = []
        new_members: list[np.ndarray] = []
        for cfg in range(self.t):
            res = split_config(cands[cfg], max_cluster)
            for mem, path in zip(res.members, res.paths):
                users = user_ids[mem]
                ci = lut.get((cfg, path))
                if ci is not None:
                    known = set(self.cluster_users(ci).tolist())
                    for u in users:
                        if int(u) not in known:
                            self.add_cluster_member(ci, int(u))
                elif len(users) >= 2:  # singletons yield no routing value
                    new_paths.append((cfg, path))
                    new_members.append(users)
        if new_members:
            base_ci = self.n_clusters
            for i, mem in enumerate(new_members):  # journal new clusters
                for u in mem:
                    self._log_member(base_ci + i, int(u))
            depth = self.cluster_paths.shape[1] if self.n_clusters else \
                self.split_depth
            add_paths = np.full((len(new_paths), depth), NO_HASH,
                                dtype=np.int32)
            for i, (_, p) in enumerate(new_paths):
                add_paths[i, : min(len(p), depth)] = p[:depth]
            self.cluster_paths = (
                np.concatenate([self.cluster_paths, add_paths])
                if self.n_clusters else add_paths)
            self.cluster_config = np.concatenate(
                [self.cluster_config,
                 np.array([c for c, _ in new_paths], dtype=np.int32)])
            self.cluster_members = np.concatenate(
                [self.cluster_members] + new_members).astype(np.int32)
            sizes = np.array([len(m) for m in new_members], dtype=np.int64)
            self.cluster_offsets = np.concatenate(
                [self.cluster_offsets,
                 self.cluster_offsets[-1] + np.cumsum(sizes)])
        self._lut = None
        self.version += 1
        return len(new_members)

    # -- persistence -------------------------------------------------------

    def consolidate(self):
        """Fold online-inserted members into the cluster CSR."""
        if not self._extra_members:
            return
        members = [self.cluster_users(ci) for ci in range(self.n_clusters)]
        self.cluster_members = (
            np.concatenate(members) if members
            else np.zeros((0,), np.int32)).astype(np.int32)
        sizes = np.array([len(m) for m in members], dtype=np.int64)
        self.cluster_offsets = np.zeros(self.n_clusters + 1, dtype=np.int64)
        np.cumsum(sizes, out=self.cluster_offsets[1:])
        self._extra_members = {}
        self._lut = None

    @staticmethod
    def _pack_touched_log(log):
        """(version, rows) journal → (versions, flat rows, offsets)."""
        versions = np.array([v for v, _ in log], dtype=np.int64)
        lengths = np.array([len(rows) for _, rows in log], dtype=np.int64)
        offsets = np.zeros(len(log) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        flat = np.array([r for _, rows in log for r in rows],
                        dtype=np.int64)
        return versions, flat, offsets

    def _journal_arrays(self) -> dict:
        """The journals as the reference's ``jrn_*`` arrays."""
        rv, rf, ro = self._pack_touched_log(self._row_log)
        tv, tf, to = self._pack_touched_log(self._tomb_log)
        mem = (np.array(self._member_log, dtype=np.int64).reshape(-1, 3)
               if self._member_log else np.zeros((0, 3), dtype=np.int64))
        return {
            "jrn_row_versions": rv, "jrn_row_rows": rf,
            "jrn_row_offsets": ro,
            "jrn_row_base": np.int64(self._row_log_base),
            "jrn_tomb_versions": tv, "jrn_tomb_rows": tf,
            "jrn_tomb_offsets": to,
            "jrn_tomb_base": np.int64(self._tomb_log_base),
            "jrn_members": mem,
            "jrn_member_base": np.int64(self._member_log_base),
        }

    def _restore_journals(self, z) -> None:
        def unpack(versions, flat, offsets):
            return [(int(v), tuple(int(r) for r in flat[offsets[i]:
                                                        offsets[i + 1]]))
                    for i, v in enumerate(versions)]
        self._row_log = unpack(z["jrn_row_versions"], z["jrn_row_rows"],
                               z["jrn_row_offsets"])
        self._row_log_base = int(z["jrn_row_base"])
        self._tomb_log = unpack(z["jrn_tomb_versions"], z["jrn_tomb_rows"],
                                z["jrn_tomb_offsets"])
        self._tomb_log_base = int(z["jrn_tomb_base"])
        self._member_log = [(int(v), int(ci), int(u))
                            for v, ci, u in z["jrn_members"]]
        self._member_log_base = int(z["jrn_member_base"])

    def save(self, path: str | Path):
        self.consolidate()
        arrays = {name: getattr(self, name) for name in _ROWS + _TABLES}
        meta = {name: np.int64(getattr(self, name)) for name in _META}
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **arrays, **meta, **self._journal_arrays())

    @classmethod
    def load(cls, path: str | Path) -> "KNNIndex":
        with np.load(path) as z:
            kw = {name: z[name] for name in z.files
                  if name not in _META and not name.startswith("jrn_")}
            kw.update({name: int(z[name]) for name in _META})
            ix = cls(**kw)
            if "jrn_row_base" in z.files:  # pre-journal artifacts load too
                ix._restore_journals(z)
        return ix


def build_index(ds: Dataset, params: C2Params | None = None, *,
                gf: GoldFinger | None = None,
                plan: ClusterPlan | None = None,
                graph: KNNGraph | None = None,
                device="cuda") -> KNNIndex:
    """Package a built C² graph (or build one on ``device``) into a
    servable index. Pass ``graph``/``plan``/``gf`` from an existing build
    (e.g. ``launch/knn_build.build``) to avoid recomputation."""
    params = params or C2Params()
    if gf is None:
        gf = fingerprint_dataset(ds, n_bits=params.n_bits, seed=params.seed)
    if plan is None:
        plan = build_plan(ds, params, device=device)
    if plan.paths is None:
        raise ValueError("plan must retain split paths for routing")
    if graph is None:
        ids, sims = local_knn(plan, gf, params, device=device)
        graph = merge_partial(ids, sims, params.k, device=device)

    depth = params.split_depth
    paths = np.full((plan.n_clusters, depth), NO_HASH, dtype=np.int32)
    for ci, p in enumerate(plan.paths):
        paths[ci, : len(p)] = p[:depth]
    sizes = plan.sizes
    offsets = np.zeros(plan.n_clusters + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    members = (np.concatenate(plan.members) if plan.members
               else np.zeros((0,), np.int32)).astype(np.int32)

    return KNNIndex(
        graph_ids=graph.ids, graph_sims=graph.sims,
        words=gf.words, card=gf.card,
        rev_ids=reverse_neighbors_np(np.asarray(graph.ids), r_max=graph.k),
        hash_seeds=frh_seeds(params),
        cluster_paths=paths,
        cluster_config=plan.config_of,
        cluster_members=members,
        cluster_offsets=offsets,
        b=params.b,
        n_bits=gf.n_bits,
        fp_seed=params.seed,
        split_depth=depth,
    )
