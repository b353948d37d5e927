"""Sharded query serving: partition a :class:`KNNIndex` into shards (torch
port of ``repro.query.sharded``).

Serving reuses the build's partition axis: clusters are LPT-assigned to
shards by member count (``core/distributed.lpt_assign``), each shard owns
the *residents* of its clusters (the union of their members, plus an
id-strided share of unclustered users so every indexed row lives
somewhere), and each shard materialises a self-contained local subgraph —
adjacency rows of its residents with neighbour ids remapped to
shard-local indices (cross-shard edges drop to PAD), its residents'
fingerprints, cards and tombstones, and a local→global id map.

A query is routed once (global FRH placement); each routed seed goes to
exactly ONE shard, the shard that *owns* the seed user (users are claimed
by their largest cluster in LPT order), so the shards explore disjoint
basins. Beam descent runs per shard over its local subgraph, and the
per-shard top-k results, in global ids, are merged shard-major with
``knn/topk.merge_topk``. The reference vmaps the descent over the shard
axis on one device (its Pallas hop batches the shard axis into one
``pallas_call``) or runs it under ``shard_map`` with a device per shard.
The port has both layouts behind :class:`ShardTables`: stacked ``[S, cap,
·]`` tables on one device, each hop ONE launch for all shards (the shard a
grid axis of both hop kernels, ``kernels/descent_score/
ops.descent_hop_sharded``); or one device per shard (a list of devices,
which may repeat one), each hop one launch per shard on its own device,
the shards' results copied to the first device and merged there, as the
reference merges after its ``shard_map``. ``ShardedDescent(devices=None)``
stacks: the per-device layout is taken only when a device list is passed,
since on one H100 and on four it measured slower than one launch for all
shards (PERF.md §6). Both layouts give the same bits.

Each shard's beam is ``max(k, ceil(oversample · beam / n_shards))`` (the
reference's ``oversample``, default 1.5): the fleet's total frontier stays
~``oversample ×`` the single placement's, and every shard's selection is
``n_shards ×`` narrower.

Incremental resharding (:meth:`ShardedDescent.sync`): the partition is
frozen at construction and *extended*, never re-balanced, as the index
mutates. New clusters go round-robin to shards, new users to their home
shard ``u % S`` plus wherever their clusters live; both rules are pure
functions of (base plan, current index), so a delta-maintained state is
bitwise-equal to a from-scratch rematerialisation under
:func:`extend_plan`. An insert burst costs one row scatter per shard,
consuming the index's row, tombstone and membership journals, and the
tables keep their shapes (``cap`` doubles geometrically). A shard is
rematerialised when a *pre-existing* user gains residency on it (a cohort
refresh registering it in a new cluster: its in-edges must be remapped);
everything is rebuilt when ``cap`` crosses a doubling boundary or a
journal no longer reaches back to the synced version.

Re-balancing (:meth:`ShardedDescent.adopt_plan`, driven by
``query/rebalance.py``) swaps in a freshly derived partition between
scheduler steps: every table is rebuilt from the index, ``generation``
counts the swaps, and in-flight beams follow through the old → new
local-id map, rows evicted from a shard mapping to PAD.

Degraded serving (:meth:`ShardedDescent.set_dead`, driven by
``faults/failover.py``): a dead shard's owned seeds are dropped and its
merge lanes set to PAD / -inf. The mask lives on the host and stays out
of the kernels: the hop launches still cover all S shards, and a dead
shard's blocks see all-PAD beams and score nothing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.distributed import lpt_assign, lpt_loads
from repro_torch.core.local_knn import capacity_of
from repro_torch.device import resolve_device, resolve_devices
from repro_torch.knn.topk import merge_topk
from repro_torch.query.index import KNNIndex
from repro_torch.query.search import (batched_descent_sharded, map_shard_ids,
                                      new_slot_part, shard_slot_admit,
                                      shard_slot_hop, shard_slot_prefix,
                                      slot_prefix_stable)
from repro_torch.sketch.goldfinger import words_tensor
from repro_torch.types import NEG_INF, PAD_ID


@dataclasses.dataclass
class ShardPlan:
    """Static cluster → shard partition of an index."""

    n_shards: int
    cluster_shard: np.ndarray     # int64[n_clusters]
    residents: list[np.ndarray]   # sorted unique global user ids per shard
    owner: np.ndarray             # int64[n] — the one shard seeding each user
    imbalance: float              # max/mean assigned cluster-size load
    version: int = -1             # index.version at derivation (journal
                                  # floor for extend_plan's scoped scans)
    resident_configs: int = 0     # tiered residency: only clusters of hash
                                  # configurations < this contribute
                                  # residents (0 = all t configurations)

    @property
    def base_n(self) -> int:
        """Users covered by this plan (== index.n when it was derived)."""
        return len(self.owner)

    def validate(self) -> "ShardPlan":
        """Raise unless every user's owner shard hosts it: seeds are
        explored only on their owner shard (:meth:`ShardedDescent.
        shard_seeds`), so an owned row missing from its shard would drop
        the user's whole basin silently."""
        for s, res in enumerate(self.residents):
            owned = np.flatnonzero(self.owner == s)
            hosted = np.isin(owned, res, assume_unique=False)
            if not hosted.all():
                bad = owned[~hosted][:8]
                raise AssertionError(
                    f"shard {s} owns users it does not host "
                    f"(e.g. {bad.tolist()}): their owner-partitioned "
                    f"seeds would be silently dropped")
        return self


def plan_shards(index: KNNIndex, n_shards: int, *,
                resident_configs: int = 0) -> ShardPlan:
    """LPT bin-packing of FRH clusters onto ``n_shards`` serving shards.

    Serving cost is linear in resident rows, so clusters are weighed by
    member count (the build's brute force weighs them by its square).
    Besides the overlapping resident sets, the plan fixes a disjoint
    *ownership*: every user belongs to the shard of the largest cluster
    claiming it. ``resident_configs`` = m > 0 restricts residency and
    ownership claims to clusters of the first m hash configurations
    (tiered residency); users in no selected cluster ride the leftover
    stride, so coverage stays total.
    """
    rc = resident_configs if 0 < resident_configs < index.t else 0
    sizes = index.cluster_sizes().astype(np.float64)
    res_cluster = (np.asarray(index.cluster_config) < rc if rc
                   else np.ones(index.n_clusters, dtype=bool))
    eff = np.where(res_cluster, sizes, 0.0)
    assign = lpt_assign(eff, n_shards)
    residents: list[np.ndarray] = []
    covered = np.zeros(index.n, dtype=bool)
    for s in range(n_shards):
        mems = [index.cluster_users(ci)
                for ci in np.flatnonzero((assign == s) & res_cluster)]
        res = (np.unique(np.concatenate(mems)).astype(np.int64)
               if mems else np.zeros(0, np.int64))
        res = res[(res >= 0) & (res < index.n)]
        residents.append(res)
        covered[res] = True
    owner = np.full(index.n, -1, dtype=np.int64)
    for ci in np.argsort(-eff, kind="stable"):  # big clusters claim first
        if not res_cluster[ci]:
            continue  # non-resident configurations cannot claim owners
        mem = index.cluster_users(int(ci))
        mem = mem[(mem >= 0) & (mem < index.n)]
        free = mem[owner[mem] < 0]
        owner[free] = assign[ci]
    # Unclustered users get a home shard; the same stride assigns
    # residency AND ownership, so ``owner ∈ residents`` holds.
    leftovers = np.flatnonzero(~covered)
    if len(leftovers):
        residents = [np.union1d(res, leftovers[s::n_shards])
                     for s, res in enumerate(residents)]
        for s in range(n_shards):
            owner[leftovers[s::n_shards]] = s
    # Balance: assigned resident cluster-size mass per shard.
    loads = lpt_loads(eff, assign, n_shards)
    imbalance = float(loads.max() / max(loads.mean(), 1e-9))
    return ShardPlan(n_shards=n_shards, cluster_shard=assign,
                     residents=residents, owner=owner, imbalance=imbalance,
                     version=index.version,
                     resident_configs=rc).validate()


def extend_plan(base: ShardPlan, index: KNNIndex) -> ShardPlan:
    """Extend a frozen partition to the index's current state.

    The base assignment never re-balances; growth follows rules that are
    pure functions of (base, current index), so the journal-driven delta
    of :meth:`ShardedDescent.sync` and this one-shot re-derivation agree
    exactly:

    * clusters unseen by ``base`` go round-robin: shard ``ci % S``;
    * users unseen by ``base`` live on (and are owned by) their home shard
      ``u % S``, plus every shard whose clusters register them;
    * membership is append-only, so resident sets only grow.

    Membership scans are scoped by the journal (only clusters born or
    membership-touched since ``base`` can add residents); when the
    membership journal no longer reaches back to ``base.version`` every
    cluster is scanned instead — the same result.
    """
    S = base.n_shards
    base_nc = len(base.cluster_shard)
    n = index.n
    rc = base.resident_configs
    cluster_shard = np.concatenate([
        base.cluster_shard,
        np.arange(base_nc, index.n_clusters, dtype=np.int64) % S])
    res_cluster = (np.asarray(index.cluster_config) < rc if rc
                   else np.ones(index.n_clusters, dtype=bool))
    owner = np.concatenate([
        base.owner, np.arange(base.base_n, n, dtype=np.int64) % S])
    home = np.arange(base.base_n, n, dtype=np.int64)
    mems = (index.members_added_since(base.version)
            if base.version >= 0 else None)
    if mems is None:  # journal expired (or a pre-journal plan): full scan
        scan = [np.flatnonzero((cluster_shard == s) & res_cluster)
                for s in range(S)]
    else:
        touched = ({int(ci) for ci, _ in mems}
                   | set(range(base_nc, index.n_clusters)))
        scan = [sorted(ci for ci in touched
                       if cluster_shard[ci] == s and res_cluster[ci])
                for s in range(S)]
    residents = []
    for s in range(S):
        parts = [base.residents[s], home[home % S == s]]
        for ci in scan[s]:
            mem = index.cluster_users(int(ci)).astype(np.int64)
            parts.append(mem[(mem >= 0) & (mem < n)])
        residents.append(np.unique(np.concatenate(parts)))
    sizes = index.cluster_sizes().astype(np.float64)
    loads = lpt_loads(np.where(res_cluster, sizes, 0.0), cluster_shard, S)
    imbalance = float(loads.max() / max(loads.mean(), 1e-9))
    return ShardPlan(n_shards=S, cluster_shard=cluster_shard,
                     residents=residents, owner=owner, imbalance=imbalance,
                     version=base.version, resident_configs=rc).validate()


TABLES = ("l_graph", "l_rev", "l_words", "l_card", "l2g", "l_tomb")


def _upload(dev, graph, rev, words, card, l2g, tomb) -> tuple:
    """Host tables (any leading axes) → tensors on ``dev``, in
    :data:`TABLES` order."""
    return (torch.from_numpy(graph).to(dev), torch.from_numpy(rev).to(dev),
            words_tensor(words, dev), torch.from_numpy(card).to(dev),
            torch.from_numpy(l2g).to(dev), torch.from_numpy(tomb).to(dev))


class ShardTables:
    """The device tables of S shards, in one of two layouts.

    * **stacked** (``devices`` None): one ``[S, cap, ·]`` set on
      ``device``; each hop is ONE launch for every shard (the shard a grid
      axis of both hop kernels);
    * **per device**: shard s's ``[1, cap, ·]`` set on ``devices[s]``; each
      hop is one launch per shard, on its own device (the reference's mesh,
      one device per shard). A device may repeat.

    :attr:`parts` lists ``(lo, hi, device, tables)``: shards ``[lo, hi)``
    and their tables in :data:`TABLES` order (``l_graph int32[·, cap, kg],
    l_rev int32[·, cap, kr], l_words int32[·, cap, W]`` bit-views,
    ``l_card int32[·, cap], l2g int32[·, cap], l_tomb bool[·, cap]``).
    """

    def __init__(self, n_shards: int, device, devices=None):
        self.per_device = devices is not None
        spans = ([(s, s + 1, d) for s, d in enumerate(devices)]
                 if self.per_device else [(0, n_shards, device)])
        self.parts = [(lo, hi, dev, ()) for lo, hi, dev in spans]

    def load(self, *host) -> None:
        """Install every shard's tables from host arrays ``[S, cap, ·]``."""
        self.parts = [(lo, hi, dev, _upload(dev, *(a[lo:hi] for a in host)))
                      for lo, hi, dev, _ in self.parts]

    def _find(self, s: int):
        for lo, hi, dev, tables in self.parts:
            if lo <= s < hi:
                return s - lo, dev, tables
        raise IndexError(f"no shard {s}")

    def set_shard(self, s: int, *host) -> None:
        """Overwrite shard ``s``'s tables with host arrays ``[cap, ·]``."""
        i, dev, tables = self._find(s)
        for a, u in zip(tables, _upload(dev, *host)):
            a[i].copy_(u)

    def scatter(self, s: int, rows: np.ndarray, *host) -> None:
        """Write host rows ``[len(rows), ·]`` into shard ``s``'s local rows
        ``rows``."""
        i, dev, tables = self._find(s)
        li = torch.from_numpy(rows.astype(np.int64)).to(dev)
        for a, u in zip(tables, _upload(dev, *host)):
            a[i].index_copy_(0, li, u)

    def stacked(self) -> tuple:
        """Every shard's tables ``[S, cap, ·]``: the stacked layout's own
        tensors, or the per-device tables gathered on the first device."""
        if len(self.parts) == 1:
            return self.parts[0][3]
        dev = self.parts[0][2]
        return tuple(torch.cat([p[3][i].to(dev) for p in self.parts])
                     for i in range(len(TABLES)))


class ShardedDescent:
    """Per-shard local subgraphs and the descent/merge over them.

    Owned by a :class:`~repro_torch.query.plan.DescentPlan`'s sharded
    placement. :attr:`tables` (:class:`ShardTables`) holds the device
    tables, stacked on ``device`` or one shard per entry of ``devices``
    (the reference's ``use_mesh``; a one-entry list stacks every shard on
    it). ``devices`` None stacks every shard on ``device``: the per-device
    layout is opt-in, unlike the reference's rule, because it measured
    slower on every workload so far. ``_g2l`` (host int32[S,
    index capacity]) maps global rows to each shard's local rows, PAD where
    not resident. :meth:`sync` repairs both after index mutations.
    """

    def __init__(self, index: KNNIndex, n_shards: int,
                 plan: ShardPlan | None = None, *, oversample: float = 1.5,
                 resident_configs: int = 0, device="cuda", devices=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.index = index
        self.oversample = oversample
        self.base_plan = plan or plan_shards(
            index, n_shards, resident_configs=resident_configs)
        self.plan = self.base_plan
        S = self.plan.n_shards
        if devices is None:
            self.device = resolve_device(device)
        else:
            devices = resolve_devices(devices)
            if len(devices) not in (1, S):
                raise ValueError(f"{S} shards need {S} devices (or one, "
                                 f"stacked), got {len(devices)}")
            self.device = devices[0]  # where shards' results merge
            if len(devices) == 1:  # the reference's use_mesh=False
                devices = None
        self.devices = devices
        self.tables = ShardTables(S, self.device, devices)
        # Bumped by every re-balance swap (adopt_plan): the tables, plan
        # and pending beam remap move together between scheduler steps.
        self.generation = 0
        # Pending old-local → new-local id map for in-flight slot beams
        # ([S, cap at the snapshot] or None); see take_beam_remap().
        self._beam_remap: np.ndarray | None = None
        self.last_hop_stats: np.ndarray | None = None
        # Degraded-serving mask (set_dead): True where a shard must not
        # seed or contribute to merges.
        self.dead = np.zeros(S, dtype=bool)
        self._materialize()

    @property
    def layout(self) -> str:
        """``"per-device"`` (one launch a shard) or ``"stacked"``."""
        return "per-device" if self.tables.per_device else "stacked"

    @property
    def _dev(self) -> tuple:
        """Every shard's device tables ``[S, cap, ·]`` in :data:`TABLES`
        order (gathered on the first device in the per-device layout)."""
        return self.tables.stacked()

    # -- tensor materialisation / repair -----------------------------------

    @staticmethod
    def _remap(g2l_row: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Global → shard-local ids; non-resident targets become PAD."""
        safe = np.where(ids == PAD_ID, 0, ids)
        return np.where(ids == PAD_ID, PAD_ID, g2l_row[safe])

    def _shard_block(self, s: int, cap: int):
        """Host tables of shard ``s`` at ``cap`` rows (the rebuild unit):
        (l2g, g2l, graph, rev, words, card, tomb)."""
        ix = self.index
        res = self.plan.residents[s]
        m = len(res)
        kg, kr = ix.k, ix.rev_ids.shape[1]
        W = ix.words.shape[1]
        l2g = np.full(cap, PAD_ID, dtype=np.int32)
        l2g[:m] = res
        # Capacity-width (not n-width): the map grows only on the index's
        # own doubling boundaries.
        g2l = np.full(ix.capacity, PAD_ID, dtype=np.int32)
        g2l[res] = np.arange(m, dtype=np.int32)
        graph = np.full((cap, kg), PAD_ID, dtype=np.int32)
        rev = np.full((cap, kr), PAD_ID, dtype=np.int32)
        words = np.zeros((cap, W), dtype=np.uint32)
        card = np.zeros(cap, dtype=np.int32)
        tomb = np.zeros(cap, dtype=bool)
        graph[:m] = self._remap(g2l, ix.graph_ids[res])
        rev[:m] = self._remap(g2l, ix.rev_ids[res])
        words[:m] = ix.words[res]
        card[:m] = ix.card[res]
        tomb[:m] = ix.tombstone[res]
        return l2g, g2l, graph, rev, words, card, tomb

    def _materialize(self):
        """Full (re)build of every shard's tables: first use, ``cap``
        crossings, journal expiry and re-balance swaps."""
        ix = self.index
        S = self.plan.n_shards
        cap = max(capacity_of(len(r), minimum=64)
                  for r in self.plan.residents)
        self.cap = cap
        blocks = [self._shard_block(s, cap) for s in range(S)]
        self._g2l = np.stack([b[1] for b in blocks])
        self.tables.load(*(np.stack([b[i] for b in blocks])
                           for i in (2, 3, 4, 5, 0, 6)))
        self.version = ix.version
        self._n_seen = ix.n

    def _l2g_host(self) -> np.ndarray:
        """Every shard's local → global map read back, host int32[S,
        cap]."""
        return np.concatenate([p[3][4].cpu().numpy()
                               for p in self.tables.parts])

    def sync(self) -> str:
        """Repair the device tables to the index's current version.

        Returns "noop" | "delta" | "rebuild". The delta path consumes the
        index's row, tombstone and membership journals and scatters only
        touched rows into affected shards; a shard where a pre-existing
        user gained residency is rematerialised whole (its local ids
        shift, and the old → new map is recorded for in-flight beams).
        """
        ix = self.index
        if self.version == ix.version:
            return "noop"
        # Snapshot the local→global map before any mutation: if local ids
        # shift, in-flight slot beams need the old→new remap it produces.
        old_l2g = self._l2g_host()
        rows = ix.rows_changed_since(self.version)
        mems = ix.members_added_since(self.version)
        tombs = ix.tombstones_since(self.version)
        if rows is None or mems is None or tombs is None:  # journal expired
            self.plan = extend_plan(self.base_plan, ix)
            self._materialize()
            self._record_remap(old_l2g)
            return "rebuild"
        # Liveness flips ride the row journal too; the union is defensive.
        rows = rows | tombs
        old_n = self._n_seen
        S = self.plan.n_shards
        # Incremental plan extension (== extend_plan(base_plan, ix)).
        cluster_shard = np.concatenate([
            self.plan.cluster_shard,
            np.arange(len(self.plan.cluster_shard), ix.n_clusters,
                      dtype=np.int64) % S])
        owner = np.concatenate([
            self.plan.owner, np.arange(old_n, ix.n, dtype=np.int64) % S])
        g2l = self._g2l
        if g2l.shape[1] < ix.n:  # the index crossed a doubling boundary
            g2l = np.pad(g2l, ((0, 0), (0, ix.capacity - g2l.shape[1])),
                         constant_values=PAD_ID)
        rc = self.plan.resident_configs
        adds: list[set[int]] = [set() for _ in range(S)]
        for u in range(old_n, ix.n):
            adds[u % S].add(u)
        for ci, u in mems:
            if rc and int(ix.cluster_config[ci]) >= rc:
                continue  # tiered residency: configuration not resident
            s = int(cluster_shard[ci])
            if g2l[s, u] == PAD_ID:
                adds[s].add(u)
        residents = []
        stale: list[int] = []  # shards whose old rows need a remap pass
        for s in range(S):
            new = np.array(sorted(a for a in adds[s]
                                  if g2l[s, a] == PAD_ID), dtype=np.int64)
            if len(new) and new[0] < old_n:
                # A pre-existing user gained residency here (cohort
                # refresh): its in-edges on this shard predate the row
                # journal window, so the whole shard remaps.
                stale.append(s)
                residents.append(np.unique(
                    np.concatenate([self.plan.residents[s], new])))
            elif len(new):
                residents.append(
                    np.concatenate([self.plan.residents[s], new]))
            else:
                residents.append(self.plan.residents[s])
        # Imbalance stays stale on the delta path; rebuilds and
        # extend_plan refresh it.
        self.plan = ShardPlan(
            n_shards=S, cluster_shard=cluster_shard, residents=residents,
            owner=owner, imbalance=self.plan.imbalance,
            version=self.plan.version, resident_configs=rc)
        cap = max(capacity_of(len(r), minimum=64) for r in residents)
        if cap != self.cap:  # doubling boundary: shapes change anyway
            self._materialize()
            self._record_remap(old_l2g)
            return "rebuild"
        self._g2l = g2l
        for s in range(S):
            if s in stale:
                l2g_b, g2l_b, graph, rev, words, card, tomb = \
                    self._shard_block(s, cap)
                self._g2l[s] = g2l_b
                self.tables.set_shard(s, graph, rev, words, card, l2g_b,
                                      tomb)
                continue
            res = residents[s]
            # Delta adds are all fresh rows (ids >= old_n) here, so the
            # sorted resident array grew by pure appends: existing local
            # ids are untouched.
            new = res[np.searchsorted(res, old_n):]
            m_old = len(res) - len(new)
            if len(new):
                self._g2l[s, new] = np.arange(m_old, len(res),
                                              dtype=np.int32)
            # Touched rows resident here: journaled mutations + the new
            # rows themselves (remapped with the UPDATED g2l).
            touch = np.array(sorted({int(r) for r in rows
                                     if g2l_local(self._g2l[s], r)}
                                    | set(int(u) for u in new)),
                             dtype=np.int64)
            if not len(touch):
                continue
            self.tables.scatter(
                s, self._g2l[s, touch],
                self._remap(self._g2l[s], ix.graph_ids[touch]),
                self._remap(self._g2l[s], ix.rev_ids[touch]),
                ix.words[touch], ix.card[touch], touch.astype(np.int32),
                ix.tombstone[touch])
        self.version = ix.version
        self._n_seen = ix.n
        if stale:  # locals shifted on the rematerialised shards
            self._record_remap(old_l2g)
        return "delta"

    def adopt_plan(self, plan: ShardPlan) -> None:
        """Re-balance swap: install a freshly derived partition and rebuild
        every shard's tables in one host-side call between scheduler steps.

        The one reshard where residency is not monotone: rows move off
        shards. The rows are read from the index, which the port keeps on
        the host in both layouts: it holds the row content a merge of the
        old shard tables gives back (the reference's
        ``merge_subgraph_rows``; ``rebalance.merge_audit`` counts the lanes
        that merge would patch). In-flight slot beams follow through the recorded old → new local-id
        map: rows still resident keep descending under their new labels,
        evicted rows map to PAD (the continuous plan masks their sims).
        ``cap`` may change with the plan; the map is ``[S, old cap]``.
        """
        old_l2g = self._l2g_host()
        self.base_plan = plan
        self.plan = plan
        self._materialize()
        self._record_remap(old_l2g)
        self.generation += 1
        # Every shard's tables were rebuilt; the failover manager re-masks
        # the shards that are still unhealthy.
        self.dead = np.zeros(self.plan.n_shards, dtype=bool)

    def _record_remap(self, old_l2g: np.ndarray):
        """Accumulate an old-local → new-local id map after a reshard that
        may have shifted local ids. Under the frozen-base extension
        residency is monotone, so every previously resident row keeps a
        local id; after a re-balance swap (:meth:`adopt_plan`) rows that
        left a shard map to PAD there. PAD stays PAD."""
        S = old_l2g.shape[0]
        rows = np.arange(S)[:, None]
        safe = np.where(old_l2g == PAD_ID, 0, old_l2g)
        mp = np.where(old_l2g == PAD_ID, PAD_ID, self._g2l[rows, safe])
        if self._beam_remap is not None:  # compose with an unconsumed map
            prev = self._beam_remap
            psafe = np.where(prev == PAD_ID, 0, prev)
            mp = np.where(prev == PAD_ID, PAD_ID, mp[rows, psafe])
        self._beam_remap = mp.astype(np.int32)

    def take_beam_remap(self) -> np.ndarray | None:
        """Consume the pending old→new local-id map (int32[S, old cap]), or
        None when local ids were stable since the last take. The
        continuous plan applies it to in-flight per-shard slot beams
        before their next hop (:meth:`remap_slots`): the beams' contents
        (global identity and sims) are unchanged, only their local labels
        move."""
        mp, self._beam_remap = self._beam_remap, None
        return mp

    # -- serving -----------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    def set_dead(self, mask) -> None:
        """Install the degraded-serving mask (bool[n_shards]): dead shards
        stop receiving seeds and stop contributing to merges from the next
        descent on."""
        mask = np.asarray(mask, dtype=bool)
        assert mask.shape == (self.plan.n_shards,), mask.shape
        self.dead = mask.copy()

    def shard_seeds(self, seeds: np.ndarray) -> np.ndarray:
        """Partition routed global seeds by ownership and remap to local.

        Returns int32[S, q, cols]: each seed in shard-local ids on the one
        shard owning that user, PAD elsewhere, so the shards explore
        disjoint basins. Seeds owned by a dead shard are dropped, not
        re-homed (the survivors need not host those rows): their basins
        are the degraded window's recall loss.
        """
        S = self.n_shards
        safe = np.where(seeds == PAD_ID, 0, seeds)
        owned = ((self.plan.owner[safe][None]
                  == np.arange(S)[:, None, None])
                 & (seeds[None] != PAD_ID))              # [S, q, cols]
        if self.dead.any():
            owned &= ~self.dead[:, None, None]
        local = self._g2l[:, safe]
        return np.where(owned, local, PAD_ID)

    def _queries(self, q_words, q_card) -> dict:
        """Host query fingerprints on each distinct device of the parts."""
        out = {}
        for _, _, dev, _ in self.tables.parts:
            if dev not in out:
                out[dev] = (words_tensor(q_words, dev), torch.from_numpy(
                    np.asarray(q_card, dtype=np.int32)).to(dev))
        return out

    def _gather(self, parts_out, fn) -> torch.Tensor:
        """Each part's ``[s, ·]`` result copied to ``device`` and joined in
        shard order."""
        return torch.cat([fn(o).to(self.device) for o in parts_out])

    def descend(self, q_words, q_card, seeds: np.ndarray, *,
                k: int, beam: int, hops: int, kernel: bool = False,
                dma: bool = False):
        """Route-seeded descent on every shard + cross-shard top-k merge.

        ``q_words`` uint32[q, W] and ``q_card`` int32[q] host arrays,
        ``seeds`` global ids (router output, PAD padded); ``beam`` is the
        single-placement frontier, divided among shards
        (:meth:`shard_beam`). ``kernel`` selects the fused hop, ``dma``
        the DMA hop (bitwise the same results): per hop, one launch for
        the stacked shards, or one per shard on its own device (every
        device's hops queued before any result is read). The shards'
        ``[q, k]`` results and counts are copied to ``device`` and merged
        in shard order. Returns (ids int32[q, k], sims float32[q, k])
        tensors on ``device``, in global ids. ``last_hop_stats`` holds the
        call's per-query ``(n_scored, dma_bytes, bytes_saved)`` int32[q, 3]
        summed over the alive shards.
        """
        l_seeds = self.shard_seeds(np.asarray(seeds)).astype(np.int32)
        queries = self._queries(q_words, q_card)
        outs = [batched_descent_sharded(
            *tables, *queries[dev],
            torch.from_numpy(l_seeds[lo:hi]).to(dev), k=k,
            beam=self.shard_beam(beam, k), hops=hops, kernel=kernel,
            dma=dma) for lo, hi, dev, tables in self.tables.parts]
        ids, sims, stats = (self._gather(outs, lambda o, i=i: o[i])
                            for i in range(3))
        if self.dead.any():
            # On top of the seed drop: a dead shard adds nothing to the
            # merge or the counts, whatever its blocks computed.
            alive = torch.from_numpy(~self.dead).to(self.device)[:, None,
                                                                 None]
            ids = torch.where(alive, ids, PAD_ID)
            sims = torch.where(alive, sims, NEG_INF)
            stats = torch.where(alive, stats, 0)
        self.last_hop_stats = stats.sum(dim=0, dtype=torch.int32) \
            .cpu().numpy()
        return _merge_shard_topk(ids, sims, k)

    def shard_beam(self, beam: int, k: int) -> int:
        """Per-shard frontier width for a fleet-level ``beam``: the fleet's
        frontier is ~``oversample ×`` the single placement's."""
        return max(k, int(np.ceil(self.oversample * beam / self.n_shards)))

    def resident_bytes(self) -> list[int]:
        """Per-shard bytes of resident rows (adjacency, reverse adjacency,
        fingerprint words, card, l2g, tombstone); the padding to ``cap``
        is excluded."""
        per_row = self.index.row_bytes
        return [len(r) * per_row for r in self.plan.residents]

    # -- continuous slots: every shard's beams on its tables' device -------

    def new_slots(self, n_slots: int, W: int, beam: int,
                  k_prefix: int = 0) -> list:
        """Empty slot arrays, one set per part of :attr:`tables` on its
        device (the reference pins the beams' shard axis to the mesh):
        beams ``[shards of the part, n_slots, beam]``."""
        return [new_slot_part(n_slots, W, beam, k_prefix, dev,
                              shards=hi - lo)
                for lo, hi, dev, _ in self.tables.parts]

    def slot_admit(self, slots: list, q_words, q_card, seeds,
                   slot_idx: np.ndarray, *, beam: int) -> None:
        """Admit requests (host fingerprints, routed global seeds, their
        slots) into every shard's slot beams, in place: each shard
        initialises its rows from the seeds it owns."""
        l_seeds = self.shard_seeds(np.asarray(seeds)).astype(np.int32)
        queries = self._queries(q_words, q_card)
        for (lo, hi, dev, tables), sl in zip(self.tables.parts, slots):
            shard_slot_admit(
                tables[2], tables[3], *queries[dev],
                torch.from_numpy(l_seeds[lo:hi]).to(dev),
                torch.from_numpy(slot_idx).to(dev), sl.q_words, sl.q_card,
                sl.beam_ids, sl.beam_sims, beam=beam, l_tomb=tables[5])

    def slot_hop(self, slots: list, active: np.ndarray, *,
                 kernel: bool = False, dma: bool = False):
        """One hop of every shard's slot beams (``active`` bool[n_slots]
        rows keep the result). Returns ``(changed bool[n_slots], stats
        int32[n_slots, 3])`` on ``device``: a slot changed when its beam
        moved on any shard; the counts are summed over shards."""
        outs = []
        for (lo, hi, dev, tables), sl in zip(self.tables.parts, slots):
            sl.beam_ids, sl.beam_sims, changed, stats = shard_slot_hop(
                *tables[:4], sl.q_words, sl.q_card, sl.beam_ids,
                sl.beam_sims, torch.from_numpy(active).to(dev),
                kernel=kernel, dma=dma, l_tomb=tables[5])
            outs.append((changed, stats))
        changed, stats = (o.to(self.device) for o in outs[0])
        for c, s in outs[1:]:
            changed = changed | c.to(self.device)
            stats = stats + s.to(self.device)
        return changed, stats

    def slot_prefix_stable(self, slots: list, *, k: int) -> torch.Tensor:
        """Adaptive budgets: bool[n_slots] on ``device``, True where every
        shard's top-k prefix held since the last call (each part's prefix
        stored for the next)."""
        stable = None
        for sl in slots:
            st, sl.prefix_ids = slot_prefix_stable(sl.beam_ids,
                                                   sl.prefix_ids, k=k)
            st = st.to(self.device)
            stable = st if stable is None else stable & st
        return stable

    def slot_topk(self, slots: list, *, k: int):
        """Cross-shard top-k of every slot, in global ids on ``device``:
        each shard's k-prefix mapped through its l2g and merged shard-major,
        the sharded wave's bits."""
        pre = [shard_slot_prefix(tables[4], sl.beam_ids, sl.beam_sims, k=k)
               for (_, _, _, tables), sl in zip(self.tables.parts, slots)]
        return _merge_shard_topk(self._gather(pre, lambda o: o[0]),
                                 self._gather(pre, lambda o: o[1]), k)

    def remap_slots(self, slots: list, remap: np.ndarray) -> None:
        """Relabel in-flight beams through a reshard's old → new local-id
        map (:meth:`take_beam_remap`); lanes mapped to PAD (rows a swap
        evicted from their shard) lose their sims."""
        for (lo, hi, dev, _), sl in zip(self.tables.parts, slots):
            sl.beam_ids = map_shard_ids(
                torch.from_numpy(remap[lo:hi]).to(dev), sl.beam_ids)
            sl.beam_sims = torch.where(sl.beam_ids == PAD_ID, NEG_INF,
                                       sl.beam_sims)

    def mask_slots(self, slots: list, down: np.ndarray) -> None:
        """Wipe the slot beams of the shards ``down`` (bool[S]) in place."""
        for (lo, hi, dev, _), sl in zip(self.tables.parts, slots):
            d = torch.from_numpy(down[lo:hi]).to(dev)[:, None, None]
            sl.beam_ids.masked_fill_(d, PAD_ID)
            sl.beam_sims.masked_fill_(d, NEG_INF)


def g2l_local(g2l_row: np.ndarray, r: int) -> bool:
    """True when global row ``r`` is resident in this shard's map."""
    return r < len(g2l_row) and g2l_row[r] != PAD_ID


def _merge_shard_topk(ids: torch.Tensor, sims: torch.Tensor, k: int):
    """[S, q, k'] per-shard results → global top-k per query, merged
    shard-major (the column order decides ties)."""
    S, q, kk = ids.shape
    flat_ids = ids.transpose(0, 1).reshape(q, S * kk)
    flat_sims = sims.transpose(0, 1).reshape(q, S * kk)
    return merge_topk(flat_ids, flat_sims, k)
