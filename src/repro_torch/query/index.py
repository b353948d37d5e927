"""The servable KNN index artifact (build output → query input).

Port of ``repro.query.index``'s rows, tables and persistence. A
:class:`KNNIndex` bundles what the online query path needs:

* the merged C² graph (forward adjacency) and its reverse adjacency,
* the GoldFinger fingerprints of every indexed user,
* the FastRandomHash routing tables — per-configuration hash seeds plus
  the split-path → cluster-members mapping of the build's plan — so an
  unseen profile can be placed in its cluster per configuration
  (repro_torch/query/router.py).

The artifact is the reference's single ``.npz`` layout, both ways:
:meth:`KNNIndex.load` reads a file written by ``repro.launch.knn_build
--index-out`` (lifecycle columns and mutation journals included) and
:meth:`KNNIndex.save` writes one the reference loads back. The journals
are carried through unchanged; the online mutations that write them
(insert, delete, update) are later slices (ROADMAP queue 1 items 3 and 6).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from repro_torch.core.clustering import ClusterPlan, build_plan, frh_seeds
from repro_torch.core.hashing import NO_HASH
from repro_torch.core.local_knn import local_knn
from repro_torch.core.merge import merge_partial
from repro_torch.core.params import C2Params
from repro_torch.knn.greedy import reverse_neighbors_np
from repro_torch.sketch.goldfinger import GoldFinger, fingerprint_dataset
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
_TABLE_DTYPES = {"hash_seeds": np.int32, "cluster_paths": np.int32,
                 "cluster_config": np.int32, "cluster_members": np.int32,
                 "cluster_offsets": np.int64}


class KNNIndex:
    """A built C² graph packaged for online query serving (host numpy)."""

    def __init__(self, *, graph_ids, graph_sims, words, card, rev_ids,
                 hash_seeds, cluster_paths, cluster_config, cluster_members,
                 cluster_offsets, b, n_bits, fp_seed, split_depth,
                 version: int = 0, tombstone=None, last_touch=None,
                 journals: dict | None = None):
        n = int(np.asarray(graph_ids).shape[0])
        rows = {"graph_ids": graph_ids, "graph_sims": graph_sims,
                "words": words, "card": card, "rev_ids": rev_ids,
                "tombstone": tombstone, "last_touch": last_touch}
        for name in _ROWS:
            arr = rows[name]
            if arr is None:  # pre-lifecycle artifact: all rows live/untouched
                arr = np.full((n,), _ROW_FILL[name], dtype=_ROW_DTYPES[name])
            setattr(self, name, np.ascontiguousarray(arr, _ROW_DTYPES[name]))
        tables = {"hash_seeds": hash_seeds, "cluster_paths": cluster_paths,
                  "cluster_config": cluster_config,
                  "cluster_members": cluster_members,
                  "cluster_offsets": cluster_offsets}
        for name in _TABLES:
            setattr(self, name, np.asarray(tables[name], _TABLE_DTYPES[name]))
        self.b = int(b)
        self.n_bits = int(n_bits)
        self.fp_seed = int(fp_seed)
        self.split_depth = int(split_depth)
        self.version = int(version)
        # The reference's mutation journals (``jrn_*`` arrays), carried
        # through save/load unchanged; a fresh index has empty ones.
        self.journals = dict(journals) if journals else self._empty_journals()
        self._lut: dict | None = None

    @classmethod
    def from_arrays(cls, **arrays) -> "KNNIndex":
        """Build from the reference's row, table and meta arrays (and any
        ``jrn_*`` journal arrays), e.g. ``np.load(path)``'s contents."""
        journals = {k: v for k, v in arrays.items() if k.startswith("jrn_")}
        kw = {k: v for k, v in arrays.items() if not k.startswith("jrn_")}
        for name in _META:
            if name in kw:
                kw[name] = int(kw[name])
        return cls(**kw, journals=journals)

    def _empty_journals(self) -> dict:
        """Journal arrays of an index no mutation has touched, laid out as
        the reference writes them."""
        empty = np.zeros((0,), dtype=np.int64)
        one = np.zeros((1,), dtype=np.int64)
        return {
            "jrn_row_versions": empty, "jrn_row_rows": empty,
            "jrn_row_offsets": one, "jrn_row_base": np.int64(self.version),
            "jrn_tomb_versions": empty, "jrn_tomb_rows": empty,
            "jrn_tomb_offsets": one, "jrn_tomb_base": np.int64(self.version),
            "jrn_members": np.zeros((0, 3), dtype=np.int64),
            "jrn_member_base": np.int64(self.version - 1),
        }

    # -- shape accessors ---------------------------------------------------

    @property
    def n(self) -> int:
        return self.graph_ids.shape[0]

    @property
    def k(self) -> int:
        return self.graph_ids.shape[1]

    @property
    def t(self) -> int:
        return len(self.hash_seeds)

    @property
    def n_clusters(self) -> int:
        return len(self.cluster_config)

    def alive_ids(self) -> np.ndarray:
        """int64 ids of live rows, ascending."""
        return np.flatnonzero(~self.tombstone)

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
        """Members of cluster ``ci``."""
        return self.cluster_members[
            self.cluster_offsets[ci]:self.cluster_offsets[ci + 1]]

    # -- persistence -------------------------------------------------------

    def save(self, path: str | Path):
        arrays = {name: getattr(self, name) for name in _ROWS + _TABLES}
        meta = {name: np.int64(getattr(self, name)) for name in _META}
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **arrays, **meta, **self.journals)

    @classmethod
    def load(cls, path: str | Path) -> "KNNIndex":
        with np.load(path) as z:
            return cls.from_arrays(**{name: z[name] for name in z.files})


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
        plan = build_plan(ds, params)
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
