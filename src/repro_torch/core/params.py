"""Cluster-and-Conquer parameters (paper §IV-C defaults; copy of
``repro.core.params``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class C2Params:
    k: int = 30                # neighborhood size (paper: 30)
    b: int = 4096              # clusters per hash function
    t: int = 8                 # number of hash functions (15 for DBLP/GW)
    max_cluster: int = 2000    # N, recursive-split threshold (4000 for ml20M)
    rho: int = 5               # Hyrec iteration bound in the ρk² switch
    n_bits: int = 1024         # GoldFinger width (paper experiments: 1024)
    seed: int = 0
    split_depth: int = 6       # precomputed distinct-hash depth for splitting
    use_goldfinger: bool = True  # Table V ablation: False → exact Jaccard
    use_pallas: bool = False   # reference field, kept so parameter sets
                               # match; the port picks the cluster-KNN
                               # kernel by tensor device instead

    @property
    def bf_threshold(self) -> int:
        """Brute-force-vs-Hyrec switch: |C| < ρ·k² → brute force (§II-F)."""
        return self.rho * self.k * self.k


# Per-dataset overrides from §IV-C.
PAPER_PARAMS = {
    "ml1M": C2Params(),
    "ml10M": C2Params(),
    "ml20M": C2Params(max_cluster=4000),
    "AM": C2Params(),
    "DBLP": C2Params(t=15),
    "GW": C2Params(t=15),
}


def params_for(dataset_name: str, **overrides) -> C2Params:
    base = PAPER_PARAMS.get(dataset_name.split("@")[0], C2Params())
    return dataclasses.replace(base, **overrides)
