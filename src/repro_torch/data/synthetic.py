"""Statistics-matched synthetic datasets.

The container is offline, so the paper's six datasets (Table I) cannot be
downloaded. We generate synthetic item-based datasets that match each
dataset's published statistics: user count, item-universe size, mean profile
size, and a Zipf item-popularity law fitted so the dataset is "dense"
(MovieLens-like) or "sparse" (Amazon/DBLP/Gowalla-like). A ``scale``
parameter shrinks the user set (keeping mean |P_u| and the item universe)
so brute-force ground truth stays tractable on one CPU core.

Each generator also plants *community structure* (users draw most items from
one of C latent topics) so that KNN graphs are meaningful and clustering
quality is measurable — a pure iid-Zipf dataset has near-constant pairwise
similarity and makes every KNN algorithm look identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.types import Dataset


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_users: int
    n_items: int
    mean_profile: float   # paper's |P_u| column
    zipf_a: float         # item popularity exponent
    n_topics: int         # latent communities
    topic_affinity: float  # fraction of a profile drawn from the home topic


# Paper Table I statistics. "synth" is a CI-sized non-paper dataset for
# serving demos and smoke benchmarks (small universe, strong communities).
PAPER_DATASETS = {
    "synth": DatasetSpec("synth", 4_000, 2_000, 60.0, 1.1, 16, 0.8),
    "ml1M":  DatasetSpec("ml1M", 6_038, 3_533, 95.28, 1.1, 24, 0.75),
    "ml10M": DatasetSpec("ml10M", 69_816, 10_472, 84.30, 1.1, 48, 0.75),
    "ml20M": DatasetSpec("ml20M", 138_362, 22_884, 88.14, 1.1, 64, 0.75),
    "AM":    DatasetSpec("AM", 57_430, 171_356, 56.82, 1.3, 96, 0.8),
    "DBLP":  DatasetSpec("DBLP", 18_889, 203_030, 36.67, 1.4, 128, 0.85),
    "GW":    DatasetSpec("GW", 20_270, 135_540, 54.64, 1.3, 96, 0.8),
}


def _zipf_weights(n: int, a: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
    return w / w.sum()


def make_dataset(name: str, scale: float = 1.0, seed: int = 0,
                 min_profile: int = 20) -> Dataset:
    """Generate a statistics-matched synthetic dataset.

    ``scale`` multiplies the user count (the paper filters users with <20
    ratings; we enforce ``min_profile`` the same way).
    """
    spec = PAPER_DATASETS[name]
    rng = np.random.default_rng(seed)
    n_users = max(64, int(round(spec.n_users * scale)))
    n_items = spec.n_items
    n_topics = spec.n_topics

    # Item → topic assignment: contiguous blocks over the popularity-ranked
    # item list so every topic has both popular and niche items.
    item_topic = rng.integers(0, n_topics, size=n_items)
    global_w = _zipf_weights(n_items, spec.zipf_a)
    # Per-topic sampling weights: global popularity restricted to the topic.
    topic_items = [np.where(item_topic == t)[0] for t in range(n_topics)]
    topic_w = [global_w[ti] / global_w[ti].sum() for ti in topic_items]

    user_topic = rng.integers(0, n_topics, size=n_users)
    # Profile sizes: lognormal around the paper's mean, clipped at
    # [min_profile, 16·mean] like the paper's ≥20-ratings filter.
    mu = np.log(spec.mean_profile)
    sizes = np.clip(
        rng.lognormal(mean=mu, sigma=0.6, size=n_users),
        min_profile, spec.mean_profile * 16,
    ).astype(np.int64)
    sizes = np.minimum(sizes, n_items // 2)

    rows = []
    for u in range(n_users):
        sz = int(sizes[u])
        t = int(user_topic[u])
        n_home = int(round(sz * spec.topic_affinity))
        ti, tw = topic_items[t], topic_w[t]
        n_home = min(n_home, len(ti))
        home = rng.choice(ti, size=n_home, replace=False, p=tw) if n_home else np.empty(0, np.int64)
        n_bg = sz - n_home
        bg = rng.choice(n_items, size=n_bg, replace=False, p=global_w) if n_bg > 0 else np.empty(0, np.int64)
        rows.append(np.unique(np.concatenate([home, bg])).astype(np.int32))

    sizes = np.array([len(r) for r in rows], dtype=np.int64)
    offsets = np.zeros(n_users + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    return Dataset(
        name=f"{name}@{scale:g}",
        n_users=n_users,
        n_items=n_items,
        items=np.concatenate(rows).astype(np.int32),
        offsets=offsets,
    )


def train_test_split(ds: Dataset, test_frac: float = 0.2, seed: int = 0):
    """Per-user item holdout for the recommendation experiment (Table III).

    Returns (train Dataset, test item lists). Mirrors the paper's 5-fold
    cross-validation: each fold holds out ``test_frac`` of every profile.
    """
    rng = np.random.default_rng(seed)
    train_rows, test_rows = [], []
    for u in range(ds.n_users):
        p = ds.profile(u)
        n_test = max(1, int(len(p) * test_frac))
        perm = rng.permutation(len(p))
        test_rows.append(np.sort(p[perm[:n_test]]))
        train_rows.append(np.sort(p[perm[n_test:]]))
    sizes = np.array([len(r) for r in train_rows], dtype=np.int64)
    offsets = np.zeros(ds.n_users + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    train = Dataset(
        name=f"{ds.name}:train", n_users=ds.n_users, n_items=ds.n_items,
        items=np.concatenate(train_rows).astype(np.int32), offsets=offsets,
    )
    return train, test_rows
