"""The benchmark's own statistics-matched dataset generator.

The model is that of the port's generator (``data/synthetic.py``): a user
universe and an item universe of the paper's Table I sizes, Zipf item
popularity, items spread over latent topics, each user drawing about
``topic_affinity`` of a lognormal-sized profile from one home topic and the
rest from the whole universe by popularity, both without replacement. It is
rewritten here so that a dataset of MovieLens-10M's or AmazonMovies' size is
made in seconds, and so that later changes to the program cannot move the
yardstick's data:

* home items are drawn per topic at once, by exponential keys over the
  topic's items divided by their weights (the k smallest keys are a
  weighted draw without replacement);
* background items are drawn with replacement by inverse CDF and the first
  distinct draws kept, which is the same successive sampling;
* the lognormal's location is set so that the mean of the clipped profile
  sizes, after the home topic's cap, is Table I's mean profile (the port's
  generator centres it on the mean before clipping, which gives profiles
  about 1.2 times Table I's).

Item-side draws (topics) come from ``item_seed``, user-side draws from
``user_seed``: an index and its unseen queries share one item universe.
The generator imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

SIZE_SIGMA = 0.6          # the port generator's lognormal sigma
MIN_PROFILE = 20          # the paper's filter: users with >= 20 ratings
MAX_PROFILE_FACTOR = 16   # profiles clipped at 16 x the mean, as the port's


@dataclasses.dataclass(frozen=True)
class Data:
    """Profiles in CSR form: ``items[offsets[u]:offsets[u + 1]]`` is user
    u's sorted, distinct item ids."""

    n_users: int
    n_items: int
    items: np.ndarray    # int32[nnz]
    offsets: np.ndarray  # int64[n_users + 1]

    @property
    def sizes(self) -> np.ndarray:
        return np.diff(self.offsets)

    def profile(self, u: int) -> np.ndarray:
        return self.items[self.offsets[u]:self.offsets[u + 1]]


def sub_seed(seed: int, stream: int) -> np.random.SeedSequence:
    """An independent stream ``stream`` of run seed ``seed`` (any integer)."""
    return np.random.SeedSequence([int(seed) % (1 << 64), stream])


def _size_quantiles(mu: float, n: int = 4096) -> np.ndarray:
    """Profile sizes at ``n`` evenly spaced quantiles of the clipped
    lognormal, before rounding (a deterministic quadrature)."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.exp(mu + SIZE_SIGMA * z)


def size_location(mean: float, n_items: int, n_topics: int,
                  affinity: float) -> float:
    """The lognormal location at which the expected profile size, clipped
    to [MIN_PROFILE, MAX_PROFILE_FACTOR * mean] and with the home part
    capped at an average topic's items, is ``mean`` (bisection)."""
    hi_clip = min(MAX_PROFILE_FACTOR * mean, n_items // 2)
    topic = n_items / n_topics

    def expected(mu: float) -> float:
        s = np.clip(_size_quantiles(mu), MIN_PROFILE, hi_clip)
        return float(np.mean(np.minimum(s * affinity, topic)
                             + s * (1 - affinity)))

    lo, hi = math.log(mean) - 3.0, math.log(mean) + 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if expected(mid) < mean:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def sorted_unique(x: np.ndarray) -> np.ndarray:
    """The distinct values of ``x``, ascending (by a sort: some numpy
    versions make ``np.unique`` hash, several times slower here)."""
    x = np.sort(x)
    return x[np.r_[True, x[1:] != x[:-1]]] if len(x) else x


def first_occurrences(key: np.ndarray) -> np.ndarray:
    """Ascending positions of the first occurrence of each value."""
    order = np.argsort(key, kind="stable")
    k = key[order]
    first = order[np.r_[True, k[1:] != k[:-1]]] if len(k) else order
    return np.sort(first)


def zipf_weights(n: int, a: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
    return w / w.sum()


def _home_items(rng, user_topic, n_home, item_topic, weights, n_topics):
    """(user, item) pairs of every user's home part: per topic, the
    ``n_home[u]`` smallest of exponential keys over the topic's weights."""
    users, items = [], []
    for t in range(n_topics):
        us = np.flatnonzero(user_topic == t)
        ti = np.flatnonzero(item_topic == t)
        if len(us) == 0 or len(ti) == 0:
            continue
        tw = weights[ti] / weights[ti].sum()
        keys = rng.standard_exponential((len(us), len(ti)),
                                        dtype=np.float32) / tw[None, :]
        cap = np.minimum(n_home[us], len(ti))
        top = int(cap.max())
        if top == 0:
            continue
        if top < len(ti):  # the `top` smallest keys of each row, in order
            part = np.argpartition(keys, top - 1, axis=1)[:, :top]
            order = np.take_along_axis(part, np.argsort(
                np.take_along_axis(keys, part, axis=1), axis=1), axis=1)
        else:
            order = np.argsort(keys, axis=1)
        rows, cols = np.nonzero(np.arange(top)[None, :] < cap[:, None])
        users.append(us[rows])
        items.append(ti[order[rows, cols]])
    return np.concatenate(users), np.concatenate(items)


def _background_items(rng, n_bg, cdf):
    """(user, item) pairs: for each user the first ``n_bg[u]`` distinct of
    draws with replacement from the popularity law (successive sampling
    without replacement)."""
    n_items = len(cdf)
    todo = np.flatnonzero(n_bg > 0)
    users, items = [], []
    factor = 3
    while len(todo):
        need = n_bg[todo]
        m = need * factor + 32
        owner = np.repeat(todo, m)
        draw = np.searchsorted(cdf, rng.random(int(m.sum())), side="right")
        draw = np.minimum(draw, n_items - 1)
        key = owner.astype(np.int64) * n_items + draw
        first = first_occurrences(key)     # in draw order
        own = owner[first]
        # Rank of each distinct draw within its user, in draw order.
        starts = np.searchsorted(own, todo)
        rank = np.arange(len(first)) - np.repeat(starts, np.diff(
            np.append(starts, len(first))))
        quota = n_bg[own]
        keep = rank < quota
        users.append(own[keep])
        items.append(draw[first][keep])
        got = np.bincount(own[keep], minlength=len(n_bg))[todo]
        done = got >= need
        # Users short of distinct draws start again with more draws.
        short = todo[~done]
        if len(short):
            drop = np.isin(users[-1], short)
            users[-1], items[-1] = users[-1][~drop], items[-1][~drop]
        todo = short
        factor *= 4
    return np.concatenate(users), np.concatenate(items)


def make_data(cfg: dict, item_seed: int, user_seed: int,
              n_users: int | None = None) -> Data:
    """A dataset of configuration ``cfg`` (its ``dataset`` and
    ``generator`` groups): ``n_users`` users (default the configuration's)
    drawn from ``user_seed`` over the item universe of ``item_seed``."""
    ds, gen = cfg["dataset"], cfg["generator"]
    n_items, mean = int(ds["n_items"]), float(ds["mean_profile"])
    n_users = int(ds["n_users"] if n_users is None else n_users)
    n_topics, aff = int(gen["n_topics"]), float(gen["topic_affinity"])
    weights = zipf_weights(n_items, float(gen["zipf_a"]))

    irng = np.random.default_rng(sub_seed(item_seed, 1))
    item_topic = irng.integers(0, n_topics, size=n_items)

    urng = np.random.default_rng(sub_seed(user_seed, 2))
    user_topic = urng.integers(0, n_topics, size=n_users)
    mu = size_location(mean, n_items, n_topics, aff)
    sizes = np.clip(urng.lognormal(mu, SIZE_SIGMA, size=n_users),
                    MIN_PROFILE, MAX_PROFILE_FACTOR * mean).astype(np.int64)
    sizes = np.minimum(sizes, n_items // 2)
    n_home = np.round(sizes * aff).astype(np.int64)
    n_bg = sizes - n_home

    hu, hi = _home_items(urng, user_topic, n_home, item_topic, weights,
                         n_topics)
    bu, bi = _background_items(urng, n_bg, np.cumsum(weights))
    key = sorted_unique(np.concatenate([hu, bu]).astype(np.int64) * n_items
                        + np.concatenate([hi, bi]))
    user_of = key // n_items
    items = (key % n_items).astype(np.int32)
    offsets = np.zeros(n_users + 1, dtype=np.int64)
    np.cumsum(np.bincount(user_of, minlength=n_users), out=offsets[1:])
    return Data(n_users=n_users, n_items=n_items, items=items,
                offsets=offsets)
