"""The benchmark's generator: seeded, vectorised, Table I's statistics."""
import json
import time

import numpy as np
import pytest

from c2bench import data
from c2bench.harness import BENCH

SMALL = {"dataset": {"n_users": 500, "n_items": 3000, "mean_profile": 40.0},
         "generator": {"zipf_a": 1.3, "n_topics": 12, "topic_affinity": 0.8}}


def test_same_seed_same_data_other_seed_other_data():
    a = data.make_data(SMALL, 7, 7)
    b = data.make_data(SMALL, 7, 7)
    c = data.make_data(SMALL, 7, 8)
    assert np.array_equal(a.items, b.items)
    assert np.array_equal(a.offsets, b.offsets)
    assert not (np.array_equal(a.offsets, c.offsets)
                and np.array_equal(a.items, c.items))


def test_large_seeds_are_taken_whole():
    a = data.make_data(SMALL, 2**33 + 5, 2**33 + 5)
    b = data.make_data(SMALL, 5, 5)
    assert not np.array_equal(a.items[:200], b.items[:200])


def test_profiles_are_sorted_distinct_and_in_range():
    d = data.make_data(SMALL, 3, 3)
    for u in range(d.n_users):
        p = d.profile(u)
        assert np.all(np.diff(p) > 0)
        assert p[0] >= 0 and p[-1] < d.n_items
    assert d.sizes.min() >= 10


def test_size_location_hits_the_mean():
    mu = data.size_location(84.3, 10472, 48, 0.75)
    s = np.clip(data._size_quantiles(mu), data.MIN_PROFILE, 16 * 84.3)
    expect = np.mean(np.minimum(0.75 * s, 10472 / 48) + 0.25 * s)
    assert abs(expect - 84.3) < 1e-6


@pytest.mark.parametrize("config", ["c2-ml10M", "c2-AM"])
def test_table_one_statistics_in_seconds(config):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    t0 = time.perf_counter()
    d = data.make_data(cfg, 1, 1)
    seconds = time.perf_counter() - t0
    ds = cfg["dataset"]
    assert d.n_users == ds["n_users"] and d.n_items == ds["n_items"]
    assert len(d.offsets) == d.n_users + 1 and d.offsets[-1] == len(d.items)
    assert abs(d.sizes.mean() / ds["mean_profile"] - 1) < 0.03
    # Set-up budgets a few seconds for the data (the chip's host: ~9 s).
    assert seconds < 30
