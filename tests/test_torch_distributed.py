"""The port's LPT bins and shard plans held bitwise against the JAX
reference.

``lpt_assign`` / ``lpt_loads`` on random costs with ties and on a synth
cluster plan's brute-force costs; ``plan_shards`` at 2–4 shards with and
without tiered residency, and ``extend_plan`` after an insert burst;
``row_bytes`` and ``resident_bytes``. Every comparison is exact.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.core import distributed as r_dist  # noqa: E402
from repro.core.clustering import build_plan as r_build_plan  # noqa: E402
from repro.core.params import C2Params as RC2Params  # noqa: E402
from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.query import sharded as r_sharded  # noqa: E402
from repro.query.engine import QueryConfig as RQueryConfig  # noqa: E402
from repro.query.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.query.index import KNNIndex as RIndex  # noqa: E402
from repro.query.index import build_index as r_build_index  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core.clustering import build_plan  # noqa: E402
from repro_torch.core.params import C2Params  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.query import sharded  # noqa: E402
from repro_torch.query.engine import QueryConfig, QueryEngine  # noqa: E402
from repro_torch.query.index import KNNIndex  # noqa: E402

PARAMS = dict(k=10, b=64, t=8, max_cluster=48)


@pytest.fixture(scope="module")
def cluster_plans():
    """The port's and the reference's cluster plans of synth@0.1 (equal:
    test_torch_build.py)."""
    return (build_plan(make_dataset("synth", scale=0.1, seed=3),
                       C2Params(**PARAMS)),
            r_build_plan(r_make_dataset("synth", scale=0.1, seed=3),
                         RC2Params(**PARAMS)))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """synth@0.15 with the reference's sharded-test parameters, built by
    the reference and loaded by both packages."""
    ix = r_build_index(r_make_dataset("synth", scale=0.15, seed=3),
                       RC2Params(**PARAMS))
    path = tmp_path_factory.mktemp("ix") / "synth.npz"
    ix.save(path)
    return path


@pytest.mark.parametrize("n_bins", [1, 2, 3, 5])
def test_lpt_matches_reference(n_bins):
    rng = np.random.default_rng(n_bins)
    for costs in (rng.random(40), rng.integers(1, 6, 50).astype(np.float64),
                  np.ones(7), np.zeros(0)):
        a = dist.lpt_assign(costs, n_bins)
        np.testing.assert_array_equal(a, r_dist.lpt_assign(costs, n_bins))
        np.testing.assert_array_equal(dist.lpt_loads(costs, a, n_bins),
                                      r_dist.lpt_loads(costs, a, n_bins))


@pytest.mark.parametrize("n_bins", [1, 2, 4])
def test_lpt_on_cluster_plan_matches_reference(cluster_plans, n_bins):
    """LPT over the synth plan's clusters weighed by brute-force cost
    (|C|², as the reference's Step 2 weighs them): the same bins, loads
    and imbalance as the reference."""
    plan, r_plan = cluster_plans
    costs = plan.sizes.astype(np.float64) ** 2
    np.testing.assert_array_equal(
        costs, np.asarray(r_plan.sizes, dtype=np.float64) ** 2)
    a = dist.lpt_assign(costs, n_bins)
    np.testing.assert_array_equal(a, r_dist.lpt_assign(costs, n_bins))
    loads = dist.lpt_loads(costs, a, n_bins)
    np.testing.assert_array_equal(loads, r_dist.lpt_loads(costs, a, n_bins))
    assert np.bincount(a, minlength=n_bins).sum() == plan.n_clusters
    assert loads.sum() == costs.sum()


def _same_plan(a, b):
    assert a.n_shards == b.n_shards and a.imbalance == b.imbalance
    assert (a.version, a.resident_configs) == (b.version, b.resident_configs)
    np.testing.assert_array_equal(a.cluster_shard, b.cluster_shard)
    np.testing.assert_array_equal(a.owner, b.owner)
    assert len(a.residents) == len(b.residents)
    for x, y in zip(a.residents, b.residents):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("resident_configs", [0, 2])
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_plan_shards_matches_reference(artifact, n_shards, resident_configs):
    port, ref = KNNIndex.load(artifact), RIndex.load(artifact)
    plan = sharded.plan_shards(port, n_shards,
                               resident_configs=resident_configs)
    _same_plan(plan, r_sharded.plan_shards(
        ref, n_shards, resident_configs=resident_configs))
    # Every user is resident somewhere and owned where it is resident.
    covered = np.zeros(port.n, bool)
    for s, res in enumerate(plan.residents):
        covered[res] = True
        assert np.isin(np.flatnonzero(plan.owner == s), res).all()
    assert covered.all()


@pytest.mark.parametrize("n_shards", [2, 3])
def test_extend_plan_after_insert_burst(artifact, n_shards):
    """70 inserts (a cohort refresh at 64) into both packages' engines:
    extend_plan of the frozen base equals the reference's, and equals
    the port's own from-scratch plan under a full scan."""
    qds = make_dataset("synth", scale=0.15, seed=99)
    engines = (QueryEngine(KNNIndex.load(artifact), QueryConfig(),
                           device="cpu"),
               RQueryEngine(RIndex.load(artifact), RQueryConfig()))
    bases = (sharded.plan_shards(engines[0].index, n_shards),
             r_sharded.plan_shards(engines[1].index, n_shards))
    for eng in engines:
        for u in range(70):
            eng.insert(qds.profile(u))
    assert engines[0].n_refreshes == engines[1].n_refreshes == 1
    ext = sharded.extend_plan(bases[0], engines[0].index)
    _same_plan(ext, r_sharded.extend_plan(bases[1], engines[1].index))
    assert sum(map(len, ext.residents)) > sum(map(len, bases[0].residents))
    unscoped = dataclasses.replace(bases[0], version=-1)
    full = sharded.extend_plan(unscoped, engines[0].index)
    for a, b in zip(full.residents, ext.residents):
        np.testing.assert_array_equal(a, b)


def test_row_and_resident_bytes_match_reference(artifact):
    port, ref = KNNIndex.load(artifact), RIndex.load(artifact)
    assert port.row_bytes == ref.row_bytes == 4 * (10 + ref.rev_ids.shape[1]
                                                   + ref.words.shape[1]) + 9
    sd = sharded.ShardedDescent(port, 3, device="cpu")
    r_sd = r_sharded.ShardedDescent(ref, 3, use_mesh=False)
    assert sd.resident_bytes() == r_sd.resident_bytes()
    assert sd.cap == r_sd.cap
