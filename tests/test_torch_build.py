"""The port's C² build held bitwise against the JAX reference.

The plain cluster-KNN (what the CUDA kernel is checked against on the
card) against the Pallas kernel run in interpret mode and against
``local_knn._group_knn``; the whole pipeline on ml1M@0.05 and
synth@0.2; the
``knn_build`` CLI's artifact; and Alg. 2's Hyrec branch above the
ρk² threshold.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.clustering import ClusterPlan as RPlan  # noqa: E402
from repro.core.local_knn import _group_knn as r_group_knn  # noqa: E402
from repro.core.local_knn import local_knn as r_local_knn  # noqa: E402
from repro.core.params import C2Params as RParams  # noqa: E402
from repro.core.params import params_for as r_params_for  # noqa: E402
from repro.core.pipeline import cluster_and_conquer as r_c2  # noqa: E402
from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.kernels import config as r_kernel_config  # noqa: E402
from repro.kernels.goldfinger_knn import ops as r_gk_ops  # noqa: E402
from repro.query.index import KNNIndex as RIndex  # noqa: E402
from repro.query.index import build_index as r_build_index  # noqa: E402
from repro.sketch.goldfinger import GoldFinger as RGF  # noqa: E402
from repro_torch.core.clustering import ClusterPlan  # noqa: E402
from repro_torch.core.local_knn import local_knn  # noqa: E402
from repro_torch.core.params import C2Params, params_for  # noqa: E402
from repro_torch.core.pipeline import cluster_and_conquer  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.kernels.goldfinger_knn import ops as gk_ops  # noqa: E402
from repro_torch.kernels.goldfinger_knn import ref as gk_ref  # noqa: E402
from repro_torch.launch import knn_build  # noqa: E402
from repro_torch.sketch.goldfinger import GoldFinger, words_tensor  # noqa: E402
from repro_torch.types import PAD_ID  # noqa: E402


@pytest.fixture(autouse=True)
def _pallas_interpret():
    r_kernel_config.set_interpret(True)
    yield
    r_kernel_config.set_interpret(None)


def _clusters(rng, m, cap, W):
    """m padded clusters with PAD tails, planted equal-sim rows and one
    cluster of a single member (every neighbor slot PAD)."""
    w = rng.integers(0, 2**32, size=(m, cap, W), dtype=np.uint64)
    for _ in range(3):
        w &= rng.integers(0, 2**32, size=w.shape, dtype=np.uint64)
    words = w.astype(np.uint32)
    words[:, 1::5] = words[:, :1]
    ids = rng.permutation(m * cap * 3)[: m * cap].astype(np.int32)
    ids = ids.reshape(m, cap)
    sizes = [cap, max(2, cap // 2 + 3), 1][:m]
    for j, s in enumerate(sizes):
        ids[j, s:] = PAD_ID
        words[j, s:] = 0
    card = np.unpackbits(words.view(np.uint8), axis=-1).sum(-1).astype(
        np.int32)
    return words, card, ids


@pytest.mark.parametrize("cap", [32, 64])
@pytest.mark.parametrize("k", [5, 10])
def test_plain_cluster_knn_matches_pallas_and_group_knn(cap, k):
    rng = np.random.default_rng(cap + k)
    words, card, ids = _clusters(rng, 3, cap, 32)
    r_ids, r_sims = r_gk_ops.cluster_knn(jnp.asarray(words),
                                         jnp.asarray(card),
                                         jnp.asarray(ids), k)
    g_ids, g_sims = r_group_knn(jnp.asarray(words), jnp.asarray(card),
                                jnp.asarray(ids), k)
    args = (words_tensor(words, "cpu"), torch.from_numpy(card),
            torch.from_numpy(ids))
    p_ids, p_sims = gk_ref.cluster_knn_ref(*args, k)
    o_ids, o_sims = gk_ops.cluster_knn(*args, k)  # CPU tensors: plain path
    for ref_ids, ref_sims in ((r_ids, r_sims), (g_ids, g_sims)):
        np.testing.assert_array_equal(np.asarray(ref_ids), p_ids.numpy())
        np.testing.assert_array_equal(np.asarray(ref_sims), p_sims.numpy())
    assert torch.equal(p_ids, o_ids) and torch.equal(p_sims, o_sims)
    assert (p_ids[2] == PAD_ID).all()  # the lone member has no neighbors


def test_plain_knn_matches_pallas_ragged():
    rng = np.random.default_rng(11)
    words, card, _ = _clusters(rng, 1, 64, 32)
    q_ids = np.arange(40, dtype=np.int32)
    d_ids = np.arange(20, 84, dtype=np.int32)
    qw, qc = words[0, :40], card[0, :40]
    dw, dc = words[0], card[0]
    r_ids, r_sims = r_gk_ops.knn(qw, qc, q_ids, dw, dc, d_ids, 7)
    p_ids, p_sims = gk_ops.knn(words_tensor(qw, "cpu"), torch.from_numpy(qc),
                               torch.from_numpy(q_ids),
                               words_tensor(dw, "cpu"), torch.from_numpy(dc),
                               torch.from_numpy(d_ids), 7)
    np.testing.assert_array_equal(np.asarray(r_ids), p_ids.numpy())
    np.testing.assert_array_equal(np.asarray(r_sims), p_sims.numpy())


# ml1M@0.05 with the paper's clustering at k=10 (reference Step 2 through
# both its jnp path and its Pallas kernel), and synth@0.2 with the
# parameters knn_serve builds its index with (800 users: b=64,
# max_cluster=48).
@pytest.mark.parametrize("name,scale,seed,overrides", [
    ("ml1M", 0.05, 3, dict(k=10)),
    ("ml1M", 0.05, 3, dict(k=10, use_pallas=True)),
    ("synth", 0.2, 0, dict(k=10, b=64, max_cluster=48)),
])
def test_cluster_and_conquer_matches_reference(name, scale, seed, overrides):
    r_graph, r_stats = r_c2(r_make_dataset(name, scale=scale, seed=seed),
                            r_params_for(name, **overrides))
    t_graph, t_stats = cluster_and_conquer(
        make_dataset(name, scale=scale, seed=seed),
        params_for(name, **overrides), device="cpu")
    np.testing.assert_array_equal(r_graph.ids, t_graph.ids)
    np.testing.assert_array_equal(r_graph.sims, t_graph.sims)
    assert (r_stats.n_clusters, r_stats.n_sims, r_stats.max_cluster) == \
        (t_stats.n_clusters, t_stats.n_sims, t_stats.max_cluster)
    assert r_graph.avg_sim() == t_graph.avg_sim()


def test_hyrec_threshold_raises():
    """Clusters with |C| >= rho*k^2 take Alg. 2's Hyrec branch: bitwise the
    reference's ``local_knn`` on the same plan (one cluster above the
    threshold, one just below it)."""
    params = C2Params(k=2, rho=5)  # bf_threshold = 20
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(60, 4), dtype=np.uint64).astype(
        np.uint32)
    words &= rng.integers(0, 2**32, size=(60, 4), dtype=np.uint64).astype(
        np.uint32)
    card = np.unpackbits(words.view(np.uint8), axis=-1).sum(-1).astype(
        np.int32)
    gf = GoldFinger(words=words, card=card)
    members = [np.arange(30), np.arange(30, 49)]
    plan = ClusterPlan(members=members, config_of=np.zeros(2, np.int32),
                       n_users=60, t=1)
    ids, sims = local_knn(plan, gf, params, device="cpu")
    r_ids, r_sims = r_local_knn(
        RPlan(members=members, config_of=np.zeros(2, np.int32), n_users=60,
              t=1), RGF(words=words, card=card), RParams(k=2, rho=5))
    assert np.array_equal(ids, r_ids) and np.array_equal(sims, r_sims)
    assert (ids[0, :49] != PAD_ID).all() and (ids[0, 49:] == PAD_ID).all()


def test_knn_build_cli_index_loads_in_reference(tmp_path, capsys):
    out = tmp_path / "ix.npz"
    res = knn_build.main(["--dataset", "synth", "--scale", "0.05",
                          "--k", "5", "--index-out", str(out),
                          "--ckpt-dir", str(tmp_path / "ck"),
                          "--device", "cpu"])
    assert "avg_sim" in capsys.readouterr().out
    ds = r_make_dataset("synth", scale=0.05, seed=0)
    ref = r_build_index(ds, r_params_for("synth", k=5))
    loaded = RIndex.load(out)
    for name in ("graph_ids", "graph_sims", "words", "card", "rev_ids",
                 "cluster_paths", "cluster_members", "cluster_offsets"):
        np.testing.assert_array_equal(getattr(ref, name),
                                      getattr(loaded, name))
    # A rerun resumes from the per-configuration checkpoints.
    again = knn_build.main(["--dataset", "synth", "--scale", "0.05",
                            "--k", "5", "--ckpt-dir", str(tmp_path / "ck"),
                            "--device", "cpu"])
    assert "resuming" in capsys.readouterr().out
    np.testing.assert_array_equal(res["graph"].ids, again["graph"].ids)
