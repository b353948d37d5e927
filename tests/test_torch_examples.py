"""The port's examples (``examples/*_torch.py``) on the CPU at the
reference examples' sizes.

* ``quickstart_torch``: quality, similarity counts and clusters equal to
  the reference's library calls on the same dataset (exact);
* ``serve_demo_torch``: the same token streams in waves and in continuous
  slots, each request within its budget, and the reference's engine on
  the example's own weights giving the same tokens;
* ``train_lm_torch --steps 2``: two finite losses on the c2 data order;
* ``distributed_knn_torch``: eight LPT bins on the CPU, the graph equal to
  the single-device pipeline's (the example asserts it).

``knn_recommend_torch`` serves all 1,208 users and brute-forces them,
which is too slow here: it runs on the card (``chip_smoke.py`` phase
4k).
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.core.params import C2Params as RParams  # noqa: E402
from repro.core.pipeline import cluster_and_conquer as r_c2  # noqa: E402
from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.eval.metrics import quality as r_quality  # noqa: E402
from repro.knn.brute_force import brute_force_knn as r_brute_force  # noqa: E402
from repro.models.config import scaled_down as r_scaled_down  # noqa: E402
from repro.serve import engine as r_engine  # noqa: E402
from repro.sketch.goldfinger import fingerprint_dataset as r_fp  # noqa: E402
from repro_torch.models.model import params_to_jax  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name: str):
    """Load ``examples/<name>.py`` by its path (``examples/`` stays off
    ``sys.path``)."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


distributed_knn_torch = _example("distributed_knn_torch")
quickstart_torch = _example("quickstart_torch")
serve_demo_torch = _example("serve_demo_torch")
train_lm_torch = _example("train_lm_torch")
CPU = ["--device", "cpu"]


def test_quickstart_matches_reference_library_calls(capsys):
    out = quickstart_torch.main(CPU)
    ds = r_make_dataset("ml1M", scale=0.3, seed=0)
    gf = r_fp(ds)
    exact = r_brute_force(gf, k=10)
    graph, stats = r_c2(ds, RParams(k=10, b=256, t=8, max_cluster=120),
                        gf=gf)
    assert out["quality"] == r_quality(ds, graph, exact)
    assert (out["n_sims"], out["n_clusters"]) == (stats.n_sims,
                                                  stats.n_clusters)
    assert out["bf_sims"] == ds.n_users * (ds.n_users - 1) // 2
    assert f"quality:     {out['quality']:.4f}" in capsys.readouterr().out


def test_serve_demo_tokens_across_modes_and_reference():
    wave = serve_demo_torch.main(CPU)
    cont = serve_demo_torch.main(CPU + ["--continuous"])
    assert wave["outputs"] == cont["outputs"]
    assert wave["stats"]["requests"] == cont["stats"]["requests"] == 10
    assert cont["stats"]["decode_steps"] <= wave["stats"]["decode_steps"]
    model = wave["model"]
    rc = r_scaled_down(r_get_config("llama3_2-1b"))
    ref = r_engine.Engine(params_to_jax(model.state_dict(), model.cfg), rc,
                          r_engine.ServeConfig(max_batch=4, max_prompt=32,
                                               max_new=16))
    rng = np.random.default_rng(0)
    budgets = {}
    for rid in range(10):
        plen = int(rng.integers(4, 32))
        prompt = rng.integers(0, rc.vocab_size, plen).astype(np.int32)
        budgets[rid] = int(rng.integers(4, 16))
        ref.submit(r_engine.Request(rid=rid, prompt=prompt,
                                    max_new=budgets[rid]))
    ref.run()
    assert {r.rid: np.asarray(r.output).tolist() for r in ref.done} \
        == wave["outputs"]
    assert all(len(v) <= budgets[rid] for rid, v in wave["outputs"].items())


def test_train_lm_two_steps(tmp_path):
    out = train_lm_torch.main(["--steps", "2", "--ckpt-dir", str(tmp_path)]
                              + CPU)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert (tmp_path / "manifest.json").exists() or any(tmp_path.iterdir())


def test_distributed_knn_on_eight_cpu_bins():
    out = distributed_knn_torch.main(CPU)
    assert out["same"] and out["n_devices"] == 8 and out["n_clusters"] > 8
