"""The port's LM stack on a (2, 2) ("data", "model") mesh of 4 CPU ranks
held against the JAX reference's own mesh run.

The port runs as 4 ``gloo`` processes (``torch_mesh_ranks.py``, a
``FileStore`` under ``tmp_path``); the reference runs beside them in one
process on 4 emulated host devices, on an ``Auto`` ``jax.sharding.Mesh``
(``torch_mesh_reference.py``). Both read the same reference parameters
and inputs, f32 scaled-down configs. On this mesh every dim the rules
look at divides: heads, kv heads (gemma's one MQA kv head excepted: its
head dim splits), ``d_ff``, the vocabulary, the experts (OLMoE's
expert-parallel branch, the capacity from each batch shard's tokens) and
the recurrent widths, so every tensor-parallel path runs.

* ``forward`` of llama, olmoe, gemma, recurrentgemma and xlstm: logits
  within the unsharded tests' f32 tolerance for the config
  (``test_torch_lm_model.py``: 1e-5 for the dense ones, 3e-5 for the MoE
  and recurrent ones), the aux loss within 1e-6
  (``test_torch_train_step.py``'s), and OLMoE's expert choices and
  kept masks per MoE layer exactly.
* ``train_step`` (remat, ``grad_shardings`` the parameters'): llama with
  1 and 2 microbatches (the second with ``"save_tp"`` remat and
  ``loss_chunk``), llama with ``grad_compress="int8"`` and olmoe: loss,
  ce, grad norm, parameters and both moments within the unsharded step
  tests' tolerances (``test_torch_train_step.py``). With int8 the norm
  is the dequantized gradient's: an entry whose two gradients straddle a
  rounding boundary lands one quantum apart, so it is held to the
  unsharded tests' gradient tolerance, 1e-5 relative (measured 1.4e-6).
* ``Engine(ctx=)``: llama in waves of 4 and olmoe in 2 continuous slots
  (batch-1 prefills, which do not divide over "data": the port runs them
  whole on both batch ranks and cuts the tokens as the reference's
  ``shard_map`` does): equal tokens rid by rid and equal stats.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402

import torch_mesh_reference as R  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.config import scaled_down  # noqa: E402
from repro_torch.models.model import params_to_jax  # noqa: E402

MESH = [[2, 2], ["data", "model"]]
# test_torch_lm_model.py's f32 logit tolerances: F32_TOL for the dense
# configs, STEPS_F32_TOL for the MoE and recurrent ones.
LOGIT_TOL = {"llama3_2-1b": 1e-5, "gemma-2b": 1e-5, "olmoe-1b-7b": 3e-5,
             "recurrentgemma-2b": 3e-5, "xlstm-125m": 3e-5}
AUX_TOL = 1e-6
LOSS_TOL = 2e-6
NORM_REL = 1e-6
GRAD_REL = 1e-5
M_REL, V_REL = 1e-5, 2e-5
PARAM_TOL, M_FLOOR = 1e-7, 1e-7
LR, WD = 3e-4, 0.1  # OptConfig's defaults, for the step bound

FORWARD = ["llama3_2-1b", "olmoe-1b-7b", "gemma-2b", "recurrentgemma-2b",
           "xlstm-125m"]
TRAIN = [{"arch": "llama3_2-1b"},
         {"arch": "llama3_2-1b", "nmb": 2, "remat": "save_tp",
          "loss_chunk": 4},
         {"arch": "llama3_2-1b", "compress": "int8"},
         {"arch": "olmoe-1b-7b"}]
ENGINE = [{"arch": "llama3_2-1b", "max_batch": 4},
          {"arch": "olmoe-1b-7b", "max_batch": 4, "continuous": True,
           "slots": 2}]
SERVE = {"max_prompt": 8, "max_new": 5}


def tasks():
    return ([{"kind": "forward", "arch": a, "tokens_shape": [4, 8]}
             for a in FORWARD]
            + [{"kind": "train", **t} for t in TRAIN]
            + [{"kind": "engine", **SERVE, **e} for e in ENGINE])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref, port = R.run_job(tmp_path_factory.mktemp("mesh22"),
                          [{"mesh": MESH, "tasks": tasks()}])
    return ref[0], port[0]


def moe_kept(gate_e: np.ndarray, run: int, capacity: int) -> np.ndarray:
    """The reference's capacity rule over runs of ``run`` tokens: a
    choice is kept while its position in its expert's stable-sorted run
    is under ``capacity``."""
    kept = np.zeros(gate_e.shape, bool)
    for t0 in range(0, gate_e.shape[0], run):
        flat = gate_e[t0:t0 + run].reshape(-1)
        order = np.argsort(flat, kind="stable")
        se = flat[order]
        pos = np.arange(len(se)) - np.searchsorted(se, se, side="left")
        k = np.empty(len(se), bool)
        k[order] = pos < capacity
        kept[t0:t0 + run] = k.reshape(-1, gate_e.shape[1])
    return kept


def capacity(cfg, n_tokens: int) -> int:
    c = int(np.ceil(n_tokens * cfg.experts_per_token * cfg.capacity_factor
                    / cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def check_forward(ref, port, arch, mesh_shape):
    np.testing.assert_allclose(port["logits"].numpy(), ref["logits"],
                               rtol=0, atol=LOGIT_TOL[arch])
    assert abs(float(port["aux"]) - float(ref["aux"])) <= AUX_TOL
    cfg = scaled_down(get_config(arch), dtype="float32")
    if not cfg.n_experts:
        assert port["gate_e"] == [] and "gate_e" not in ref
        return
    n_moe = sum(kind == "moe" for grp in cfg.block_pattern for kind in grp)
    assert len(ref["gate_e"]) == len(port["gate_e"]) == n_moe * cfg.n_groups
    n_model = mesh_shape[-1]
    n_batch = int(np.prod(mesh_shape[:-1]))
    T = ref["gate_e"][0].shape[0]
    run = T // n_batch if cfg.n_experts % n_model == 0 else T
    for r, p in zip(ref["gate_e"], port["gate_e"]):
        np.testing.assert_array_equal(p.numpy(), r)
        np.testing.assert_array_equal(
            moe_kept(p.numpy(), run, capacity(cfg, run)),
            moe_kept(r, run, capacity(cfg, run)))


def _rel_close(got: dict, ref: dict, rel: float, what: str):
    assert set(got) == set(ref)
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(got[k] - r).max()) <= rel * scale, (what, k)


def check_train(ref, port, task):
    cfg = R.config(get_config, scaled_down, task)
    for key in ("loss", "ce"):
        assert abs(port[key][0] - ref[key][0]) <= LOSS_TOL, key
    rel = GRAD_REL if task.get("compress") else NORM_REL
    assert abs(port["grad_norm"][0] - ref["grad_norm"][0]) <= (
        rel * ref["grad_norm"][0])
    got = {k: R.flatten(params_to_jax(port[k], cfg))
           for k in ("params", "m", "v")}
    _rel_close(got["m"], ref["m"], M_REL, "m")
    _rel_close(got["v"], ref["v"], V_REL, "v")
    for k, r in ref["params"].items():
        diff = np.abs(got["params"][k] - r)
        live = np.abs(ref["m"][k]) >= M_FLOOR
        assert float(diff[live].max(initial=0.0)) <= PARAM_TOL, k
        assert (diff <= LR * (1 + WD * np.abs(r)) * 2).all(), k


def check_engine(ref, port):
    assert sorted(port["tokens"]) == sorted(ref["tokens"])
    for rid, toks in ref["tokens"].items():
        np.testing.assert_array_equal(port["tokens"][rid], toks, str(rid))
    assert port["stats"] == ref["stats"]


@pytest.mark.parametrize("arch", FORWARD)
def test_forward_matches_reference_mesh(runs, arch):
    i = FORWARD.index(arch)
    check_forward(runs[0][i], runs[1][i], arch, MESH[0])


@pytest.mark.parametrize("i", range(len(TRAIN)),
                         ids=["llama", "llama-mb2-save_tp-chunk",
                              "llama-int8", "olmoe"])
def test_train_step_matches_reference_mesh(runs, i):
    j = len(FORWARD) + i
    check_train(runs[0][j], runs[1][j], TRAIN[i])


@pytest.mark.parametrize("i", range(len(ENGINE)),
                         ids=["llama-waves", "olmoe-slots"])
def test_engine_matches_reference_mesh(runs, i):
    j = len(FORWARD) + len(TRAIN) + i
    check_engine(runs[0][j], runs[1][j])
