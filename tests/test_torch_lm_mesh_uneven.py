"""The port's LM stack on meshes whose model axis divides nothing, held
against the JAX reference's own mesh runs (``test_torch_lm_mesh.py``'s
harness and tolerances).

On (1, 3) ("data", "model") no dim of the scaled-down configs divides by
3: heads, kv heads, ``d_ff``, the vocabulary, the experts and the
recurrent widths all fall back to replication, as the reference's rules
say, and every model rank computes every block whole. OLMoE then takes
the branch for experts that do not divide (every rank buckets all B·S
tokens with the capacity from all of them); on (2, 3), 6 ranks, that
branch also gathers the tokens and router choices over the batch axis.

* (1, 3): ``forward`` of all five configs; ``train_step`` for olmoe and
  xlstm (cut to one mLSTM and one sLSTM layer, as the unsharded step
  tests cut it); ``Engine(ctx=)`` for olmoe in waves of 4 and xlstm in 2
  continuous slots.
* (2, 3): ``forward`` of olmoe against the reference's mesh, and its
  ``train_step`` against the reference's one-device step: the
  reference's own step on this mesh returns NaN gradients, and the
  branch computes the one-device function (one bucketing of all B·S
  tokens).
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_mesh_reference as R  # noqa: E402
from test_torch_lm_mesh import (FORWARD, SERVE, check_engine,  # noqa: E402
                                check_forward, check_train)

MESH13 = [[1, 3], ["data", "model"]]
MESH23 = [[2, 3], ["data", "model"]]
TRAIN13 = [{"arch": "olmoe-1b-7b"}, {"arch": "xlstm-125m", "cut": True}]
# The reference's own (2, 3) mesh step gives NaN gradients (its GSPMD
# program for these shardings); the branch buckets all B·S tokens at once,
# which is the reference's one-device step, so the port is held to that.
TRAIN23 = {"arch": "olmoe-1b-7b", "ref_mesh": False}
ENGINE13 = [{"arch": "olmoe-1b-7b", "max_batch": 4},
            {"arch": "xlstm-125m", "max_batch": 4, "continuous": True,
             "slots": 2}]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    t13 = ([{"kind": "forward", "arch": a, "tokens_shape": [4, 8]}
            for a in FORWARD]
           + [{"kind": "train", **t} for t in TRAIN13]
           + [{"kind": "engine", **SERVE, **e} for e in ENGINE13])
    t23 = [{"kind": "forward", "arch": "olmoe-1b-7b", "tokens_shape": [4, 8]},
           {"kind": "train", **TRAIN23}]
    ref, port = R.run_job(tmp_path_factory.mktemp("mesh_uneven"),
                          [{"mesh": MESH13, "tasks": t13},
                           {"mesh": MESH23, "tasks": t23}])
    return ref, port


@pytest.mark.parametrize("arch", FORWARD)
def test_forward_1x3(runs, arch):
    i = FORWARD.index(arch)
    check_forward(runs[0][0][i], runs[1][0][i], arch, MESH13[0])


@pytest.mark.parametrize("i", range(len(TRAIN13)), ids=["olmoe", "xlstm"])
def test_train_step_1x3(runs, i):
    j = len(FORWARD) + i
    check_train(runs[0][0][j], runs[1][0][j], TRAIN13[i])


@pytest.mark.parametrize("i", range(len(ENGINE13)),
                         ids=["olmoe-waves", "xlstm-slots"])
def test_engine_1x3(runs, i):
    j = len(FORWARD) + len(TRAIN13) + i
    check_engine(runs[0][0][j], runs[1][0][j])


def test_forward_and_train_step_2x3(runs):
    check_forward(runs[0][1][0], runs[1][1][0], "olmoe-1b-7b", MESH23[0])
    check_train(runs[0][1][1], runs[1][1][1], TRAIN23)
