"""The port's LM stack on the multi-pod layout, ("pod", "data", "model")
= (2, 1, 2) on 4 CPU ranks, held against the JAX reference's own mesh run
(``test_torch_lm_mesh.py``'s harness and tolerances).

The batch splits over ("pod", "data") together; parameters are split on
"data" (size 1 here) and "model" only, so every gradient is summed over
"pod" after the backward. Gemma's one MQA kv head replicates and its
head dim splits on "model"; RG-LRU's width splits.

* ``forward`` of llama, olmoe and gemma;
* ``train_step`` of gemma, recurrentgemma and xlstm (2 microbatches),
  the last two cut to one group of their two block kinds as the
  unsharded step tests cut them (``test_torch_train_step.py``), whose
  tolerances were measured there;
* ``Engine(ctx=)``: llama in waves of 4 and recurrentgemma in 2
  continuous slots.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_mesh_reference as R  # noqa: E402
from test_torch_lm_mesh import (SERVE, check_engine,  # noqa: E402
                                check_forward, check_train)

MESH = [[2, 1, 2], ["pod", "data", "model"]]
FORWARD = ["llama3_2-1b", "olmoe-1b-7b", "gemma-2b"]
TRAIN = [{"arch": "gemma-2b"}, {"arch": "recurrentgemma-2b", "cut": True},
         {"arch": "xlstm-125m", "nmb": 2, "cut": True}]
ENGINE = [{"arch": "llama3_2-1b", "max_batch": 4},
          {"arch": "recurrentgemma-2b", "max_batch": 4, "continuous": True,
           "slots": 2}]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tasks = ([{"kind": "forward", "arch": a, "tokens_shape": [4, 8]}
              for a in FORWARD]
             + [{"kind": "train", **t} for t in TRAIN]
             + [{"kind": "engine", **SERVE, **e} for e in ENGINE])
    ref, port = R.run_job(tmp_path_factory.mktemp("mesh_pod"),
                          [{"mesh": MESH, "tasks": tasks}])
    return ref[0], port[0]


@pytest.mark.parametrize("arch", FORWARD)
def test_forward_pod_mesh(runs, arch):
    i = FORWARD.index(arch)
    check_forward(runs[0][i], runs[1][i], arch, MESH[0])


@pytest.mark.parametrize("i", range(len(TRAIN)),
                         ids=["gemma", "recurrentgemma", "xlstm-mb2"])
def test_train_step_pod_mesh(runs, i):
    j = len(FORWARD) + i
    check_train(runs[0][j], runs[1][j], TRAIN[i])


@pytest.mark.parametrize("i", range(len(ENGINE)),
                         ids=["llama-waves", "recurrentgemma-slots"])
def test_engine_pod_mesh(runs, i):
    j = len(FORWARD) + len(TRAIN) + i
    check_engine(runs[0][j], runs[1][j])
