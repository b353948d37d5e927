"""The port's sharding rules and checkpoints across meshes, held against
the JAX reference, and its one-rank mesh held bitwise to one device.

* Spec rules, with no processes: ``param_pspecs`` on every published
  config's parameters (``params_to_tree`` of the meta-device model against
  ``jax.eval_shape`` of the reference's ``init_params``), ``cache_pspecs``
  on each config's decode cache (batches 32 and 3, so the batch divides
  or not) and ``batch_pspec``, on meshes (16, 16), (2, 16, 16), (2, 2),
  (1, 3) and (4, 1); the reference is given a stand-in mesh carrying only
  ``axis_names`` and ``shape``, which is all its rules read. Specs are
  compared entry by entry, an axis name and a one-name tuple alike.
* ``restore_sharded``: a training state (params, m, v) saved by the
  reference from 8 emulated host devices on a (2, 4) mesh restores
  bitwise into the port on 4 ``gloo`` ranks ((2, 2), each rank holding
  its shards) and on 1; the port's save from the 4 ranks restores
  bitwise in the reference (``repro.checkpoint.restore``).
* One rank: ``make_host_mesh``'s (1, 1) mesh against no mesh for llama,
  olmoe and xlstm: logits and aux, a train step with 2 microbatches
  (loss, ce, grad norm, parameters and moments; olmoe with int8
  compression) and the engine's tokens in waves and in 2 slots, all
  bitwise.
* ``make_production_mesh`` names the world size it needs and has.
"""
import types

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

import torch_mesh_reference as R  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.models import sharding as r_sharding  # noqa: E402
from repro.models.model import init_cache as r_init_cache  # noqa: E402
from repro.models.model import init_params as r_init_params  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_production_mesh  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.config import scaled_down  # noqa: E402
from repro_torch.models.model import (full_shapes, init_cache,  # noqa: E402
                                      params_to_tree)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x3": ((1, 3), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    ref = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    return ref, MeshShape(axes, shape)


def _norm(spec) -> tuple:
    """A spec's entries as tuples of axis names (None: ())."""
    return tuple(() if e is None else ((e,) if isinstance(e, str)
                                        else tuple(e)) for e in spec)


def _pairs(port_tree, ref_tree, path=()):
    if isinstance(ref_tree, dict):
        assert set(port_tree) == set(ref_tree), path
        for k in ref_tree:
            yield from _pairs(port_tree[k], ref_tree[k], path + (k,))
    else:
        yield path, port_tree, ref_tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_pspecs_match_reference(arch, mesh):
    r_mesh, p_mesh = _meshes(mesh)
    rc, pc = r_get_config(arch), get_config(arch)
    r_params = jax.eval_shape(lambda: r_init_params(jax.random.key(0), rc))
    p_params = params_to_tree(full_shapes(pc), pc)
    got = sharding.param_pspecs(pc, p_params, p_mesh)
    ref = r_sharding.param_pspecs(rc, r_params, r_mesh)
    n = 0
    for path, g, r in _pairs(got, ref):
        assert _norm(g) == _norm(r), path
        n += 1
    assert n == len(jax.tree.leaves(r_params))
    for batch in (32, 3):
        r_cache = jax.eval_shape(lambda: r_init_cache(rc, batch, 64))
        p_cache = init_cache(pc, batch, 64, device="meta")
        got = sharding.cache_pspecs(pc, p_cache, p_mesh)
        ref = r_sharding.cache_pspecs(rc, r_cache, r_mesh)
        for path, g, r in _pairs(got, ref):
            assert _norm(g) == _norm(r), (batch, path)
    for rank in (1, 2, 3):
        assert (_norm(sharding.batch_pspec(p_mesh, rank))
                == _norm(r_sharding.batch_pspec(r_mesh, rank)))


def test_state_pspecs_and_placements():
    """A state-dict key's spec is its stacked leaf's without the group
    dim; ``to_shardings`` places each spec on the mesh's axes."""
    pc = get_config("llama3_2-1b")
    _, mesh = _meshes("2x16x16")
    full = full_shapes(pc)
    specs = sharding.state_pspecs(pc, full, mesh)
    tree = sharding.param_pspecs(pc, params_to_tree(full, pc), mesh)
    assert specs["layers.3.l0b0_attn.block.wq"] == \
        tree["groups"]["l0b0_attn"]["block"]["wq"][1:] == \
        ("data", "model", None)
    assert specs["embed"] == ("model", "data")
    sh = sharding.to_shardings({"wq": specs["layers.3.l0b0_attn.block.wq"],
                                "tok": sharding.batch_pspec(mesh, 2)}, mesh)
    assert sh["wq"].placements == (("replicate",), ("shard", 0),
                                   ("shard", 1))
    assert sh["tok"].placements == (("shard", 0), ("shard", 0),
                                    ("replicate",))


def test_make_production_mesh_names_the_world_size():
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError,
                           match=f"needs {n} ranks.*world size of 1"):
            make_production_mesh(multi_pod=multi_pod)


# ------------------------------------------------ processes: ckpt, world 1

CKPT_ARCH = "llama3_2-1b"
WORLD1 = [{"arch": "llama3_2-1b"}, {"arch": "olmoe-1b-7b",
                                    "compress": "int8"},
          {"arch": "xlstm-125m"}]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    for arch in sorted({CKPT_ARCH} | {t["arch"] for t in WORLD1}):
        R.save_inputs(d, {"arch": arch})
    # A training state with moments that are not zero.
    with np.load(d / R.inputs_name({"arch": CKPT_ARCH})) as z:
        params = {k[len("params/"):]: z[k] for k in z.files
                  if k.startswith("params/")}
    rng = np.random.default_rng(5)
    tree = {f"params/{k}": v for k, v in params.items()}
    for part in ("m", "v"):
        tree.update({f"{part}/{k}": rng.standard_normal(v.shape)
                     .astype(np.float32) ** (1 + (part == "v"))
                     for k, v in params.items()})
    np.savez(d / "state.npz", **tree)
    save_job = {"mesh": [[2, 4], ["data", "model"]], "arch": CKPT_ARCH,
                "tree": str(d / "state.npz"), "ckpt": str(d / "ref_ckpt"),
                "step": 3}
    world1, w1_out = R.launch_port(
        d, "world1", [[1, 1], ["data", "model"]],
        [{"kind": "world1", **t} for t in WORLD1])
    saver, _ = R.launch_reference(d, "save", save_job)
    R.wait([saver])
    ckpt = {"kind": "ckpt", "arch": CKPT_ARCH,
            "ckpt_in": str(d / "ref_ckpt")}
    four, four_out = R.launch_port(
        d, "ckpt4", [[2, 2], ["data", "model"]],
        [dict(ckpt, ckpt_out=str(d / "port_ckpt"))])
    one, one_out = R.launch_port(d, "ckpt1", [[1, 1], ["data", "model"]],
                                 [ckpt])
    R.wait(world1 + four + one)
    return {"tree": tree, "dir": d, "ckpt4": R.load_port(four_out)[0],
            "ckpt1": R.load_port(one_out)[0],
            "world1": R.load_port(w1_out)}


def _flat_port(whole) -> dict:
    params, opt = whole
    out = {f"params/{k}": v for k, v in R.flatten(params).items()}
    for part in ("m", "v"):
        out.update({f"{part}/{k}": v
                    for k, v in R.flatten(opt[part]).items()})
    return out


@pytest.mark.parametrize("world", ["ckpt4", "ckpt1"])
def test_reference_save_restores_sharded_in_the_port(runs, world):
    got = _flat_port(runs[world]["tree"])
    assert runs[world]["step"] == 3
    assert set(got) == set(runs["tree"])
    for k, v in runs["tree"].items():
        np.testing.assert_array_equal(got[k], v, k)
    cfg = scaled_down(get_config(CKPT_ARCH), dtype="float32")
    # wq [G, D, H, hd]: D split on "data", H on "model" at (2, 2).
    split = 2 if world == "ckpt4" else 1
    assert runs[world]["local_shape"] == (
        cfg.n_groups, cfg.d_model // split, cfg.n_heads // split,
        cfg.head_dim_)


def test_port_save_from_four_ranks_restores_in_the_reference(runs):
    from repro.checkpoint import restore as r_restore
    from repro.checkpoint import latest_step as r_latest

    d = runs["dir"] / "port_ckpt"
    assert r_latest(d) == 3
    params = {}
    for k, v in runs["tree"].items():
        if k.startswith("params/"):
            node = params
            *path, leaf = k[len("params/"):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    like = (params, {"m": params, "step": 0, "v": params})
    (got_p, got_o), step = r_restore(d, like)
    assert step == 3 and int(got_o["step"]) == 3
    got = {f"params/{k}": v for k, v in R.flatten(got_p).items()}
    for part in ("m", "v"):
        got.update({f"{part}/{k}": v
                    for k, v in R.flatten(got_o[part]).items()})
    for k, v in runs["tree"].items():
        np.testing.assert_array_equal(got[k], v, k)


@pytest.mark.parametrize("i", range(len(WORLD1)),
                         ids=[t["arch"] for t in WORLD1])
def test_one_rank_mesh_is_bitwise_one_device(runs, i):
    assert runs["world1"][i] == {"forward": True, "train": True,
                                 "waves": True, "slots": True}
