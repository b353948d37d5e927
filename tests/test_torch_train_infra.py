"""The port's token pipeline, checkpoints and training launcher held
against the JAX reference (``repro.data.tokens``, ``repro.checkpoint``,
``repro.launch.train``) on the CPU.

* ``TokenPipeline`` batches bitwise the reference's in iid and c2 order
  (the c2 order through the FastRandomHash kernel's CSR wrapper, once,
  equal to the reference's host order), past the corpus' end, and a
  stub frontend's embeddings.
* Checkpoints: round trip, atomic overwrite, the manifest's ``treedef``
  in JAX's form, a leaf-count or shape mismatch refused, and checkpoints
  crossing both ways with bf16 leaves, written byte for byte as the
  reference writes them. The reference's own ``restore`` returns a bf16
  leaf as ``|V2``, which JAX refuses; the port restores it.
* ``launch/train --smoke --device cpu``: a crash at step 6 resumed from
  the step-5 checkpoint ends on the straight run's loss, within 1e-4 (the
  reference's restart bound; measured bitwise), with f32 state and with
  int8 compression (bf16 residuals through the checkpoint). A reference
  checkpoint resumed by the port, and a port checkpoint resumed by the
  reference, end within 1e-3 of the other package's straight 10-step run
  on losses of ~5.4 (measured 9.3e-5 and 1.3e-4: four steps in each
  package from the same state at the smoke config's bf16 compute, which
  the two frameworks round at other places).
"""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as r_ckpt  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.data.tokens import DataConfig as RDataConfig  # noqa: E402
from repro.data.tokens import TokenPipeline as RTokenPipeline  # noqa: E402
from repro.launch import train as r_train  # noqa: E402
from repro.models.config import scaled_down as r_scaled_down  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint.checkpoint import treedef_str  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels.frh_minhash import ops as minhash_ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.config import scaled_down  # noqa: E402

RESTART_TOL = 1e-4
CROSS_TOL = 1e-3
BASE = ["--smoke", "--steps", "10", "--batch", "2", "--seq", "32",
        "--ckpt-every", "3"]


def _pipes(arch, ordering, **kw):
    dc = dict(seq_len=32, global_batch=4, seed=3, ordering=ordering,
              n_docs=64, **kw)
    return (RTokenPipeline(r_scaled_down(r_get_config(arch)),
                           RDataConfig(**dc)),
            TokenPipeline(scaled_down(get_config(arch)), DataConfig(**dc),
                          device="cpu"))


@pytest.mark.parametrize("ordering", ["iid", "c2"])
def test_token_batches_bitwise(ordering, monkeypatch):
    calls = []
    csr = minhash_ops.minhash_csr
    monkeypatch.setattr(minhash_ops, "minhash_csr",
                        lambda *a: calls.append(a) or csr(*a))
    ref, got = _pipes("llama3_2-1b", ordering)
    if ordering == "c2":
        # One call of the kernel's wrapper: t = 1, b = 4,096.
        assert len(calls) == 1 and list(calls[0][2]) == [3]
        assert calls[0][3] == 4096
        np.testing.assert_array_equal(got._order, ref._order)
        assert sorted(got._order.tolist()) == list(range(64))
    else:
        assert calls == [] and got._order is None
    for step in (0, 1, 17, 40):  # 17 and 40 wrap past the 64 documents
        r, g = ref.batch(step), got.batch(step)
        assert set(g) == set(r) == {"tokens", "labels"}
        for key in r:
            assert g[key].dtype == torch.int32
            np.testing.assert_array_equal(g[key].numpy(), r[key])


def test_token_batches_frontend_embeddings():
    ref, got = _pipes("phi-3-vision-4_2b", "iid")
    for step in (0, 5):
        r, g = ref.batch(step), got.batch(step)
        assert set(g) == set(r) == {"embeddings", "labels"}
        np.testing.assert_array_equal(g["embeddings"].numpy(),
                                      r["embeddings"])
        np.testing.assert_array_equal(g["labels"].numpy(), r["labels"])


def _tree():
    bf = torch.tensor([[1.5, -2.25, 3e-3], [7.0, 0.0, -1e4]],
                      dtype=torch.bfloat16)
    return ({"b": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "a": {"c": torch.ones((3, 4), dtype=torch.int32), "bf": bf}},
            {"step": torch.tensor(7, dtype=torch.int32),
             "m": [torch.zeros(2), None], "t": (torch.full((1,), 2.0),)})


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


def test_checkpoint_roundtrip_and_treedef(tmp_path):
    tree = _tree()
    path = ckpt.save(tmp_path, tree, step=7)
    assert path.name == "step_00000007" and ckpt.latest_step(tmp_path) == 7
    assert not list(tmp_path.glob(".tmp_*"))
    got, step = ckpt.restore(tmp_path, tree)
    assert step == 7
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        _same(a, b)
    assert got[1]["m"][1] is None and isinstance(got[1]["t"], tuple)
    manifest = json.loads((path / "manifest.json").read_text())
    shaped = jax.tree.map(lambda t: np.zeros(t.shape), tree)
    assert manifest["treedef"] == treedef_str(tree) == str(
        jax.tree.structure(shaped))
    assert manifest["n_leaves"] == 6
    assert [leaf["dtype"] for leaf in manifest["leaves"]] == [
        "bfloat16", "int32", "float32", "float32", "int32", "float32"]


def test_checkpoint_atomic_overwrite_and_mismatch(tmp_path):
    """The reference's overwrite test, ported; a tree of another leaf
    count or shape is refused."""
    tree = {"a": np.zeros(4)}
    ckpt.save(tmp_path, tree, step=1)
    ckpt.save(tmp_path, {"a": np.ones(4)}, step=2)
    got, step = ckpt.restore(tmp_path, tree)
    assert step == 2 and float(got["a"].sum()) == 4
    ckpt.save(tmp_path, {"a": np.full(4, 3.0)}, step=2)  # overwrite in place
    assert float(ckpt.restore(tmp_path, tree)[0]["a"].sum()) == 12
    assert float(ckpt.restore(tmp_path, tree, step=1)[0]["a"].sum()) == 0
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(tmp_path, {"a": np.zeros(4), "b": np.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, {"a": np.zeros(5)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", tree)


def test_checkpoints_cross_packages_with_bf16_leaves(tmp_path):
    tree = _tree()
    as_jax = jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), tree)
    # The port's checkpoint, read by the reference: equal values, the bf16
    # leaf as raw 2-byte items holding the same bits.
    ckpt.save(tmp_path / "port", tree, step=3)
    r_got, r_step = r_ckpt.restore(tmp_path / "port", as_jax)
    assert r_step == 3
    for a, b in zip(jax.tree.leaves(r_got), jax.tree.leaves(tree)):
        if b.dtype == torch.bfloat16:
            assert a.dtype.kind == "V" and a.dtype.itemsize == 2
            bits = b.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(a.view(np.uint16), bits)
        else:
            np.testing.assert_array_equal(a, b.numpy())
    # The reference's checkpoint, read by the port, and written byte for
    # byte as the port writes it.
    r_ckpt.save(tmp_path / "ref", as_jax, step=3)
    got, step = ckpt.restore(tmp_path / "ref", tree)
    assert step == 3
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        _same(a, b)
    for leaf in sorted((tmp_path / "ref" / "step_00000003").glob("*.npy")):
        port_leaf = tmp_path / "port" / "step_00000003" / leaf.name
        assert leaf.read_bytes() == port_leaf.read_bytes(), leaf.name


def test_reference_restore_keeps_bf16_as_void(tmp_path):
    """A fault of the reference the port does not share: its ``restore``
    returns a bf16 leaf as ``|V2`` (np.save writes bfloat16 as '<V2'),
    which JAX refuses, so a bf16 optimizer state cannot resume there. The
    port takes the dtype from the manifest and gives back the bits."""
    leaf = jnp.asarray([1.5, -3.0, 0.1], jnp.bfloat16)
    r_ckpt.save(tmp_path, {"err": leaf}, step=0)
    manifest = json.loads((tmp_path / "step_00000000" /
                           "manifest.json").read_text())
    assert manifest["leaves"][0]["dtype"] == "bfloat16"
    r_got, _ = r_ckpt.restore(tmp_path, {"err": leaf})
    assert r_got["err"].dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        jnp.asarray(r_got["err"])
    got, _ = ckpt.restore(tmp_path, {"err": leaf})
    assert got["err"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["err"].float().numpy(),
                                  np.asarray(leaf, np.float32))


@pytest.mark.parametrize("extra", [[], ["--grad-compress", "int8"]])
def test_launch_restart_matches_straight(tmp_path, extra):
    """The reference's restart test for the port's launcher: crash at
    step 6, resume from the step-5 checkpoint, same final loss."""
    base = ["--arch", "llama3.2-1b", "--device", "cpu"] + BASE + extra
    straight = train.run(base + ["--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(SystemExit) as exc:
        train.main(base + ["--ckpt-dir", str(tmp_path / "b"),
                           "--fail-at-step", "6"])
    assert exc.value.code == 42
    assert ckpt.latest_step(tmp_path / "b") == 5
    resumed = train.run(base + ["--ckpt-dir", str(tmp_path / "b")])
    assert resumed["start_step"] == 6 and len(resumed["losses"]) == 4
    assert len(straight["losses"]) == 10
    assert all(np.isfinite(straight["losses"]))
    assert abs(straight["final_loss"] - resumed["final_loss"]) < RESTART_TOL
    opt = resumed["opt_state"]
    assert int(opt["step"]) == 10
    if extra:
        assert opt["err"]["embed"].dtype == torch.bfloat16


def test_checkpoints_resume_across_packages(tmp_path):
    """A reference run crashed at step 6 resumes in the port, and a port
    run crashed there resumes in the reference; each ends on the other
    package's straight run."""
    base = ["--arch", "llama3.2-1b"] + BASE
    r_straight = r_train.main(base + ["--ckpt-dir", str(tmp_path / "r0")])
    with pytest.raises(SystemExit):
        r_train.main(base + ["--ckpt-dir", str(tmp_path / "r1"),
                             "--fail-at-step", "6"])
    port_resumed = train.run(base + ["--device", "cpu", "--ckpt-dir",
                                     str(tmp_path / "r1")])
    assert port_resumed["start_step"] == 6
    assert abs(port_resumed["final_loss"] - r_straight) < CROSS_TOL

    p_straight = train.main(base + ["--device", "cpu", "--ckpt-dir",
                                    str(tmp_path / "p0")])
    with pytest.raises(SystemExit):
        train.main(base + ["--device", "cpu", "--ckpt-dir",
                           str(tmp_path / "p1"), "--fail-at-step", "6"])
    r_resumed = r_train.main(base + ["--ckpt-dir", str(tmp_path / "p1")])
    assert abs(r_resumed - p_straight) < CROSS_TOL
