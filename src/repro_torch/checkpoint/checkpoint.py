"""Checkpoint/restart with an atomic commit (torch port of
``repro.checkpoint``), in the reference's layout.

Layout: ``<dir>/step_<N>/`` holding one ``leaf_<i>.npy`` per pytree leaf
plus a ``manifest.json`` (``step``, ``n_leaves``, ``treedef``, and each
leaf's name, shape and dtype). Writes go to a ``.tmp_step_<N>``
directory committed with one rename, so a run killed mid-save never
corrupts the latest checkpoint.

Trees are nested dicts, tuples and lists whose leaves are tensors or
numpy arrays. Leaves are numbered in JAX's flatten order (dict keys
sorted, tuples and lists in order, ``None`` no leaf), so a checkpoint
of the reference's ``(params, opt_state)`` and one of the port's, both in
the reference's group-stacked layout (``models.model.params_to_tree``),
restore in either package. ``treedef`` is written in JAX's
``str(treedef)`` form; the reference checks only ``n_leaves``.

numpy has no bfloat16 without ``ml_dtypes``: a bf16 leaf is written as
the reference's ``np.save`` writes it (2-byte ``'<V2'`` items holding
the bits) with ``"dtype": "bfloat16"`` in the manifest, and ``restore``
reads the manifest's dtype and gives the bits back as a bf16 tensor.
(The reference's own ``restore`` returns such a leaf as ``|V2``, which
JAX refuses: it cannot resume a bf16 leaf; the port can.)

``restore_sharded``, which places leaves under a device mesh, waits for
the mesh (ROADMAP item 5, rest).
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

BF16 = "bfloat16"


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, tuple, list))


def tree_leaves(tree: Any) -> list:
    """Leaves in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """``like``'s structure with ``leaves`` in JAX's flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def treedef_str(tree: Any) -> str:
    """The structure as JAX prints a treedef: ``PyTreeDef(...)``."""
    def fmt(node):
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, tuple):
            inner = ", ".join(fmt(s) for s in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if isinstance(node, list):
            return "[" + ", ".join(fmt(s) for s in node) + "]"
        return "*"

    return f"PyTreeDef({fmt(tree)})"


def _write_leaf(path: Path, leaf) -> dict:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(f, {
                    "descr": "<V2", "fortran_order": False,
                    "shape": tuple(bits.shape)})
                f.write(bits.astype("<u2").tobytes())
            return {"shape": list(bits.shape), "dtype": BF16}
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    np.save(path, arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype)}


def _read_leaf(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == BF16:
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir: str | os.PathLike, tree: Any, step: int) -> Path:
    """Atomically write one checkpoint. Returns the committed path."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = tree_leaves(tree)
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": treedef_str(tree), "leaves": []}
    for i, leaf in enumerate(leaves):
        name = f"leaf_{i:05d}"
        manifest["leaves"].append(
            {"name": name, **_write_leaf(tmp / f"{name}.npy", leaf)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    return final


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore(ckpt_dir: str | os.PathLike, like: Any, step: int | None = None):
    """Restore into the structure of ``like`` (its leaves give only their
    shapes, which must match); returns (tree of CPU tensors, step). Each
    leaf takes the manifest's dtype."""
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    like_leaves = tree_leaves(like)
    if len(like_leaves) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, target "
            f"structure has {len(like_leaves)}: incompatible trees")
    leaves = []
    for i, (meta, ref) in enumerate(zip(manifest["leaves"], like_leaves)):
        shape = getattr(ref, "shape", None)
        if shape is not None and list(shape) != meta["shape"]:
            raise ValueError(f"leaf {i} has shape {meta['shape']} in the "
                             f"checkpoint, {list(shape)} in the target")
        leaves.append(_read_leaf(d / f"{meta['name']}.npy", meta["dtype"]))
    return tree_unflatten(like, leaves), step
