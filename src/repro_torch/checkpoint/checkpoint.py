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

Elasticity, as the reference's: leaves are stored unsharded, so a
checkpoint restores under any mesh. ``save(..., shardings=)`` of a
sharded tree gathers each leaf whole (a collective every rank joins) and
rank 0 writes; ``restore_sharded`` reads the whole leaves and keeps this
rank's shard of each under the current mesh, at any world size.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

BF16 = "bfloat16"
# Leaves read or written at once.
IO_THREADS = 4


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
    # np.load reads into an array of its own: no second copy.
    return torch.from_numpy(arr if arr.flags.writeable else np.array(arr))


def save(ckpt_dir: str | os.PathLike, tree: Any, step: int,
         shardings: Any = None) -> Path:
    """Atomically write one checkpoint. Returns the committed path.

    ``shardings`` (a tree like ``tree`` of ``models.sharding.
    NamedSharding``, or None where a leaf is whole) says how a sharded
    tree's leaves are cut: each is gathered whole, one leaf at a time,
    and only rank 0 of the mesh writes; every rank returns after the
    commit."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    leaves = tree_leaves(tree)
    mesh = None
    if shardings is not None:
        plan = _sharding_leaves(tree, shardings)
        mesh = next((sh.mesh for sh in plan if sh is not None), None)
    if mesh is not None and mesh.rank != 0:
        for leaf, sh in zip(leaves, plan):
            if sh is not None:
                sh.gather(leaf)
        torch.distributed.barrier()
        return final
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": treedef_str(tree), "leaves": []}
    # Leaves are written by a few threads (file writes release the GIL),
    # each gathered (a collective, in leaf order) before its write.
    with concurrent.futures.ThreadPoolExecutor(IO_THREADS) as pool:
        writes = []
        for i, leaf in enumerate(leaves):
            if mesh is not None and plan[i] is not None:
                leaf = plan[i].gather(leaf)
            writes.append(pool.submit(
                _write_leaf, tmp / f"leaf_{i:05d}.npy", leaf))
        manifest["leaves"] = [{"name": f"leaf_{i:05d}", **w.result()}
                              for i, w in enumerate(writes)]
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    if mesh is not None:
        torch.distributed.barrier()
    return final


def _sharding_leaves(tree: Any, shardings: Any) -> list:
    """``shardings`` aligned with ``tree``'s leaves (None: whole)."""
    def walk(node, sh):
        if node is None:
            return []
        if isinstance(node, dict):
            return [x for k in sorted(node)
                    for x in walk(node[k], None if sh is None
                                  else sh.get(k))]
        if isinstance(node, (tuple, list)):
            return [x for i, sub in enumerate(node)
                    for x in walk(sub, None if sh is None else sh[i])]
        return [sh]
    return walk(tree, shardings)


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
    for i, (meta, ref) in enumerate(zip(manifest["leaves"], like_leaves)):
        shape = getattr(ref, "shape", None)
        if shape is not None and list(shape) != meta["shape"]:
            raise ValueError(f"leaf {i} has shape {meta['shape']} in the "
                             f"checkpoint, {list(shape)} in the target")
    with concurrent.futures.ThreadPoolExecutor(IO_THREADS) as pool:
        leaves = list(pool.map(
            lambda meta: _read_leaf(d / f"{meta['name']}.npy",
                                    meta["dtype"]), manifest["leaves"]))
    return tree_unflatten(like, leaves), step


def restore_sharded(ckpt_dir: str | os.PathLike, like: Any, shardings: Any,
                    step: int | None = None):
    """Elastic restore: every leaf read whole and cut to this rank's
    shard under the *current* mesh (``shardings`` as for ``save``; None
    keeps a leaf whole), on the mesh's device; the world size may differ
    from the run that saved. Returns (tree, step)."""
    tree, step = restore(ckpt_dir, like, step)
    leaves = tree_leaves(tree)
    plan = _sharding_leaves(tree, shardings)
    placed = []
    for leaf, sh in zip(leaves, plan):
        if sh is not None:
            leaf = sh.shard(leaf.to(sh.mesh.device))
        placed.append(leaf)
    return tree_unflatten(tree, placed), step
