"""Sharding rules: FSDP on the data axis × tensor parallel on the model
axis, with the pod axis (multi-pod mesh) as pure data parallelism (torch
port of ``repro.models.sharding``).

A spec is a tuple with one entry per tensor dim, as a ``PartitionSpec``:
an axis name, a tuple of axis names (the dim split over them together,
row-major), or None (replicated). Rules are divisibility-guarded, as the
reference's: a dim is sharded only if the mesh axis divides it (MQA's one
kv head replicates, and ``wk``/``wv`` then shard the head dim on "model";
a 16-way model axis leaves gemma's 8 heads whole). Group-stacked leaves
(``groups``) carry a leading n_groups dim that is never sharded; the
port's state dict holds one group a key, so ``state_pspecs`` drops it.
The rules read only ``mesh.axis_names`` and ``mesh.size(axis)``: a
``launch.mesh.MeshShape`` will do.

``shard_state`` cuts this rank's shard of every leaf of a full state dict
(weights made by ``init_params`` or carried by ``params_from_jax``) and
``gather_state`` puts the shards back together; ``to_shardings`` pairs
each spec with its mesh, as ``NamedSharding``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ShardCtx

Spec = tuple


def batch_axes_of(mesh) -> tuple:
    """Data-parallel axes: ("pod", "data") on the multi-pod mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_ctx(mesh) -> ShardCtx:
    if mesh is None:
        return ShardCtx(mesh=None)
    return ShardCtx(mesh=mesh, batch_axes=batch_axes_of(mesh),
                    model_axis="model")


def _div(mesh, axis: str, dim: int):
    """axis name if it divides dim, else None (replicate)."""
    return axis if (axis in mesh.axis_names
                    and dim % mesh.size(axis) == 0) else None


def leaf_pspec(keys: tuple, shape: tuple, mesh) -> Spec:
    """The rule for one parameter leaf at pytree path ``keys`` (the
    reference's dict keys) with its full ``shape``."""
    dp = "data"
    tp = "model"
    name = keys[-1]
    if keys[0] == "embed":
        return (_div(mesh, tp, shape[0]), _div(mesh, dp, shape[1]))
    if keys[0] == "lm_head":
        return (_div(mesh, dp, shape[0]), _div(mesh, tp, shape[1]))
    if name == "scale":  # norms
        return (None,) * len(shape)
    # Block params: leading n_groups scan dim → None first.
    s = shape[1:] if keys[0] == "groups" else shape
    lead = (None,) if keys[0] == "groups" else ()

    def spec(*rest):
        return lead + rest

    if name == "wq":
        return spec(_div(mesh, dp, s[0]), _div(mesh, tp, s[1]), None)
    if name in ("wk", "wv"):
        return spec(_div(mesh, dp, s[0]), _div(mesh, tp, s[1]),
                    None if _div(mesh, tp, s[1]) else _div(mesh, tp, s[2]))
    if name == "wo":
        return spec(_div(mesh, tp, s[0]), None, _div(mesh, dp, s[2]))
    if name in ("w_gate", "w_up"):
        if len(s) == 3:  # MoE experts [E, D, F]
            return spec(_div(mesh, tp, s[0]), _div(mesh, dp, s[1]), None)
        return spec(_div(mesh, dp, s[0]), _div(mesh, tp, s[1]))
    if name == "w_down":
        if len(s) == 3:  # MoE [E, F, D]
            return spec(_div(mesh, tp, s[0]), None, _div(mesh, dp, s[2]))
        return spec(_div(mesh, tp, s[0]), _div(mesh, dp, s[1]))
    if name == "router":
        return spec(_div(mesh, dp, s[0]), None)
    if name in ("w_x", "w_z", "w_i", "w_f", "w_o", "w_q", "w_k", "w_v",
                "w_rec_gate", "w_in_gate", "w_up"):
        if len(s) == 2:
            return spec(_div(mesh, dp, s[0]), _div(mesh, tp, s[1]))
        return spec(*([None] * len(s)))
    if name == "conv_w":
        return spec(None, _div(mesh, tp, s[1]))
    if name == "lam":
        return spec(_div(mesh, tp, s[0]))
    if name == "w_out":
        return spec(_div(mesh, tp, s[0]), _div(mesh, dp, s[1]))
    if name == "r_z":
        return spec(*([None] * len(s)))
    return (None,) * len(shape)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(cfg: ModelConfig, params_tree: Any, mesh) -> Any:
    """Spec pytree mirroring the params in the reference's group-stacked
    layout (``models.model.params_to_tree``; meta tensors will do)."""
    return _map_with_path(
        lambda path, leaf: leaf_pspec(path, tuple(leaf.shape), mesh),
        params_tree)


def state_pspecs(cfg: ModelConfig, state: Mapping[str, Any], mesh) -> dict:
    """The spec of every key of a full state dict (``LM.state_dict()``
    keys; the values give only their shapes): a block leaf's spec without
    the group dim."""
    out = {}
    for key, t in state.items():
        parts = key.split(".")
        if parts[0] == "layers":
            _, _, name, part, w = parts
            out[key] = leaf_pspec(("groups", name, part, w),
                                  (1,) + tuple(t.shape), mesh)[1:]
        else:
            out[key] = leaf_pspec(tuple(parts), tuple(t.shape), mesh)
    return out


def cache_pspecs(cfg: ModelConfig, cache_tree: Any, mesh) -> Any:
    """Decode-cache specs: batch on the data axes; heads on model when
    divisible (MQA kv=1 replicates across model — batch carries it)."""
    ba = batch_axes_of(mesh)
    n_batch = 1
    for a in ba:
        n_batch *= mesh.size(a)

    def rule(path, leaf) -> Spec:
        name = path[-1]
        shape = tuple(leaf.shape)
        bax = ba if shape[1] % n_batch == 0 else None
        if name in ("k", "v"):      # [G, B, alloc, KV, hd]
            return (None, bax, None, _div(mesh, "model", shape[3]), None)
        if name == "pos":           # [G, alloc] (per row: [G, B, alloc])
            return (None, None) + (None,) * (len(shape) - 2)
        if name == "conv":          # [G, B, cw−1, w]
            return (None, bax, None, _div(mesh, "model", shape[3]))
        if name == "C":             # [G, B, H, hd, hd]
            return (None, bax, _div(mesh, "model", shape[2]), None, None)
        if name == "n":             # [G, B, H, hd] or [G, B, w]
            if len(shape) == 4:
                return (None, bax, _div(mesh, "model", shape[2]), None)
            return (None, bax, _div(mesh, "model", shape[2]))
        if name in ("h", "c"):      # [G, B, w]
            return (None, bax, _div(mesh, "model", shape[2]))
        return (None,) * len(shape)

    return _map_with_path(rule, cache_tree)


def batch_pspec(mesh, rank: int) -> Spec:
    """Token batches: batch dim on the data axes, rest replicated."""
    return (batch_axes_of(mesh),) + (None,) * (rank - 1)


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sharded_axes(spec: Spec) -> tuple:
    """Every mesh axis a spec shards some dim over."""
    return tuple(a for e in spec for a in spec_axes(e))


def shard_tensor(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` (a copy)."""
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        n = mesh.count(axes)
        size = t.shape[d] // n
        t = t.narrow(d, mesh.index(axes) * size, size)
    return t.clone()


def gather_tensor(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's shard ``t`` (collective)."""
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            t = mesh.all_gather(t, axes, d)
    return t


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh. ``placements`` has one entry per mesh axis, as
    DTensor's: ``("shard", dim)`` or ``("replicate",)``."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        out = []
        for axis in self.mesh.axis_names:
            dims = [d for d, e in enumerate(self.spec)
                    if axis in spec_axes(e)]
            out.append(("shard", dims[0]) if dims else ("replicate",))
        return tuple(out)

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        return shard_tensor(t, self.spec, self.mesh)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather_tensor(t, self.spec, self.mesh)


def to_shardings(tree_of_pspecs: Any, mesh) -> Any:
    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return NamedSharding(mesh, node)
    return walk(tree_of_pspecs)


def shard_state(state: Mapping[str, torch.Tensor], specs: Mapping[str, Spec],
                mesh, device=None) -> dict:
    """This rank's shard of every leaf of a full state dict, on
    ``device`` (default: the mesh's)."""
    device = device if device is not None else mesh.device
    return {k: shard_tensor(t.to(device), specs[k], mesh)
            for k, t in state.items()}


def gather_state(state: Mapping[str, torch.Tensor],
                 specs: Mapping[str, Spec], mesh) -> dict:
    """The full state dict from every rank's shards (collective)."""
    return {k: gather_tensor(t.detach(), specs[k], mesh)
            for k, t in state.items()}
