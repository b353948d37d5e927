"""One card's published peaks, and the device meshes (counterpart of
``repro.launch.mesh``, whose constants are a TPU v5e's).

The port runs on one NVIDIA H100 SXM5 80GB. Its peaks, from NVIDIA's
H100 Tensor Core GPU data sheet (SXM form factor, dense rates, 700 W),
are the only hardware constants the roofline and the on-card bounds
use. f32 products run on the CUDA cores: the port keeps f32 operands in
full f32, with TF32 off, so TF32's rate is listed for the record only.

A mesh is one process per card (rank), laid out row-major over named
axes as the reference's ``np.array(jax.devices()).reshape(shape)``:
``MeshShape`` carries only the axis names and sizes, which is all the
sharding rules (``models/sharding.py``) read, so they run at production
sizes with no process group; ``Mesh`` adds the process sub-group of every
set of axes over an initialised ``torch.distributed`` default group
(``nccl`` on the cards, ``gloo`` on the CPU) and the plain collectives the
layers build on; a collective over one rank is the identity and issues
nothing. ``make_production_mesh`` and ``make_host_mesh`` are functions,
so importing this module starts no process group.

The mesh dry-run needs no cards: ``fake_world(n)`` initialises torch's
``fake`` backend, whose collectives return at once, at world size n as
rank 0, so ``Mesh(..., device="meta")`` over it builds every sub-group of
a 256- or 512-rank mesh in this one process and the layers' collectives
run on meta tensors.

Links: ranks are row-major, eight to a node (a DGX H100), so a sub-group
whose ranks all sit on one node talks over NVLink and any other over the
network (``axis_link``). On both production meshes every axis spans more
than one node (the "model" axis's 16 ranks are two nodes), so every
collective there is charged at the network's rate.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Sequence

import torch

# Dense tensor-core rates (FLOP/s; int8: operations/s).
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_TF32 = 495e12
PEAK_OPS_INT8 = 1979e12
# f32 outside the tensor cores (CUDA cores), FLOP/s.
PEAK_FLOPS_F32 = 67e12
# HBM3: bytes/s and capacity.
HBM_BW = 3.35e12
HBM_BYTES = 80e9

# The rate a dot product runs at, by its operands' dtype as
# ``op_analysis`` names it.
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float16": PEAK_FLOPS_BF16,
              "float32": PEAK_FLOPS_F32}

# Cards a node, as a DGX H100 holds them.
CARDS_PER_NODE = 8
# NVLink 4, bytes/s a direction a card (NVIDIA H100 SXM data sheet: 900
# GB/s bidirectional).
NVLINK_BW = 450e9
# The network, bytes/s a card (DGX H100: one 400 Gb/s ConnectX-7 port a
# card).
NET_BW = 50e9
LINK_BW = {"nvlink": NVLINK_BW, "network": NET_BW}

# The reference's production meshes, one rank a card: (shape, axes).
PRODUCTION_MESHES = {"pod": ((16, 16), ("data", "model")),
                     "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Named mesh axes and their sizes, without processes."""

    axis_names: tuple
    shape: tuple

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    def axis_rows(self, axes) -> list:
        """The ranks of every sub-group over ``axes`` (a set of axis
        names), one list a sub-group, in the order ``Mesh`` makes them."""
        dims = tuple(d for d, a in enumerate(self.axis_names) if a in axes)
        rest = [d for d in range(len(self.shape)) if d not in dims]
        grid = torch.arange(self.n_devices).reshape(self.shape)
        # Axes last, row-major: each row is one sub-group.
        return grid.permute(*rest, *dims).reshape(
            -1, math.prod(self.shape[d] for d in dims)).tolist()


def axis_link(mesh: MeshShape, axes) -> str:
    """The link a collective over ``axes`` crosses: "nvlink" where every
    sub-group over them sits on one node of ``CARDS_PER_NODE`` cards,
    else "network" (module doc)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    one_node = all(len({r // CARDS_PER_NODE for r in row}) == 1
                   for row in mesh.axis_rows(axes))
    return "nvlink" if one_node else "network"


def production_shape(name: str) -> MeshShape:
    """The axes and sizes of a production mesh ("pod" or "multipod")."""
    shape, axes = PRODUCTION_MESHES[name]
    return MeshShape(axes, shape)


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A default process group of ``n`` ranks on torch's ``fake`` backend
    (its collectives move nothing), this process rank ``rank``; destroyed
    on exit. Raises if a process group exists already."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group exists already; "
                           "destroy it first")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "fake_world needs torch.testing._internal.distributed.fake_pg "
            f"(the 'fake' process-group backend), which torch "
            f"{torch.__version__} lacks") from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _funcol():
    import torch.distributed._functional_collectives as fc
    return fc


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if hasattr(t, "wait") else t


class Mesh(MeshShape):
    """A ``MeshShape`` over the ranks of the default process group: rank
    r sits at ``np.unravel_index(r, shape)``. Every non-empty set of axes
    gets its process sub-groups (one per coordinate of the other axes),
    made once here, in the same order on every rank. ``device`` is this
    rank's card (``cuda:<rank % cards>``) unless the caller names one."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None):
        import torch.distributed as dist
        super().__init__(tuple(axis_names), tuple(int(s) for s in shape))
        if not dist.is_initialized():
            raise RuntimeError("a Mesh spans the ranks of a process group: "
                               "call torch.distributed.init_process_group "
                               "first")
        world = dist.get_world_size()
        if world != self.n_devices:
            raise ValueError(f"a {self.shape} mesh needs {self.n_devices} "
                             f"ranks; the process group has {world}")
        rank = dist.get_rank()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: pass device='cpu' to "
                                   "run the mesh on the CPU")
            device = torch.device("cuda", rank % torch.cuda.device_count())
        object.__setattr__(self, "device", torch.device(device))
        object.__setattr__(self, "rank", rank)
        grid = torch.arange(world).reshape(self.shape)
        object.__setattr__(self, "coords", tuple(
            int(c) for c in (grid == rank).nonzero()[0]))
        groups = {}
        for k in range(1, len(self.shape) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                for row in self.axis_rows(axes):
                    g = dist.new_group(row)
                    if rank in row:
                        groups[axes] = g
        object.__setattr__(self, "_groups", groups)
        object.__setattr__(self, "group_axes", {
            g.group_name: axes for axes, g in groups.items()})

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        return self._groups[self._axes(axes)]

    def index(self, axes) -> int:
        """This rank's position along ``axes`` taken together, row-major."""
        idx = 0
        for a in self._axes(axes):
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + self.coords[i]
        return idx

    def count(self, axes) -> int:
        return math.prod(self.size(a) for a in self._axes(axes))

    def all_gather(self, t: torch.Tensor, axes, dim: int = 0):
        """The shards of ``t`` along ``axes`` concatenated on ``dim``."""
        if self.count(axes) == 1:
            return t
        fc = _funcol()
        ag = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
        return _wait(ag(t.contiguous(), dim, self.group(axes)))

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"):
        if self.count(axes) == 1:
            return t
        fc = _funcol()
        return _wait(fc.all_reduce(t.contiguous(), op, self.group(axes)))

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int = 0):
        """The sum of ``t`` over ``axes``, this rank's shard of ``dim``."""
        if self.count(axes) == 1:
            return t
        fc = _funcol()
        rs = getattr(fc, "reduce_scatter_single", None) \
            or fc.reduce_scatter_tensor
        return _wait(rs(t.contiguous(), "sum", dim, self.group(axes)))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's (16, 16) ("data", "model") mesh, or (2, 16, 16)
    with "pod" first: one rank a card, so 256 or 512 of them (under
    ``fake_world`` with ``device="meta"`` for the dry-run)."""
    import torch.distributed as dist
    shape, axes = PRODUCTION_MESHES["multipod" if multi_pod else "pod"]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {shape} (multi_pod={multi_pod}) needs "
            f"{math.prod(shape)} ranks, one a card; this process group "
            f"has a world size of {world}")
    return Mesh(shape, axes, device)


def make_host_mesh(device=None) -> Mesh:
    """A (1, 1) ("data", "model") mesh over a one-rank process group (the
    axes kept for the rules)."""
    return Mesh((1, 1), ("data", "model"), device)
