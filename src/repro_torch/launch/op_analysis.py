"""Per-op cost model of one step as PyTorch dispatches it: matmul FLOPs
by operand dtype, eager bytes, op counts and the live tensor bytes over
the step (counterpart of ``repro.launch.hlo_analysis``; there is no HLO,
so the ops are read at the ATen dispatcher instead).

``OpCounter`` is a ``TorchDispatchMode``: every ATen op the step runs,
forward and backward (autograd carries the mode into its engine), passes
through it once. It runs on meta tensors (the dry-run: nothing is
allocated) or on a card's tensors (the same step, counted where it runs).

* FLOPs count the dot products only (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolution; ``torch.utils.flop_counter``'s formulas), the
  reference's MFU convention, split by the operands' dtype, since the
  card runs bf16 and f32 products at different peaks.
* Eager bytes: operands plus results of every op that is not a view,
  the counterpart of the reference's bytes at fusion boundaries (an
  eager op is a kernel boundary). A gather reads only the rows it
  returns and an indexed write touches only its values' rows, as the
  reference charges slices; an op that overwrites its first operand
  (``copy_``, ``fill_``) does not read it; allocation alone (``empty``)
  moves nothing.
* Op counts by ATen op, and ``kernels``: the ops that are not views,
  near the kernels an eager step launches (an op may launch none, one
  or several).
* Live bytes: every storage a tracked input holds or an op creates is
  counted from its creation until it dies (a ``weakref.finalize`` on the
  storage), so ``peak_bytes`` is the most the step holds at once, its
  inputs included, in the allocator's terms (no block rounding).
* Collectives: every ``_c10d_functional`` collective a step on a mesh
  issues (``launch.mesh.Mesh``'s all-gather, all-reduce and
  reduce-scatter; all-to-all) is counted by kind and by the set of mesh
  axes its group spans (``OpCounter(mesh=)`` names a group's axes), in
  bytes as the reference's ``collective_bytes`` counts them: each
  result's bytes on this rank, summed. They add no FLOPs and stand
  outside the ops, kernels and eager bytes above (those are the step's
  compute); their results count toward the live bytes and the peak as
  any result does. ``wait_tensor`` and ``_wrap_tensor_autograd`` (the
  async result's bookkeeping) count nowhere.

On meta tensors an op's result depends only on its operands' shapes,
strides and dtypes and its other arguments, so the counter remembers
each op's result metadata by those and makes the next identical call's
results with ``empty_strided`` instead of running the op's meta kernel
again (most of them are Python reference implementations that take
~0.1-1 ms a call): a loop's second and later trips cost the dispatch
alone. In-place ops on meta tensors only check their operands, so a
remembered one returns its first operand; views, ops that resize and
ops on other devices always run, and so does every collective.

The reference multiplies a ``while`` body by its trip count
(``hlo_analysis._trip_count``). The port's loops are Python loops, which
a count runs step by step; where that is too slow (one step a token in
xLSTM's recurrences, quadratic attention blocks at 32k over many groups)
the dry-run counts the step at a few sizes of one dimension and extends
every counter by the polynomial through them (``extend``): affine in the
number of groups, quadratic in the sequence length of a recurrence
(autograd's per-step ``select`` gradients each write a buffer of the
whole sequence). FLOPs, bytes and op counts are such polynomials, so the
extension is exact; the peak is extrapolated along the line through the
two largest sizes.

A count frees the step's tensors when it returns, by reference counts
alone. torch wraps a dispatch mode's ``__torch_dispatch__`` in
``torch._disable_dynamo``, which imports ``torch._dynamo`` on its first
call: the process's first counted op, deep in the step. That import
runs ``torch.fx.wrap``, whose frame holds itself
(``inspect.currentframe()``) and, through ``f_back``, its callers'
frames: the step's, with its activations and gradients, until the
garbage collector runs. So this module imports ``torch._dynamo`` before
any step runs, as ``models/model.py`` does for remat's ``checkpoint``.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import Counter
from fractions import Fraction
from typing import Any

import torch
import torch._dynamo  # noqa: F401  (module doc: imported before a step)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# The operand whose dtype names a dot product's FLOPs, where not the first.
_MATRIX_ARG = {aten.addmm: 1, aten.baddbmm: 1}
# Ops that read only the rows they return.
_GATHERS = {aten.index, aten.index_select, aten.gather}
# Ops that write ``values`` rows into their first operand.
_INDEXED_WRITES = {aten.index_put, aten.index_put_, aten._index_put_impl_,
                   aten.index_add, aten.index_add_, aten.scatter,
                   aten.scatter_, aten.scatter_add, aten.scatter_add_}
# Ops that overwrite their first operand without reading it.
_OVERWRITES = {aten.copy_, aten.fill_, aten.zero_}
# Allocation only: no byte moves.
_NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided,
             aten.new_empty, aten.new_empty_strided,
             aten._local_scalar_dense}


# Ops never remembered: they change their operand's metadata.
_RESIZES = {aten.resize_, aten.set_, aten.resize_as_, aten.as_strided_}
_ATOMS = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)
# ``_c10d_functional`` collectives by the reference's names for them
# (``repro.launch.dryrun._COLLECTIVES``); the group name is their last
# positional argument.
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
COLLECTIVE_KINDS = tuple(COLLECTIVES.values())


class _Uncached(Exception):
    """An argument or result the meta cache cannot key or rebuild."""


def _key(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _Uncached
        return ("T", tuple(x.shape), x.stride(), x.storage_offset(),
                x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_key(v) for v in x)
    if isinstance(x, _ATOMS):
        return (type(x).__name__, x)
    raise _Uncached


def _spec(out):
    """A result's metadata, or ``_Uncached`` if ``empty_strided`` would
    not rebuild it (a view of a larger fresh buffer, say)."""
    if isinstance(out, torch.Tensor):
        spec = (tuple(out.shape), out.stride(), out.dtype)
        if (out.device.type != "meta" or out.storage_offset() != 0
                or _make(spec).untyped_storage()
                .nbytes() != out.untyped_storage().nbytes()):
            raise _Uncached
        return spec
    if isinstance(out, (list, tuple)):
        return (type(out),) + tuple(_spec(v) for v in out)
    if out is None:
        return None
    raise _Uncached


def _make(spec):
    if spec is None:
        return None
    if isinstance(spec[0], type):
        return spec[0](_make(s) for s in spec[1:])
    return torch.empty_strided(spec[0], spec[1], dtype=spec[2],
                               device="meta")


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def tensors_of(tree) -> list:
    """The tensors of a nested dict / list / tuple (or a module's
    parameters), in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (list, tuple, type({}.values()))):
        return [t for sub in tree for t in tensors_of(sub)]
    return []


def nbytes(tree) -> int:
    """Bytes of the tensors of ``tree`` (each tensor's own elements)."""
    return sum(t.numel() * t.element_size() for t in tensors_of(tree))


def axes_key(axes) -> str:
    """A set of mesh axes as a record's key: "data+model"."""
    return "+".join(axes)


@dataclasses.dataclass
class Counts:
    """What one counted step did. ``flops`` maps an operand dtype name
    to the dot-product FLOPs at that dtype; ``coll_bytes`` and
    ``coll_counts`` a collective's kind to its result bytes and calls,
    ``axes_bytes`` a set of mesh axes (``axes_key``) to the result bytes
    of the collectives over it; ``on_mesh``: counted on a mesh (its
    ``as_dict`` then carries ``collectives``)."""
    flops: dict
    bytes: int
    ops: dict
    kernels: int
    peak_bytes: int
    input_bytes: int
    coll_bytes: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)
    axes_bytes: dict = dataclasses.field(default_factory=dict)
    on_mesh: bool = False

    @property
    def total_flops(self) -> int:
        return sum(self.flops.values())

    def collectives(self) -> dict:
        """The collectives as a mesh record holds them: the reference's
        ``collective_bytes`` keys (every kind, zeros included) and the
        bytes by axis set."""
        return {"per_op_bytes": {k: self.coll_bytes.get(k, 0)
                                 for k in COLLECTIVE_KINDS},
                "per_op_counts": {k: self.coll_counts.get(k, 0)
                                  for k in COLLECTIVE_KINDS},
                "per_axes_bytes": dict(sorted(self.axes_bytes.items())),
                "total_bytes_per_device": sum(self.coll_bytes.values())}

    def as_dict(self) -> dict:
        return {"flops_by_dtype": dict(sorted(self.flops.items())),
                "flops": self.total_flops, "eager_bytes": self.bytes,
                "kernels": self.kernels, "peak_bytes": self.peak_bytes,
                "input_bytes": self.input_bytes,
                "ops": dict(sorted(self.ops.items())),
                **({"collectives": self.collectives()} if self.on_mesh
                   else {})}


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (module doc).

        with OpCounter() as oc:
            oc.track(model, opt_state, batch)   # live before the step
            step(...)
        oc.counts()
    """

    def __init__(self, meta_cache: bool = True, mesh=None):
        super().__init__()
        self.meta_cache = meta_cache
        self.mesh = mesh
        self.coll_bytes: Counter = Counter()
        self.coll_counts: Counter = Counter()
        self.axes_bytes: Counter = Counter()
        self.flops: Counter = Counter()
        self.bytes = 0
        self.ops: Counter = Counter()
        self.kernels = 0
        self.live = 0
        self.peak = 0
        self.input_bytes = 0
        self._storages: dict[int, int] = {}
        self._meta_cache: dict = {}

    # -- live bytes
    def track(self, *trees) -> None:
        """Count the storages of ``trees`` as live from now on (the
        step's inputs, made before the counter was entered)."""
        before = self.live
        for t in tensors_of(trees):
            self._hold(t)
        self.input_bytes += self.live - before

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- the ops
    def _op_bytes(self, packet, args, kwargs, outs) -> int:
        if packet in _NO_BYTES:
            return 0
        ins = tensors_of(list(args) + list(kwargs.values()))
        if packet in _GATHERS:
            return 2 * nbytes(outs) + nbytes(ins[1:])
        if packet in _INDEXED_WRITES:
            values = ins[-1] if packet not in (aten.index_add,
                                               aten.index_add_) else ins[2]
            return 2 * nbytes(values) + nbytes(ins[1:-1])
        if packet in _OVERWRITES:
            ins = ins[1:]
        return nbytes(ins) + nbytes(outs)

    def _collective(self, func, args, kwargs):
        """Run a ``_c10d_functional`` op; count it if it is a collective
        (module doc)."""
        out = func(*args, **kwargs)
        kind = COLLECTIVES.get(func.overloadpacket.__name__)
        if kind is not None:
            n = nbytes(tensors_of(out))
            name = args[-1] if isinstance(args[-1], str) else kwargs.get(
                "group_name")
            axes = getattr(self.mesh, "group_axes", {}).get(name)
            self.coll_bytes[kind] += n
            self.coll_counts[kind] += 1
            self.axes_bytes[axes_key(axes) if axes else f"group {name}"] += n
        for t in tensors_of(out):
            self._hold(t)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "_c10d_functional":
            return self._collective(func, args, kwargs)
        packet = func.overloadpacket
        if packet not in flop_registry:
            # Outside autograd (inference mode) composite ops such as
            # ``matmul`` arrive whole: count the ops they run.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = self._run(func, packet, args, kwargs)
        self.ops[packet.__name__] += 1
        outs = tensors_of(out)
        if not func.is_view:
            self.kernels += 1
            self.bytes += self._op_bytes(packet, args, kwargs, outs)
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            arg = args[_MATRIX_ARG.get(packet, 0)]
            self.flops[dtype_name(arg.dtype)] += int(n)
        for t in outs:
            self._hold(t)
        return out

    def _run(self, func, packet, args, kwargs):
        """``func(*args, **kwargs)``, from the meta cache where it may
        (module doc)."""
        if not self.meta_cache or func.is_view or packet in _RESIZES:
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
        except _Uncached:
            return func(*args, **kwargs)
        hit = self._meta_cache.get(key)
        if hit is not None:
            return args[0] if hit == "self" else _make(hit)
        out = func(*args, **kwargs)
        schema = func._schema
        if schema.is_mutable:
            first = schema.arguments[0].alias_info
            if (len(schema.returns) == 1 and first is not None
                    and first.is_write and out is args[0]):
                self._meta_cache[key] = "self"
            return out
        ins = {t.untyped_storage()._cdata
               for t in tensors_of(list(args) + list(kwargs.values()))}
        if any(t.untyped_storage()._cdata in ins for t in tensors_of(out)):
            return out  # an alias of an operand (``_unsafe_view``, say)
        try:
            self._meta_cache[key] = _spec(out)
        except _Uncached:
            pass
        return out

    def counts(self) -> Counts:
        return Counts(flops=dict(self.flops), bytes=self.bytes,
                      ops=dict(self.ops), kernels=self.kernels,
                      peak_bytes=self.peak, input_bytes=self.input_bytes,
                      coll_bytes=dict(self.coll_bytes),
                      coll_counts=dict(self.coll_counts),
                      axes_bytes=dict(self.axes_bytes),
                      on_mesh=self.mesh is not None)


def count(step, *inputs, mesh=None) -> tuple[Any, Counts]:
    """Run ``step()`` once under an ``OpCounter`` with ``inputs`` tracked
    as live (``mesh``: the one its collectives run on); returns (its
    result, the counts)."""
    with OpCounter(mesh=mesh) as oc:
        oc.track(*inputs)
        out = step()
    return out, oc.counts()


def _lagrange(values, xs, x) -> int:
    """The polynomial of degree len(xs) - 1 through (xs[i], values[i])
    at x, an integer (exact whenever the counter is such a polynomial)."""
    total = Fraction(0)
    for i, (xi, vi) in enumerate(zip(xs, values)):
        w = Fraction(vi)
        for j, xj in enumerate(xs):
            if j != i:
                w *= Fraction(x - xj, xi - xj)
        total += w
    return round(total)


def extend(parts, xs, x) -> Counts:
    """Every counter of ``parts[i]`` (counted at size ``xs[i]``) extended
    to size ``x`` by the polynomial through them (affine from two sizes,
    quadratic from three); the peak and the input bytes by the line
    through the two largest sizes, since a peak is affine only once the
    same phase of the step holds it (the smallest size's may not)."""
    def each(key, last=len(xs)):
        return _lagrange([getattr(p, key) for p in parts][-last:],
                         xs[-last:], x)

    def per_key(attr):
        keys = sorted(set().union(*(getattr(p, attr) for p in parts)))
        return {k: _lagrange([getattr(p, attr).get(k, 0) for p in parts],
                             xs, x) for k in keys}

    return Counts(flops=per_key("flops"), bytes=each("bytes"),
                  ops=per_key("ops"), kernels=each("kernels"),
                  peak_bytes=each("peak_bytes", 2),
                  input_bytes=each("input_bytes", 2),
                  coll_bytes=per_key("coll_bytes"),
                  coll_counts=per_key("coll_counts"),
                  axes_bytes=per_key("axes_bytes"),
                  on_mesh=any(p.on_mesh for p in parts))


def same_flops(a: Counts, b: Counts) -> bool:
    """FLOPs equal dtype by dtype, as integers."""
    keys = set(a.flops) | set(b.flops)
    return all(a.flops.get(k, 0) == b.flops.get(k, 0) for k in keys)
