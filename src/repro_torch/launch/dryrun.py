"""The dry-run: every (architecture × input shape) cell's step run once
on meta tensors under ``op_analysis``, recording its FLOPs by dtype,
bytes, predicted peak memory and whether it fits on an H100, on one card
or per rank of the reference's production meshes (counterpart of
``repro.launch.dryrun``, which lowers and compiles each cell on a 256- or
512-chip TPU mesh and reads XLA's analyses).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \
        --shape train_4k [--mesh h100|pod|multipod|both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Results are cached as JSON under ``artifacts/dryrun_torch/`` (one file
per cell, ``{arch}_{shape}_h100{tag}.json`` for one card,
``{arch}_{shape}_{pod|multipod}_h100{tag}.json`` per rank of a mesh);
``launch/roofline.py`` reads them. Nothing is allocated, so every
published config runs at its full size, ``kimi-k2-1t-a32b`` included, on
any machine's CPU.

The cells run the port's own steps: ``train/steps.train_step`` (AdamW
state in ``OptConfig``'s dtype, remat as given), and the serving path's
``serve/steps`` prefill and decode on the serving copy
(``LM.serving_copy``: weights cast once, as ``serve/engine.py`` serves),
decode at the last position of a full ``seq_len`` cache. A cell whose
count step by step would take minutes (one step a token in xLSTM's
recurrences; prefill's attention blocks at 32k over many groups) is
counted at a few sizes and extended (``op_analysis.extend``); its record
says how under ``counted``.

On a mesh (``--mesh pod``: (16, 16) ("data", "model"), 256 ranks;
``multipod``: (2, 16, 16) with "pod" first, 512) the dry-run counts rank
0's step under ``launch.mesh.fake_world``: a ``Mesh`` on the meta device
over torch's ``fake`` process group, the model cut to rank 0's shards
(``LM.shard``), train cells with their AdamW state from those shards and
``train_step(ctx=, grad_shardings=<the parameters' specs>)``, as every
mesh caller runs it (each FSDP gather's backward reduce-scatters its
gradient), serving cells on the serving copy of the shards with the
cache cut by ``cache_pspecs``. Every
rank takes the global batch and computes on its rows, as ``Engine(ctx=)``
and ``train_step(ctx=)`` do (``ShardCtx.for_batch`` / ``row_range``;
``long_500k``'s batch of 1 does not divide and is computed whole on every
rank, as the reference replicates it). The rules split a width only where
the axis divides it (``sharding._div``), so every rank's step has the
same shapes and rank 0's counts are every rank's. A mesh record adds the
collectives' bytes by kind and by axis set (``collectives``), its
``least_bytes`` and ``peak_bytes`` are one rank's, and ``fits`` holds
that rank's peak to one card's 80 GB. ``--donate`` and
``--grad-scatter`` are the reference's flags and change no count, so
they are only recorded: the port's AdamW and decode update their state
in place already, and its gradients always come out sharded like the
parameters (it has no counterpart of GSPMD's lowering of unpinned
gradients, a whole-gradient all-reduce).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ALIASES, ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.launch import op_analysis as oa
from repro_torch.launch.mesh import (HBM_BYTES, PRODUCTION_MESHES,
                                     fake_world, make_production_mesh)
from repro_torch.launch.roofline import MESH, least_bytes, record_name
from repro_torch.launch.specs import META, abstract_model, batch_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_cache, init_params
from repro_torch.models.sharding import make_ctx, to_shardings
from repro_torch.serve.steps import decode_step, prefill_step
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.steps import train_step

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
MESHES = (MESH, *PRODUCTION_MESHES)
NEEDS_MESH = ("--grad-scatter pins a train step's gradients to the "
              "parameters' shards on a mesh: give --mesh pod, multipod or "
              "both")
# Sizes a fitted cell is counted at: groups (counters affine in them),
# or sequence positions (quadratic: autograd's per-step ``select``
# gradients write a whole-sequence buffer each step).
FIT_GROUPS = (1, 2)
FIT_SEQ = (64, 128, 256)


@dataclasses.dataclass
class Cell:
    """One cell's step and what it reads: ``step()`` runs it once.
    ``mesh``: the mesh the step runs on (None: one card)."""
    cfg: ModelConfig
    shape: ShapeSpec
    step: object
    model: object
    batch: dict
    opt_state: dict | None = None
    cache: dict | None = None
    cur_index: int = 0
    mesh: object = None

    @property
    def inputs(self) -> tuple:
        """What is live before the step (the counter tracks it)."""
        return tuple(x for x in (self.model, self.opt_state, self.cache,
                                 self.batch) if x is not None)


def build_cell(arch: str, shape_name: str, *, oc=None,
               n_microbatches: int = 1, loss_chunk: int = 0,
               remat="full", cfg_overrides: dict | None = None,
               cfg: ModelConfig | None = None,
               shape: ShapeSpec | None = None, device=META,
               mesh=None) -> Cell:
    """The cell's step on ``device`` (meta: nothing allocated), or on
    ``mesh`` (a ``launch.mesh.Mesh``; its device) as this rank runs it.
    ``cfg`` and ``shape``, when given, take the place of the published
    ones (a cut of depth or length, say)."""
    if cfg is None:
        cfg = get_config(arch)
        if cfg_overrides:
            cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = shape or SHAPES[shape_name]
    oc = oc or OptConfig()
    ctx = make_ctx(mesh) if mesh is not None else None
    device = torch.device(mesh.device if mesh is not None else device)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
             for k, v in batch_specs(cfg, shape).items()}
    if shape.kind == "train":
        model = _model(cfg, device, ctx, trainable=True)
        opt = init_opt_state(dict(model.named_parameters()), oc)
        grad_sh = None if mesh is None else to_shardings(model.specs, mesh)

        def step():
            return train_step(model, opt, batch, oc,
                              n_microbatches=n_microbatches, remat=remat,
                              loss_chunk=loss_chunk, ctx=ctx,
                              grad_shardings=grad_sh)

        return Cell(cfg, shape, step, model, batch, opt_state=opt,
                    mesh=mesh)

    model = _model(cfg, device, ctx).serving_copy()
    if shape.kind == "prefill":
        is_emb = cfg.frontend is not None
        x = batch["embeddings"] if is_emb else batch["tokens"]

        def step():
            return prefill_step(model, x, s_alloc=shape.seq_len,
                                is_embeds=is_emb)

        return Cell(cfg, shape, step, model, batch, mesh=mesh)

    cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                       device=device, ctx=ctx)
    cur = shape.seq_len - 1
    del batch["cur_index"]  # the port's decode takes a host int

    def step():
        return decode_step(model, cache, batch["tokens"], cur)

    return Cell(cfg, shape, step, model, batch, cache=cache, cur_index=cur,
                mesh=mesh)


def _model(cfg: ModelConfig, device, ctx=None, trainable: bool = False):
    """The model on ``device``: meta tensors, or random weights from seed
    0 on a real device; cut to this rank's shards under ``ctx``."""
    if device == META:
        model = abstract_model(cfg, trainable=trainable)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        model = init_params(cfg, gen, device, trainable=trainable)
    return model if ctx is None else model.shard(ctx)


def cell_least_bytes(cell: Cell) -> dict:
    """``roofline.least_bytes`` of the cell's step; on a mesh this rank's:
    its shards of the model, state and cache, its rows of the batch and
    its part of the logits."""
    B, S = cell.shape.global_batch, cell.shape.seq_len
    ctx = cell.model.ctx
    batch, vocab = cell.batch, cell.cfg.vocab_size
    if ctx is not None:
        batch = {k: ctx.rows(v) for k, v in batch.items()}
        if ctx.splits(vocab):
            vocab //= ctx.model_size
    prefill_cache = None
    if cell.shape.kind == "prefill":
        prefill_cache = init_cache(cell.cfg, B, S, device=META, ctx=ctx)
    return least_bytes(cell.shape.kind, cell.model, batch,
                       opt_state=cell.opt_state, cache=cell.cache,
                       cur_index=cell.cur_index, prefill_cache=prefill_cache,
                       vocab=vocab)


def count_cell(cell: Cell) -> oa.Counts:
    """The step run once under an ``OpCounter``."""
    return oa.count(cell.step, *cell.inputs, mesh=cell.mesh)[1]


def sequential(cfg: ModelConfig) -> bool:
    """Whether a forward runs one step a token (sLSTM; mLSTM without
    chunks)."""
    kinds = {k for grp in cfg.block_pattern for k in grp}
    return "slstm" in kinds or ("mlstm" in kinds and not cfg.mlstm_chunk)


def fit_plan(cfg: ModelConfig, shape: ShapeSpec):
    """(dimension, sizes counted) for a cell counted by the fit, or None
    for a direct count: the sequence length where a forward runs one step
    a token (sizes in whole mLSTM chunks where it has them), the number of
    groups for 32k prefills of deeper models."""
    if shape.kind == "decode":
        return None
    if sequential(cfg):
        chunk = cfg.mlstm_chunk or 1
        base = -(-FIT_SEQ[0] // chunk) * chunk
        sizes = tuple(base * n // FIT_SEQ[0] for n in FIT_SEQ)
        if shape.seq_len > sizes[-1]:
            return "seq_len", sizes
    if shape.kind == "prefill" and cfg.n_groups > FIT_GROUPS[-1]:
        return "n_groups", FIT_GROUPS
    return None


def counted(arch, shape_name, cfg, shape, **knobs) -> tuple[oa.Counts, str]:
    """The cell's counts, directly or by the fit (``fit_plan``), and how
    they were taken."""
    plan = fit_plan(cfg, shape)
    if plan is None:
        return count_cell(build_cell(arch, shape_name, cfg=cfg, shape=shape,
                                     **knobs)), "direct"
    dim, sizes = plan
    parts = []
    for n in sizes:
        if dim == "seq_len":
            c, s = cfg, dataclasses.replace(shape, seq_len=n)
        else:
            c = dataclasses.replace(
                cfg, n_layers=n * len(cfg.block_pattern))
            s = shape
        parts.append(count_cell(build_cell(arch, shape_name, cfg=c, shape=s,
                                           **knobs)))
    full = shape.seq_len if dim == "seq_len" else cfg.n_groups
    how = (f"{dim} {', '.join(map(str, sizes))}, extended to {full} by "
           f"the polynomial of degree {len(sizes) - 1} through them")
    return oa.extend(parts, sizes, full), how


def run_cell(arch: str, shape_name: str, force: bool = False,
             n_microbatches: int = 1, loss_chunk: int = 0,
             cfg_overrides: dict | None = None, remat="full",
             tag: str = "", oc=None, mesh: str = MESH,
             grad_scatter: bool = False, donate: bool = False) -> dict:
    """Count one cell on one card (``mesh="h100"``) or per rank of a
    production mesh ("pod", "multipod") and write its record."""
    arch = ALIASES.get(arch, arch)
    if grad_scatter and mesh == MESH:
        raise ValueError(NEEDS_MESH)
    ART.mkdir(parents=True, exist_ok=True)
    out_path = ART / record_name(arch, shape_name, mesh, tag)
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh, "tag": tag,
           "status": "skipped"}
    if not applicable(cfg, shape_name):
        rec["reason"] = ("long_500k needs sub-quadratic attention; "
                         f"{arch} is pure full-attention (DESIGN.md §6)")
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    shape = SHAPES[shape_name]
    knobs = dict(oc=oc, n_microbatches=n_microbatches,
                 loss_chunk=loss_chunk, remat=remat)
    knob_rec = {"n_microbatches": n_microbatches, "loss_chunk": loss_chunk,
                "remat": remat, "overrides": cfg_overrides or {}}
    if mesh != MESH:
        knob_rec.update(grad_scatter=grad_scatter, donate=donate)
    elif donate:
        knob_rec["donate"] = True
    label = f"{arch} × {shape_name} × {mesh}{tag}"
    t0 = time.time()
    try:
        with contextlib.ExitStack() as stack:
            m = None
            if mesh != MESH:
                n = PRODUCTION_MESHES[mesh][0]
                stack.enter_context(fake_world(math.prod(n)))
                m = make_production_mesh(multi_pod=mesh == "multipod",
                                         device=META)
            counts, how = counted(arch, shape_name, cfg, shape, mesh=m,
                                  **knobs)
            cell = build_cell(arch, shape_name, cfg=cfg, shape=shape,
                              mesh=m, **knobs)
            least = cell_least_bytes(cell)
        rec.update(
            status="ok", n_devices=m.n_devices if m else 1, counted=how,
            knobs=knob_rec, **counts.as_dict(),
            least_bytes=least,
            param_bytes=oa.nbytes(cell.model),
            opt_state_bytes=oa.nbytes(cell.opt_state),
            cache_bytes=oa.nbytes(cell.cache),
            hbm_bytes=HBM_BYTES,
            fits=counts.peak_bytes <= HBM_BYTES,
            seconds=round(time.time() - t0, 2))
        coll = ""
        if m is not None:
            coll = (f" coll={rec['collectives']['total_bytes_per_device']:.3e}"
                    "B")
        print(f"[dryrun] OK  {label}  "
              f"{rec['seconds']:.1f}s ({how}) flops={rec['flops']:.4e} "
              f"{counts.flops} least={least['total']:.3e}B{coll} "
              f"peak={counts.peak_bytes / 1e9:.2f}GB "
              f"{'fits' if rec['fits'] else 'does not fit'}")
    except Exception as e:  # record failures — they are bugs to fix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] FAIL {label}: {e}")
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def _overrides(items) -> dict | None:
    return {k: (int(v) if v.lstrip("-").isdigit() else v)
            for k, v in (o.split("=") for o in items)} or None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default=MESH, choices=[*MESHES, "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--donate", action="store_true")
    ap.add_argument("--grad-scatter", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. mlstm_chunk=128")
    ap.add_argument("--remat", default="full", choices=["full", "save_tp"])
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if args.grad_scatter and args.mesh == MESH:
        ap.error(NEEDS_MESH)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = list(PRODUCTION_MESHES) if args.mesh == "both" else [args.mesh]
    n_ok = n_fail = 0
    for arch in archs:
        for shp in shapes:
            for mesh in meshes:
                rec = run_cell(arch, shp, force=args.force,
                               n_microbatches=args.microbatches,
                               loss_chunk=args.loss_chunk,
                               cfg_overrides=_overrides(args.override),
                               remat=args.remat, tag=args.tag, mesh=mesh,
                               grad_scatter=args.grad_scatter,
                               donate=args.donate)
                if rec["status"] == "error":
                    n_fail += 1
                elif rec["status"] == "ok":
                    n_ok += 1
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
