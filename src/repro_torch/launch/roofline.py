"""Roofline over the dry-run records, on an H100's terms (counterpart of
``repro.launch.roofline``).

For every (arch × shape) cell of ``artifacts/dryrun_torch/``, on one card
(``--mesh h100``) or per rank of a production mesh (``pod``,
``multipod``):

    compute term    = Σ over dtype of counted FLOPs / that dtype's peak
                      (bf16 989 TFLOP/s; f32 67 TFLOP/s, TF32 off)
    memory term     = least bytes / 3.35 TB/s
    collective term = Σ over axis sets of the collectives' bytes / the
                      rate of the link ``mesh.axis_link`` gives them
                      (NVLink 450 GB/s, the network 50 GB/s a card;
                      every axis of both production meshes crosses
                      nodes, so the network's); 0 on one card

plus MODEL_FLOPS = 6·N_active·tokens (train) or 2·N_active·tokens
(prefill/decode), the reference's formula; the ratio MODEL / counted
(remat, masked attention blocks and f32 work show up here; per rank on
a mesh: MODEL / n_devices / counted); the dominant term;
``mfu_bound``, the model FLOPs (per device on a mesh, the reference's
form) at the bf16 peak over the larger term; ``fits``, the predicted
peak (a rank's on a mesh) within the card's 80 GB; and the reference's
advice where it applies.

The least bytes count each input byte read
once and each output byte written once (``least_bytes``). The same
functions give ``chip_smoke.py`` its LM bounds.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                     PEAK_FLOPS_BF16, PEAK_FLOPS_F32,
                                     PRODUCTION_MESHES, axis_link,
                                     production_shape)
from repro_torch.launch.op_analysis import nbytes

ART = Path(__file__).resolve().parents[3] / "artifacts"
MESH = "h100"


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens
    return 2.0 * n_act * shape.global_batch  # decode: 1 token/sequence


# ------------------------------------------------------------ least bytes

def _expert_leaf(name: str) -> bool:
    return "_moe.block." in name and not name.endswith(".router")


def param_read_bytes(model, rows: int | None = None,
                     experts_read=None) -> int:
    """Bytes of the parameters one step reads, as ``model`` holds them.
    ``rows``: the step gathers only that many rows of an untied
    embedding (serving); None reads it whole (training updates it).
    ``experts_read``: for each MoE block in order, the number of its
    experts the step reads (None: all, as the bucketed dispatch does)."""
    cfg = model.cfg
    total, moe_i = 0, 0
    moe_seen: dict = {}
    for name, p in model.named_parameters():
        size = p.numel() * p.element_size()
        if name == "embed" and not cfg.tie_embeddings and rows is not None:
            size = min(rows, p.shape[0]) * p.shape[1] * p.element_size()
        elif experts_read is not None and _expert_leaf(name):
            block = name.rsplit(".", 1)[0]
            if block not in moe_seen:
                moe_seen[block] = experts_read[moe_i]
                moe_i += 1
            size = size // p.shape[0] * moe_seen[block]
        total += size
    return total


def _attn(sub: dict) -> bool:
    return "pos" in sub


def cache_read_bytes(cache: dict, valid: int) -> int:
    """A decode step's cache reads: the ``valid`` newest positions of
    each attention cache (all of a ring shorter than that) with its
    positions, every recurrent state whole."""
    total = 0
    for sub in cache.values():
        if _attn(sub):
            alloc = sub["k"].shape[2]
            n = min(valid, alloc)
            for key in ("k", "v"):
                leaf = sub[key]
                total += leaf.numel() // alloc * n * leaf.element_size()
            total += nbytes(sub["pos"])
        else:
            total += nbytes(sub)
    return total


def cache_write_bytes(cache: dict) -> int:
    """A decode step's cache writes: one position of each attention
    cache (k, v and its position), every recurrent state whole."""
    total = 0
    for sub in cache.values():
        if _attn(sub):
            alloc = sub["k"].shape[2]
            total += sum(sub[k].numel() // alloc * sub[k].element_size()
                         for k in ("k", "v"))
            pos = sub["pos"]
            total += pos.numel() // alloc * pos.element_size()
        else:
            total += nbytes(sub)
    return total


def least_bytes(kind: str, model, batch: dict, *, opt_state=None,
                cache=None, cur_index: int = 0, prefill_cache=None,
                experts_read=None, vocab: int | None = None) -> dict:
    """Bytes one step must move, by part: each input byte read once and
    each output byte written once.

    train: parameters, AdamW state and batch in; parameters and state
    out (the metrics are scalars). prefill: the parameters it reads and
    the batch in; f32 logits [B, S, V] and ``prefill_cache`` (the cache
    it builds) out. decode: the parameters it reads, the ``cur_index +
    1`` valid cache positions and the batch in; f32 logits [B, 1, V] and
    the cache's new position (recurrent states whole) out. ``vocab``:
    the logits' width (a rank's share on a mesh; default the config's)."""
    cfg = model.cfg
    vocab = vocab or cfg.vocab_size
    toks = batch.get("tokens", batch.get("embeddings"))
    B, S = toks.shape[0], toks.shape[1]
    parts = {"batch_in": nbytes(batch)}
    if kind == "train":
        parts["params_in"] = parts["params_out"] = param_read_bytes(model)
        parts["opt_state_in"] = parts["opt_state_out"] = nbytes(opt_state)
    elif kind == "prefill":
        rows = 0 if "embeddings" in batch else B * S
        parts["params_in"] = param_read_bytes(model, rows, experts_read)
        parts["logits_out"] = B * S * vocab * 4
        parts["cache_out"] = nbytes(prefill_cache)
    else:
        parts["params_in"] = param_read_bytes(model, B, experts_read)
        parts["cache_in"] = cache_read_bytes(cache, cur_index + 1)
        parts["logits_out"] = B * vocab * 4
        parts["cache_out"] = cache_write_bytes(cache)
    parts["total"] = sum(parts.values())
    return parts


# ---------------------------------------------------------------- terms

def compute_s(flops_by_dtype: dict) -> float:
    """Σ over dtype of FLOPs at that dtype's peak (f32's for any other)."""
    return sum(n / PEAK_FLOPS.get(dt, PEAK_FLOPS_F32)
               for dt, n in flops_by_dtype.items())


def collective_s(per_axes_bytes: dict, mesh) -> float:
    """Σ over axis sets ("data+model") of their collectives' bytes over
    the rate of the link they cross on ``mesh`` (a ``MeshShape``)."""
    return sum(n / LINK_BW[axis_link(mesh, key.split("+"))]
               for key, n in per_axes_bytes.items())


def terms(flops_by_dtype: dict, least: int, collectives: dict | None = None,
          mesh=None) -> dict:
    """The roofline's terms in seconds, the bottleneck and the bound;
    ``collectives`` (a mesh record's) over ``mesh``'s links, none on one
    card."""
    coll = 0.0
    if mesh is not None and collectives:
        coll = collective_s(collectives["per_axes_bytes"], mesh)
    t = {"compute": compute_s(flops_by_dtype), "memory": least / HBM_BW,
         "collective": coll}
    bott = max(t, key=t.get)
    return {"compute_s": t["compute"], "memory_s": t["memory"],
            "collective_s": t["collective"], "bottleneck": bott,
            "bound_s": t[bott]}


def _advice(bottleneck: str, kind: str, flops: dict, arch: str) -> str:
    if bottleneck == "collective":
        if get_config(arch).n_experts:
            return ("shrink TP all-reduce traffic: sequence-sharded "
                    "norms/residual (SP) + keep expert psum in bf16")
        return ("sequence parallelism on the model axis to turn per-layer "
                "all-reduces into reduce-scatter/all-gather halves")
    if bottleneck == "memory":
        if kind == "decode":
            return ("KV-cache traffic dominates: quantize cache to int8, "
                    "grow per-chip batch")
        return ("activation traffic dominates: fuse the f32 loss/softmax "
                "pipeline, keep residuals bf16, reduce remat width")
    if compute_s({"float32": flops.get("float32", 0)}) > compute_s(
            {"bfloat16": flops.get("bfloat16", 0)}):
        return ("compute-bound on f32 products (CUDA cores, TF32 off): "
                "bf16 operands with f32 accumulation would run them on the "
                "tensor cores")
    return "compute-bound: raise per-chip utilization (larger tiles/batch)"


def mesh_label(mesh: str = MESH) -> str:
    """A file name's mesh part: "h100" for one card, "pod_h100" or
    "multipod_h100" per card of a production mesh."""
    return MESH if mesh == MESH else f"{mesh}_{MESH}"


def record_name(arch: str, shape_name: str, mesh: str = MESH,
                tag: str = "") -> str:
    """A dry-run record's file name under ``artifacts/dryrun_torch/``."""
    return f"{arch}_{shape_name}_{mesh_label(mesh)}{tag}.json"


def load_cells(tag: str = "", mesh: str = MESH) -> list:
    """The roofline's rows from the records of one card (``mesh="h100"``)
    or of a production mesh's rank ("pod", "multipod")."""
    shape_of = None if mesh == MESH else production_shape(mesh)
    rows = []
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            f = ART / "dryrun_torch" / record_name(arch, shape_name,
                                                   mesh, tag)
            if not f.exists():
                continue
            rec = json.loads(f.read_text())
            row = {"arch": arch, "shape": shape_name,
                   "status": rec["status"]}
            if rec["status"] == "skipped":
                row["note"] = rec.get("reason", "")
                rows.append(row)
                continue
            if rec["status"] != "ok":
                row["note"] = rec.get("error", "")[:160]
                rows.append(row)
                continue
            flops = rec["flops_by_dtype"]
            t = terms(flops, rec["least_bytes"]["total"],
                      rec.get("collectives"), shape_of)
            n_dev = rec["n_devices"]
            mf = model_flops(arch, shape_name)
            row.update(
                n_devices=n_dev, **t,
                model_flops_global=mf,
                counted_flops=rec["flops"],
                counted_flops_by_dtype=flops,
                model_over_counted=mf / n_dev / max(rec["flops"], 1),
                mfu_bound=(mf / n_dev / PEAK_FLOPS_BF16)
                / max(t["bound_s"], 1e-12),
                peak_bytes=rec["peak_bytes"], fits=rec["fits"],
                advice=_advice(t["bottleneck"], SHAPES[shape_name].kind,
                               flops, arch))
            if shape_of is not None:
                row["collective_bytes"] = rec["collectives"][
                    "total_bytes_per_device"]
            rows.append(row)
    return rows


def out_file(mesh: str = MESH, tag: str = "") -> Path:
    return ART / f"roofline_{mesh_label(mesh)}{tag}.json"


def render(rows, title="Roofline (one NVIDIA H100 SXM 80GB: bf16 989, "
           "f32 67 TFLOP/s, HBM 3.35 TB/s)"):
    out = [f"### {title}", "",
           "| arch | shape | compute s | memory s | collective s | "
           "bottleneck | MODEL/counted | MFU-bound | peak GB | fits |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"skipped | — | — | — | — |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | FAILED: "
                       f"{r.get('note', '')} | | | | | | | |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"**{r['bottleneck']}** | {r['model_over_counted']:.2f} | "
            f"{r['mfu_bound']:.3f} | {r['peak_bytes'] / 1e9:.1f} | "
            f"{'yes' if r['fits'] else 'no'} |")
    return "\n".join(out)


TITLES = {MESH: "Roofline (one NVIDIA H100 SXM 80GB: bf16 989, f32 67 "
                "TFLOP/s, HBM 3.35 TB/s)",
          "pod": "Roofline per card of 256 H100s, (16, 16) (bf16 989, f32 "
                 "67 TFLOP/s, HBM 3.35 TB/s, network 50 GB/s a card)",
          "multipod": "Roofline per card of 512 H100s, (2, 16, 16) (bf16 "
                      "989, f32 67 TFLOP/s, HBM 3.35 TB/s, network 50 GB/s "
                      "a card)"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=MESH, choices=[MESH, *PRODUCTION_MESHES])
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    rows = load_cells(args.tag, args.mesh)
    out_file(args.mesh, args.tag).write_text(json.dumps(rows, indent=2))
    print(render(rows, TITLES[args.mesh]))
    return rows


if __name__ == "__main__":
    main()
