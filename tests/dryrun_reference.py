"""The reference's dry-run cells compiled on one CPU device, counted by
its own ``repro.launch.hlo_analysis.analyze`` (helper of
``test_torch_dryrun.py``; pytest does not collect it).

    PYTHONPATH=src python tests/dryrun_reference.py

prints, for every applicable cell, the reference's FLOPs on one device,
the port's committed record (``artifacts/dryrun_torch/``) and the
reference's committed 256-chip record (``artifacts/dryrun/*_pod.json``,
``flops_per_device`` × ``n_devices``), with the ratios. Nothing is
allocated: XLA compiles the step on abstract inputs (~2 min for all 32
cells on a CPU).
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import jax

from repro.configs import get_config
from repro.configs.shapes import SHAPES, applicable
from repro.launch.hlo_analysis import analyze
from repro.launch.specs import input_specs
from repro.models.layers import ShardCtx
from repro.serve.steps import decode_step, prefill_step
from repro.train.optimizer import OptConfig
from repro.train.steps import train_step

ROOT = Path(__file__).resolve().parents[1]
CTX = ShardCtx()  # no mesh: one device


def reference_flops(cfg, shape) -> int:
    """``analyze``'s FLOPs of the reference's step for (``cfg``,
    ``shape``) compiled on one device, remat as its dry-run runs it."""
    specs = input_specs(cfg, shape, OptConfig())
    S = shape.seq_len
    if shape.kind == "train":
        def step(p, o, b):
            return train_step(p, o, b, cfg, CTX, OptConfig(), remat="full")
        args = (specs["params"], specs["opt_state"], specs["batch"])
    elif shape.kind == "prefill":
        is_emb = cfg.frontend is not None

        def step(p, b):
            x = b["embeddings"] if is_emb else b["tokens"]
            return prefill_step(p, x, cfg, CTX, s_alloc=S, is_embeds=is_emb)
        args = (specs["params"], specs["batch"])
    else:
        def step(p, c, b):
            return decode_step(p, c, b["tokens"], b["cur_index"], cfg, CTX)
        args = (specs["params"], specs["cache"], specs["batch"])
    hlo = jax.jit(step).lower(*args).compile().as_text()
    return int(analyze(hlo)["flops_per_device"])


def pod_flops(arch: str, shape_name: str) -> float:
    rec = json.loads((ROOT / "artifacts" / "dryrun"
                      / f"{arch}_{shape_name}_pod.json").read_text())
    return rec["analysis"]["flops_per_device"] * rec["n_devices"]


def port_record(arch: str, shape_name: str) -> dict:
    return json.loads((ROOT / "artifacts" / "dryrun_torch"
                       / f"{arch}_{shape_name}_h100.json").read_text())


def main() -> None:
    from repro.configs import ARCH_IDS

    print("| cell | reference, one device | port | port / one device | "
          "reference, 256 chips | port / 256 chips |")
    print("|---|---|---|---|---|---|")
    for arch in ARCH_IDS:
        for name, shape in SHAPES.items():
            cfg = get_config(arch)
            if not applicable(cfg, name):
                continue
            t0 = time.time()
            one = reference_flops(cfg, shape)
            port = port_record(arch, name)["flops"]
            pod = pod_flops(arch, name)
            print(f"| {arch} {name} | {one} | {port} | {port / one:.6f} | "
                  f"{pod:.0f} | {port / pod:.6f} | ({time.time() - t0:.1f} s)",
                  flush=True)


if __name__ == "__main__":
    main()
