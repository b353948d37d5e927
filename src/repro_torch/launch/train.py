"""Training launcher (torch port of ``repro.launch.train``): config,
checkpoint/restart, deterministic data skip and failure simulation.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --batch 8 --seq 512 --steps 8 --data-order c2

Everything runs on ``--device`` (default ``cuda``; without a card that
raises at once, ``--device cpu`` runs on the CPU); ``--smoke`` trains the
reduced config (``scaled_down``). Weights are random from ``--seed``.

Fault tolerance: checkpoints are atomic and in the reference's layout
(``repro_torch.checkpoint``), so ``--ckpt-dir`` resumes from one written
by either package, at the saved step + 1 (batches are a pure function
of the step). ``--fail-at-step N`` simulates a node failure (exit code
42). ``--data-order c2`` orders documents by the FastRandomHash kernel
(``data/tokens.py``).
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.config import scaled_down
from repro_torch.models.model import (init_params, load_tree_,
                                      opt_state_to_tree, params_to_tree)
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.steps import train_step

FAILURE_EXIT = 42


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--data-order", default="iid", choices=["iid", "c2"])
    ap.add_argument("--grad-compress", default=None, choices=[None, "int8"])
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="simulate a node failure (tests restart)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def state_tree(model, opt_state, device=None):
    """``(params, opt_state)`` in the reference's layout, the tree a
    checkpoint holds, its tensors on ``device``."""
    cfg = model.cfg
    return (params_to_tree(model.state_dict(), cfg, device),
            opt_state_to_tree(opt_state, cfg, device))


def save_state(ckpt_dir, model, opt_state, step: int):
    """Write ``(params, opt_state)`` in the reference's layout."""
    return ckpt.save(ckpt_dir, state_tree(model, opt_state, "cpu"), step)


def restore_state(ckpt_dir, model, opt_state, step=None) -> int:
    """Load a checkpoint of either package into ``model`` and
    ``opt_state`` (in place, on their device); returns its step."""
    (params, opt), step = ckpt.restore(
        ckpt_dir, state_tree(model, opt_state, "meta"), step)
    load_tree_(model.state_dict(), params)
    with torch.no_grad():
        opt_state["step"].copy_(opt["step"])
    for key in ("m", "v", "err"):
        if key in opt:
            load_tree_(opt_state[key], opt[key])
    return step


def run(argv=None, cfg=None) -> dict:
    """Parse ``argv`` and train. Returns the run's record: ``losses`` and
    ``step_ms`` (host clock to the loss on the host) of every step run,
    ``final_loss``, ``start_step``, ``peak_gb`` on a card, and the
    ``model``, ``opt_state`` and ``pipeline``. A ``cfg`` given here (a
    model cut in depth, say) takes the place of ``--arch``'s."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = scaled_down(cfg)
    oc = OptConfig(lr=args.lr, grad_compress=args.grad_compress)
    dc = DataConfig(seq_len=args.seq, global_batch=args.batch,
                    seed=args.seed, ordering=args.data_order,
                    n_docs=max(1024, 4 * args.batch))
    pipe = TokenPipeline(cfg, dc, device)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = init_params(cfg, gen, device, trainable=True)
    opt_state = init_opt_state(dict(model.named_parameters()), oc)
    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        start_step = restore_state(args.ckpt_dir, model, opt_state) + 1
        print(f"[train] restored checkpoint, resuming at step {start_step}")

    losses, step_ms = [], []
    t0 = time.time()
    for step in range(start_step, args.steps):
        if args.fail_at_step is not None and step == args.fail_at_step:
            print(f"[train] simulating node failure at step {step}")
            raise SystemExit(FAILURE_EXIT)
        ts = time.perf_counter()
        batch = pipe.batch(step)
        _, _, metrics = train_step(model, opt_state, batch, oc,
                                   n_microbatches=args.microbatches)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {losses[-1]:.4f}"
                  f" ({(time.time() - t0):.1f}s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_state(args.ckpt_dir, model, opt_state, step)
    # The final state, unless the cadence has just written this very step
    # (the reference writes it twice, the same files).
    if args.ckpt_dir and not (args.steps > start_step
                              and args.steps % args.ckpt_every == 0):
        save_state(args.ckpt_dir, model, opt_state, args.steps - 1)
    final = losses[-1] if losses else math.nan
    print(f"[train] done: {args.steps - start_step} steps, "
          f"final loss {final:.4f}")
    out = {"losses": losses, "step_ms": step_ms, "final_loss": final,
           "start_step": start_step, "model": model, "opt_state": opt_state,
           "pipeline": pipe}
    if device.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def main(argv=None) -> float:
    return run(argv)["final_loss"]


if __name__ == "__main__":
    main()
