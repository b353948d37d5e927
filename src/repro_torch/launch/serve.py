"""LM serving launcher (torch port of ``repro.launch.serve``): bring up
the batched engine on a model with random weights from ``--seed`` and
drive it with synthetic requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --requests 32 --max-batch 8 --max-prompt 512 --max-new 64 \
        [--continuous --slots 8]

``--smoke`` serves the reduced config (``scaled_down``). Everything runs
on ``--device`` (default ``cuda``; without a card that raises at once,
``--device cpu`` runs on the CPU). ``--continuous`` streams the requests
through ``--slots`` decode slots instead of closed waves of
``--max-batch``: the same tokens for dense and recurrent models (e.g.
``--arch recurrentgemma-2b``, ``xlstm-125m``) up to bf16 rounding at a
near tie; for MoE models (``olmoe-1b-7b``) the expert capacity follows
each call's batch, so the two modes can drop different tokens. The
requests are the reference launcher's for the same seed and flags.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.config import scaled_down
from repro_torch.models.model import init_params
from repro_torch.serve.engine import Engine, Request, ServeConfig


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="slot-scheduled streaming admission")
    ap.add_argument("--slots", type=int, default=0,
                    help="decode slots with --continuous (0: --max-batch)")
    ap.add_argument("--device", default="cuda")
    return ap


def build(argv=None, cfg=None) -> Engine:
    """Parse ``argv``, make the model and the engine, submit the
    requests; ``engine.run()`` serves them. A ``cfg`` given here (a
    model cut in depth, say) takes the place of ``--arch``'s."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = scaled_down(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    engine = Engine(init_params(cfg, gen, device), ServeConfig(
        max_batch=args.max_batch, max_prompt=args.max_prompt,
        max_new=args.max_new, continuous=args.continuous, slots=args.slots))
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.max_prompt))
        engine.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new=int(rng.integers(2, args.max_new + 1))))
    return engine


def report(stats: dict) -> None:
    print(f"[serve] {stats['requests']} requests in {stats['waves']} waves"
          f" | {stats['tokens_per_s']:.1f} tok/s"
          f" | latency mean {stats['mean_latency_s']:.2f}s"
          f" p95 {stats['p95_latency_s']:.2f}s")


def main(argv=None) -> dict:
    stats = build(argv).run()
    report(stats)
    return stats


if __name__ == "__main__":
    main()
