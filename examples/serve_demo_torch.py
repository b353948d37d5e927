"""Serve a small model on the PyTorch port with batched requests, in wave
mode (queue → prefill wave → batched decode) or continuous mode
(slot-scheduled streaming admission, ``--continuous``), with
throughput/latency stats.

    PYTHONPATH=src python examples/serve_demo_torch.py [--continuous]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.config import scaled_down
from repro_torch.models.model import init_params
from repro_torch.serve.engine import Engine, Request, ServeConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--continuous", action="store_true",
                    help="slot-scheduled streaming admission instead of "
                         "closed waves (identical token streams)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = scaled_down(get_config("llama3_2-1b"))
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    engine = Engine(model, ServeConfig(max_batch=4, max_prompt=32,
                                       max_new=16,
                                       continuous=args.continuous))
    rng = np.random.default_rng(0)
    for rid in range(10):
        plen = int(rng.integers(4, 32))
        engine.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new=int(rng.integers(4, 16))))
    stats = engine.run()
    unit = "ticks" if args.continuous else "waves"
    print("requests:", stats["requests"], f"{unit}:", stats["waves"],
          "decode steps:", stats["decode_steps"])
    print(f"throughput: {stats['tokens_per_s']:.1f} tok/s "
          f"({stats['mode']} greedy decode, {dev.type})")
    print(f"latency: mean {stats['mean_latency_s']:.2f}s "
          f"p95 {stats['p95_latency_s']:.2f}s")
    for r in engine.done[:3]:
        print(f"  req {r.rid}: {len(r.output)} tokens -> "
              f"{r.output[:8].tolist()}...")
    return {"stats": stats, "model": model,
            "outputs": {r.rid: r.output.tolist() for r in engine.done}}


if __name__ == "__main__":
    main()
