"""End-to-end run on the PyTorch port: train a ~100M-parameter
llama-style LM with checkpointing and C² locality-aware data ordering
(the order through the FastRandomHash kernel's CSR entry on a card).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]

Checkpoints go to ``--ckpt-dir`` (default: a fresh temporary directory,
removed at exit).
"""
import argparse
import tempfile

from repro_torch.launch import train as T


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        # ~100M-param reduction of llama3.2-1b (same family/blocks).
        rec = T.run(["--arch", "llama3_2-1b", "--smoke",
                     "--steps", str(args.steps),
                     "--batch", "8", "--seq", "256",
                     "--data-order", "c2",
                     "--ckpt-dir", args.ckpt_dir or tmp,
                     "--ckpt-every", "50", "--device", args.device])
    return {"losses": rec["losses"], "final_loss": rec["final_loss"],
            "step_ms": rec["step_ms"]}


if __name__ == "__main__":
    main()
