"""Distributed C² on the PyTorch port: Step 2 with one LPT bin of clusters
per device, then checked against the single-device pipeline.

    PYTHONPATH=src python examples/distributed_knn_torch.py [--shards 8]

Bin i runs on ``cuda:i % torch.cuda.device_count()`` (so one card runs
every bin, and a machine with 8 cards gives each bin a card of its own);
``--device cpu`` puts every bin on the CPU.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.distributed import distributed_c2
from repro_torch.core.params import C2Params
from repro_torch.core.pipeline import cluster_and_conquer
from repro_torch.data.synthetic import make_dataset
from repro_torch.device import resolve_device
from repro_torch.sketch.goldfinger import fingerprint_dataset


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=8,
                    help="LPT bins, one per device")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    devices = ([torch.device("cuda", i % torch.cuda.device_count())
                for i in range(args.shards)] if dev.type == "cuda"
               else [dev] * args.shards)

    ds = make_dataset("ml1M", scale=0.15, seed=7)
    gf = fingerprint_dataset(ds)
    p = C2Params(k=10, b=256, t=4, max_cluster=120)

    g_dist, stats = distributed_c2(ds, p, devices, gf=gf)
    g_single, _ = cluster_and_conquer(ds, p, gf=gf, device=devices[0])

    same = bool(np.array_equal(g_dist.ids, g_single.ids)
                and np.array_equal(g_dist.sims, g_single.sims))
    print(f"devices:        {stats['n_devices']} "
          f"({len(set(devices))} distinct)")
    print(f"clusters:       {stats['n_clusters']} "
          f"(LPT imbalance {stats['lpt_imbalance']:.3f})")
    print(f"matches single-device graph: {same}")
    assert same
    return {"same": same, **stats}


if __name__ == "__main__":
    main()
