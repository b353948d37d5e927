"""Quickstart on the PyTorch port: build an approximate KNN graph with
Cluster-and-Conquer and hold it against brute force.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Step 2 and brute force run through the cluster-KNN CUDA kernel on
``--device cuda`` (the default), through its plain version on the CPU.
"""
import argparse
import time

from repro_torch.core.params import C2Params
from repro_torch.core.pipeline import cluster_and_conquer
from repro_torch.data.synthetic import make_dataset
from repro_torch.eval.metrics import quality
from repro_torch.knn.brute_force import brute_force_knn, n_similarities
from repro_torch.sketch.goldfinger import fingerprint_dataset


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # A MovieLens-1M-statistics dataset at 30% user scale.
    ds = make_dataset("ml1M", scale=0.3, seed=0)
    print(f"dataset: {ds.n_users} users × {ds.n_items} items, "
          f"{ds.nnz} ratings ({100 * ds.density:.2f}% dense)")

    gf = fingerprint_dataset(ds)          # 1024-bit GoldFinger sketches
    t0 = time.perf_counter()
    exact = brute_force_knn(gf, k=10, device=args.device)  # the reference
    t_bf = time.perf_counter() - t0

    params = C2Params(k=10, b=256, t=8, max_cluster=120)
    t0 = time.perf_counter()
    graph, stats = cluster_and_conquer(ds, params, gf=gf, device=args.device)
    t_c2 = time.perf_counter() - t0

    q = quality(ds, graph, exact, device=args.device)
    bf_sims = n_similarities(ds.n_users)
    print(f"brute force: {t_bf:.2f}s ({bf_sims:,} sims)")
    print(f"C²:          {t_c2:.2f}s ({stats.n_sims:,} sims, "
          f"{stats.n_clusters} clusters)")
    print(f"quality:     {q:.4f}  (1.0 = exact graph)")
    print(f"sim budget:  ×{bf_sims / stats.n_sims:.1f} "
          f"fewer similarity computations")
    return {"quality": q, "n_sims": stats.n_sims, "bf_sims": bf_sims,
            "n_clusters": stats.n_clusters, "t_bf": t_bf, "t_c2": t_c2}


if __name__ == "__main__":
    main()
