"""The card's peaks and the work of each kernel on a measured path.

A roofline share is the least time the card could take for the work,
the larger of operations at peak and bytes at peak bandwidth, over the
kernel's measured device time. The work is counted from the kernel's
inputs, never from the program's own counters, so a change in how a kernel
skips work cannot move the yardstick:

* every input byte the work needs is counted once and every output byte
  once, whatever a kernel reads again;
* a GoldFinger pair is an AND and a popcount of ``n_bits`` bits, counted
  as ``2 * n_bits`` operations at the int8 rate (an int8 product of 0/1
  bit planes does the same work).

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W.
"""
from __future__ import annotations

import numpy as np
import torch

PEAK_INT8_OPS = 1979e12   # int8 tensor-core operations/s, dense
PEAK_HBM_BYTES = 3.35e12  # HBM3 bytes/s
PAD = -1


def least_time(ops: float, nbytes: float) -> tuple[float, str]:
    """(seconds, bound) of work of ``ops`` operations and ``nbytes``
    bytes at the card's peaks; bound names the larger term."""
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share(ops: float, nbytes: float, device_s: float) -> float:
    """Percent of the roofline that ``device_s`` of kernel time reached."""
    return 100.0 * least_time(ops, nbytes)[0] / device_s


def cluster_knn_work(sizes, n_bits: int, k: int) -> tuple[int, int]:
    """(ops, bytes) of Step 2's brute force over clusters of ``sizes``
    members: every unordered member pair once (no padded slot), each
    member's fingerprint, cardinality and id read once per cluster, its k
    neighbour ids and sims written once."""
    m = np.asarray(sizes, dtype=np.int64)
    m = m[m >= 2]
    pairs = int((m * (m - 1) // 2).sum())
    members = int(m.sum())
    read = members * (n_bits // 8 + 4 + 4)
    written = members * k * (4 + 4)
    return pairs * 2 * n_bits, read + written


def hop_work(graph: torch.Tensor, rev: torch.Tensor, beam: torch.Tensor,
             active: torch.Tensor, n_bits: int) -> tuple[int, int]:
    """(ops, bytes) of one descent hop over the ``active`` rows of
    ``beam`` (ids [rows, B], PAD padded), on adjacency ``graph`` [n, kg]
    and ``rev`` [n, kr]: each row's distinct candidates, its beam's
    forward and reverse neighbours that are neither PAD nor already in its
    beam, scored once each. Bytes: the adjacency rows of the distinct beam
    ids, the fingerprints and cardinalities of the distinct candidate ids,
    each active row's query fingerprint and beam in and out."""
    beam = beam[active].long()
    rows, B = beam.shape
    if rows == 0:
        return 0, 0
    dead = beam == PAD
    safe = torch.where(dead, 0, beam)
    cand = torch.cat([graph[safe].long().masked_fill(dead[..., None], PAD),
                      rev[safe].long().masked_fill(dead[..., None], PAD)],
                     dim=2).reshape(rows, -1)
    n = graph.shape[0] + 1
    key = torch.arange(rows, device=cand.device)[:, None] * n + (cand + 1)
    in_beam = torch.isin(key, torch.arange(rows, device=cand.device)[:, None]
                         * n + (beam + 1))
    keep = (cand != PAD) & ~in_beam
    pairs = int(torch.unique(key[keep]).numel())
    cand_rows = int(torch.unique(cand[keep]).numel())
    beam_rows = int(torch.unique(beam[~dead]).numel())
    row_b = n_bits // 8 + 4
    nbytes = (beam_rows * (graph.shape[1] + rev.shape[1]) * 4
              + cand_rows * row_b + rows * (row_b + 2 * B * 8))
    return pairs * 2 * n_bits, nbytes
