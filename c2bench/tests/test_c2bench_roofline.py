"""The roofline's work counts against hand counts at small shapes."""
import pytest
import torch

from c2bench import roofline

PAD = -1


def test_cluster_pairs_exclude_padding_and_singletons():
    # Members 1, 2, 3, 5: pairs 0 + 1 + 3 + 10 = 14; singletons do no work.
    ops, nbytes = roofline.cluster_knn_work([1, 2, 3, 5], n_bits=64, k=2)
    assert ops == 14 * 2 * 64
    # 10 clustered members: 8-byte fingerprint + card + id read once,
    # k = 2 ids and sims written once.
    assert nbytes == 10 * (8 + 4 + 4) + 10 * 2 * 8


def test_hop_counts_distinct_unseen_candidates_once():
    graph = torch.tensor([[1, 2], [0, 2], [3, PAD], [0, 1]])
    rev = torch.tensor([[3, PAD], [0, PAD], [0, 1], [2, PAD]])
    beam = torch.tensor([[0, 1, PAD], [2, PAD, PAD], [3, 0, 1]])
    active = torch.tensor([True, True, False])
    ops, nbytes = roofline.hop_work(graph, rev, beam, active, n_bits=64)
    # Row 0 (beam 0, 1): candidates 1 2 3 | 0 2 PAD → new: {2, 3}.
    # Row 1 (beam 2): candidates 3 PAD 0 1 → new: {3, 0, 1}.
    assert ops == (2 + 3) * 2 * 64
    beam_rows = 3                      # ids 0, 1, 2
    cand_rows = 4                      # ids 0, 1, 2, 3
    row_b = 64 // 8 + 4
    assert nbytes == (beam_rows * 4 * 4 + cand_rows * row_b
                      + 2 * (row_b + 2 * 3 * 8))


def test_least_time_names_its_bound_and_share_stays_under_100():
    t, bound = roofline.least_time(roofline.PEAK_INT8_OPS, 1.0)
    assert bound == "operations" and t == pytest.approx(1.0)
    t, bound = roofline.least_time(1.0, roofline.PEAK_HBM_BYTES * 2)
    assert bound == "bytes" and t == pytest.approx(2.0)
    assert roofline.share(roofline.PEAK_INT8_OPS, 0, 1.0) == pytest.approx(100)
