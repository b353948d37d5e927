"""Deterministic synthetic LM token pipeline with restart skip (torch
port of ``repro.data.tokens``).

Batches are a pure function of (seed, step), bitwise the reference's:
after a crash/restart the loader resumes at exactly the next step with
zero replayed or skipped data (the checkpoint holds the step counter).
Documents are drawn on the host with numpy, as the reference draws them;
``batch`` hands the step's tensors to the pipeline's device.

C²-locality ordering (``ordering="c2"``): documents are clustered by
FastRandomHash over their token sets (the first 64 distinct tokens) and
batches draw from one cluster at a time. The hashes come from the
FastRandomHash kernel's CSR entry (``kernels.frh_minhash.ops
.minhash_csr``: one launch on a CUDA device, the plain version on the
CPU) with one seed, ``dc.seed``, and b = 4,096 buckets; the kernel's
``& (b − 1)`` equals the reference's host ``% b`` for a power of two, so
the order is the reference's. The labels are the tokens themselves,
unshifted, as the reference makes them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.frh_minhash import ops as minhash_ops
from repro_torch.models.config import ModelConfig

C2_BUCKETS = 4096     # FastRandomHash buckets of the c2 order
PROFILE_ITEMS = 64    # distinct tokens a document's profile keeps


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    ordering: str = "iid"  # "iid" | "c2"
    n_docs: int = 4096     # synthetic corpus size for c2 ordering


class TokenPipeline:
    def __init__(self, cfg: ModelConfig, dc: DataConfig, device="cuda"):
        if dc.ordering not in ("iid", "c2"):
            raise ValueError(f"unknown ordering {dc.ordering!r}")
        self.cfg = cfg
        self.dc = dc
        self.device = resolve_device(device)
        self._order = None
        if dc.ordering == "c2":
            self._order = self._c2_order()

    def _doc_tokens(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.dc.seed, doc_id))
        # Zipf-ish token stream with doc-specific topic offset.
        topic = rng.integers(0, max(self.cfg.vocab_size // 64, 1))
        z = rng.zipf(1.3, size=self.dc.seq_len).astype(np.int64)
        toks = (z + topic * 64) % self.cfg.vocab_size
        return toks.astype(np.int32)

    def c2_profiles(self) -> tuple[np.ndarray, np.ndarray]:
        """The documents' token-set profiles as CSR (offsets int64[n + 1],
        items int32[nnz])."""
        n = self.dc.n_docs
        profiles = [np.unique(self._doc_tokens(d))[:PROFILE_ITEMS]
                    for d in range(n)]
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(p) for p in profiles], out=offsets[1:])
        return offsets, np.concatenate(profiles).astype(np.int32)

    def _c2_order(self) -> np.ndarray:
        """Documents sorted (stably) by their FastRandomHash value."""
        offsets, items = self.c2_profiles()
        H = minhash_ops.minhash_csr(
            torch.from_numpy(offsets).to(self.device),
            torch.from_numpy(items).to(self.device), [self.dc.seed],
            C2_BUCKETS)[:, 0]
        return np.argsort(H.cpu().numpy(), kind="stable").astype(np.int64)

    def batch(self, step: int) -> dict:
        """The step's batch on the pipeline's device: ``labels`` int32
        [B, S] and ``tokens`` (the same tokens) or, for a stub frontend,
        f32 ``embeddings`` [B, S, D]."""
        B, S = self.dc.global_batch, self.dc.seq_len
        docs = np.arange(step * B, (step + 1) * B, dtype=np.int64)
        if self._order is not None:
            docs = self._order[docs % self.dc.n_docs]
        else:
            docs = docs % self.dc.n_docs
        toks = np.stack([self._doc_tokens(int(d)) for d in docs])
        out = {"labels": toks}
        if self.cfg.frontend:
            rng = np.random.default_rng((self.dc.seed, 777, step))
            out["embeddings"] = rng.standard_normal(
                (B, S, self.cfg.d_model)).astype(np.float32)
        else:
            out["tokens"] = toks
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in out.items()}
