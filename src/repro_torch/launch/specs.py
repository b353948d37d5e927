"""Abstract inputs of every (architecture × shape) dry-run cell as meta
tensors: shapes and dtypes, nothing allocated (counterpart of
``repro.launch.specs``, whose ``ShapeDtypeStruct`` leaves these equal
leaf for leaf).

``input_specs`` gives the reference's layout: parameters and the AdamW
state as group-stacked trees (``models.model.params_to_tree``), the
decode cache as ``models.model.init_cache`` makes it. The dry-run runs
the port's steps on ``abstract_model`` and ``init_opt_state`` of it,
the same tensors in the port's per-group layout.
"""
from __future__ import annotations

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (LM, init_cache, init_params,
                                      opt_state_to_tree, params_to_tree)
from repro_torch.train.optimizer import OptConfig, init_opt_state

META = torch.device("meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The data batch for one step (train/prefill/decode)."""
    B, S = shape.global_batch, shape.seq_len

    def t(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=META)

    if shape.kind == "train":
        labels = t((B, S), torch.int32)
        if cfg.frontend:  # stub frontend: precomputed frame/patch embeddings
            return {"embeddings": t((B, S, cfg.d_model), L.compute_dtype(cfg)),
                    "labels": labels}
        return {"tokens": t((B, S), torch.int32), "labels": labels}
    if shape.kind == "prefill":
        if cfg.frontend:
            return {"embeddings": t((B, S, cfg.d_model), L.compute_dtype(cfg))}
        return {"tokens": t((B, S), torch.int32)}
    # decode: one new token against a seq_len cache.
    return {"tokens": t((B, 1), torch.int32), "cur_index": t((), torch.int32)}


def abstract_model(cfg: ModelConfig, trainable: bool = False) -> LM:
    """The model with its parameters on the meta device."""
    return init_params(cfg, torch.Generator(), device=META,
                       trainable=trainable)


def abstract_state(cfg: ModelConfig, oc: OptConfig):
    """Abstract (params, opt_state) for train cells, as trees in the
    reference's layout."""
    model = abstract_model(cfg, trainable=True)
    opt = init_opt_state(dict(model.named_parameters()), oc)
    return (params_to_tree(model.state_dict(), cfg),
            opt_state_to_tree(opt, cfg))


def abstract_decode_cache(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    return init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                oc: OptConfig | None = None) -> dict:
    """Everything the cell's step function consumes, abstract."""
    oc = oc or OptConfig()
    out = {"batch": batch_specs(cfg, shape)}
    if shape.kind == "train":
        out["params"], out["opt_state"] = abstract_state(cfg, oc)
    else:
        out["params"] = params_to_tree(abstract_model(cfg).state_dict(), cfg)
        if shape.kind == "decode":
            out["cache"] = abstract_decode_cache(cfg, shape)
    return out
