"""Serving steps: prefill (context → cache + first logits) and decode
(one token against the cache), and host-driven greedy decoding (torch
port of ``repro.serve.steps``). On a mesh the steps return this rank's
part of the logits (``LM.forward``) and the cache's shards."""
from __future__ import annotations

import torch

from repro_torch.models.model import LM


@torch.inference_mode()
def prefill_step(model: LM, tokens_or_embeds: torch.Tensor, *,
                 s_alloc: int = 0, is_embeds: bool = False):
    """Process the full prompt; returns (logits [B, S, V], cache)."""
    kw = ({"input_embeds": tokens_or_embeds} if is_embeds
          else {"tokens": tokens_or_embeds})
    S = tokens_or_embeds.shape[1]
    logits, cache, _ = model(want_cache=True, s_alloc=s_alloc or S, **kw)
    return logits, cache


@torch.inference_mode()
def decode_step(model: LM, cache: dict, tokens: torch.Tensor, cur_index):
    """One decode step: tokens [B, 1] against ``cache`` at ``cur_index``
    (a scalar, or int[B] per row). Returns (logits [B, 1, V], cache); the
    cache is updated in place."""
    logits, cache, _ = model(tokens=tokens, cache=cache,
                             cur_index=cur_index)
    return logits, cache


@torch.inference_mode()
def greedy_generate(model: LM, prompt: torch.Tensor, max_new: int,
                    s_alloc: int = 0) -> torch.Tensor:
    """Greedy decoding of ``max_new`` tokens after ``prompt`` [B, S]."""
    B, S = prompt.shape
    alloc = s_alloc or (S + max_new)
    logits, cache = prefill_step(model, prompt, s_alloc=alloc)
    # argmax returns the first maximum, as jnp.argmax does.
    tok = torch.argmax(model.gather_logits(logits[:, -1:], B),
                       dim=-1).to(torch.int32)
    out = [tok]
    for i in range(max_new - 1):
        logits, cache = decode_step(model, cache, tok, S + i)
        tok = torch.argmax(model.gather_logits(logits[:, -1:], B),
                           dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)
