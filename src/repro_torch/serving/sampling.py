"""Token sampling."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def sample(logits, generator: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: int = 0):
    """logits: (B, V). temperature 0 = greedy (argmax, first max wins)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k:
        vals, _ = torch.topk(logits, top_k, dim=-1)
        cutoff = vals[..., -1:]
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, NEG_INF), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
