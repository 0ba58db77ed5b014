"""LR schedules: linear warmup + cosine decay."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1):
    """The learning rate at ``step`` (a number or a tensor), as a float32
    tensor on the step's device.  Both branches are evaluated and one is
    selected, as the reference's ``jnp.where`` does: a Python step is
    carried in double until it meets a tensor, a tensor step in float32."""
    step = step.float() if torch.is_tensor(step) else float(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp(torch.as_tensor((step - warmup) / max(total - warmup, 1),
                                       dtype=torch.float32), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    warm = torch.as_tensor(warm, dtype=torch.float32, device=cos.device)
    return torch.where(torch.as_tensor(step < warmup, device=cos.device),
                       warm, cos)
