"""In-house AdamW with global-norm clipping and decoupled weight decay.

The optimizer state's dtype follows the params' (bf16 params get bf16
``m`` and ``v``); the update itself is computed in float32.  Params and
state are updated in place (the reference's training step donates them),
leaf by leaf, so that a step holds one leaf's temporaries at a time.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.descriptor import flatten_with_names, unflatten_from_paths


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_map(fn, tree):
    """``fn`` on every leaf, in the reference's leaf order (dict keys
    sorted), the structure kept."""
    _, paths, leaves = flatten_with_names(tree)
    return unflatten_from_paths(paths, [fn(x) for x in leaves])


def init_opt_state(params):
    """Zero ``m`` and ``v`` shaped like the params, and ``count`` an int32
    scalar on the first leaf's device."""
    device = flatten_with_names(params)[2][0].device
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32, summed leaf by
    leaf in the reference's leaf order."""
    leaves = flatten_with_names(tree)[2]
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


@torch.no_grad()
def adamw_update(params, grads, state, lr, cfg: AdamWConfig):
    """One AdamW step, in place: returns (params, state, gnorm) with the
    same param, ``m`` and ``v`` tensors updated and ``count`` advanced."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()
    trees = (params, grads, state["m"], state["v"])
    for p, g, m, v in zip(*(flatten_with_names(t)[2] for t in trees)):
        g = g.float() * scale
        m32, v32 = m.float(), v.float()
        m_n = cfg.b1 * m32 + (1 - cfg.b1) * g
        v_n = cfg.b2 * v32 + (1 - cfg.b2) * torch.square(g)
        step = (m_n / c1) / (torch.sqrt(v_n / c2) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (step + cfg.weight_decay * p32))
        m.copy_(m_n)
        v.copy_(v_n)
    return params, {"m": state["m"], "v": state["v"], "count": count}, gnorm
