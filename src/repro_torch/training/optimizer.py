"""In-house AdamW with global-norm clipping and decoupled weight decay.

The optimizer state's dtype follows the params' (bf16 params get bf16
``m`` and ``v``); the update itself is computed in float32.  Params and
state are updated in place (the reference's training step donates them),
leaf by leaf, so that a step holds one leaf's temporaries at a time.

Params, gradients and state may also be DTensors (the sharded step of
``distributed/train_step.py``): each rank then updates its own shards,
and the global norm sums, on each rank, the squares of the elements that
rank owns (see ``_owned``), with one all-reduce over the mesh for the
total.  A leaf replicated over some mesh dims is counted once, by the
ranks at coordinate 0 on those dims, not once per replica.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

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


def _local(x) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself, not a copy), or ``x``."""
    return x.to_local() if isinstance(x, DTensor) else x


def _owned(x) -> bool:
    """Whether this rank counts DTensor ``x``'s local elements in a sum over
    the mesh: it does unless it is a replica, i.e. unless some mesh dim
    that ``x`` is replicated over puts this rank past coordinate 0."""
    coord = x.device_mesh.get_coordinate()
    return not any(c and not p.is_shard()
                   for c, p in zip(coord, x.placements))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32, summed leaf by
    leaf in the reference's leaf order.  For DTensor leaves, each rank sums
    the leaves it owns and one all-reduce over the mesh gives the total
    (the same on every rank; the sum's order differs from one device's,
    so the norm agrees with it to rounding)."""
    leaves = flatten_with_names(tree)[2]
    if not isinstance(leaves[0], DTensor):
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves))
    from repro_torch.distributed import comm
    sq = torch.zeros((), dtype=torch.float32, device=_local(leaves[0]).device)
    for x in leaves:
        if _owned(x):
            sq += torch.sum(torch.square(_local(x).float()))
    return torch.sqrt(comm.all_reduce_sum(sq, leaves[0].device_mesh))


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
    for leaves in zip(*(flatten_with_names(t)[2] for t in trees)):
        p, g, m, v = map(_local, leaves)
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
