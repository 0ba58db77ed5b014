"""Top-k token-choice MoE with sort-based dispatch (capacity-dropping).

The reference's GSPMD formulation (``_moe_mlp_gspmd``): dense batched
products over an (E, C, D) dispatch buffer.  Its explicit expert-parallel
variant (``moe_mlp_shardmap``) needs a device mesh and waits for the
distribution slice (ROADMAP queue A); ``moe_mlp`` here is always the
GSPMD path.

One difference in form, none in value: the reference combines with a
scatter-add (``out.at[st].add``).  Here each token sums its K weighted
expert outputs in a fixed order (by expert id, the order the sorted
dispatch visits them, starting from zero), so the result does not depend
on the order in which atomics land on a GPU: two runs on bit-equal
weights give bit-equal outputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ninit


def init_moe(gen, cfg, device=None, stack=None):
    E, D, Fd = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    kw = dict(device=device, stack=stack)
    p = {
        "router": ninit(gen, (D, E), scale=0.02, **kw),
        "wi": ninit(gen, (E, D, Fd), fan_in_axis=1, **kw),
        "wd": ninit(gen, (E, Fd, D), fan_in_axis=1, **kw),
    }
    if cfg.mlp_gated:
        p["wg"] = ninit(gen, (E, D, Fd), fan_in_axis=1, **kw)
    return p


def moe_mlp(params, x, cfg, return_aux=False):
    """x: (B, S, D) -> (B, S, D). Token-choice top-k with capacity drop:
    each expert takes at most ``cap = max(int(factor * T * K / E), 1)`` of
    the call's T tokens, in token order; the rest of its tokens get no
    output from it.  ``return_aux`` adds the Switch load-balance loss."""
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_topk
    T = B * S
    dt = x.dtype
    dev = x.device
    xf = x.reshape(T, D)

    logits = (xf @ params["router"].to(dt)).float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.topk(probs, K, dim=-1)                       # (T, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    cap = max(int(cfg.moe_capacity_factor * T * K / E), 1)
    flat_e = expert.reshape(-1)                                       # (T*K,)
    flat_g = gate.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)

    # stable sort by expert id; rank within expert = index - segment start
    order = torch.sort(flat_e, stable=True).indices
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - starts[se]
    keep = rank < cap
    dest = torch.where(keep, se * cap + rank,
                       torch.full_like(rank, E * cap))                # drop slot

    # dispatch: (E*C+1, D) buffer, last row = trash for dropped tokens
    buf = xf.new_zeros((E * cap + 1, D))
    buf[dest] = xf[st]
    h = buf[:E * cap].reshape(E, cap, D)

    a = torch.bmm(h, params["wi"].to(dt))
    if cfg.mlp_gated:
        a = F.silu(torch.bmm(h, params["wg"].to(dt))) * a
    else:
        a = F.gelu(a, approximate="tanh")   # jax.nn.gelu's default
    y = torch.bmm(a, params["wd"].to(dt)).reshape(E * cap, D)

    # combine: gather expert outputs back to token order, weighted by gates
    contrib = torch.where(keep[:, None],
                          y[torch.clamp(dest, max=E * cap - 1)],
                          torch.zeros((), dtype=dt, device=dev))
    contrib = contrib * sg[:, None].to(dt)
    # each token's K sorted positions, ascending = by expert id
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=dev)
    slots = torch.sort(inv.reshape(T, K), dim=1).values
    out = xf.new_zeros((T, D))
    for k in range(K):
        out = out + contrib[slots[:, k]]
    out = out.reshape(B, S, D)

    if return_aux:
        # Switch-style load-balance loss
        me = probs.mean(0)                                            # (E,)
        ce = torch.bincount(flat_e, minlength=E) / (T * K)
        aux = E * torch.sum(me * ce)
        return out, aux
    return out
