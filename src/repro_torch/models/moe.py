"""Top-k token-choice MoE with sort-based dispatch (capacity-dropping).

The router is the reference's softmax top-k, or, for a block that brings
a ``MoESpec`` (DeepSeek-V3's, Moonlight's), a sigmoid score with a
selection bias (``_route``) and a shared gated MLP that every token
passes through beside its routed experts (counted in
``moe.shared_rows``).  The sigmoid router has no load-balance loss and no
sharded layout: it raises under an env that splits the experts or the
rows.

``moe_mlp`` dispatches as the reference's does: the GSPMD formulation
(``_moe_mlp_gspmd``, dense batched products over an (E, C, D) dispatch
buffer) unless the installed env asks for ``moe_impl="shardmap"``.

Distributed (an env installed in ``distributed.ctx``):

- ``_moe_mlp_gspmd`` keeps the semantics of one device over the whole
  microbatch, as GSPMD does: when the rows are this rank's data shard,
  the ranks all-gather their per-expert counts, so the capacity is taken
  over the microbatch's T and each token's rank within its expert counts
  the tokens of lower data shards first;
- ``moe_mlp_shardmap`` is the reference's explicit expert parallelism:
  each data shard routes its own tokens with a local sort and a capacity
  from its local T;
- in both, with the experts split over ``model`` (expert parallelism),
  a rank computes its ``E / msize`` experts and the partial outputs are
  summed over ``model``.

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

from repro_torch import tracing
from repro_torch.distributed import comm, ctx
from repro_torch.distributed.sharding import moe_split
from repro_torch.models.layers import _enter, _leave, init_mlp, mlp, ninit


def init_moe(gen, cfg, device=None, stack=None, moe=None):
    """``moe``: a ``MoESpec`` adds the sigmoid router's selection bias and
    the shared experts' MLP."""
    E, D, Fd = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    kw = dict(device=device, stack=stack)
    p = {
        "router": ninit(gen, (D, E), scale=0.02, **kw),
        "wi": ninit(gen, (E, D, Fd), fan_in_axis=1, **kw),
        "wd": ninit(gen, (E, Fd, D), fan_in_axis=1, **kw),
    }
    if cfg.mlp_gated:
        p["wg"] = ninit(gen, (E, D, Fd), fan_in_axis=1, **kw)
    if moe is not None:
        p["router_bias"] = ninit(gen, (E,), scale=0.02, **kw)
        p["shared"] = init_mlp(gen, D, moe.shared_d_ff, True, **kw)
    return p


def moe_mlp(params, x, cfg, return_aux=False, moe=None):
    """Dispatch to the configured implementation (the ctx env).  ``moe``:
    the block's ``MoESpec`` (sigmoid routing and shared experts), None
    for the softmax router."""
    env = ctx.get_env()
    if (env is not None and env.moe_impl == "shardmap" and not return_aux
            and moe is None and cfg.moe_experts % env.msize == 0):
        return moe_mlp_shardmap(params, x, cfg, env)
    return _moe_mlp_gspmd(params, x, cfg, return_aux, moe)


def _moe_mlp_gspmd(params, x, cfg, return_aux=False, moe=None):
    """x: (B, S, D) -> (B, S, D). Token-choice top-k with capacity drop:
    each expert takes at most ``capacity(cfg, T)`` of the T tokens (of the
    whole microbatch when these rows are a data shard), in token order;
    the rest of its tokens get no output from it.  ``return_aux`` adds the
    Switch load-balance loss."""
    t = ctx.tp()
    return _moe(params, x, cfg,
                t if t is not None and moe_split(cfg, t.env) else None,
                ctx.batch_groups(), return_aux, moe)


def moe_mlp_shardmap(params, x, cfg, env):
    """Explicit expert-parallel dispatch: this rank's rows ``x`` are routed
    with a local sort and a capacity from their own T; the rank computes
    its ``E / msize`` experts and the parts are summed over ``model``."""
    return _moe(params, x, cfg, ctx.tp_of(env), [], False)


def capacity(cfg, T: int) -> int:
    """The tokens each expert takes of a call's ``T``: ``max(int(factor *
    T * K / E), 1)``."""
    return max(int(cfg.moe_capacity_factor * T * cfg.moe_topk
                   / cfg.moe_experts), 1)


def count_dropped(params, x, cfg) -> int:
    """Tokens the experts refuse in one single-device ``moe_mlp`` call on
    ``x``: the top-k choices past each expert's capacity."""
    xf = x.reshape(-1, x.shape[-1])
    _, expert, _ = _route((xf @ params["router"].to(x.dtype)).float(),
                          params, cfg.moe_topk, None)
    counts = expert_counts(expert.reshape(-1), cfg.moe_experts)
    return int(torch.clamp(counts - capacity(cfg, xf.shape[0]), min=0).sum())


def expert_counts(ids, E: int) -> torch.Tensor:
    """How many of ``ids`` name each of the ``E`` experts: ``bincount``'s
    counts, by a scatter-add of fixed shape, which meta tensors (the dry
    run) take as well."""
    return torch.zeros(E, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _route(logits, params, K, moe):
    """(gate, expert), each (T, K), and the (T, E) scores, from the
    router's fp32 ``logits``.  Softmax (``moe`` None): the top K
    probabilities, renormalised.  Sigmoid (``moe``): the top K of the
    scores plus the selection bias ``router_bias``, their scores (not
    biased) renormalised and scaled by ``moe.routed_scale``."""
    if moe is None:
        probs = torch.softmax(logits, dim=-1)
        gate, expert = torch.topk(probs, K, dim=-1)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return gate, expert, probs
    scores = torch.sigmoid(logits)
    expert = torch.topk(scores + params["router_bias"].float(), K,
                        dim=-1).indices
    gate = scores.gather(-1, expert)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-20) * moe.routed_scale
    return gate, expert, scores


def _moe(params, x, cfg, tp, groups, return_aux, moe=None):
    """The dispatch, expert products and combine; ``tp`` the TP when the
    experts are split over ``model``, ``groups`` the batch axes whose data
    shards share the capacity (``ctx.batch_groups``); ``moe`` the block's
    ``MoESpec`` (sigmoid routing, shared experts) or None."""
    if return_aux and (tp is not None or groups):
        raise NotImplementedError("the load-balance loss of a distributed "
                                  "MoE call")
    if moe is not None and (return_aux or tp is not None or groups):
        raise NotImplementedError("sigmoid routing with shared experts has "
                                  "no load-balance loss and no sharded "
                                  "layout")
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_topk
    T = B * S
    dt = x.dtype
    dev = x.device
    xf = _enter(x, tp).reshape(T, D)

    logits = (xf @ params["router"].to(dt)).float()                  # (T, E)
    gate, expert, probs = _route(logits, params, K, moe)              # (T, K)

    flat_e = expert.reshape(-1)                                       # (T*K,)
    flat_g = gate.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)

    # stable sort by expert id; rank within expert = index - segment start
    order = torch.sort(flat_e, stable=True).indices
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    counts = expert_counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - starts[se]
    T_all = T
    if groups:      # the data shards of lower index come first
        every = comm.gather_counts(counts, groups)                   # (n, E)
        rank = rank + every[:ctx.batch_index()].sum(0)[se]
        T_all = T * every.shape[0]
    cap = capacity(cfg, T_all)
    keep = rank < cap
    if tp is None:
        El, e0 = E, 0
    else:           # this rank's experts
        El = E // tp.size
        e0 = tp.rank * El
        keep = keep & (se >= e0) & (se < e0 + El)
    tracing.count("moe.routed_rows", T * K)      # host ints: no sync
    tracing.count("moe.expert_rows", El * cap)
    dest = torch.where(keep, (se - e0) * cap + rank,
                       torch.full_like(rank, El * cap))            # drop slot

    # dispatch: (E*C+1, D) buffer, last row = trash for dropped tokens
    buf = xf.new_zeros((El * cap + 1, D))
    buf[dest] = xf[st]
    h = buf[:El * cap].reshape(El, cap, D)

    a = torch.bmm(h, params["wi"].to(dt))
    if cfg.mlp_gated:
        a = F.silu(torch.bmm(h, params["wg"].to(dt))) * a
    else:
        a = F.gelu(a, approximate="tanh")   # jax.nn.gelu's default
    y = torch.bmm(a, params["wd"].to(dt)).reshape(El * cap, D)

    # combine: gather expert outputs back to token order, weighted by gates
    contrib = torch.where(keep[:, None],
                          y[torch.clamp(dest, max=El * cap - 1)],
                          torch.zeros((), dtype=dt, device=dev))
    contrib = contrib * sg[:, None].to(dt)
    # each token's K sorted positions, ascending = by expert id
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=dev)
    slots = torch.sort(inv.reshape(T, K), dim=1).values
    out = xf.new_zeros((T, D))
    for k in range(K):
        out = out + contrib[slots[:, k]]
    if moe is not None:
        tracing.count("moe.shared_rows", T)
        out = out + mlp(params["shared"], xf, True)
    out = _leave(out.reshape(B, S, D), tp)

    if return_aux:
        # Switch-style load-balance loss
        me = probs.mean(0)                                            # (E,)
        ce = expert_counts(flat_e, E) / (T * K)
        aux = E * torch.sum(me * ce)
        return out, aux
    return out
