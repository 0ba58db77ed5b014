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

Where no token can drop, one device computes only the routed rows:
``_moe`` takes the routed path (``_routed``) when the capacity is at least
the call's T, the call is on one device with its experts whole, asks no
load-balance loss, tracks no gradient, runs in float32 and is on the card,
where the hand-written kernel (``kernels/moe_experts``) launches.  The
sorted rows then go through their own experts alone: the same outputs as
the dense dispatch, which there only adds padded rows.  Everything else
keeps the dense dispatch and the reference's drop rule: the CPU, unless
inside ``routed_on("cpu")`` (the tests, and ``chip_smoke.py``'s CPU side,
run the kernel's plain version there), and the dry run's meta tensors.
Counters: ``moe.expert_rows`` the rows the experts compute (T K routed,
E C dense), ``moe.routed_calls`` the calls that took the routed path.

One difference in form, none in value: the reference combines with a
scatter-add (``out.at[st].add``).  Here each token sums its K weighted
expert outputs in a fixed order (by expert id, the order the sorted
dispatch visits them, starting from zero), so the result does not depend
on the order in which atomics land on a GPU: two runs on bit-equal
weights give bit-equal outputs.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.core.descriptor import flatten_with_names
from repro_torch.distributed import comm, ctx
from repro_torch.distributed.sharding import moe_split
from repro_torch.kernels.moe_experts import moe_experts
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


# device types whose calls take the routed path: those where the grouped
# expert kernel launches, and those ``routed_on`` adds for its block
_ROUTED_DEVICES = ("cuda",)


@contextlib.contextmanager
def routed_on(device_type: str):
    """Calls on ``device_type`` take the routed path too inside the block,
    through the kernel's plain version off the card: the CPU's checks of
    the path the card serves."""
    global _ROUTED_DEVICES
    before = _ROUTED_DEVICES
    _ROUTED_DEVICES = before + (device_type,)
    try:
        yield
    finally:
        _ROUTED_DEVICES = before


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
    tracing.count("moe.routed_rows", T * K)      # host ints: no sync
    if _routed(params, x, cfg, tp, groups, return_aux):
        tracing.count("moe.routed_calls", 1)
        tracing.count("moe.expert_rows", T * K)
        y = moe_experts(xf[st], counts, starts, params["wi"].to(dt),
                        params["wg"].to(dt) if cfg.mlp_gated else None,
                        params["wd"].to(dt))
        contrib = y * sg[:, None].to(dt)           # y in sorted order
    else:
        contrib = _dense(params, xf, cfg, tp, groups, se, st, sg, starts,
                         counts)
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


def _routed(params, x, cfg, tp, groups, return_aux) -> bool:
    """Whether a call computes only its routed rows: no token can drop (the
    capacity, a host int, is at least the call's T, so each expert keeps
    all its rows), one device with the experts whole, no load-balance loss,
    no gradient tracked (the kernel has no backward), float32 (the
    kernel's), and on a device where it launches or ``routed_on`` names
    (so not the dry run's meta tensors, whose counts stay the dense
    dispatch's)."""
    T = x.shape[0] * x.shape[1]
    return (tp is None and not groups and not return_aux
            and capacity(cfg, T) >= T and x.dtype == torch.float32
            and x.device.type in _ROUTED_DEVICES
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or any(
                         t.requires_grad
                         for t in flatten_with_names(params)[2]))))


def _dense(params, xf, cfg, tp, groups, se, st, sg, starts, counts):
    """The dense dispatch: an (El, cap, D) buffer, capacity-dropping, through
    this rank's El experts; the gate-weighted output of each sorted row
    (zero where dropped)."""
    E, K = cfg.moe_experts, cfg.moe_topk
    T, D = xf.shape
    dt, dev = xf.dtype, xf.device
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
    return contrib * sg[:, None].to(dt)
