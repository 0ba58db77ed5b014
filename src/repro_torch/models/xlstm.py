"""xLSTM blocks: mLSTM (matrix-memory, chunked-parallel) and sLSTM
(scalar-memory, true recurrence).

Faithful to the xLSTM block structure (up-proj -> conv -> q/k/v -> cell ->
group-norm -> gated down-proj). As in the reference, one documented
simplification: bounded sigmoid input/forget gates rather than the
exponential-gate + max-stabilizer form — identical state-update structure,
FLOPs and memory, but unconditionally stable in bf16.  The reference's
``lax.scan`` over chunks (mLSTM) and over steps (sLSTM) is ``scan.scan``
here, a Python loop.

mLSTM tensor parallelism (an env whose ``model`` axis divides d_inner;
``sharding.mlstm_split``): each rank owns the value columns
``[r * d_inner / msize, (r + 1) * d_inner / msize)`` (whole heads when
``model`` divides the heads, else a part of one head), as ``param_pspec``
lays out ``wv``'s columns, ``w_down``'s rows and ``w_up``'s columns.  The
rank computes ``up = x @ w_up`` on its columns and gathers it over
``model``, since xm feeds the q, k and v projections whole; q and k
likewise, so that the scores, decays and ``n`` of its heads are whole,
and its state ``C`` is (B, heads, dh, its value columns).  Its output's
norm over d_inner sums its squares over ``model`` and ``w_down``'s
product is a partial sum.  ``up``, q, k, the gates and the conv are used
whole by every rank for its own columns, so their gradients are parts:
the gathers' backward sums over ``model`` before it slices
(``comm.gather_shared``) and the step sums the replicated leaves' parts
(``sharding.model_partial``).  Caches at rest are whole (``cache_pspec``):
prefill gathers the final state, and decode updates its own columns of
the whole cache and gathers them back.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import comm, ctx
from repro_torch.distributed.sharding import mlstm_split
from repro_torch.models.layers import (_enter, _leave, cinit, init_rms_norm,
                                      ninit, pair, rms_norm, split_rms_norm,
                                      zinit)
from repro_torch.models.scan import scan
from repro_torch.models.ssm import check_chunks


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mdims(cfg, spec):
    d_inner = spec.expand * cfg.d_model
    H = spec.num_heads
    return d_inner, H, d_inner // H


def init_mlstm(gen, cfg, spec, device=None, stack=None):
    d = cfg.d_model
    d_inner, H, _ = _mdims(cfg, spec)
    kw = dict(device=device, stack=stack)
    return {
        "w_up": ninit(gen, (d, 2 * d_inner), **kw),
        "conv_w": ninit(gen, (4, d_inner), scale=0.1, **kw),
        "conv_b": zinit((d_inner,), **kw),
        "wq": ninit(gen, (d_inner, d_inner), **kw),
        "wk": ninit(gen, (d_inner, d_inner), **kw),
        "wv": ninit(gen, (d_inner, d_inner), **kw),
        "w_gates": ninit(gen, (d_inner, 2 * H), scale=0.02, **kw),
        "b_gates": cinit(torch.cat([torch.zeros(H), 3.0 * torch.ones(H)]),
                         **kw),
        "norm": init_rms_norm(d_inner, **kw),
        "w_down": ninit(gen, (d_inner, d), **kw),
    }


def _key_scale(dh, dt):
    """1/sqrt(dh) as the reference divides by it: sqrt in fp32, then cast."""
    return torch.tensor(math.sqrt(dh), dtype=torch.float32).to(dt)


class _Own(NamedTuple):
    """A rank's share of an mLSTM block's value columns
    ``[c0, c0 + dl)`` of d_inner: ``Hl`` heads from ``h0``, ``wl`` value
    columns of each from ``w0`` (whole heads, or a part of one)."""
    c0: int
    dl: int
    h0: int
    Hl: int
    w0: int
    wl: int


def _split(cfg, spec):
    """(TP, _Own) of the installed env's split of the block over
    ``model`` (``sharding.mlstm_split``), or (None, the whole block)."""
    d_inner, H, dh = _mdims(cfg, spec)
    t = ctx.tp()
    if t is None or not mlstm_split(cfg, spec, t.env):
        return None, _Own(0, d_inner, 0, H, 0, dh)
    dl = d_inner // t.size
    c0 = t.rank * dl
    if dl >= dh:
        return t, _Own(c0, dl, c0 // dh, dl // dh, 0, dh)
    return t, _Own(c0, dl, c0 // dh, 1, c0 % dh, dl)


def _mlstm_qkv(params, x, cfg, spec, tp, own):
    """The block's inputs to its cell: q and k of the rank's heads, its
    value columns v, z and whole xm, the log forget and input gates of its
    heads.  Split over ``model``, ``up`` and q, k are gathered whole (used
    by each rank for its own share, their gradients are parts)."""
    dt = x.dtype
    d_inner, H, dh = _mdims(cfg, spec)
    B, S = x.shape[:2]
    heads = slice(own.h0, own.h0 + own.Hl)
    whole = ((lambda t: t) if tp is None else
             (lambda t: comm.gather_shared(t, tp, -1)))
    up = whole(_enter(x, tp) @ params["w_up"].to(dt))
    xm, z = up[..., :d_inner], up[..., d_inner:]
    # causal depthwise conv(4)
    w = params["conv_w"].to(dt)
    pad = F.pad(xm, (0, 0, w.shape[0] - 1, 0))
    xc = sum(pad[:, i:i + xm.shape[1]] * w[i] for i in range(w.shape[0]))
    xc = F.silu(xc + params["conv_b"].to(dt))
    q = whole(xc @ params["wq"].to(dt)).reshape(B, S, H, dh)[:, :, heads]
    k = (whole(xc @ params["wk"].to(dt)).reshape(B, S, H, dh)
         / _key_scale(dh, dt))[:, :, heads]
    v = (xm @ params["wv"].to(dt)).reshape(B, S, own.Hl, own.wl)
    gates = xc @ params["w_gates"].to(dt) + params["b_gates"].to(dt)
    lf = F.logsigmoid(gates[..., H:].float())[..., heads]            # (B,S,Hl)
    ig = torch.sigmoid(gates[..., :H].float())[..., heads]
    return q, k, v, z[..., own.c0:own.c0 + own.dl], xm, lf, ig


def _mlstm_out(params, h, z, cfg, spec, tp, own):
    """The down projection of the normed, gated cell output ``h`` (this
    rank's value columns): the norm over d_inner sums its squares over
    ``model``, and the product is a partial sum there."""
    dt = h.dtype
    scale = params["norm"]["scale"][own.c0:own.c0 + own.dl]
    h = split_rms_norm(h, scale, cfg.norm_eps, _mdims(cfg, spec)[0], tp)
    return _leave((h * F.silu(z)) @ params["w_down"].to(dt), tp)


def _whole_state(C, n, tp, H):
    """The cell's state over all heads and value columns, gathered over
    ``model`` (caches at rest are whole, ``cache_pspec``)."""
    if tp is None:
        return C, n
    B, _, dh, _ = C.shape
    cols = C.permute(0, 2, 1, 3).reshape(B, dh, -1)     # value cols last
    C = comm.gather_model(cols, tp, -1).reshape(B, dh, H, dh) \
        .permute(0, 2, 1, 3).contiguous()
    # ranks that share a head hold the same n
    return C, comm.gather_model(n, tp, 1)[:, ::max(tp.size // H, 1)]


def mlstm_forward(params, x, cfg, spec, chunk=256, return_state=False):
    B, S, D = x.shape
    d_inner, H, dh = _mdims(cfg, spec)
    dt = x.dtype
    tp, own = _split(cfg, spec)
    q, k, v, z, xm, lf, ig = _mlstm_qkv(params, x, cfg, spec, tp, own)

    chunk = check_chunks(S, chunk)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    C = torch.zeros((B, own.Hl, dh, own.wl), dtype=torch.float32,
                    device=x.device)
    n = torch.zeros((B, own.Hl, dh), dtype=torch.float32, device=x.device)

    def step(i, carry):
        C, n = carry
        sl = slice(i * chunk, (i + 1) * chunk)
        qf, kf, vf = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        lf_i, ig_i = lf[:, sl], ig[:, sl]
        cum = torch.cumsum(lf_i, dim=1)                 # (B,c,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        # clamp masked entries before exp
        decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                            0.0)
        att = pair("bshd,bjhd->bsjh", qf, kf) * decay \
            * ig_i[:, None, :, :]
        num = pair("bsjh,bjhd->bshd", att, vf)
        den = att.sum(dim=2)                            # (B,c,H)
        # carried state contribution
        dec_s = torch.exp(cum)                          # (B,c,H)
        # the reference's "bshd,bhdw,bsh->bshw" and "bshd,bhd,bsh->bsh",
        # in jnp.einsum's pairs
        num = num + pair("bsh,bhws->bshw", dec_s,
                         pair("bhdw,bshd->bhws", C, qf))
        den = den + pair("bsh,bhs->bsh", dec_s, pair("bshd,bhd->bhs", qf, n))
        h = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
        # state update
        dec_end = torch.exp(cum[:, -1, None, :] - cum) * ig_i   # (B,c,H)
        C = torch.exp(cum[:, -1])[:, :, None, None] * C + pair(
            "bjhd,bjhw->bhdw", pair("bjh,bjhd->bjhd", dec_end, kf), vf)
        n = torch.exp(cum[:, -1])[:, :, None] * n + pair(
            "bjh,bjhd->bhd", dec_end, kf)
        return (C, n), h

    (C, n), h = scan(step, (C, n), S // chunk, source=x)
    out = _mlstm_out(params, h.reshape(B, S, own.dl).to(dt), z, cfg, spec,
                     tp, own)
    if return_state:
        d_conv = params["conv_w"].shape[0]
        conv_state = F.pad(xm, (0, 0, d_conv - 1, 0))[:, -(d_conv - 1):]
        C, n = _whole_state(C, n, tp, H)
        return out, {"C": C, "n": n, "conv": conv_state}
    return out


def init_mlstm_cache(cfg, spec, batch, dtype, device=None):
    d_inner, H, dh = _mdims(cfg, spec)
    return {
        "C": torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, 3, d_inner), dtype=dtype, device=device),
    }


def mlstm_decode(params, x, cfg, spec, cache):
    """x: (B,1,D) single-step.  Split over ``model``, the rank updates its
    value columns of the whole cache and the new cache is gathered."""
    B = x.shape[0]
    d_inner, H, dh = _mdims(cfg, spec)
    dt = x.dtype
    tp, own = _split(cfg, spec)
    heads = slice(own.h0, own.h0 + own.Hl)
    whole = ((lambda t: t) if tp is None else
             (lambda t: comm.gather_model(t, tp, -1)))
    up = whole(_enter(x, tp) @ params["w_up"].to(dt))    # (B,1,2*d_inner)
    xm, z = up[..., :d_inner], up[..., d_inner:]
    hist = torch.cat([cache["conv"], xm], dim=1)         # (B,4,d_inner)
    w = params["conv_w"].to(dt)
    xc = F.silu(torch.einsum("bkc,kc->bc", hist, w) + params["conv_b"].to(dt))
    q = whole(xc @ params["wq"].to(dt)).reshape(B, H, dh)[:, heads].float()
    k = (whole(xc @ params["wk"].to(dt)).reshape(B, H, dh)
         / _key_scale(dh, dt))[:, heads].float()
    v = (xm[:, 0] @ params["wv"].to(dt)).reshape(B, own.Hl, own.wl).float()
    gates = xc @ params["w_gates"].to(dt) + params["b_gates"].to(dt)
    f = torch.sigmoid(gates[..., H:].float())[:, heads]
    i = torch.sigmoid(gates[..., :H].float())[:, heads]
    C = cache["C"][:, heads, :, own.w0:own.w0 + own.wl]
    C = C * f[:, :, None, None] + i[:, :, None, None] * torch.einsum(
        "bhd,bhw->bhdw", k, v)
    n = cache["n"][:, heads] * f[:, :, None] + i[:, :, None] * k
    num = torch.einsum("bhd,bhdw->bhw", q, C)
    den = torch.einsum("bhd,bhd->bh", q, n)
    h = (num / torch.clamp(torch.abs(den), min=1.0)[..., None]) \
        .reshape(B, 1, own.dl).to(dt)
    out = _mlstm_out(params, h, z[..., own.c0:own.c0 + own.dl], cfg, spec,
                     tp, own)
    C, n = _whole_state(C, n, tp, H)
    return out, {"C": C, "n": n, "conv": hist[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen, cfg, spec, device=None, stack=None):
    d = cfg.d_model
    H = spec.num_heads
    dh = d // H
    p_dim = int(spec.proj_factor * d)
    kw = dict(device=device, stack=stack)
    return {
        "w": ninit(gen, (d, 4 * d), **kw),          # i,f,z,o input projections
        "r": ninit(gen, (4, H, dh, dh), fan_in_axis=2, **kw),  # block-diag
        "b": cinit(torch.cat([torch.zeros(d), 3.0 * torch.ones(d),
                              torch.zeros(2 * d)]), **kw),
        "norm": init_rms_norm(d, **kw),
        "w_up": ninit(gen, (d, 2 * p_dim), **kw),
        "w_down": ninit(gen, (p_dim, d), **kw),
    }


def _slstm_cell(params, xt, state, H):
    """xt: (B, 4d) pre-projected inputs; state: dict of (B, d)."""
    c, n, h = state["c"], state["n"], state["h"]
    B, d = c.shape
    dh = d // H
    hr = h.reshape(B, H, dh)
    rec = torch.einsum("bhd,ghde->bghe", hr,
                       params["r"].to(h.dtype))                    # (B,4,H,dh)
    gates = xt.reshape(B, 4, d) + rec.reshape(B, 4, d) \
        + params["b"].to(h.dtype).reshape(4, d)
    i = torch.sigmoid(gates[:, 0])
    f = torch.sigmoid(gates[:, 1])
    zv = torch.tanh(gates[:, 2])
    o = torch.sigmoid(gates[:, 3])
    c = f * c + i * zv
    n = f * n + i
    h = o * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": h}


def _slstm_out(params, h, cfg):
    dt = h.dtype
    h = rms_norm(h, params["norm"]["scale"], cfg.norm_eps)
    up = h @ params["w_up"].to(dt)
    p = up.shape[-1] // 2
    return (F.gelu(up[..., :p], approximate="tanh") * up[..., p:]) \
        @ params["w_down"].to(dt)


def slstm_forward(params, x, cfg, spec, return_state=False):
    B, S, D = x.shape
    dt = x.dtype
    xg = x @ params["w"].to(dt)                          # (B,S,4d)
    state = {k: torch.zeros((B, D), dtype=dt, device=x.device)
             for k in ("c", "n", "h")}

    def step(t, state):
        state = _slstm_cell(params, xg[:, t], state, spec.num_heads)
        return state, state["h"][:, None]

    state, hs = scan(step, state, S, source=x)
    out = _slstm_out(params, hs, cfg)
    if return_state:
        return out, state
    return out


def init_slstm_cache(cfg, spec, batch, dtype, device=None):
    return {k: torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)
            for k in ("c", "n", "h")}


def slstm_decode(params, x, cfg, spec, cache):
    dt = x.dtype
    xt = x[:, 0] @ params["w"].to(dt)
    state = _slstm_cell(params, xt, cache, spec.num_heads)
    return _slstm_out(params, state["h"][:, None], cfg), state
