"""Mamba2 (State Space Duality) block: chunked-parallel prefill path +
O(1)-state decode recurrence.

Follows the SSD formulation (Dao & Gu, 2024): scalar per-head decay A,
per-step dt (softplus), shared B/C projections (ngroups=1), causal depthwise
conv on (x, B, C), gated output with RMSNorm.  The reference scans over
chunks with ``lax.scan``; here ``scan.scan``, a Python loop, carries the state
from chunk to chunk.

Mamba tensor parallelism (an env with ``mamba_tp`` whose ``model`` axis
divides the heads; ``sharding.mamba_split``): every SSD einsum carries
the head dim and never contracts it, so each rank computes its heads.
It takes its columns of ``in_proj`` (its heads of z, x and dt; B and C
whole), of the conv and of the per-head leaves, with its state
(B, H/msize, P, N); the gated norm over d_inner sums its squares over
``model``; ``out_proj``'s contraction over d_inner is a partial sum.  The
weights stay replicated over ``model`` (``param_pspec`` lays Mamba out
by fsdp only), so each rank's gradients of them are parts, summed over
``model`` by the step.  Caches at rest are whole (``cache_pspec``): the
final state and conv window are gathered over ``model``, and decode
computes on its own heads of them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import comm, ctx
from repro_torch.distributed.sharding import mamba_split
from repro_torch.models.layers import (_enter, _leave, cinit, init_rms_norm,
                                      ninit, pair, split_rms_norm, zinit)
from repro_torch.models.scan import scan


def _dims(cfg, spec):
    d_inner = spec.expand * cfg.d_model
    nheads = d_inner // spec.head_dim
    return d_inner, nheads, spec.d_state


def softplus(x):
    """jax.nn.softplus: log(1 + exp(x)) with no switch to the identity
    (``F.softplus`` returns x itself past its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba(gen, cfg, spec, device=None, stack=None):
    d, (d_inner, nheads, N) = cfg.d_model, _dims(cfg, spec)
    conv_ch = d_inner + 2 * N
    kw = dict(device=device, stack=stack)
    lin = np.linspace(1.0, 16.0, nheads, dtype=np.float32)
    dtb = np.linspace(1e-3, 1e-1, nheads, dtype=np.float32)
    return {
        # [z, x, B, C, dt]
        "in_proj": ninit(gen, (d, 2 * d_inner + 2 * N + nheads), **kw),
        "conv_w": ninit(gen, (spec.d_conv, conv_ch), scale=0.1, **kw),
        "conv_b": zinit((conv_ch,), **kw),
        "A_log": cinit(torch.log(torch.from_numpy(lin)), **kw),
        "dt_bias": cinit(torch.log(torch.expm1(torch.from_numpy(dtb))),
                         **kw),
        "D": cinit(torch.ones(nheads), **kw),
        "norm": init_rms_norm(d_inner, **kw),
        "out_proj": ninit(gen, (d_inner, d), **kw),
    }


def _tp_split(params, cfg, spec):
    """(params, (d_inner, H, N), TP): the rank's own columns of every leaf
    and its dims when the block's heads are split over ``model``, else
    the block as it is and None."""
    t = ctx.tp()
    dims = _dims(cfg, spec)
    if t is None or not mamba_split(cfg, spec, t.env):
        return params, dims, None
    d_inner, H, N = dims
    Hl = H // t.size
    h0, dl = t.rank * Hl, Hl * spec.head_dim
    c0 = h0 * spec.head_dim
    xs = slice(c0, c0 + dl)
    conv = lambda w: torch.cat([w[..., xs], w[..., d_inner:]], dim=-1)
    w = params["in_proj"]
    own = {
        "in_proj": torch.cat([w[:, xs], w[:, d_inner + c0:d_inner + c0 + dl],
                              w[:, 2 * d_inner:2 * d_inner + 2 * N],
                              w[:, 2 * d_inner + 2 * N + h0:
                                2 * d_inner + 2 * N + h0 + Hl]], dim=1),
        "conv_w": conv(params["conv_w"]), "conv_b": conv(params["conv_b"]),
        "A_log": params["A_log"][h0:h0 + Hl],
        "dt_bias": params["dt_bias"][h0:h0 + Hl],
        "D": params["D"][h0:h0 + Hl],
        "norm": {"scale": params["norm"]["scale"][xs]},
        "out_proj": params["out_proj"][xs],
    }
    return own, (dl, Hl, N), t


def _gated_norm(y, z, scale, eps, d_inner, tp):
    """rms_norm(y * silu(z)) over d_inner (split over ``model``, its sum
    of squares summed over it)."""
    return split_rms_norm(y * F.silu(z), scale, eps, d_inner, tp)


def _whole_cache(state, conv_state, d_inner, tp):
    """The final SSD state and conv window over all heads and channels."""
    if tp is None:
        return state, conv_state
    dl = d_inner // tp.size
    xs = comm.gather_model(conv_state[..., :dl], tp, -1)
    return (comm.gather_model(state, tp, 1),
            torch.cat([xs, conv_state[..., dl:]], dim=-1))


def _own_cache(cache, cfg, spec, tp):
    """This rank's heads of a whole cache."""
    if tp is None:
        return cache
    d_inner, H, _ = _dims(cfg, spec)
    Hl, dl = H // tp.size, d_inner // tp.size
    conv = cache["conv"]
    return {"ssd": cache["ssd"][:, tp.rank * Hl:(tp.rank + 1) * Hl],
            "conv": torch.cat([conv[..., tp.rank * dl:(tp.rank + 1) * dl],
                               conv[..., d_inner:]], dim=-1)}


def _split_proj(params, x, cfg, spec, dims=None):
    d_inner, nheads, N = dims or _dims(cfg, spec)
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * N]
    dt = zxbcdt[..., -nheads:]
    return z, xbc, dt


def _conv_scan(params, xbc):
    """Causal depthwise conv over (B, S, C)."""
    w = params["conv_w"].to(xbc.dtype)                        # (d_conv, C)
    d_conv = w.shape[0]
    pad = F.pad(xbc, (0, 0, d_conv - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1]] * w[i] for i in range(d_conv))
    return F.silu(out + params["conv_b"].to(xbc.dtype))


def check_chunks(S: int, chunk: int) -> int:
    """The chunk length the scan uses, ``min(chunk, S)``; S must be a
    multiple of it (the reference asserts the same)."""
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq must be divisible by chunk: {S} % {chunk}")
    return chunk


def mamba_forward(params, x, cfg, spec, chunk=256, return_state=False):
    """x: (B, S, D). Chunked SSD scan; optionally return final SSM+conv state."""
    B, S, D = x.shape
    d_full = _dims(cfg, spec)[0]
    params, (d_inner, H, N), tp = _tp_split(params, cfg, spec)
    x = _enter(x, tp)
    P = spec.head_dim
    dt_ = x.dtype
    f32 = torch.float32

    z, xbc_raw, dt = _split_proj(params, x, cfg, spec, (d_inner, H, N))
    xbc = _conv_scan(params, xbc_raw)
    xs = xbc[..., :d_inner].reshape(B, S, H, P)
    Bm = xbc[..., d_inner:d_inner + N]                        # (B,S,N)
    Cm = xbc[..., d_inner + N:]

    A = -torch.exp(params["A_log"].float())                   # (H,) negative
    dt = softplus(dt.float() + params["dt_bias"].float())
    dA = dt * A                                               # (B,S,H) log-decay

    chunk = check_chunks(S, chunk)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    state = torch.zeros((B, H, P, N), dtype=f32, device=x.device)

    def step(i, state):
        sl = slice(i * chunk, (i + 1) * chunk)
        x_i, b_i, c_i = xs[:, sl].float(), Bm[:, sl].float(), Cm[:, sl].float()
        da_i, dt_i = dA[:, sl], dt[:, sl]
        cum = torch.cumsum(da_i, dim=1)                       # (B,c,H)
        # intra-chunk: y[s] = sum_{j<=s} exp(cum_s - cum_j) dt_j (C_s.B_j) x_j
        seg = cum[:, :, None, :] - cum[:, None, :, :]         # (B,c,c,H)
        # clamp masked entries BEFORE exp: exp(+large) -> inf
        decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                            0.0)
        cb = torch.einsum("bsn,bjn->bsj", c_i, b_i)
        att = cb[..., None] * decay * dt_i[:, None, :, :]     # (B,c,c,H)
        y = torch.einsum("bsjh,bjhp->bshp", att, x_i)
        # contribution of carried state: y += C_s . state * exp(cum_s)
        # the reference's "bsn,bhpn,bsh->bshp", in jnp.einsum's pairs
        y = y + pair("bsnh,bhpn->bshp",
                     pair("bsn,bsh->bsnh", c_i, torch.exp(cum)), state)
        # new chunk state: exp(cum_end)*state + sum_j exp(cum_end-cum_j) dt_j B_j x_j^T
        dec_end = torch.exp(cum[:, -1, None, :] - cum)        # (B,c,H)
        sB = pair("bjhp,bjhn->bhpn", x_i,          # "bjh,bjn,bjhp->bhpn"
                  pair("bjh,bjn->bjhn", dec_end * dt_i, b_i))
        state = torch.exp(cum[:, -1])[:, :, None, None] * state + sB
        return state, y

    state, y = scan(step, state, S // chunk, source=x)
    y = y + xs.float() * params["D"].float()[None, None, :, None]
    y = y.reshape(B, S, d_inner).to(dt_)
    y = _gated_norm(y, z, params["norm"]["scale"], cfg.norm_eps, d_full, tp)
    out = _leave(y @ params["out_proj"].to(dt_), tp)
    if return_state:
        d_conv = params["conv_w"].shape[0]
        conv_state = F.pad(xbc_raw, (0, 0, d_conv - 1, 0))[:, -(d_conv - 1):]
        state, conv_state = _whole_cache(state.float(), conv_state, d_full,
                                         tp)
        return out, {"ssd": state, "conv": conv_state}
    return out


def init_mamba_cache(cfg, spec, batch, dtype, device=None):
    d_inner, H, N = _dims(cfg, spec)
    conv_ch = d_inner + 2 * N
    return {
        "ssd": torch.zeros((batch, H, spec.head_dim, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, spec.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def mamba_decode(params, x, cfg, spec, cache):
    """One-step recurrence. x: (B,1,D)."""
    B = x.shape[0]
    d_full = _dims(cfg, spec)[0]
    params, (d_inner, H, N), tp = _tp_split(params, cfg, spec)
    cache = _own_cache(cache, cfg, spec, tp)
    x = _enter(x, tp)
    P = spec.head_dim
    dt_ = x.dtype

    z, xbc_raw, dt = _split_proj(params, x, cfg, spec, (d_inner, H, N))
    # conv over ring of last d_conv inputs
    hist = torch.cat([cache["conv"], xbc_raw], dim=1)         # (B,d_conv,C)
    w = params["conv_w"].to(dt_)
    xbc = F.silu(torch.einsum("bkc,kc->bc", hist, w)
                 + params["conv_b"].to(dt_))
    new_conv = hist[:, 1:]

    xh = xbc[:, :d_inner].reshape(B, H, P).float()
    Bm = xbc[:, d_inner:d_inner + N].float()
    Cm = xbc[:, d_inner + N:].float()
    A = -torch.exp(params["A_log"].float())
    dtv = softplus(dt[:, 0].float() + params["dt_bias"].float())
    decay = torch.exp(dtv * A)                                # (B,H)
    state = cache["ssd"] * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dtv, Bm, xh)
    y = torch.einsum("bn,bhpn->bhp", Cm, state)
    y = y + xh * params["D"].float()[None, :, None]
    y = y.reshape(B, 1, d_inner).to(dt_)
    y = _gated_norm(y, z, params["norm"]["scale"], cfg.norm_eps, d_full, tp)
    out = _leave(y @ params["out_proj"].to(dt_), tp)
    state, new_conv = _whole_cache(state, new_conv, d_full, tp)
    return out, {"ssd": state, "conv": new_conv}
