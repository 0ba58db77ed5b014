"""xLSTM blocks: mLSTM (matrix-memory, chunked-parallel) and sLSTM
(scalar-memory, true recurrence).

Faithful to the xLSTM block structure (up-proj -> conv -> q/k/v -> cell ->
group-norm -> gated down-proj). As in the reference, one documented
simplification: bounded sigmoid input/forget gates rather than the
exponential-gate + max-stabilizer form — identical state-update structure,
FLOPs and memory, but unconditionally stable in bf16.  The reference's
``lax.scan`` over chunks (mLSTM) and over steps (sLSTM) is a Python loop
here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (cinit, init_rms_norm, ninit, rms_norm,
                                      zinit)
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


def _mlstm_qkv(params, x, cfg, spec):
    dt = x.dtype
    d_inner, H, dh = _mdims(cfg, spec)
    up = x @ params["w_up"].to(dt)
    xm, z = up[..., :d_inner], up[..., d_inner:]
    # causal depthwise conv(4)
    w = params["conv_w"].to(dt)
    pad = F.pad(xm, (0, 0, w.shape[0] - 1, 0))
    xc = sum(pad[:, i:i + xm.shape[1]] * w[i] for i in range(w.shape[0]))
    xc = F.silu(xc + params["conv_b"].to(dt))
    B, S = x.shape[:2]
    q = (xc @ params["wq"].to(dt)).reshape(B, S, H, dh)
    k = (xc @ params["wk"].to(dt)).reshape(B, S, H, dh) \
        / _key_scale(dh, dt)
    v = (xm @ params["wv"].to(dt)).reshape(B, S, H, dh)
    gates = xc @ params["w_gates"].to(dt) + params["b_gates"].to(dt)
    lf = F.logsigmoid(gates[..., H:].float())                        # (B,S,H)
    ig = torch.sigmoid(gates[..., :H].float())
    return q, k, v, z, xm, lf, ig


def mlstm_forward(params, x, cfg, spec, chunk=256, return_state=False):
    B, S, D = x.shape
    d_inner, H, dh = _mdims(cfg, spec)
    dt = x.dtype
    q, k, v, z, xm, lf, ig = _mlstm_qkv(params, x, cfg, spec)

    chunk = check_chunks(S, chunk)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
    hs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qf, kf, vf = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        lf_i, ig_i = lf[:, sl], ig[:, sl]
        cum = torch.cumsum(lf_i, dim=1)                 # (B,c,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        # clamp masked entries before exp
        decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                            0.0)
        att = torch.einsum("bshd,bjhd->bsjh", qf, kf) * decay \
            * ig_i[:, None, :, :]
        num = torch.einsum("bsjh,bjhd->bshd", att, vf)
        den = att.sum(dim=2)                            # (B,c,H)
        # carried state contribution
        dec_s = torch.exp(cum)                          # (B,c,H)
        num = num + torch.einsum("bshd,bhdw,bsh->bshw", qf, C, dec_s)
        den = den + torch.einsum("bshd,bhd,bsh->bsh", qf, n, dec_s)
        hs.append(num / torch.clamp(torch.abs(den), min=1.0)[..., None])
        # state update
        dec_end = torch.exp(cum[:, -1, None, :] - cum) * ig_i   # (B,c,H)
        C = torch.exp(cum[:, -1])[:, :, None, None] * C + torch.einsum(
            "bjh,bjhd,bjhw->bhdw", dec_end, kf, vf)
        n = torch.exp(cum[:, -1])[:, :, None] * n + torch.einsum(
            "bjh,bjhd->bhd", dec_end, kf)
    h = torch.cat(hs, dim=1).reshape(B, S, d_inner).to(dt)
    h = rms_norm(h, params["norm"]["scale"], cfg.norm_eps)
    out = (h * F.silu(z)) @ params["w_down"].to(dt)
    if return_state:
        d_conv = params["conv_w"].shape[0]
        conv_state = F.pad(xm, (0, 0, d_conv - 1, 0))[:, -(d_conv - 1):]
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
    """x: (B,1,D) single-step."""
    B = x.shape[0]
    d_inner, H, dh = _mdims(cfg, spec)
    dt = x.dtype
    up = x @ params["w_up"].to(dt)                       # (B,1,2*d_inner)
    xm, z = up[..., :d_inner], up[..., d_inner:]
    hist = torch.cat([cache["conv"], xm], dim=1)         # (B,4,d_inner)
    w = params["conv_w"].to(dt)
    xc = F.silu(torch.einsum("bkc,kc->bc", hist, w) + params["conv_b"].to(dt))
    q = (xc @ params["wq"].to(dt)).reshape(B, H, dh).float()
    k = ((xc @ params["wk"].to(dt)).reshape(B, H, dh)
         / _key_scale(dh, dt)).float()
    v = (xm[:, 0] @ params["wv"].to(dt)).reshape(B, H, dh).float()
    gates = xc @ params["w_gates"].to(dt) + params["b_gates"].to(dt)
    f = torch.sigmoid(gates[..., H:].float())
    i = torch.sigmoid(gates[..., :H].float())
    C = cache["C"] * f[:, :, None, None] + i[:, :, None, None] * torch.einsum(
        "bhd,bhw->bhdw", k, v)
    n = cache["n"] * f[:, :, None] + i[:, :, None] * k
    num = torch.einsum("bhd,bhdw->bhw", q, C)
    den = torch.einsum("bhd,bhd->bh", q, n)
    h = (num / torch.clamp(torch.abs(den), min=1.0)[..., None]) \
        .reshape(B, 1, d_inner).to(dt)
    h = rms_norm(h, params["norm"]["scale"], cfg.norm_eps)
    out = (h * F.silu(z)) @ params["w_down"].to(dt)
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
    hs = []
    for t in range(S):
        state = _slstm_cell(params, xg[:, t], state, spec.num_heads)
        hs.append(state["h"])
    out = _slstm_out(params, torch.stack(hs, dim=1), cfg)
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
