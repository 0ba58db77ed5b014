"""Shared layers of the attention models: norms, RoPE, GQA attention
(prefill with its cache, one-token decode, global and sliding-window),
MLPs, embedding and output head.

Plain functions on tensors; parameters are nested dicts of tensors with
the reference package's names and layouts (heads kept as separate axes:
``wq`` (d, H, hd), ``wo`` (H, hd, d)).  The code stays close to the
reference's jnp code, eagerly, so that tests compare like with like.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def ninit(gen: torch.Generator, shape, scale=None, fan_in_axis=None,
          device=None, stack: Optional[int] = None):
    """Truncated-normal init in [-2, 2] standard deviations; default scale
    1/sqrt(fan_in).  ``stack`` prepends a repeat axis of that many
    independent draws (the reference's vmap over a group's repeats)."""
    if scale is None:
        fan_in = shape[fan_in_axis] if fan_in_axis is not None else shape[0]
        scale = 1.0 / np.sqrt(max(fan_in, 1))
    full = tuple(shape) if stack is None else (stack,) + tuple(shape)
    t = torch.empty(full, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale)


def zinit(shape, device=None, stack: Optional[int] = None):
    full = tuple(shape) if stack is None else (stack,) + tuple(shape)
    return torch.zeros(full, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def init_rms_norm(d, device=None, stack=None):
    return {"scale": zinit((d,), device, stack)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta).astype(np.float32)).to(
        x.device)
    ang = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model, d_ff, gated, device=None, stack=None):
    p = {"wi": ninit(gen, (d_model, d_ff), device=device, stack=stack),
         "wd": ninit(gen, (d_ff, d_model), device=device, stack=stack)}
    if gated:
        p["wg"] = ninit(gen, (d_model, d_ff), device=device, stack=stack)
    return p


def mlp(params, x, gated):
    dt = x.dtype
    h = x @ params["wi"].to(dt)
    if gated:
        h = F.silu(x @ params["wg"].to(dt)) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ params["wd"].to(dt)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def init_attention(gen, cfg, spec, device=None, stack=None):
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(device=device, stack=stack)
    p = {
        "wq": ninit(gen, (d, h, hd), **kw),
        "wk": ninit(gen, (d, k, hd), **kw),
        "wv": ninit(gen, (d, k, hd), **kw),
        "wo": ninit(gen, (h, hd, d), fan_in_axis=0, **kw),
    }
    if spec.qkv_bias:
        p["bq"] = zinit((h, hd), **kw)
        p["bk"] = zinit((k, hd), **kw)
        p["bv"] = zinit((k, hd), **kw)
    if spec.qk_norm:
        p["q_norm"] = init_rms_norm(hd, **kw)
        p["k_norm"] = init_rms_norm(hd, **kw)
    return p


def _project_qkv(params, x, spec, cfg, positions):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if spec.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"]["scale"], cfg.norm_eps)
    if spec.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, scale):
    """q: (B,Sq,H,hd) k,v: (B,Sk,K,hd); GQA by head grouping.
    mask: (B|1,Sq,Sk) bool."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    q = q.reshape(B, Sq, K, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * scale
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, hd)


def attention_prefill(params, x, spec, cfg, positions, cache_len):
    """Causal (optionally sliding-window) attention over the prompt; also
    returns the (k, v) cache of size cache_len.

    Window layers keep only the last ``window`` keys (ring layout, slot =
    pos % window).  The reference splits long prompts into query chunks
    to bound its working set; this computes the same masked attention in
    one pass."""
    q, k, v = _project_qkv(params, x, spec, cfg, positions)
    B = x.shape[0]
    scale = cfg.head_dim ** -0.5
    qpos = positions if positions.dim() > 1 else positions[None, :]
    mask = qpos[:, :, None] >= qpos[:, None, :]
    if spec.window:
        mask &= qpos[:, :, None] - qpos[:, None, :] < spec.window
    out = _sdpa(q, k, v, mask, scale)

    if spec.window is not None:
        w = min(spec.window, cache_len)
        # ring layout: entry for absolute position p lives at slot p % w.
        tail_k, tail_v = k[:, -w:], v[:, -w:]
        pos_tail = (positions[..., -w:] if positions.dim() > 1
                    else positions[-w:][None])
        slots = (pos_tail % w).to(torch.long).expand(B, -1)
        ck = torch.zeros((B, w) + tuple(k.shape[2:]), dtype=k.dtype,
                         device=k.device)
        cv = torch.zeros_like(ck)
        bidx = torch.arange(B, device=k.device)[:, None]
        ck[bidx, slots] = tail_k
        cv[bidx, slots] = tail_v
        cache = {"k": ck, "v": cv}
    else:
        pad = cache_len - x.shape[1]
        cache = {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
                 "v": F.pad(v, (0, 0, 0, 0, 0, pad))}
    dt = x.dtype
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt)), cache


def attention_decode(params, x, spec, cfg, cache, pos):
    """One-token decode. x: (B,1,D); pos: (B,) absolute positions.

    Global layers: cache (B,Smax,K,hd), write at pos, mask j<=pos.
    Window layers: ring cache (B,w,K,hd), write at pos%w, mask by recency.
    """
    B = x.shape[0]
    q, k, v = _project_qkv(params, x, spec, cfg, pos[:, None])
    scale = cfg.head_dim ** -0.5
    ck, cv = cache["k"].clone(), cache["v"].clone()
    bidx = torch.arange(B, device=x.device)
    if spec.window is not None:
        w = ck.shape[1]
        slot = (pos % w).to(torch.long)
        ck[bidx, slot] = k[:, 0]
        cv[bidx, slot] = v[:, 0]
        # slot s holds abs position: the largest p' <= pos with p' % w == s.
        valid = (torch.arange(w, device=x.device)[None, :]
                 <= torch.clamp(pos, max=w - 1)[:, None])
    else:
        Smax = ck.shape[1]
        ck[bidx, pos.to(torch.long)] = k[:, 0]
        cv[bidx, pos.to(torch.long)] = v[:, 0]
        valid = torch.arange(Smax, device=x.device)[None, :] <= pos[:, None]
    out = _sdpa(q, ck, cv, valid[:, None, :], scale)
    dt = x.dtype
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
    return y, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def init_embed(gen, cfg, device=None):
    cb = cfg.num_codebooks
    shape = ((cb, cfg.vocab_size, cfg.d_model) if cb > 1
             else (cfg.vocab_size, cfg.d_model))
    p = {"tok": ninit(gen, shape, scale=0.02, fan_in_axis=-1, device=device)}
    if not cfg.tie_embeddings:
        oshape = ((cfg.d_model, cb * cfg.vocab_size) if cb > 1
                  else (cfg.d_model, cfg.vocab_size))
        p["out"] = ninit(gen, oshape, device=device)
    return p


def embed_tokens(params, cfg, tokens, dtype):
    """tokens: (B,S) or (B,S,CB) for multi-codebook archs."""
    tok = params["tok"].to(dtype)
    if cfg.num_codebooks > 1:
        # sum of per-codebook embeddings
        out = 0.0
        for c in range(cfg.num_codebooks):
            out = out + tok[c][tokens[..., c].to(torch.long)]
        return out
    return tok[tokens.to(torch.long)]


def output_logits(params, cfg, h):
    """h: (B,S,D) -> logits (B,S,V) or (B,S,CB,V)."""
    dt = h.dtype
    if cfg.tie_embeddings:
        tok = params["tok"].to(dt)
        if cfg.num_codebooks > 1:
            return torch.einsum("bsd,cvd->bscv", h, tok)
        return torch.einsum("bsd,vd->bsv", h, tok)
    logits = h @ params["out"].to(dt)
    if cfg.num_codebooks > 1:
        B, S = h.shape[:2]
        return logits.reshape(B, S, cfg.num_codebooks, cfg.vocab_size)
    return logits
