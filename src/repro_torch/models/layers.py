"""Shared layers of the model families: norms, RoPE, GQA attention
(training with query chunks, prefill with its cache, one-token decode
over a dense or a paged cache, global and sliding-window), MLPs,
embedding, output head and chunked cross-entropy.

Plain functions on tensors; parameters are nested dicts of tensors with
the reference package's names and layouts (heads kept as separate axes:
``wq`` (d, H, hd), ``wo`` (H, hd, d)).  The code stays close to the
reference's jnp code, eagerly, so that tests compare like with like.

Tensor parallelism (an env installed in ``distributed.ctx`` whose
``model`` axis has size > 1): each rank holds its shards of the weights
that ``param_pspec`` splits over ``model`` and computes its part, where
the reference's GSPMD partitions the einsums.  Activations stay plain
tensors replicated over ``model``; a split region starts with
``comm.copy_to_model`` and ends with ``comm.reduce_from_model``:

- attention by ``sharding.attn_plan``: "heads" splits Q and K/V heads;
  "hd" splits head_dim, so the scores are a partial sum (all-reduced
  before the softmax, whose output enters the value product as a copy),
  and RoPE's rotate-half and the q/k norms, which need whole heads, run
  on head_dim gathered over ``model`` and re-sliced; "qtp" splits Q
  heads and computes K/V whole on every rank;
- the MLP column-parallel (``wi``/``wg``) and row-parallel (``wd``);
- the embedding, logits and cross-entropy vocab-parallel: a masked local
  lookup summed over ``model``; local logits, gathered over vocab for
  prefill and decode; a loss from the max, the sum of exponentials and
  the gold logit, each reduced over ``model`` (an untied multi-codebook
  head splits by whole codebooks, each rank's loss a part of the sum,
  or, with more ranks than codebooks, by columns: each codebook's max,
  sum of exponentials and gold logit reduced over ``model``).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import comm, ctx
from repro_torch.distributed.sharding import attn_plan
from repro_torch.kernels.paged_attention.ops import paged_attention

NEG_INF = -1e30


def split_over(n: int):
    """The installed env's ``ctx.TP`` when a dim of ``n`` splits over
    ``model`` (the rule ``param_pspec`` applies), else None."""
    t = ctx.tp()
    return t if t is not None and n % t.size == 0 else None


def _enter(x, t):
    return x if t is None else comm.copy_to_model(x, t)


def _leave(y, t):
    return y if t is None else comm.reduce_from_model(y, t)

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


def cinit(values: torch.Tensor, device=None, stack: Optional[int] = None):
    """A constant fp32 leaf (the reference's ``jnp.ones``, ``linspace``...),
    repeated over a group's ``stack`` axis."""
    t = values.to(device=device, dtype=torch.float32)
    return t if stack is None else t.expand((stack,) + tuple(t.shape)).clone()


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def pair(spec, x, y):
    """``torch.einsum`` of two operands, with the reference's rule for which
    products are matmuls, forward and backward: ``jnp.einsum`` makes every
    pair a ``dot_general`` and AD transposes it into two more, of which XLA
    keeps as dots those that contract an index and turns the rest into
    multiplies.  torch's einsum multiplies where nothing is contracted, as
    XLA does, but the backward of its ``bmm`` is two ``bmm``s even where one
    contracts nothing; ``pair``'s backward is two einsums.  The recurrent
    blocks write each of the reference's einsums in their loops as such
    pairs, in the order ``jnp.einsum`` contracts them, so that the port's
    matmuls are the reference's (``distributed/op_analysis``'s dot FLOPs
    equal its ``hlo_analysis``'s)."""
    return _Pair.apply(spec, x, y)


class _Pair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, x, y):
        ctx.spec = spec
        ctx.save_for_backward(x, y)
        return torch.einsum(spec, x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        ins, out = ctx.spec.split("->")
        a, b = ins.split(",")
        gx = (torch.einsum(f"{out},{b}->{a}", g, y)
              if ctx.needs_input_grad[1] else None)
        gy = (torch.einsum(f"{out},{a}->{b}", g, x)
              if ctx.needs_input_grad[2] else None)
        return None, gx, gy


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def split_rms_norm(x, scale, eps, d, tp):
    """``rms_norm`` over a last dim of ``d`` of which ``x`` holds this
    rank's part when ``tp`` (the TP) is given: the sum of squares is summed
    over ``model`` (and, used by every rank's part, so is its gradient)."""
    if tp is None:
        return rms_norm(x, scale, eps)
    dt = x.dtype
    x = x.float()
    sq = torch.sum(torch.square(x), -1, keepdim=True)
    var = comm.copy_to_model(comm.reduce_from_model(sq, tp), tp) / d
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def init_rms_norm(d, device=None, stack=None):
    return {"scale": zinit((d,), device, stack)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def rope_table(head_dim, theta, device):
    """``rope_freqs`` as an fp32 tensor on ``device``, built once for each
    ``(head_dim, theta, device)``: a decode step uploads nothing for it,
    and a CUDA graph of the step can read it."""
    return torch.from_numpy(rope_freqs(head_dim, theta).astype(
        np.float32)).to(device)


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_table(x.shape[-1], theta, x.device)
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


def mlp(params, x, gated, tp=None):
    """``tp``: the rank's ``ctx.TP`` when d_ff is split over ``model``
    (``wi``/``wg`` by columns, ``wd`` by rows: a partial sum)."""
    dt = x.dtype
    x = _enter(x, tp)
    h = x @ params["wi"].to(dt)
    if gated:
        h = F.silu(x @ params["wg"].to(dt)) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return _leave(h @ params["wd"].to(dt), tp)


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


def _attn_tp(cfg):
    """(TP, plan) of the installed env's attention split, or (None, None)
    when attention is not split (no env, or replicated over ``model``)."""
    t = ctx.tp()
    plan = attn_plan(cfg, t.env) if t is not None else None
    return (t, plan) if plan else (None, None)


def _cache_hd(cfg):
    """The TP when ``cache_pspec`` splits the K/V caches' head_dim over
    ``model`` while attention computes on whole heads ("qtp", replicated),
    so that caches are sliced to rest and gathered to compute."""
    t = ctx.tp()
    if t is None or _attn_tp(cfg)[1] in ("heads", "hd"):
        return None
    ms = t.size
    return t if cfg.num_kv_heads % ms and cfg.head_dim % ms == 0 else None


def _kv_heads(k, cfg, tp):
    """Under "qtp", the K/V heads this rank's Q heads read: its local Q
    head ``i`` is head ``tp.rank * Hl + i`` and reads K/V head ``(tp.rank
    * Hl + i) // G``.  Local heads that fill whole groups, or lie in one,
    share their K/V heads (``_sdpa`` groups them); heads that straddle
    groups each get their own."""
    Hl = cfg.num_heads // tp.size
    G = cfg.num_heads // cfg.num_kv_heads
    first = tp.rank * Hl
    if G % Hl == 0 or Hl % G == 0:
        j = first // G
        return k[:, :, j:j + max(Hl // G, 1)]
    idx = torch.tensor([(first + i) // G for i in range(Hl)],
                       device=k.device)
    return k.index_select(2, idx)


def _project_qkv(params, x, spec, cfg, positions, tp=None, plan=None):
    dt = x.dtype
    x = _enter(x, tp)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if spec.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    whole = plan == "hd" and (spec.qk_norm or spec.rope)
    if whole:      # rotate-half and the norms need whole heads
        q, k = comm.gather_model(q, tp, -1), comm.gather_model(k, tp, -1)
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"]["scale"], cfg.norm_eps)
    if spec.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if whole:
        q, k = comm.slice_model(q, tp, -1), comm.slice_model(k, tp, -1)
    return q, k, v


def _sdpa(q, k, v, mask, scale, part=None):
    """q: (B,Sq,H,hd) k,v: (B,Sk,K,hd); GQA by head grouping.
    mask: (B|1,Sq,Sk) bool.  ``part``: the TP when head_dim is split over
    ``model``: the scores are summed over it before the softmax."""
    B, Sq, H, hd = q.shape
    scores = _scores(q, k, mask, scale, part)
    w = _enter(torch.softmax(scores, dim=-1).to(v.dtype), part)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, hd)


def _scores(q, k, mask, scale, part):
    """``_sdpa``'s scores (B,K,G,Sq,Sk) in float32, masked."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    q = q.reshape(B, Sq, K, H // K, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * scale
    scores = _leave(scores, part)
    return torch.where(mask[:, None, None, :, :], scores,
                       torch.full_like(scores, NEG_INF))


def _sdpa_split(q, k, v, valid, scale, part, sp):
    """``_sdpa`` of one query per row over this rank's slice of a
    sequence-parallel cache (``valid`` (B, n) its mask), merged with the
    other data shards' by ``comm.sp_attn_combine``."""
    B, Sq, H, hd = q.shape
    scores = _scores(q, k, valid[:, None, :], scale, part)
    top = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - top)
    o = torch.einsum("bkgqs,bskh->bqkgh", _enter(p.to(v.dtype), part), v)
    lay = lambda t: t.permute(0, 3, 1, 2)          # (B,K,G,q) -> (B,q,K,G)
    out = comm.sp_attn_combine(lay(top[..., 0]), lay(p.sum(-1)), o,
                               sp.groups)
    return out.to(v.dtype).reshape(B, Sq, H, hd)


def attention_train(params, x, spec, cfg, positions, q_chunk=1024,
                    exact_causal_slices=False):
    """Causal (optionally sliding-window) attention for training.

    Past ``q_chunk`` tokens the queries go in chunks of ``q_chunk``, so
    the score working set is (B, H, chunk, Skv): global layers score each
    chunk against every key (masked), window layers only against the
    (window + chunk) band of keys they can see.  ``exact_causal_slices``
    gives each chunk of a global layer only the keys up to its end, which
    halves the scores' FLOPs.  S must be a multiple of ``q_chunk`` then,
    as the reference's reshape requires."""
    scale = cfg.head_dim ** -0.5
    tp, plan = _attn_tp(cfg)
    q, k, v = _project_qkv(params, x, spec, cfg, positions, tp, plan)
    out = _attend(q, k, v, spec, cfg, positions, scale, q_chunk, tp, plan,
                  exact_causal_slices)
    return _leave(torch.einsum("bshk,hkd->bsd", out,
                               params["wo"].to(x.dtype)), tp)


def _attend(q, k, v, spec, cfg, positions, scale, q_chunk, tp, plan,
            exact_causal_slices=False):
    """Causal attention of the prompt: in one pass up to ``q_chunk``
    queries, else in query chunks; the split's own heads (or head_dim)."""
    if plan == "qtp":
        k, v = _kv_heads(k, cfg, tp), _kv_heads(v, cfg, tp)
    part = tp if plan == "hd" else None
    if q.shape[1] <= q_chunk:
        return _attend_whole(q, k, v, spec, positions, scale, part)
    if spec.window is not None:
        return _window_chunked(q, k, v, spec.window, q_chunk, scale, part)
    if exact_causal_slices:
        return _causal_unrolled(q, k, v, q_chunk, scale, part)
    return _causal_chunked(q, k, v, q_chunk, scale, part)


def _attend_whole(q, k, v, spec, positions, scale, part=None):
    """Causal (and window) masked attention of every query in one pass."""
    qpos = positions if positions.dim() > 1 else positions[None, :]
    mask = qpos[:, :, None] >= qpos[:, None, :]
    if spec.window:
        mask &= qpos[:, :, None] - qpos[:, None, :] < spec.window
    return _sdpa(q, k, v, mask, scale, part)


def _num_chunks(S: int, c: int) -> int:
    if S % c:
        raise ValueError(f"seq {S} is not a multiple of q_chunk {c}")
    return S // c


def _causal_chunked(q, k, v, c, scale, part=None):
    """Each query chunk against all S keys, masked causally."""
    S = q.shape[1]
    kpos = torch.arange(S, device=q.device)
    outs = []
    for i in range(_num_chunks(S, c)):
        qpos = i * c + torch.arange(c, device=q.device)
        mask = (qpos[:, None] >= kpos[None, :])[None]
        outs.append(_sdpa(q[:, i * c:(i + 1) * c], k, v, mask, scale, part))
    return torch.cat(outs, dim=1)


def _causal_unrolled(q, k, v, c, scale, part=None):
    """Each query chunk against the keys up to its own end."""
    S = q.shape[1]
    outs = []
    for i in range(_num_chunks(S, c)):
        kv_end = (i + 1) * c
        qpos = i * c + torch.arange(c, device=q.device)
        kpos = torch.arange(kv_end, device=q.device)
        mask = (qpos[:, None] >= kpos[None, :])[None]
        outs.append(_sdpa(q[:, i * c:kv_end], k[:, :kv_end], v[:, :kv_end],
                          mask, scale, part))
    return torch.cat(outs, dim=1)


def _window_chunked(q, k, v, window, c, scale, part=None):
    """Front-pad KV by ``window`` (rounded up to a chunk multiple) so each
    query chunk reads a fixed (w + c) band; keys before position 0 and
    past the window are masked."""
    S = q.shape[1]
    w = ((window + c - 1) // c) * c
    kp = F.pad(k, (0, 0, 0, 0, w, 0))
    vp = F.pad(v, (0, 0, 0, 0, w, 0))
    outs = []
    for i in range(_num_chunks(S, c)):
        qpos = i * c + torch.arange(c, device=q.device)
        kpos = i * c - w + torch.arange(w + c, device=q.device)
        mask = ((qpos[:, None] >= kpos[None, :])
                & (qpos[:, None] - kpos[None, :] < window)
                & (kpos[None, :] >= 0))[None]
        outs.append(_sdpa(q[:, i * c:(i + 1) * c], kp[:, i * c:i * c + w + c],
                          vp[:, i * c:i * c + w + c], mask, scale, part))
    return torch.cat(outs, dim=1)


def attention_prefill(params, x, spec, cfg, positions, cache_len,
                      q_chunk=1024):
    """Causal (optionally sliding-window) attention over the prompt; also
    returns the (k, v) cache of size cache_len.

    Window layers keep only the last ``window`` keys (ring layout, slot =
    pos % window).  Past ``q_chunk`` tokens the queries go in chunks, as
    in training.  A sequence-parallel cache (``ctx.seq_split``) keeps only
    this rank's slice of the positions, or of the ring's slots."""
    tp, plan = _attn_tp(cfg)
    q, k, v = _project_qkv(params, x, spec, cfg, positions, tp, plan)
    B = x.shape[0]
    out = _attend(q, k, v, spec, cfg, positions, cfg.head_dim ** -0.5,
                  q_chunk, tp, plan)

    sp = ctx.seq_split(spec.window)
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
        if sp is not None:      # this rank's slots of the ring
            cache = {n: c[:, sp.first:sp.first + sp.length].clone()
                     for n, c in cache.items()}
    else:
        first, n = (0, cache_len) if sp is None else (sp.first, sp.length)
        cache = {"k": _positions(k, first, n), "v": _positions(v, first, n)}
    rest = _cache_hd(cfg)
    if rest is not None:
        cache = {n: comm.slice_model(c, rest, -1) for n, c in cache.items()}
    dt = x.dtype
    return _leave(torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt)),
                  tp), cache


def _positions(t, first, n):
    """Positions ``[first, first + n)`` of the prompt's ``t`` (B, S, ...),
    zeros past its end."""
    part = t[:, first:first + n]
    return F.pad(part, (0, 0, 0, 0, 0, n - part.shape[1]))


def attention_decode(params, x, spec, cfg, cache, pos):
    """One-token decode. x: (B,1,D); pos: (B,) absolute positions.

    Global layers: cache (B,Smax,K,hd), write at pos, mask j<=pos.
    Window layers: ring cache (B,w,K,hd), write at pos%w, mask by recency.

    A sequence-parallel cache (``ctx.seq_split``) is this rank's slice of
    positions (or slots) ``[first, first + n)``: the rank whose slice
    holds the new entry writes it, the mask reads the slice's absolute
    positions, and the ranks' attention over their slices is merged by
    ``comm.sp_attn_combine``.
    """
    B = x.shape[0]
    tp, plan = _attn_tp(cfg)
    q, k, v = _project_qkv(params, x, spec, cfg, pos[:, None], tp, plan)
    scale = cfg.head_dim ** -0.5
    rest = _cache_hd(cfg)
    if rest is not None:
        ck, cv = (comm.gather_model(cache[n], rest, -1) for n in ("k", "v"))
    else:
        ck, cv = cache["k"].clone(), cache["v"].clone()
    bidx = torch.arange(B, device=x.device)
    sp = ctx.seq_split(spec.window)
    if sp is not None:
        w = sp.whole
        at, top = ((pos % w, torch.clamp(pos, max=w - 1))
                   if spec.window is not None else (pos, pos))
        # the entry lands on the rank whose slice holds it; elsewhere the
        # slot it is clamped to is written back unchanged
        i = at.to(torch.long) - sp.first
        mine = ((i >= 0) & (i < sp.length))[:, None, None]
        i = torch.clamp(i, 0, sp.length - 1)
        ck[bidx, i] = torch.where(mine, k[:, 0], ck[bidx, i])
        cv[bidx, i] = torch.where(mine, v[:, 0], cv[bidx, i])
        valid = (sp.first + torch.arange(sp.length, device=x.device)
                 )[None, :] <= top[:, None]
    elif spec.window is not None:
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
    ka, va = ((_kv_heads(ck, cfg, tp), _kv_heads(cv, cfg, tp))
              if plan == "qtp" else (ck, cv))
    part = tp if plan == "hd" else None
    if sp is None:
        out = _sdpa(q, ka, va, valid[:, None, :], scale, part)
    else:
        out = _sdpa_split(q, ka, va, valid, scale, part, sp)
    dt = x.dtype
    y = _leave(torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt)), tp)
    if rest is not None:
        ck, cv = comm.slice_model(ck, rest, -1), comm.slice_model(cv, rest, -1)
    return y, {"k": ck, "v": cv}


def attention_paged_decode(params, x, spec, cfg, pos, *, write, frames,
                           tables, lengths, backend="auto"):
    """One-token decode over a paged cache. x: (B,1,D); pos: (B,) absolute.
    ``write(k_rows, v_rows)`` stores the token's K and V (B,K,hd) in its
    slots; the paged kernel then attends over ``frames`` (F,Tp,K,hd)
    through the layer's K and V page ``tables`` (B,W) up to ``lengths``
    (B,), a window layer from ``lengths - window``.  One device, no split:
    ``attention_decode`` carries the tensor- and sequence-parallel
    layouts."""
    B = x.shape[0]
    q, k, v = _project_qkv(params, x, spec, cfg, pos[:, None])
    write(k[:, 0], v[:, 0])
    qh = q[:, 0].reshape(B, cfg.num_kv_heads,
                         cfg.num_heads // cfg.num_kv_heads, cfg.head_dim)
    starts = (torch.clamp(lengths - spec.window, min=0)
              if spec.window is not None else None)
    out = paged_attention(qh, frames, frames, tables[0], lengths,
                          v_page_table=tables[1], starts=starts,
                          backend=backend)
    out = out.reshape(B, 1, cfg.num_heads, cfg.head_dim)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))


def init_attn_cache(cfg, spec, batch, cache_len, dtype, device=None):
    w = min(spec.window, cache_len) if spec.window is not None else cache_len
    shape = (batch, w, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Embedding / head / loss
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
    """tokens: (B,S) or (B,S,CB) for multi-codebook archs.  With the vocab
    split over ``model``, each rank looks up the ids in its range and the
    rows are summed over ``model``."""
    tok = params["tok"].to(dtype)
    t = split_over(cfg.vocab_size)
    if t is not None:
        Vl = tok.shape[-2]
        look = lambda table, ids: _masked_rows(table, ids.long() - t.rank * Vl)
    else:
        look = lambda table, ids: table[ids.to(torch.long)]
    if cfg.num_codebooks > 1:
        # sum of per-codebook embeddings
        out = 0.0
        for c in range(cfg.num_codebooks):
            out = out + look(tok[c], tokens[..., c])
    else:
        out = look(tok, tokens)
    return _leave(out, t)


def _masked_rows(table, local):
    """Rows ``local`` of ``table``, zero where ``local`` is out of range."""
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(mine, local, torch.zeros_like(local))]
    return torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))


def _vocab_tp(cfg):
    """(TP, split) of the output head over ``model``: split "vocab" (each
    rank a vocab range), "codebooks" (an untied multi-codebook head whose
    column shards are whole codebooks), "columns" (an untied
    multi-codebook head whose column shards are not: each rank a range of
    the codebooks' concatenated vocabularies) or None."""
    cb = cfg.num_codebooks
    if cfg.tie_embeddings or cb == 1:
        t = split_over(cfg.vocab_size)
        return t, "vocab" if t is not None else None
    t = split_over(cb * cfg.vocab_size)
    if t is None:
        return None, None
    return t, "codebooks" if cb % t.size == 0 else "columns"


def output_logits(params, cfg, h):
    """h: (B,S,D) -> logits (B,S,V) or (B,S,CB,V); split over ``model``,
    each rank's part is gathered."""
    logits, t, split = _local_logits(params, cfg, h)
    if t is None:
        return logits
    if split == "columns":
        return comm.gather_model(logits, t, -1).reshape(
            logits.shape[:-1] + (cfg.num_codebooks, cfg.vocab_size))
    return comm.gather_model(logits, t, -1 if split == "vocab" else -2)


def _local_logits(params, cfg, h):
    """(this rank's logits, the TP or None, its split); "columns": this
    rank's columns (B,S,W) of the (B,S,CB*V) logits."""
    t, split = _vocab_tp(cfg)
    h = _enter(h, t)
    if split == "columns":
        return h @ params["out"].to(h.dtype), t, split
    return _head(params, cfg, h), t, split


def _head(params, cfg, h):
    dt = h.dtype
    if cfg.tie_embeddings:
        tok = params["tok"].to(dt)
        if cfg.num_codebooks > 1:
            return torch.einsum("bsd,cvd->bscv", h, tok)
        return torch.einsum("bsd,vd->bsv", h, tok)
    logits = h @ params["out"].to(dt)
    if cfg.num_codebooks > 1:
        B, S = h.shape[:2]
        return logits.reshape(B, S, -1, cfg.vocab_size)
    return logits


def _columns_loss(logits, labels, cfg, t):
    """The summed cross-entropy of an untied multi-codebook head whose
    column shards are not whole codebooks: this rank's columns ``logits``
    (..., W) cover parts of some codebooks; each codebook's max, sum of
    exponentials and gold logit are (..., CB) tensors, filled by each
    rank in the codebooks it covers (-inf or 0 elsewhere) and reduced over
    ``model`` in one all-reduce each."""
    V, cb = cfg.vocab_size, cfg.num_codebooks
    W = logits.shape[-1]
    lo = t.rank * W
    segs = {c: (max(c * V, lo) - lo, min((c + 1) * V, lo + W) - lo)
            for c in range(lo // V, (lo + W - 1) // V + 1)}
    lead = logits.shape[:-1]
    none = torch.full(lead, -torch.inf, dtype=logits.dtype,
                      device=logits.device)
    m = comm.all_reduce_max(torch.stack(
        [logits[..., slice(*segs[c])].amax(-1) if c in segs else none
         for c in range(cb)], -1), t)
    zero = torch.zeros(lead, dtype=logits.dtype, device=logits.device)
    se, gold = [], []
    for c in range(cb):
        if c not in segs:
            se.append(zero)
            gold.append(zero)
            continue
        a, b = segs[c]
        seg = logits[..., a:b]
        se.append(torch.exp(seg - m[..., c:c + 1]).sum(-1))
        local = labels[..., c].long() + (c * V - lo - a)
        mine = (local >= 0) & (local < b - a)
        g = torch.gather(seg, -1, torch.where(
            mine, local, torch.zeros_like(local))[..., None])[..., 0]
        gold.append(torch.where(mine, g, 0.0))
    lse = m + torch.log(comm.reduce_from_model(torch.stack(se, -1), t))
    return torch.sum(lse - comm.reduce_from_model(torch.stack(gold, -1), t))


def chunked_xent(params, cfg, h, labels, chunk=256):
    """Mean cross-entropy without materializing (B, S, V) logits: the
    sequence goes in chunks, each checkpointed, so that the backward pass
    recomputes one chunk's logits at a time."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    nc = S // chunk

    def chunk_loss(hc, lc):
        logits, t, split = _local_logits(params, cfg, hc)
        logits = logits.float()
        if split == "columns":
            return _columns_loss(logits, lc, cfg, t)
        if split == "codebooks":        # this rank's codebooks, whole
            n = logits.shape[-2]
            lc = lc[..., t.rank * n:(t.rank + 1) * n]
        if t is None or split == "codebooks":
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                lc[..., None].to(torch.long))[..., 0]
            return _leave(torch.sum(lse - gold), t)
        # vocab-parallel: max, sum of exponentials and gold logit over model
        m = comm.all_reduce_max(logits.amax(-1), t)
        lse = m + torch.log(comm.reduce_from_model(
            torch.exp(logits - m[..., None]).sum(-1), t))
        local = lc.long() - t.rank * logits.shape[-1]
        mine = (local >= 0) & (local < logits.shape[-1])
        gold = torch.gather(logits, -1, torch.where(
            mine, local, torch.zeros_like(local))[..., None])[..., 0]
        gold = comm.reduce_from_model(torch.where(mine, gold, 0.0), t)
        return torch.sum(lse - gold)

    bounds = [(i * chunk, (i + 1) * chunk) for i in range(nc)]
    if S > nc * chunk:
        bounds.append((nc * chunk, S))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for a, b in bounds:
        total = total + checkpoint(chunk_loss, h[:, a:b], labels[:, a:b],
                                   use_reentrant=False)
    denom = B * S * (cfg.num_codebooks if cfg.num_codebooks > 1 else 1)
    return total / denom
