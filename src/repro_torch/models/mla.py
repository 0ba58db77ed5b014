"""Multi-head latent attention (MLA, DeepSeek-V2/V3) for the MLASpec
block: train-mode forward, prefill with its cache, and one-token decode.

Per token, with x the normed input and H heads:

- queries ``q = x wq`` (d -> H x (nope + rope)), split per head into
  ``q_nope`` and ``q_pe``; ``q_pe`` is roped;
- the latent and the shared rotary key ``[c, k_pe] = x wkv_a`` (d ->
  kv_lora + rope); ``c = RMSNorm(c)`` (``kv_norm``, held as 1 + scale);
  ``k_pe`` is roped once and shared by every head;
- each head's key and value ``[k_nope_h, v_h] = c wkv_b[:, h]``;
- ``s_h = [q_nope_h, q_pe_h] . [k_nope_h, k_pe] * (nope + rope)^-0.5``,
  causal softmax, ``o_h = sum p v_h``, then ``wo`` (H x v -> d).

Rotary embedding is the port's (halves rotated, frequencies
``theta^(-2i/rope)``) on the rope dimensions.

Train and prefill compute this expanded form.  The cache holds one row
per token, ``[c, k_pe]`` (``spec.latent_dim`` wide, as (B, S, 1,
latent_dim): one latent "KV head"), and decode attends over it in the
absorbed form: each head's query becomes ``[q_nope_h wkv_b[:, h, :nope]^T,
q_pe_h]``, scored against the row, and its output ``(sum p c)
wkv_b[:, h, nope:]``: the same function in another order, equal up to
rounding.  ``mla_paged_decode`` is that decode over a paged cache, through
the latent kernel (``kernels/paged_attention/latent.py``): the serving
engine's, and ``mla_decode``'s over its dense cache.

The block has no sharded layout: under an env that splits over ``model``
(tensor or expert parallel), or splits rows or the cache over the data
axes, every function here raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import ctx
from repro_torch.kernels.paged_attention.latent import latent_attention
from repro_torch.models.layers import (NEG_INF, apply_rope, init_rms_norm,
                                       ninit, rms_norm)


def refuse_sharding() -> None:
    """Raise where the installed env would shard an MLA block."""
    env = ctx.get_env()
    if env is None:
        return
    if env.msize > 1:
        raise NotImplementedError(
            "latent attention has no tensor- or expert-parallel layout: its "
            "latent and shared rotary key are one row for all heads")
    if ctx.batch_groups() or ctx.seq_split() is not None:
        raise NotImplementedError(
            "latent attention has no data- or sequence-parallel layout for "
            "its rows or its latent cache")


def init_mla(gen, cfg, spec, device=None, stack=None):
    d, H = cfg.d_model, cfg.num_heads
    kw = dict(device=device, stack=stack)
    return {
        "wq": ninit(gen, (d, H, spec.qk_head_dim), **kw),
        "wkv_a": ninit(gen, (d, spec.latent_dim), **kw),
        "kv_norm": init_rms_norm(spec.kv_lora_rank, **kw),
        "wkv_b": ninit(gen, (spec.kv_lora_rank, H,
                             spec.qk_nope_head_dim + spec.v_head_dim), **kw),
        "wo": ninit(gen, (H, spec.v_head_dim, d),
                    scale=(H * spec.v_head_dim) ** -0.5, **kw),
    }


def init_cache(cfg, spec, batch, cache_len, dtype, device=None):
    return {"c": torch.zeros((batch, cache_len, 1, spec.latent_dim),
                             dtype=dtype, device=device)}


def scale_of(spec) -> float:
    return spec.qk_head_dim ** -0.5


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------


def _queries(params, x, spec, cfg, positions):
    """(q_nope (B,S,H,nope), q_pe (B,S,H,rope) roped)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    q_nope, q_pe = q.split([spec.qk_nope_head_dim, spec.qk_rope_head_dim], -1)
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta)


def latent_rows(params, x, spec, cfg, positions):
    """The cached rows ``[RMSNorm(c), rope(k_pe)]`` of ``x`` (B, S, d):
    (B, S, latent_dim)."""
    ckv = x @ params["wkv_a"].to(x.dtype)
    c, k_pe = ckv.split([spec.kv_lora_rank, spec.qk_rope_head_dim], -1)
    c = rms_norm(c, params["kv_norm"]["scale"], cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None], positions, cfg.rope_theta)[:, :, 0]
    return torch.cat([c, k_pe], -1)


def _expanded(params, x, spec, cfg, positions):
    """Per-head queries, keys and values of the expanded form, and the
    rows: (q, k (B,S,H,nope+rope), v (B,S,H,v), rows)."""
    H = cfg.num_heads
    q_nope, q_pe = _queries(params, x, spec, cfg, positions)
    rows = latent_rows(params, x, spec, cfg, positions)
    c, k_pe = rows.split([spec.kv_lora_rank, spec.qk_rope_head_dim], -1)
    kv = torch.einsum("bsc,chk->bshk", c, params["wkv_b"].to(x.dtype))
    k_nope, v = kv.split([spec.qk_nope_head_dim, spec.v_head_dim], -1)
    k_pe = k_pe[:, :, None].expand(-1, -1, H, -1)
    return (torch.cat([q_nope, q_pe], -1), torch.cat([k_nope, k_pe], -1), v,
            rows)


def _causal(q, k, v, scale, q_chunk):
    """Causal attention of every query; q, k (B,S,H,dk), v (B,S,H,dv) ->
    (B,S,H,dv).  Queries go in chunks of ``q_chunk``, each against the
    keys up to its own end."""
    S = q.shape[1]
    outs = []
    for a in range(0, S, q_chunk):
        b = min(a + q_chunk, S)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, a:b], k[:, :b]).float()
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(b, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s * scale,
                        torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v[:, :b]))
    return torch.cat(outs, dim=1)


def _out(params, o, dt):
    return torch.einsum("bshv,hvd->bsd", o, params["wo"].to(dt))


# ---------------------------------------------------------------------------
# train / prefill / decode
# ---------------------------------------------------------------------------


def mla_train(params, x, spec, cfg, positions, q_chunk=1024):
    refuse_sharding()
    q, k, v, _ = _expanded(params, x, spec, cfg, positions)
    return _out(params, _causal(q, k, v, scale_of(spec), q_chunk), x.dtype)


def mla_prefill(params, x, spec, cfg, positions, cache_len, q_chunk=1024):
    """Causal attention over the prompt, and the latent cache of
    ``cache_len`` positions (rows past the prompt zero)."""
    refuse_sharding()
    q, k, v, rows = _expanded(params, x, spec, cfg, positions)
    y = _out(params, _causal(q, k, v, scale_of(spec), q_chunk), x.dtype)
    c = rows[:, :cache_len, None]
    c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, cache_len - c.shape[1]))
    return y, {"c": c}


def absorb(params, x, spec, cfg, pos):
    """One token's absorbed queries and its cached row: x (B, 1, d), pos
    (B,) -> (q (B, H, latent_dim), row (B, latent_dim))."""
    q_nope, q_pe = _queries(params, x, spec, cfg, pos[:, None])
    w_uk = params["wkv_b"][..., :spec.qk_nope_head_dim].to(x.dtype)
    q_lat = torch.einsum("bhn,chn->bhc", q_nope[:, 0], w_uk)
    row = latent_rows(params, x, spec, cfg, pos[:, None])[:, 0]
    return torch.cat([q_lat, q_pe[:, 0]], -1), row


def unabsorb(params, o_lat, spec, dt):
    """Each head's output from its latent output: o_lat (B, H, kv_lora)
    -> the block's output (B, 1, d)."""
    w_uv = params["wkv_b"][..., spec.qk_nope_head_dim:].to(dt)
    o = torch.einsum("bhc,chv->bhv", o_lat, w_uv)
    return _out(params, o[:, None], dt)


def mla_paged_decode(params, x, spec, cfg, pos, *, write, frames, tables,
                     lengths, backend="auto"):
    """One token's latent attention over a paged latent cache: x (B, 1,
    d), pos (B,).  Its absorbed queries; its row stored by ``write(rows
    (B, 1, latent_dim), None)``; the latent kernel over the rows of
    ``frames`` (F, Tp, [1,] latent_dim) through ``tables[0]`` (B, W) up to
    ``lengths`` (B,); the heads' outputs un-absorbed: (B, 1, d)."""
    refuse_sharding()
    q, row = absorb(params, x, spec, cfg, pos)
    write(row[:, None], None)
    o = latent_attention(q, frames, tables[0], lengths,
                         dv=spec.kv_lora_rank, scale=scale_of(spec),
                         backend=backend)
    return unabsorb(params, o, spec, x.dtype)


def mla_decode(params, x, spec, cfg, cache, pos):
    """One-token decode over a dense latent cache (B, Smax, 1, latent_dim):
    ``mla_paged_decode`` over it as B pages of Smax slots, sequence b in
    page b, the row written at ``pos``, positions ``<= pos`` attended."""
    c = cache["c"].clone()
    B, Smax = c.shape[:2]
    bidx = torch.arange(B, device=x.device)

    def write(rows, _):
        c[bidx, pos.to(torch.long)] = rows

    y = mla_paged_decode(params, x, spec, cfg, pos, write=write,
                         frames=c.view(B, Smax, -1),
                         tables=(bidx[:, None].int(),), lengths=pos + 1,
                         backend="torch")
    return y, {"c": c}
