"""Causal LM over the attention architectures.

Layer stacks are (unit pattern) x repeat groups (configs/base.py).  As in
the reference, the params of each block position in a unit are stacked
over ``repeat`` (leading axis) and so are the caches; blocks marked
``shared=True`` hold ONE param set at group level.  The reference scans
over the repeat axis; here a Python loop applies the repeats in order.

Only attention blocks (dense MLP) are ported.  MoE, Mamba and xLSTM
blocks raise ``NotImplementedError`` (ROADMAP queue A, "other model
families").

API:
  init_params(cfg, generator, device)
  prefill(params, cfg, tokens, cache_len)            -> (last_logits, caches)
  decode_step(params, cfg, caches, token, pos)       -> (logits, caches)
"""
from __future__ import annotations

import torch

from repro_torch import _dtypes
from repro_torch.configs.base import ArchConfig, AttnSpec
from repro_torch.models import layers as L

_UNPORTED = ("not ported yet: MoE, Mamba and xLSTM blocks are ROADMAP "
             "queue A, 'other model families'")


def _check_spec(cfg: ArchConfig, spec) -> None:
    if not isinstance(spec, AttnSpec):
        raise NotImplementedError(f"{type(spec).__name__} {_UNPORTED}")
    if cfg.moe_experts:
        raise NotImplementedError(f"MoE MLP {_UNPORTED}")


def _has_mlp(cfg: ArchConfig, spec) -> bool:
    return isinstance(spec, AttnSpec) and (cfg.d_ff > 0 or cfg.moe_experts > 0)


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------


def init_block(gen, cfg, spec, device=None, stack=None):
    _check_spec(cfg, spec)
    kw = dict(device=device, stack=stack)
    p = {"norm1": L.init_rms_norm(cfg.d_model, **kw),
         "attn": L.init_attention(gen, cfg, spec, **kw)}
    if _has_mlp(cfg, spec):
        p["norm2"] = L.init_rms_norm(cfg.d_model, **kw)
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, **kw)
    return p


def apply_block(params, h, cfg, spec, *, mode, positions=None, cache=None,
                pos=None, cache_len=0):
    """mode: prefill | decode. Returns (h, cache_out)."""
    _check_spec(cfg, spec)
    hn = L.rms_norm(h, params["norm1"]["scale"], cfg.norm_eps)
    if mode == "prefill":
        a, cache_out = L.attention_prefill(params["attn"], hn, spec, cfg,
                                           positions, cache_len)
    elif mode == "decode":
        a, cache_out = L.attention_decode(params["attn"], hn, spec, cfg,
                                          cache, pos)
    else:
        raise ValueError(f"mode must be prefill or decode, got {mode!r}")
    h = h + a
    if _has_mlp(cfg, spec):
        hn2 = L.rms_norm(h, params["norm2"]["scale"], cfg.norm_eps)
        h = h + L.mlp(params["mlp"], hn2, cfg.mlp_gated)
    return h, cache_out


# ---------------------------------------------------------------------------
# params / cache init
# ---------------------------------------------------------------------------


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


def init_params(cfg: ArchConfig, generator: torch.Generator, device="cuda"):
    """Random parameters with the reference's structure, names, shapes and
    init scales.  The numbers differ from jax's PRNG; tests that compare
    with the reference carry its parameters across (models/convert.py)."""
    groups = []
    for g in cfg.groups:
        blocks = []
        for spec in g.unit:
            stack = None if getattr(spec, "shared", False) else g.repeat
            blocks.append(init_block(generator, cfg, spec, device, stack))
        groups.append({"blocks": blocks})
    params = {
        "embed": L.init_embed(generator, cfg, device),
        "groups": groups,
        "final_norm": L.init_rms_norm(cfg.d_model, device),
    }
    if cfg.param_dtype != "float32":
        params = _cast_tree(params, _dtypes.torch_dtype(cfg.param_dtype))
    return params


def _index_tree(tree, r):
    if isinstance(tree, dict):
        return {k: _index_tree(v, r) for k, v in tree.items()}
    return tree[r]


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def _run_groups(params, cfg, h, *, mode, positions=None, caches=None,
                pos=None, cache_len=0):
    """Apply every group's repeats in order; returns (h, new_caches) with
    each block's cache stacked over its group's repeats."""
    new_groups = []
    for gi, (g, gp) in enumerate(zip(cfg.groups, params["groups"])):
        gc = caches["groups"][gi] if caches is not None else None
        per_block = [[] for _ in g.unit]
        for r in range(g.repeat):
            for bi, spec in enumerate(g.unit):
                bp = gp["blocks"][bi]
                if not getattr(spec, "shared", False):
                    bp = _index_tree(bp, r)
                c = (_index_tree(gc["blocks"][bi], r) if gc is not None
                     else None)
                h, co = apply_block(bp, h, cfg, spec, mode=mode,
                                    positions=positions, cache=c, pos=pos,
                                    cache_len=cache_len)
                per_block[bi].append(co)
        new_groups.append({"blocks": [
            {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
            for cs in per_block]})
    return h, {"groups": new_groups}


def prefill(params, cfg: ArchConfig, tokens, cache_len):
    dt = _dtypes.torch_dtype(cfg.compute_dtype)
    h = L.embed_tokens(params["embed"], cfg, tokens, dt)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    h, caches = _run_groups(params, cfg, h, mode="prefill",
                            positions=positions, cache_len=cache_len)
    h = L.rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    logits = L.output_logits(params["embed"], cfg, h[:, -1:])[:, 0]
    return logits, caches


def decode_step(params, cfg: ArchConfig, caches, token, pos):
    """token: (B,) int (or (B,CB) multi-codebook); pos: (B,) absolute."""
    dt = _dtypes.torch_dtype(cfg.compute_dtype)
    tok = token[:, None] if token.dim() == 1 else token[:, None, :]
    h = L.embed_tokens(params["embed"], cfg, tok, dt)
    h, caches = _run_groups(params, cfg, h, mode="decode", caches=caches,
                            pos=pos)
    h = L.rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    logits = L.output_logits(params["embed"], cfg, h)[:, 0]
    return logits, caches
