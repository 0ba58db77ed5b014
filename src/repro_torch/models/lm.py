"""Unified causal LM over the model families: attention (dense or MoE
MLP), latent attention (MLA, dense or MoE MLP per block), Mamba2, mLSTM
and sLSTM blocks.

Layer stacks are (unit pattern) x repeat groups (configs/base.py).  As in
the reference, the params of each block position in a unit are stacked
over ``repeat`` (leading axis) and so are the caches; blocks marked
``shared=True`` (zamba2's attention) hold ONE param set at group level,
while their caches are still per application (stacked).  The reference
scans over the repeat axis; here ``scan.scan``, a Python loop, applies
the repeats in order.  In training each application of a unit is
checkpointed by the remat policy (``_remat``).

API:
  init_params(cfg, generator, device)
  forward(params, cfg, tokens)                       -> hidden (B,S,D)
  loss_fn(params, cfg, tokens, labels)               -> scalar
  logits_fn(params, cfg, tokens)                     -> logits
  prefill(params, cfg, tokens, cache_len, q_chunk)   -> (last_logits, caches)
  decode_step(params, cfg, caches, token, pos)       -> (logits, caches)
  init_cache(cfg, batch, cache_len, dtype, device)
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import _dtypes
from repro_torch.configs.base import (ArchConfig, AttnSpec, MambaSpec,
                                      MLASpec, MLSTMSpec, SLSTMSpec)
from repro_torch.distributed import comm, ctx
from repro_torch.distributed.sharding import model_partial
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.scan import scan


def _has_mlp(cfg: ArchConfig, spec) -> bool:
    return isinstance(spec, AttnSpec) and (cfg.d_ff > 0 or cfg.moe_experts > 0)


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------

class _Recurrent(NamedTuple):
    """A recurrent block family: its params' key in the block, and its
    functions (the prefill forward returns the final state)."""
    key: str
    init: Callable
    forward: Callable
    decode: Callable
    init_cache: Callable


_RECURRENT = {
    MambaSpec: _Recurrent("mamba", SSM.init_mamba, SSM.mamba_forward,
                          SSM.mamba_decode, SSM.init_mamba_cache),
    MLSTMSpec: _Recurrent("mlstm", XL.init_mlstm, XL.mlstm_forward,
                          XL.mlstm_decode, XL.init_mlstm_cache),
    SLSTMSpec: _Recurrent("slstm", XL.init_slstm, XL.slstm_forward,
                          XL.slstm_decode, XL.init_slstm_cache),
}


def _family(spec):
    """The spec's recurrent family, or None for an attention block."""
    fam = _RECURRENT.get(type(spec))
    if fam is None and not isinstance(spec, (AttnSpec, MLASpec)):
        raise TypeError(spec)
    return fam


def _init_mla_block(gen, cfg, spec, kw):
    p = {"norm1": L.init_rms_norm(cfg.d_model, **kw),
         "attn": MLA.init_mla(gen, cfg, spec, **kw),
         "norm2": L.init_rms_norm(cfg.d_model, **kw)}
    if spec.moe is not None:
        p["moe"] = MOE.init_moe(gen, cfg, moe=spec.moe, **kw)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, **kw)
    return p


def block_mlp(params, h, cfg, spec):
    """The block's tail on the residual ``h``: ``h`` plus, on its second
    norm, its MoE (``params["moe"]``, routed by the spec's ``MoESpec``
    where it has one) or its dense MLP (``params["mlp"]``); ``h`` itself
    where the block has neither."""
    if "moe" not in params and "mlp" not in params:
        return h
    hn2 = L.rms_norm(h, params["norm2"]["scale"], cfg.norm_eps)
    if "moe" in params:
        return h + MOE.moe_mlp(params["moe"], hn2, cfg,
                               moe=getattr(spec, "moe", None))
    return h + L.mlp(params["mlp"], hn2, cfg.mlp_gated,
                     tp=L.split_over(cfg.d_ff))


# each attention block's one-token decode over a paged cache, by its spec's
# type; one signature (``layers.attention_paged_decode``)
PAGED_DECODE = {AttnSpec: L.attention_paged_decode,
                MLASpec: MLA.mla_paged_decode}


def init_block(gen, cfg, spec, device=None, stack=None):
    kw = dict(device=device, stack=stack)
    if isinstance(spec, MLASpec):
        return _init_mla_block(gen, cfg, spec, kw)
    fam = _family(spec)
    if fam is not None:
        return {"norm1": L.init_rms_norm(cfg.d_model, **kw),
                fam.key: fam.init(gen, cfg, spec, **kw)}
    p = {"norm1": L.init_rms_norm(cfg.d_model, **kw),
         "attn": L.init_attention(gen, cfg, spec, **kw)}
    if _has_mlp(cfg, spec):
        p["norm2"] = L.init_rms_norm(cfg.d_model, **kw)
        if cfg.moe_experts:
            p["moe"] = MOE.init_moe(gen, cfg, **kw)
        else:
            p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                                  **kw)
    return p


def apply_block(params, h, cfg, spec, *, mode, positions=None, cache=None,
                pos=None, cache_len=0, q_chunk=1024, exact_causal=False):
    """mode: train | prefill | decode. Returns (h, cache_out_or_None)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got "
                         f"{mode!r}")
    fam = _family(spec)
    hn = L.rms_norm(h, params["norm1"]["scale"], cfg.norm_eps)
    cache_out = None
    if fam is not None:
        if mode == "decode":
            y, cache_out = fam.decode(params[fam.key], hn, cfg, spec, cache)
        elif mode == "prefill":
            y, cache_out = fam.forward(params[fam.key], hn, cfg, spec,
                                       return_state=True)
        else:
            y = fam.forward(params[fam.key], hn, cfg, spec)
        return h + y, cache_out

    if isinstance(spec, MLASpec):
        if mode == "train":
            a = MLA.mla_train(params["attn"], hn, spec, cfg, positions,
                              q_chunk)
        elif mode == "prefill":
            a, cache_out = MLA.mla_prefill(params["attn"], hn, spec, cfg,
                                           positions, cache_len, q_chunk)
        else:
            a, cache_out = MLA.mla_decode(params["attn"], hn, spec, cfg,
                                          cache, pos)
    elif mode == "train":
        a = L.attention_train(params["attn"], hn, spec, cfg, positions,
                              q_chunk=q_chunk,
                              exact_causal_slices=exact_causal)
    elif mode == "prefill":
        a, cache_out = L.attention_prefill(params["attn"], hn, spec, cfg,
                                           positions, cache_len,
                                           q_chunk=q_chunk)
    else:
        a, cache_out = L.attention_decode(params["attn"], hn, spec, cfg,
                                          cache, pos)
    return block_mlp(params, h + a, cfg, spec), cache_out


def init_block_cache(cfg, spec, batch, cache_len, dtype, device=None):
    if isinstance(spec, MLASpec):
        return MLA.init_cache(cfg, spec, batch, cache_len, dtype, device)
    fam = _family(spec)
    if fam is None:
        return L.init_attn_cache(cfg, spec, batch, cache_len, dtype, device)
    return fam.init_cache(cfg, spec, batch, dtype, device)


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


def init_cache(cfg: ArchConfig, batch, cache_len, dtype=torch.bfloat16,
               device="cuda"):
    """Zero caches of every block, stacked over its group's repeats (a
    shared block keeps one cache per application)."""
    dtype = _dtypes.torch_dtype(dtype)
    groups = []
    for g in cfg.groups:
        blocks = []
        for spec in g.unit:
            single = init_block_cache(cfg, spec, batch, cache_len, dtype,
                                      device)
            blocks.append({k: torch.zeros((g.repeat,) + tuple(v.shape),
                                          dtype=v.dtype, device=v.device)
                           for k, v in single.items()})
        groups.append({"blocks": blocks})
    return {"groups": groups}


def _index_tree(tree, r):
    if isinstance(tree, dict):
        return {k: _index_tree(v, r) for k, v in tree.items()}
    return tree[r]


# ---------------------------------------------------------------------------
# forward / loss / prefill / decode
# ---------------------------------------------------------------------------


def _save_weight_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of weight products with no
    batch dimension (``aten.mm``, and ``aten.bmm`` over a batch of one,
    which is what ``einsum`` makes of a projection) and recompute the
    rest, batched products (attention scores, expert products) included:
    the torch reading of jax's ``dots_with_no_batch_dims_saveable``."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` checkpointed by ``policy``: "none" keeps every activation,
    "full" recomputes all of ``fn`` in the backward pass, "dots" keeps the
    weight products' outputs and recomputes the rest.  All three give the
    same numbers; only memory and time differ."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_weight_products))
    raise ValueError(f"remat policy must be none, full or dots, got "
                     f"{policy!r}")


def _unit_params(cfg, gi, gp, r):
    """The params of each block of repeat ``r`` of group ``gi``: a shared
    block's one set, or the r-th slice of a stacked one.  A DTensor leaf
    (the sharded step and serve functions pass the group leaves so) is
    gathered over the fsdp axes here, one layer's slice at a time
    (``comm.gather_layer``), inside the loop and, in training, inside the
    checkpointed unit, so that its recompute gathers again."""
    g = cfg.groups[gi]
    return [_layer_leaves(cfg, bp, f"groups/{gi}/blocks/{bi}",
                          None if getattr(spec, "shared", False) else r)
            for bi, (spec, bp) in enumerate(zip(g.unit, gp["blocks"]))]


def _layer_leaves(cfg, tree, name, r):
    if isinstance(tree, dict):
        return {k: _layer_leaves(cfg, v, f"{name}/{k}", r)
                for k, v in tree.items()}
    if isinstance(tree, DTensor):
        env = ctx.get_env()
        tp = (ctx.tp_of(env) if model_partial(name, tuple(tree.shape), cfg,
                                               env) else None)
        return comm.gather_layer(tree, r, env.fsdp, [
            i for i, a in enumerate(env.axes) if a in env.dp], tp)
    return tree if r is None else tree[r]


def _run_groups(params, cfg, h, *, mode, positions=None, caches=None,
                pos=None, cache_len=0, q_chunk=1024, exact_causal=False,
                remat="none"):
    """Apply every group's repeats in order; returns (h, new_caches) with
    each block's cache stacked over its group's repeats, or (h, None) in
    training, where each application of a unit is checkpointed by
    ``remat``."""
    if mode == "train":
        for gi, (g, gp) in enumerate(zip(cfg.groups, params["groups"])):
            def step(r, h, _g=g, _gp=gp, _gi=gi):
                def unit_fn(h):
                    for spec, bp in zip(_g.unit,
                                        _unit_params(cfg, _gi, _gp, r)):
                        h, _ = apply_block(bp, h, cfg, spec, mode="train",
                                           positions=positions,
                                           q_chunk=q_chunk,
                                           exact_causal=exact_causal)
                    return h
                return _remat(unit_fn, remat)(h), None
            h, _ = scan(step, h, g.repeat)
        return h, None

    new_groups = []
    for gi, (g, gp) in enumerate(zip(cfg.groups, params["groups"])):
        gc = caches["groups"][gi] if caches is not None else None
        keys = []

        def step(r, h, g=g, gp=gp, gc=gc, keys=keys, gi=gi):
            out = []
            for bi, (spec, bp) in enumerate(zip(
                    g.unit, _unit_params(cfg, gi, gp, r))):
                c = (_index_tree(gc["blocks"][bi], r) if gc is not None
                     else None)
                h, co = apply_block(bp, h, cfg, spec, mode=mode,
                                    positions=positions, cache=c, pos=pos,
                                    cache_len=cache_len, q_chunk=q_chunk)
                if len(keys) < len(g.unit):     # the first trip's
                    keys.append(list(co))
                out += [co[k][None] for k in co]
            return h, out

        h, stacked = scan(step, h, g.repeat, dim=0)
        it = iter(stacked)
        new_groups.append({"blocks": [{k: next(it) for k in ks}
                                      for ks in keys]})
    return h, {"groups": new_groups}


def forward(params, cfg: ArchConfig, tokens, q_chunk=1024, exact_causal=False,
            remat: Optional[str] = None):
    """Final-norm hidden states (B, S, D) of the whole sequence; ``remat``
    None takes the config's policy."""
    dt = _dtypes.torch_dtype(cfg.compute_dtype)
    h = L.embed_tokens(params["embed"], cfg, tokens, dt)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, _ = _run_groups(params, cfg, h, mode="train", positions=positions,
                       q_chunk=q_chunk, exact_causal=exact_causal,
                       remat=remat if remat is not None else cfg.remat_policy)
    return L.rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)


def loss_fn(params, cfg: ArchConfig, tokens, labels, q_chunk=1024,
            exact_causal=False, remat=None, xent_chunk=256):
    h = forward(params, cfg, tokens, q_chunk, exact_causal, remat)
    return L.chunked_xent(params["embed"], cfg, h, labels, chunk=xent_chunk)


def logits_fn(params, cfg: ArchConfig, tokens, **kw):
    h = forward(params, cfg, tokens, **kw)
    return L.output_logits(params["embed"], cfg, h)


def prefill(params, cfg: ArchConfig, tokens, cache_len, q_chunk=1024):
    dt = _dtypes.torch_dtype(cfg.compute_dtype)
    h = L.embed_tokens(params["embed"], cfg, tokens, dt)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    h, caches = _run_groups(params, cfg, h, mode="prefill",
                            positions=positions, cache_len=cache_len,
                            q_chunk=q_chunk)
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
