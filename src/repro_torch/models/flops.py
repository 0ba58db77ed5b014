"""Analytic parameter & MODEL_FLOPS accounting (no allocation).

MODEL_FLOPS convention used in EXPERIMENTS.md §Roofline:
  train   : 6 * N_active_nonembed * tokens + 6 * d_model * vocab * tokens (head)
  prefill : 2 * N_active_nonembed * tokens + 2 * d_model * vocab * batch (last-pos head)
  decode  : 2 * N_active_nonembed * batch  + 2 * d_model * vocab * batch
            + attention-score term 2 * 2 * H * hd * kv_len * batch per attn layer
"""
from __future__ import annotations

from repro_torch.configs.base import (ArchConfig, AttnSpec, MambaSpec,
                                      MLASpec, MLSTMSpec, SLSTMSpec,
                                      ShapeConfig)


def _attn_block_params(cfg: ArchConfig, spec: AttnSpec, active: bool):
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n = d * h * hd + 2 * d * k * hd + h * hd * d          # q,k,v,o
    if spec.qkv_bias:
        n += h * hd + 2 * k * hd
    if spec.qk_norm:
        n += 2 * hd
    n += d                                                # norm1
    if cfg.moe_experts:
        e = cfg.moe_topk if active else cfg.moe_experts
        per = cfg.d_model * cfg.moe_d_ff * (3 if cfg.mlp_gated else 2)
        n += e * per + cfg.d_model * cfg.moe_experts + d  # experts + router + norm2
    elif cfg.d_ff:
        n += cfg.d_model * cfg.d_ff * (3 if cfg.mlp_gated else 2) + d
    return n


def _mla_block_params(cfg: ArchConfig, spec: MLASpec, active: bool):
    d, h = cfg.d_model, cfg.num_heads
    n = (d * h * spec.qk_head_dim + d * spec.latent_dim      # wq, wkv_a
         + spec.kv_lora_rank                                 # kv_norm
         + spec.kv_lora_rank * h * (spec.qk_nope_head_dim + spec.v_head_dim)
         + h * spec.v_head_dim * d + d)                      # wo, norm1
    if spec.moe is None:
        return n + 3 * d * cfg.d_ff + d                      # dense, norm2
    # experts, router and its bias, shared experts, norm2
    e = cfg.moe_topk if active else cfg.moe_experts
    return (n + e * 3 * d * cfg.moe_d_ff + d * cfg.moe_experts
            + cfg.moe_experts + 3 * d * spec.moe.shared_d_ff + d)


def _mla_attn_flops(cfg, spec, q_len, ctx) -> float:
    """Scores over the query and rope dims, values over the value dims, of
    ``q_len`` queries against ``ctx`` keys each (the expanded form)."""
    return (2 * cfg.num_heads * (spec.qk_head_dim + spec.v_head_dim)
            * q_len * ctx)


def _mamba_block_params(cfg, spec):
    d = cfg.d_model
    d_inner = spec.expand * d
    H = d_inner // spec.head_dim
    N = spec.d_state
    conv_ch = d_inner + 2 * N
    return (d * (2 * d_inner + 2 * N + H)        # in_proj
            + spec.d_conv * conv_ch + conv_ch    # conv
            + 3 * H                              # A, dt_bias, D
            + d_inner + d_inner * d + d)         # norm, out_proj, norm1


def _mlstm_block_params(cfg, spec):
    d = cfg.d_model
    d_inner = spec.expand * d
    H = spec.num_heads
    return (d * 2 * d_inner + 4 * d_inner + d_inner      # up, conv
            + 3 * d_inner * d_inner                      # q,k,v
            + d_inner * 2 * H + 2 * H                    # gates
            + d_inner + d_inner * d + d)                 # norm, down, norm1


def _slstm_block_params(cfg, spec):
    d = cfg.d_model
    H = spec.num_heads
    dh = d // H
    p = int(spec.proj_factor * d)
    return d * 4 * d + 4 * H * dh * dh + 4 * d + d + d * 2 * p + p * d + d


def block_params(cfg, spec, active=False):
    if isinstance(spec, AttnSpec):
        return _attn_block_params(cfg, spec, active)
    if isinstance(spec, MLASpec):
        return _mla_block_params(cfg, spec, active)
    if isinstance(spec, MambaSpec):
        return _mamba_block_params(cfg, spec)
    if isinstance(spec, MLSTMSpec):
        return _mlstm_block_params(cfg, spec)
    if isinstance(spec, SLSTMSpec):
        return _slstm_block_params(cfg, spec)
    raise TypeError(spec)


def param_counts(cfg: ArchConfig):
    """Returns (total, active, embed) param counts."""
    total = active = 0
    for g in cfg.groups:
        shared_seen = set()
        for bi, spec in enumerate(g.unit):
            if getattr(spec, "shared", False):
                if (id(g), bi) not in shared_seen:
                    total += block_params(cfg, spec)
                    active += block_params(cfg, spec, active=True)
                    shared_seen.add((id(g), bi))
            else:
                total += g.repeat * block_params(cfg, spec)
                active += g.repeat * block_params(cfg, spec, active=True)
    embed = cfg.num_codebooks * cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        embed += cfg.d_model * cfg.num_codebooks * cfg.vocab_size
    total += embed + cfg.d_model
    active += embed + cfg.d_model
    return total, active, embed


def model_flops(cfg: ArchConfig, shape: ShapeConfig):
    """MODEL_FLOPS per the §Roofline convention (global, per step)."""
    total, active, embed = param_counts(cfg)
    nonembed_active = active - embed
    head = cfg.d_model * cfg.num_codebooks * cfg.vocab_size
    B, S = shape.global_batch, shape.seq_len
    if shape.step == "train":
        tokens = B * S
        return 6 * nonembed_active * tokens + 6 * head * tokens
    if shape.step == "prefill":
        tokens = B * S
        # causal attention term: 2(QK)+2(AV) * H*hd * S^2/2 per attn layer
        attn = 0
        for spec in cfg.block_specs():
            if isinstance(spec, AttnSpec):
                ctx = min(spec.window, S) if spec.window else S / 2
                attn += 4 * cfg.num_heads * cfg.head_dim * S * ctx * B
            elif isinstance(spec, MLASpec):
                attn += _mla_attn_flops(cfg, spec, S, S / 2) * B
        return 2 * nonembed_active * tokens + attn + 2 * head * B
    # decode: one token per sequence
    attn = 0
    for spec in cfg.block_specs():
        if isinstance(spec, AttnSpec):
            ctx = min(spec.window, S) if spec.window else S
            attn += 4 * cfg.num_heads * cfg.head_dim * ctx * B
        elif isinstance(spec, MLASpec):
            attn += _mla_attn_flops(cfg, spec, 1, S) * B
    return 2 * nonembed_active * B + attn + 2 * head * B
