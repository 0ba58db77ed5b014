"""moonlight-16b-a3b [moe]: Moonlight-16B-A3B as published
(moonshotai/Moonlight-16B-A3B, ``config.json``, model_type deepseek_v3).

27 layers of width 2048: multi-head latent attention in every layer (16
heads; kv_lora_rank 512, no query latent, qk_nope_head_dim 128,
qk_rope_head_dim 64, v_head_dim 128; rope_theta 50,000); layer 0 a dense
SwiGLU MLP of 11,264 (first_k_dense_replace 1), the other 26 a mixture of
64 routed experts of 1,408, top 6, scored by a sigmoid and picked by the
scores plus a selection bias (noaux_tc, one group), the chosen scores
renormalised and scaled by 2.446, beside 2 shared experts (one gated MLP
of 2,816); vocabulary 163,840, embeddings untied, context 8,192.

Departures: RMSNorm held as 1 + scale; rotary embedding with halves
rotated, where the source pairs interleaved dimensions (a fixed
permutation of the rope columns of the query and latent projections); the
experts' capacity dispatch kept with a factor of 11.0, which drops no
token (``int(11.0 * T * 6 / 64) >= T``; 64/6 in floating point would
drop one at T = 7).
"""
from repro_torch.configs.base import (ArchConfig, GroupSpec, MLASpec,
                                      MoESpec, register)

DENSE = MLASpec()
SPARSE = MLASpec(moe=MoESpec(routed_scale=2.446, shared_d_ff=2 * 1408))

CONFIG = register(ArchConfig(
    name="moonlight-16b-a3b",
    family="moe",
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=11264,
    vocab_size=163840,
    groups=(GroupSpec(unit=(DENSE,), repeat=1),
            GroupSpec(unit=(SPARSE,), repeat=26)),
    mlp_gated=True,
    moe_experts=64,
    moe_topk=6,
    moe_d_ff=1408,
    moe_capacity_factor=11.0,
    tie_embeddings=False,
    max_seq_len=8192,
    rope_theta=50000.0,
    norm_eps=1e-5,
    subquadratic=False,
))
