"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert)
vocab=163840, MoE 384 experts top-8 — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]

We follow the assigned spec (GQA kv=8); the production K2 uses MLA — noted
in DESIGN.md. All layers MoE; ~1.03T total, ~32B active parameters.
"""
from repro_torch.configs.base import ArchConfig, AttnSpec, GroupSpec, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=0,                      # no dense MLP; MoE FFN instead
    vocab_size=163840,
    groups=(GroupSpec(unit=(AttnSpec(),), repeat=61),),
    mlp_gated=True,
    moe_experts=384,
    moe_topk=8,
    moe_d_ff=2048,
    tie_embeddings=False,
    param_dtype="bfloat16",      # 1T fp32 master + Adam does not fit any pod
    subquadratic=False,
    microbatches=16,
))
