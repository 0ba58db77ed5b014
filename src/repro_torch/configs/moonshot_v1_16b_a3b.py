"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (MHA kv=16) d_ff=1408(expert)
vocab=163840, MoE 64 experts top-6 (kimi/moonlight lineage).

Assigned dims followed literally (all-MoE, gated experts).  The sizes echo
moonshotai/Moonlight-16B-A3B, but the block is not Moonlight's: plain
multi-head attention where Moonlight has latent attention, softmax
routing where it scores by a sigmoid with a selection bias, no shared
experts, no leading dense layer, 48 layers where it has 27.  The
published block is ``moonlight_16b_a3b`` (``moonlight-16b-a3b``).
"""
from repro_torch.configs.base import ArchConfig, AttnSpec, GroupSpec, register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=163840,
    groups=(GroupSpec(unit=(AttnSpec(),), repeat=48),),
    mlp_gated=True,
    moe_experts=64,
    moe_topk=6,
    moe_d_ff=1408,
    tie_embeddings=True,
    subquadratic=False,
    microbatches=4,
))
