"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion VQ image tokens. [arXiv:2405.09818; unverified]

Backbone only: chameleon's early fusion means images arrive as discrete VQ
codes *inside the unified 65536 vocab*, so the frontend stub is simply the
token stream (input_specs yields token ids; the VQ-GAN encoder is out of
scope per the assignment). QK-norm enabled, as chameleon requires for
stability at this scale.
"""
from repro_torch.configs.base import ArchConfig, AttnSpec, GroupSpec, register

CONFIG = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    groups=(GroupSpec(unit=(AttnSpec(qk_norm=True),), repeat=48),),
    mlp_gated=True,
    tie_embeddings=False,
    subquadratic=False,
    microbatches=16,
))
