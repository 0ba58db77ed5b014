"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

GQA with QKV bias. [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ArchConfig, AttnSpec, GroupSpec, register

CONFIG = register(ArchConfig(
    name="qwen2-7b",
    family="dense",
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    groups=(GroupSpec(unit=(AttnSpec(qkv_bias=True),), repeat=28),),
    mlp_gated=True,
    tie_embeddings=False,
    rope_theta=1000000.0,
    subquadratic=False,
    microbatches=4,
))
