"""stablelm-3b [dense]: 32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.

[hf:stabilityai/stablelm-2-1_6b; unverified] — config as assigned.
"""
from repro_torch.configs.base import ArchConfig, AttnSpec, GroupSpec, register

CONFIG = register(ArchConfig(
    name="stablelm-3b",
    family="dense",
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    groups=(GroupSpec(unit=(AttnSpec(),), repeat=32),),
    mlp_gated=True,
    tie_embeddings=False,
    subquadratic=False,
    microbatches=2,
))
