"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

Code model, GPT-BigCode-style: MQA + non-gated (2-matrix) GELU MLP — the
non-gated MLP is what makes the assigned dims total ~34B parameters.
[arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ArchConfig, AttnSpec, GroupSpec, register

CONFIG = register(ArchConfig(
    name="granite-34b",
    family="dense",
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    groups=(GroupSpec(unit=(AttnSpec(),), repeat=88),),
    mlp_gated=False,
    tie_embeddings=True,
    subquadratic=False,
    microbatches=16,
))
