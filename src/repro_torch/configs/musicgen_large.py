"""musicgen-large [audio]: 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only per assignment; the EnCodec frontend is a STUB: inputs are the
4 codebook token streams (delay pattern omitted), embeddings are summed, and
the head predicts 4 × 2048 logits. Non-gated GELU MLP (musicgen uses a plain
transformer decoder).
"""
from repro_torch.configs.base import ArchConfig, AttnSpec, GroupSpec, register

CONFIG = register(ArchConfig(
    name="musicgen-large",
    family="audio",
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    groups=(GroupSpec(unit=(AttnSpec(),), repeat=48),),
    mlp_gated=False,
    num_codebooks=4,
    tie_embeddings=False,
    subquadratic=False,
    microbatches=2,
))
