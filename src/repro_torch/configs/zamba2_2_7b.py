"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64 — Mamba2 backbone + ONE shared attention(+MLP) block applied
every 6 mamba blocks (weights shared across applications, as in the paper).
[arXiv:2411.15242; hf]

Simplifications noted in DESIGN.md: per-invocation LoRA deltas on the shared
block are omitted; single shared block rather than two alternating.
"""
from repro_torch.configs.base import ArchConfig, AttnSpec, GroupSpec, MambaSpec, register

_M = MambaSpec(d_state=64, d_conv=4, expand=2, head_dim=64)
_SHARED_ATTN = AttnSpec(shared=True, rope=True)

CONFIG = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    groups=(
        # 9 × (6 mamba + shared attention) = 54 mamba layers + 9 shared-attn
        # applications (one parameter set).
        GroupSpec(unit=(_M, _M, _M, _M, _M, _M, _SHARED_ATTN), repeat=9),
    ),
    mlp_gated=True,
    tie_embeddings=True,
    subquadratic=True,
    microbatches=2,
))
