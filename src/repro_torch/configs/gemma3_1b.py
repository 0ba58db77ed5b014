"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5:1 local:global sliding-window pattern (window=512), 128k context.
[hf:google/gemma-3-1b-pt; unverified]

26 layers = 4 × (5 local + 1 global) + 2 local tail.
Sub-quadratic eligible for long_500k: 22/26 layers have window-512 caches;
the 4 global layers decode linearly against the full cache.
"""
from repro_torch.configs.base import ArchConfig, AttnSpec, GroupSpec, register

_LOCAL = AttnSpec(window=512)
_GLOBAL = AttnSpec(window=None)

CONFIG = register(ArchConfig(
    name="gemma3-1b",
    family="dense",
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    groups=(
        GroupSpec(unit=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL), repeat=4),
        GroupSpec(unit=(_LOCAL, _LOCAL), repeat=1),
    ),
    mlp_gated=True,
    tie_embeddings=True,
    max_seq_len=131072,
    rope_theta=1000000.0,
    subquadratic=True,
    microbatches=2,
))
