"""Micro configs used by the paper-analogue benchmarks and examples.

These play the role of the paper's evaluated "functions" (hello, json,
pyaes, ..., recognition): model instances of increasing state size, so that
fork/startup/state-transfer costs span the same relative range.
"""
from repro_torch.configs.base import ArchConfig, AttnSpec, GroupSpec, register

# "hello" — minimal instance (≈1 MB state)
MICRO_HELLO = register(ArchConfig(
    name="micro-hello",
    family="dense",
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=256, vocab_size=512,
    groups=(GroupSpec(unit=(AttnSpec(),), repeat=2),),
    tie_embeddings=True, max_seq_len=1024, microbatches=1,
))

# "json" — small instance (≈10 MB state)
MICRO_SMALL = register(ArchConfig(
    name="micro-small",
    family="dense",
    d_model=256, num_heads=8, num_kv_heads=8, head_dim=32,
    d_ff=1024, vocab_size=2048,
    groups=(GroupSpec(unit=(AttnSpec(),), repeat=4),),
    tie_embeddings=True, max_seq_len=2048, microbatches=1,
))

# "image" — medium instance (≈50 MB state)
MICRO_MEDIUM = register(ArchConfig(
    name="micro-medium",
    family="dense",
    d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=8192,
    groups=(GroupSpec(unit=(AttnSpec(),), repeat=6),),
    tie_embeddings=True, max_seq_len=4096, microbatches=1,
))

# "recognition" — large instance (≈150+ MB state); the paper's worst case.
MICRO_LARGE = register(ArchConfig(
    name="micro-large",
    family="dense",
    d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=16384,
    groups=(GroupSpec(unit=(AttnSpec(),), repeat=12),),
    tie_embeddings=True, max_seq_len=4096, microbatches=1,
))

# ~100M-param config for examples/train driver presets.
TRAIN_100M = register(ArchConfig(
    name="train-100m",
    family="dense",
    d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=32768,
    groups=(GroupSpec(unit=(AttnSpec(),), repeat=12),),
    tie_embeddings=True, max_seq_len=2048, microbatches=1,
))
