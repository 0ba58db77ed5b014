"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks. [arXiv:2405.04517; unverified]

xLSTM[7:1] ratio: each group of 8 = 7 mLSTM + 1 sLSTM; 6 groups = 48 blocks.
mLSTM uses the chunked-parallel (linear-attention) form; sLSTM is a true
recurrence lowered with lax.scan. No separate FFN (blocks carry their own
up/down projections), per the paper.
"""
from repro_torch.configs.base import ArchConfig, GroupSpec, MLSTMSpec, SLSTMSpec, register

_M = MLSTMSpec(expand=2, num_heads=4)
_S = SLSTMSpec(num_heads=4)

CONFIG = register(ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    groups=(GroupSpec(unit=(_M, _M, _M, _M, _M, _M, _M, _S), repeat=6),),
    mlp_gated=True,
    tie_embeddings=True,
    subquadratic=True,
    microbatches=2,
))
