"""Architecture & shape configuration for the MITOSIS-JAX model zoo.

Every assigned architecture is expressed as an ``ArchConfig`` whose layer
stack is a list of ``GroupSpec``s: a *unit* (ordered tuple of block specs)
repeated ``repeat`` times.  The unified LM (models/lm.py) scans over the
repeat axis, so HLO size is independent of depth — essential for AOT
compiles of 61–88 layer models on 512 logical devices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Block specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Self-attention block (pre-norm, residual, followed by MLP unless
    ``mlp_dim == 0``)."""

    kind: str = "attn"
    window: Optional[int] = None        # sliding-window size; None = global
    shared: bool = False                # zamba2: one param set for all repeats
    qk_norm: bool = False               # chameleon-style
    qkv_bias: bool = False              # qwen2-style
    rope: bool = True


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    """Mamba2 (SSD) block."""

    kind: str = "mamba"
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64                  # SSD head dim (P)
    shared: bool = False


@dataclasses.dataclass(frozen=True)
class MLSTMSpec:
    kind: str = "mlstm"
    expand: int = 2
    num_heads: int = 4
    shared: bool = False


@dataclasses.dataclass(frozen=True)
class SLSTMSpec:
    kind: str = "slstm"
    num_heads: int = 4
    proj_factor: float = 4.0 / 3.0
    shared: bool = False


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """A mixture of experts whose router scores each expert by a sigmoid
    and picks the top-k of the scores plus a selection bias (DeepSeek-V3's
    ``noaux_tc`` with one group), renormalises the chosen scores and
    scales them by ``routed_scale``; beside the routed experts, every
    token passes through one shared gated MLP of width ``shared_d_ff``
    (the shared experts side by side).  Expert count, top-k, expert width
    and capacity factor are the ArchConfig's ``moe_*``."""

    routed_scale: float = 1.0
    shared_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class MLASpec:
    """Multi-head latent attention block (DeepSeek-V2/V3, pre-norm,
    residual): keys and values come up from a normed latent of
    ``kv_lora_rank`` per token, beside a rotary key of
    ``qk_rope_head_dim`` that every head shares; queries are projected
    whole (no query latent).  Followed by the MoE of ``moe`` or, where
    ``moe`` is None, the dense gated MLP of ``cfg.d_ff``."""

    kind: str = "mla"
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    moe: Optional[MoESpec] = None

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Width of one cached row: the normed latent, then the roped
        shared key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


BlockSpec = object  # union of the above


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    unit: Tuple[BlockSpec, ...]
    repeat: int


# ---------------------------------------------------------------------------
# Arch config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                          # dense | moe | hybrid | ssm | audio | vlm
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int                            # dense MLP hidden (0 = no MLP in block)
    vocab_size: int
    groups: Tuple[GroupSpec, ...]
    # --- MLP style ---
    mlp_gated: bool = True               # SwiGLU vs plain GELU
    # --- MoE ---
    moe_experts: int = 0                 # 0 = dense
    moe_topk: int = 0
    moe_d_ff: int = 0                    # per-expert hidden
    moe_capacity_factor: float = 1.25
    # --- embeddings / io ---
    num_codebooks: int = 1               # musicgen: 4 summed codebooks
    tie_embeddings: bool = True
    max_seq_len: int = 131072
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # --- dtype policy ---
    param_dtype: str = "float32"         # master params
    compute_dtype: str = "bfloat16"
    # --- applicability ---
    subquadratic: bool = False           # eligible for long_500k
    # --- training knobs (overridable per shape at launch) ---
    remat_policy: str = "full"           # none | full | dots
    microbatches: int = 1

    @property
    def num_layers(self) -> int:
        return sum(g.repeat * len(g.unit) for g in self.groups)

    def block_specs(self) -> Sequence[BlockSpec]:
        out = []
        for g in self.groups:
            for _ in range(g.repeat):
                out.extend(g.unit)
        return out

    def validate(self) -> None:
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if self.moe_experts:
            assert self.moe_topk > 0 and self.moe_d_ff > 0


# ---------------------------------------------------------------------------
# Shapes (assigned, shared by all 10 archs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    step: str                            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Per assignment: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: long_500k skipped (see DESIGN.md §Arch-applicability)"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY = {}


def register(cfg: ArchConfig) -> ArchConfig:
    cfg.validate()
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from repro_torch.configs import (  # noqa: F401
        stablelm_3b, gemma3_1b, granite_34b, qwen2_7b, zamba2_2_7b,
        kimi_k2_1t_a32b, moonshot_v1_16b_a3b, musicgen_large, xlstm_1_3b,
        chameleon_34b, micro, moonlight_16b_a3b,
    )


# ---------------------------------------------------------------------------
# Reduced configs for smoke tests: same family, tiny dims.
# ---------------------------------------------------------------------------


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Shrink a config to CPU-smoke scale, preserving block structure family."""
    groups = []
    for g in cfg.groups[:2]:
        unit = tuple(_shrink_block(b) for b in g.unit[:3])
        groups.append(GroupSpec(unit=unit, repeat=min(g.repeat, 2)))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) or 1,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        groups=tuple(groups),
        moe_experts=min(cfg.moe_experts, 4),
        moe_topk=min(cfg.moe_topk, 2),
        moe_d_ff=64 if cfg.moe_experts else 0,
        moe_capacity_factor=8.0,   # no drops at smoke scale: keeps decode == forward
        max_seq_len=512,
        microbatches=1,
        param_dtype="float32",
        compute_dtype="float32",
    )


def _shrink_block(b):
    if isinstance(b, AttnSpec):
        return dataclasses.replace(b, window=min(b.window, 32) if b.window else None)
    if isinstance(b, MambaSpec):
        return dataclasses.replace(b, d_state=8, head_dim=16)
    if isinstance(b, MLSTMSpec):
        return dataclasses.replace(b, num_heads=2)
    if isinstance(b, SLSTMSpec):
        return dataclasses.replace(b, num_heads=2)
    return b
