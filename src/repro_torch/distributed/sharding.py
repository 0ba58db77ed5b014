"""Sharding rules for the production meshes.

Axes: `model` = tensor/expert parallel; `data` (+ `pod` when present) =
data parallel and FSDP (ZeRO-3-style parameter sharding on a non-model dim).

Policy:
  * attention: head-TP when both H and KV divide the model axis; else shard
    head_dim (partial-sum contractions); else replicate heads.
  * MLP: F_ff over model, D over fsdp.  MoE: experts over model (EP).
  * embeddings: vocab over model, d_model over fsdp.
  * Mamba in/out projections: fsdp only in the baseline (splitting the
    fused in_proj would unlock TP).  mLSTM projections: over model by
    columns (``w_up``, q/k/v) and rows (``w_down``).
  * activations: batch over (pod, data); batch-1 long-context decode shards
    the KV sequence axis instead (sequence-parallel decode).

The rules are the reference's, rule for rule, and return the port's own
spec type ``P``: a tuple with one entry per tensor dim, each ``None``, an
axis name or a tuple of axis names, which reads like ``PartitionSpec`` and
compares equal to a tuple.  ``placements`` turns a spec into one DTensor
placement per mesh dim; the trees of ``params_shardings`` and its kin hold
``NamedSharding`` leaves (a mesh and a spec, with their placements).  A mesh is either a torch ``DeviceMesh`` or a
shape-only ``MeshShape`` (the 256- and 512-chip production meshes exist
only in that form).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.core.descriptor import flatten_with_names, unflatten_from_paths


class P(tuple):
    """A partition spec: ``P("data", None)``; ``P()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh known by its axis sizes only (no devices, no process group)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size}, in mesh-dim order, of a ``MeshShape`` or a
    ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class AxisEnv:
    mesh: object                   # DeviceMesh or MeshShape
    fsdp: Tuple[str, ...]          # param-shard axes
    dp: Tuple[str, ...]            # batch axes
    model: str = "model"
    # attention head policy: "v1" = head-TP only if H and K both divide
    # (else shard head_dim); "qtp" = shard Q heads over model whenever H
    # divides, replicate K/V when K doesn't — kills the scores partial-sum
    # all-reduce for MQA/GQA (granite/kimi/chameleon).
    attn_policy: str = "v1"
    # MoE dispatch: "gspmd" = capacity and in-expert order over the whole
    # microbatch; "shardmap" = each data shard routes its own tokens with
    # a local sort and a local capacity (models/moe.py).
    moe_impl: str = "gspmd"
    # Mamba/SSD tensor parallelism: this rank computes its heads of the
    # SSD block; the in/out projections stay laid out by fsdp only.
    mamba_tp: bool = False

    @property
    def axes(self) -> Dict[str, int]:
        return mesh_axes(self.mesh)

    @property
    def msize(self) -> int:
        return self.axes[self.model]

    @property
    def fsize(self) -> int:
        return math.prod(self.axes[a] for a in self.fsdp)

    @property
    def dpsize(self) -> int:
        return math.prod(self.axes[a] for a in self.dp)


def make_axis_env(mesh, fsdp_over_pod: bool = True,
                  attn_policy: str = "v1", moe_impl: str = "gspmd",
                  mamba_tp: bool = False) -> AxisEnv:
    names = tuple(mesh_axes(mesh))
    dp = tuple(a for a in ("pod", "data") if a in names)
    fsdp = dp if fsdp_over_pod else ("data",)
    return AxisEnv(mesh=mesh, fsdp=fsdp, dp=dp, attn_policy=attn_policy,
                   moe_impl=moe_impl, mamba_tp=mamba_tp)


def _div(n: int, k: int) -> bool:
    return n % k == 0


def param_pspec(path: str, shape, cfg: ArchConfig, env: AxisEnv) -> P:
    """Name-based sharding rule. `path` is 'a/b/c' leaf path; stacked block
    params carry a leading repeat axis (never sharded)."""
    m, F = env.model, env.fsdp
    ms = env.msize
    parts = path.split("/")
    leaf = parts[-1]
    owner = parts[-2] if len(parts) >= 2 else ""
    nd = len(shape)

    def lead(spec_tail):  # prepend None for the stacked repeat axis
        pad = nd - len(spec_tail)
        return P(*([None] * pad + list(spec_tail)))

    # ---- embeddings ----
    # Vocab over model only: sharding D over the data axis conflicts with
    # batch-sharded token gathers (the reference's dry-run observed
    # involuntary full rematerialization under SPMD).
    if owner == "embed" and leaf == "tok":
        return lead([m, None]) if _div(shape[-2], ms) else P()
    if owner == "embed" and leaf == "out":
        return lead([None, m]) if _div(shape[-1], ms) else P()

    # ---- attention ----
    if owner == "attn" or (len(parts) >= 3 and parts[-3] == "attn"):
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if env.attn_policy == "qtp":
            q_tp = _div(H, ms)
            kv_tp = _div(K, ms)
            if leaf == "wq":
                return lead([F, m, None]) if q_tp else lead([F, None, None])
            if leaf in ("wk", "wv"):
                return lead([F, m, None]) if kv_tp else lead([F, None, None])
            if leaf == "wo":
                return lead([m, None, F]) if q_tp else lead([None, None, F])
            if leaf == "bq":
                return lead([m, None]) if q_tp else P()
            if leaf in ("bk", "bv"):
                return lead([m, None]) if kv_tp else P()
            return P()
        head_tp = _div(H, ms) and _div(K, ms)
        hd_tp = _div(hd, ms)
        if leaf == "wq":
            if head_tp:
                return lead([F, m, None])
            return lead([F, None, m]) if hd_tp else lead([F, None, None])
        if leaf in ("wk", "wv"):
            if head_tp:
                return lead([F, m, None])
            return lead([F, None, m]) if hd_tp else lead([F, None, None])
        if leaf == "wo":
            if head_tp:
                return lead([m, None, F])
            return lead([None, m, F]) if hd_tp else lead([None, None, F])
        if leaf in ("bq", "bk", "bv"):
            if head_tp:
                return lead([m, None])
            return lead([None, m]) if hd_tp else P()
        return P()                                    # q_norm/k_norm scales

    # ---- dense MLP ----
    if owner == "mlp":
        if leaf in ("wi", "wg"):
            return lead([F, m]) if _div(shape[-1], ms) else lead([F, None])
        if leaf == "wd":
            return lead([m, F]) if _div(shape[-2], ms) else lead([None, F])

    # ---- MoE ----
    if owner == "moe":
        etp = moe_split(cfg, env)
        if leaf == "router":
            return lead([F, None])
        if leaf in ("wi", "wg"):
            return lead([m, F, None]) if etp else lead([None, F, None])
        if leaf == "wd":
            return lead([m, None, F]) if etp else lead([None, None, F])

    # ---- Mamba2 (baseline: fsdp only) ----
    if owner == "mamba":
        if leaf == "in_proj":
            return lead([F, None])
        if leaf == "out_proj":
            return lead([None, F])
        return P()

    # ---- xLSTM ----
    if owner == "mlstm":
        if leaf == "w_up":
            return lead([F, m]) if _div(shape[-1], ms) else lead([F, None])
        if leaf in ("wq", "wk", "wv"):
            return lead([F, m]) if _div(shape[-1], ms) else lead([F, None])
        if leaf == "w_down":
            return lead([m, F]) if _div(shape[-2], ms) else lead([None, F])
        return P()
    if owner == "slstm":
        return P()

    return P()       # norms, biases, scalars


# ---------------------------------------------------------------------------
# tensor parallelism: how each layer splits its work over ``model``
# ---------------------------------------------------------------------------


def attn_plan(cfg: ArchConfig, env: AxisEnv):
    """How attention splits over ``model``, following ``param_pspec``:
    "heads" (Q and K/V heads split), "hd" (head_dim split: partial-sum
    scores), "qtp" (Q heads split, K/V replicated) or None (replicated)."""
    H, K, hd, ms = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, env.msize
    if ms == 1:
        return None
    if env.attn_policy == "qtp":
        if not _div(H, ms):
            return None
        return "heads" if _div(K, ms) else "qtp"
    if _div(H, ms) and _div(K, ms):
        return "heads"
    return "hd" if _div(hd, ms) else None


def mamba_split(cfg: ArchConfig, spec, env: AxisEnv) -> bool:
    """Whether a Mamba block computes its heads split over ``model``."""
    heads = spec.expand * cfg.d_model // spec.head_dim
    return env.mamba_tp and env.msize > 1 and _div(heads, env.msize)


def moe_split(cfg: ArchConfig, env: AxisEnv) -> bool:
    """Whether the MoE experts are placed over ``model`` (expert
    parallelism): with ``model`` larger than 1, each rank computes its
    ``E / msize`` experts."""
    return _div(cfg.moe_experts, env.msize)


def mlstm_split(cfg: ArchConfig, spec, env: AxisEnv) -> bool:
    """Whether an mLSTM block splits its value columns over ``model``:
    when ``model`` divides d_inner (``param_pspec`` then splits its
    ``w_up``, ``wq``/``wk``/``wv`` and ``w_down``), each rank computes
    d_inner / msize of them, whole heads or a part of one."""
    d_inner, H, ms = spec.expand * cfg.d_model, spec.num_heads, env.msize
    if ms == 1 or not _div(d_inner, ms):
        return False
    if not (_div(H, ms) or _div(ms, H)):
        raise NotImplementedError(
            f"mLSTM: {ms} ranks' value columns straddle {H} heads")
    return True


def model_partial(path: str, shape, cfg: ArchConfig, env: AxisEnv) -> bool:
    """Whether a leaf replicated over ``model`` is used inside a region
    that is split over it, so that each rank's gradient of it is a part
    and the sum over ``model`` is the whole: q/k norms where Q heads are
    split, K/V projections under "qtp", the MoE router under expert
    parallelism, every leaf of a split Mamba block, and the replicated
    leaves of a split mLSTM block (the conv, the gates, the norm).  It
    reads the same plans the layers split by (``attn_plan``,
    ``moe_split``, ``mamba_split``, ``mlstm_split``); a layer that splits
    by anything else must add its rule here, or its replicated leaves'
    gradients come out as parts."""
    if env.msize == 1 or env.model in [
            a for e in param_pspec(path, shape, cfg, env)
            for a in spec_axes(e)]:
        return False
    parts = path.split("/")
    leaf = parts[-1]
    owner = parts[-2] if len(parts) >= 2 else ""
    if owner == "attn" or (len(parts) >= 3 and parts[-3] == "attn"):
        return attn_plan(cfg, env) in ("heads", "qtp")
    if owner == "moe":
        return leaf == "router" and moe_split(cfg, env)
    if "mamba" in parts or "mlstm" in parts:  # groups/<g>/blocks/<b>/...
        spec = cfg.groups[int(parts[1])].unit[int(parts[3])]
        split = mamba_split if "mamba" in parts else mlstm_split
        return split(cfg, spec, env)
    return False


# ---------------------------------------------------------------------------
# activations / inputs
# ---------------------------------------------------------------------------


def batch_pspec(batch: int, env: AxisEnv) -> P:
    if _div(batch, env.dpsize):
        return P(env.dp)
    if "data" in env.dp and _div(batch, env.axes["data"]):
        return P("data")
    return P()


def cache_pspec(path: str, shape, cfg: ArchConfig, env: AxisEnv,
                batch: int) -> P:
    """KV / SSM cache leaves. Leading axis is the stacked repeat axis.

    Attention caches: (R, B, S, K, hd); SSM: (R, B, H, P, N) etc.
    Prefer batch over dp; for batch-1 long-context shard the seq axis."""
    nd = len(shape)
    leaf = path.split("/")[-1]
    bspec = batch_pspec(batch, env)
    if leaf in ("k", "v") and nd >= 4:
        pads = [None] * nd
        if bspec != P():
            pads[1] = bspec[0] if len(bspec) else None
        else:
            # sequence-parallel cache for unshardable batch
            if _div(shape[2], env.dpsize):
                pads[2] = env.dp
        K, hd = shape[-2], shape[-1]
        if _div(K, env.msize):
            pads[-2] = env.model
        elif _div(hd, env.msize):
            pads[-1] = env.model
        return P(*pads)
    # recurrent states: batch over dp if divisible, else replicate
    pads = [None] * nd
    if nd >= 2 and bspec != P():
        pads[1] = bspec[0] if len(bspec) else None
    return P(*pads)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry: () for None."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, env: AxisEnv) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` on every mesh dim that
    tensor dim ``d``'s entry names, ``Replicate()`` elsewhere.  A dim over
    several axes must name them in mesh-dim order (JAX's major-to-minor
    layout is then DTensor's left-to-right one)."""
    return _placements(spec, list(env.axes))


def _placements(spec, names) -> tuple:
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in spec_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} names its axes out of "
                             f"mesh order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]} "
                                 f"shards two dims")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the leaf of a shardings tree, as JAX's."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return _placements(self.spec, list(mesh_axes(self.mesh)))


def local_shape(shape, spec, env: AxisEnv) -> Tuple[int, ...]:
    """The shape each rank holds of a tensor of ``shape`` under ``spec``.
    A sharded dim must divide by its axes' sizes: the reference's rules
    never check it for the fsdp axes, and DTensor would pad unevenly, so a
    dim that does not divide raises."""
    out = list(shape)
    for d, entry in enumerate(spec):
        k = math.prod(env.axes[a] for a in spec_axes(entry))
        if out[d] % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {spec_axes(entry)} ({k})")
        out[d] //= k
    return tuple(out)


def _shardings(tree, env: AxisEnv, spec_of):
    names, paths, leaves = flatten_with_names(tree)
    return unflatten_from_paths(paths, [
        NamedSharding(env.mesh, spec_of(n, tuple(l.shape)))
        for n, l in zip(names, leaves)])


def params_shardings(cfg: ArchConfig, params_shapes, env: AxisEnv):
    """The sharding of every param leaf; ``params_shapes`` is any tree of
    leaves with a ``.shape`` (tensors, meta tensors)."""
    return _shardings(params_shapes, env,
                      lambda n, s: param_pspec(n, s, cfg, env))


def cache_shardings(cfg: ArchConfig, cache_shapes, env: AxisEnv, batch: int):
    return _shardings(cache_shapes, env,
                      lambda n, s: cache_pspec(n, s, cfg, env, batch))


def opt_state_shardings(param_sh, env: AxisEnv):
    """m/v mirror params; count is replicated."""
    return {"m": param_sh, "v": param_sh,
            "count": NamedSharding(env.mesh, P())}
