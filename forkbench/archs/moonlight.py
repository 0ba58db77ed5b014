"""``moonlight``: DeepSeek-V3's block as Moonlight-16B-A3B publishes it.
Every layer is multi-head latent attention (MLA); the first
``dense_layers`` are followed by a dense gated MLP of ``d_ff``, the rest
by ``moe_experts`` routed experts of ``moe_d_ff`` (top ``moe_topk`` by a
sigmoid score plus a selection bias, gates renormalised and scaled by
``moe_routed_scale``) beside a shared gated MLP of ``moe_shared_d_ff``.
The program runs it as its registered arch (``port.arch``) with the
file's sizes, float32: a group of dense MLA blocks, then a group of
expert MLA blocks.  The reference is ``forkbench/reference/moonlight.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List

from forkbench import roofline
from forkbench.reference.moonlight import Reference  # noqa: F401 (the arch's)

F32 = roofline.F32
BIAS_SCALE = 0.02   # the selection bias's draw (the config's "assumed")
# keys of the published config and the model dict they must equal
SAME = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
        "num_key_value_heads": "num_heads", "vocab_size": "vocab_size",
        "num_hidden_layers": "num_layers",
        "first_k_dense_replace": "dense_layers",
        "intermediate_size": "d_ff", "kv_lora_rank": "kv_lora_rank",
        "qk_nope_head_dim": "qk_nope_head_dim",
        "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
        "n_routed_experts": "moe_experts", "num_experts_per_tok": "moe_topk",
        "moe_intermediate_size": "moe_d_ff",
        "routed_scaling_factor": "moe_routed_scale",
        "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
        "tie_word_embeddings": "tie_embeddings"}
# published keys whose value is the only one the program and the
# reference compute
FIXED = {"model_type": "deepseek_v3", "hidden_act": "silu",
         "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
         "topk_group": 1, "norm_topk_prob": True, "q_lora_rank": None,
         "moe_layer_freq": 1, "attention_bias": False}


def check_config(conf: dict) -> None:
    """The published keys the file holds agree with its ``model`` dict,
    and those of another value than the program computes are absent."""
    m = conf["model"]
    for hf, key in SAME.items():
        if hf in conf and conf[hf] != m[key]:
            raise ValueError(f"{hf}={conf[hf]} but model.{key}={m[key]}")
    for hf, want in FIXED.items():
        if hf in conf and conf[hf] != want:
            raise ValueError(f"{hf}={conf[hf]!r}: the program computes "
                             f"{want!r} only")
    if "n_shared_experts" in conf and (conf["n_shared_experts"]
                                       * m["moe_d_ff"] != m["moe_shared_d_ff"]):
        raise ValueError("moe_shared_d_ff is n_shared_experts experts of "
                         "moe_d_ff side by side")
    if not 0 < m["dense_layers"] < m["num_layers"] or m["tie_embeddings"]:
        raise ValueError("a dense group and an expert group, untied")


def port_config(conf: dict):
    """The program's ArchConfig of ``conf``: its registered arch with the
    file's sizes, the dense MLA blocks then the expert ones, float32."""
    from repro_torch.configs.base import GroupSpec, MLASpec, MoESpec, get_arch
    m, base = conf["model"], get_arch(conf["port"]["arch"])
    attn = {k: m[k] for k in ("kv_lora_rank", "qk_nope_head_dim",
                              "qk_rope_head_dim", "v_head_dim")}
    sparse = MLASpec(**attn, moe=MoESpec(routed_scale=m["moe_routed_scale"],
                                         shared_d_ff=m["moe_shared_d_ff"]))
    k = m["dense_layers"]
    keys = ("d_model", "num_heads", "d_ff", "vocab_size", "moe_experts",
            "moe_topk", "moe_d_ff", "moe_capacity_factor", "tie_embeddings",
            "rope_theta", "norm_eps")
    return dataclasses.replace(
        base, name=conf["port"]["name"], **{n: m[n] for n in keys},
        num_kv_heads=m["num_heads"], head_dim=m["v_head_dim"],
        groups=(GroupSpec(unit=(MLASpec(**attn),), repeat=k),
                GroupSpec(unit=(sparse,), repeat=m["num_layers"] - k)),
        compute_dtype="float32", param_dtype="float32")


def tiny(m: dict) -> dict:
    """A tiny model of this architecture, for the benchmark's CPU tests:
    a dense layer and two expert layers, 3 of 8 experts with shared ones,
    a capacity that drops no token."""
    return {"arch": "moonlight", "d_model": 64, "num_heads": 4,
            "vocab_size": 256, "num_layers": 3, "dense_layers": 1,
            "d_ff": 96, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
            "qk_rope_head_dim": 8, "v_head_dim": 16, "moe_experts": 8,
            "moe_topk": 3, "moe_d_ff": 24, "moe_shared_d_ff": 48,
            "moe_routed_scale": 2.446, "moe_capacity_factor": 11.0,
            "tie_embeddings": False, "rope_theta": 50000.0, "norm_eps": 1e-5}


def leaves(m: dict) -> List[tuple]:
    """(path, shape, scale) of every leaf of model ``m``: the embedding
    and the untied head, the dense group's block and the expert group's,
    each stacked over its layers, the final norm."""
    D, V = m["d_model"], m["vocab_size"]
    k = m["dense_layers"]
    return ([(("embed", "tok"), (V, D), 0.02),
             (("embed", "out"), (D, V), D ** -0.5)]
            + block_leaves(m, ("groups", "0", "blocks", "0"), k, False)
            + block_leaves(m, ("groups", "1", "blocks", "0"),
                           m["num_layers"] - k, True)
            + [(("final_norm", "scale"), (D,), 0.1)])


def block_leaves(m: dict, blk: tuple, L: int, moe: bool) -> List[tuple]:
    """The leaves of one MLA block at path ``blk``, stacked over ``L``
    layers, with the experts (``moe``) or the dense MLP."""
    D, H, C = m["d_model"], m["num_heads"], m["kv_lora_rank"]
    nope, r, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    out = [
        (blk + ("norm1", "scale"), (L, D), 0.1),
        (blk + ("attn", "wq"), (L, D, H, nope + r), D ** -0.5),
        (blk + ("attn", "wkv_a"), (L, D, C + r), D ** -0.5),
        (blk + ("attn", "kv_norm", "scale"), (L, C), 0.1),
        (blk + ("attn", "wkv_b"), (L, C, H, nope + dv), C ** -0.5),
        (blk + ("attn", "wo"), (L, H, dv, D), (H * dv) ** -0.5),
        (blk + ("norm2", "scale"), (L, D), 0.1),
    ]
    if not moe:
        Fd = m["d_ff"]
        return out + [(blk + ("mlp", "wi"), (L, D, Fd), D ** -0.5),
                      (blk + ("mlp", "wg"), (L, D, Fd), D ** -0.5),
                      (blk + ("mlp", "wd"), (L, Fd, D), Fd ** -0.5)]
    E, Fe, S = m["moe_experts"], m["moe_d_ff"], m["moe_shared_d_ff"]
    return out + [
        (blk + ("moe", "router"), (L, D, E), 0.02),
        (blk + ("moe", "router_bias"), (L, E), BIAS_SCALE),
        (blk + ("moe", "wi"), (L, E, D, Fe), D ** -0.5),
        (blk + ("moe", "wg"), (L, E, D, Fe), D ** -0.5),
        (blk + ("moe", "wd"), (L, E, Fe, D), Fe ** -0.5),
        (blk + ("moe", "shared", "wi"), (L, D, S), D ** -0.5),
        (blk + ("moe", "shared", "wg"), (L, D, S), D ** -0.5),
        (blk + ("moe", "shared", "wd"), (L, S, D), S ** -0.5)]


# ---------------------------------------------------------------------------
# the counts of forkbench/roofline.py
# ---------------------------------------------------------------------------


def row_floats(m: dict) -> int:
    """Floats of one cached latent row: the latent and the shared rope
    key."""
    return m["kv_lora_rank"] + m["qk_rope_head_dim"]


def _attn_params(m: dict) -> int:
    D, H, C = m["d_model"], m["num_heads"], m["kv_lora_rank"]
    nope, r, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    return (D * H * (nope + r) + D * (C + r) + C + C * H * (nope + dv)
            + H * dv * D + D)                     # wq, wkv_a, norms, wkv_b, wo


def _mlp_params(m: dict, moe: bool, active: bool) -> int:
    D = m["d_model"]
    if not moe:
        return 3 * D * m["d_ff"] + D                       # gated, norm2
    E = m["moe_experts"]
    e = m["moe_topk"] if active else E
    return (e * 3 * D * m["moe_d_ff"] + D * E + E          # experts, router
            + 3 * D * m["moe_shared_d_ff"] + D)            # shared, norm2


def block_params(m: dict, active: bool = True) -> int:
    """Parameters of the layer stack and the final norm a token passes
    through (``active``: its top-k experts only, the shared ones always)."""
    k, L = m["dense_layers"], m["num_layers"]
    return (L * _attn_params(m) + k * _mlp_params(m, False, active)
            + (L - k) * _mlp_params(m, True, active) + m["d_model"])


def state_bytes(m: dict) -> int:
    """Bytes of the whole state a fork moves."""
    return F32 * (block_params(m, active=False)
                  + 2 * m["vocab_size"] * m["d_model"])


def kv_bytes(m: dict, positions: int) -> int:
    """Bytes of the latent rows of ``positions`` positions in every
    layer."""
    return F32 * m["num_layers"] * positions * row_floats(m)


def prefill_work(m: dict, P: int) -> tuple:
    """The prompt of ``P`` tokens: every token through the stack (its
    top-k and shared experts only), causal attention in the expanded form
    (scores over nope + rope, values over v), the head at the last
    position; bytes: those weights once, the prompt's embedding rows and
    its latent rows written."""
    D, V, L, H = m["d_model"], m["vocab_size"], m["num_layers"], m["num_heads"]
    width = m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"]
    flops = (2 * block_params(m) * P + L * 2 * H * width * P * (P + 1) / 2
             + 2 * D * V)
    nbytes = F32 * (block_params(m) + D * V + P * D) + kv_bytes(m, P)
    return flops, nbytes


def decode_work(m: dict, ctx: int) -> tuple:
    """One decoded token attending over ``ctx`` positions (its own
    included) in the absorbed form: scores over the whole row, values over
    the latent; bytes: the active weights, one embedding row, ``ctx``
    latent rows read and one written."""
    D, V, L, H = m["d_model"], m["vocab_size"], m["num_layers"], m["num_heads"]
    flops = (2 * block_params(m) + L * 2 * H * (row_floats(m)
                                                 + m["kv_lora_rank"]) * ctx
             + 2 * D * V)
    nbytes = (F32 * (block_params(m) + D * V + D) + kv_bytes(m, ctx)
              + kv_bytes(m, 1))
    return flops, nbytes


def attention_bytes(m: dict, P: int, n_out: int) -> int:
    """What the latent kernel needs over a request's decode steps: each
    step's rows, its absorbed queries read and its latent outputs
    written, in every layer."""
    per_step = F32 * m["num_layers"] * m["num_heads"] * (row_floats(m)
                                                         + m["kv_lora_rank"])
    return sum(kv_bytes(m, c) + per_step
               for c in roofline.decode_contexts(P, n_out))
