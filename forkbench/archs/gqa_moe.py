"""``gqa_moe``: a causal LM of one block kind repeated ``num_layers``
times: pre-norm attention with KV heads shared by groups of query heads
and rotary embedding on whole heads, then a gated dense MLP or a softmax
top-k mixture of experts (``moe_experts`` > 0).  The program runs it as
its registered arch (``port.arch``) with the file's sizes, every block
plain attention, float32; the reference is
``forkbench/reference/model.py``.  stablelm-3b and mixtral-8x7b-2L."""
from __future__ import annotations

import dataclasses
from typing import List

from forkbench import roofline
from forkbench.reference.model import Reference  # noqa: F401 (the arch's)

F32 = roofline.F32
# keys of the published config and the model dict they must equal
SAME = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
        "num_key_value_heads": "num_kv_heads", "vocab_size": "vocab_size",
        "num_hidden_layers": "num_layers", "n_routed_experts": "moe_experts",
        "num_local_experts": "moe_experts", "num_experts_per_tok": "moe_topk",
        "moe_intermediate_size": "moe_d_ff", "rope_theta": "rope_theta",
        "tie_word_embeddings": "tie_embeddings"}


def check_config(conf: dict) -> None:
    """The published keys the file holds agree with its ``model`` dict."""
    m = conf["model"]
    pairs = dict(SAME)
    if not m["moe_experts"]:
        pairs["intermediate_size"] = "d_ff"
    elif "moe_intermediate_size" not in conf:   # a source whose every
        pairs["intermediate_size"] = "moe_d_ff"  # layer is experts
    for hf, key in pairs.items():
        if hf in conf and conf[hf] != m[key]:
            raise ValueError(f"{hf}={conf[hf]} but model.{key}={m[key]}")
    if not m["mlp_gated"]:
        raise ValueError("the reference has gated MLPs only")


def port_config(conf: dict):
    """The program's ArchConfig of ``conf``: its registered arch with the
    file's sizes, every block plain attention, float32."""
    from repro_torch.configs.base import AttnSpec, GroupSpec, get_arch
    m, base = conf["model"], get_arch(conf["port"]["arch"])
    if any(u != AttnSpec() for g in base.groups for u in g.unit):
        raise ValueError(f"{base.name}: the benchmark runs plain attention "
                         f"blocks only")
    keys = ("d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
            "vocab_size", "mlp_gated", "moe_experts", "moe_topk", "moe_d_ff",
            "moe_capacity_factor", "tie_embeddings", "rope_theta", "norm_eps")
    return dataclasses.replace(
        base, name=conf["port"]["name"], **{k: m[k] for k in keys},
        groups=(GroupSpec(unit=(AttnSpec(),), repeat=m["num_layers"]),),
        compute_dtype="float32", param_dtype="float32")


def tiny(m: dict) -> dict:
    """A tiny model of ``m``'s kind, for the benchmark's CPU tests: dense
    where ``m`` has no experts, a mixture of experts where it has."""
    moe = bool(m["moe_experts"])
    return {"d_model": 64, "num_heads": 4, "num_kv_heads": 4 if moe else 2,
            "head_dim": 16, "d_ff": 0 if moe else 128, "vocab_size": 256,
            "num_layers": 2, "mlp_gated": True, "tie_embeddings": False,
            "rope_theta": 10000.0, "norm_eps": 1e-5,
            "moe_experts": 8 if moe else 0, "moe_topk": 2 if moe else 0,
            "moe_d_ff": 32 if moe else 0, "moe_capacity_factor": 1.25}


def leaves(m: dict) -> List[tuple]:
    """(path, shape, scale) of every leaf of model ``m``: the embedding,
    one block stacked over the layers, the final norm."""
    D, V = m["d_model"], m["vocab_size"]
    out = [(("embed", "tok"), (V, D), 0.02)]
    if not m["tie_embeddings"]:
        out.append((("embed", "out"), (D, V), D ** -0.5))
    out += block_leaves(m, ("groups", "0", "blocks", "0"), m["num_layers"])
    out.append((("final_norm", "scale"), (D,), 0.1))
    return out


def block_leaves(m: dict, blk: tuple, L: int) -> List[tuple]:
    """The leaves of one block of ``m`` at path ``blk``, stacked over
    ``L`` layers."""
    D, H, K, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    out = [
        (blk + ("norm1", "scale"), (L, D), 0.1),
        (blk + ("attn", "wq"), (L, D, H, hd), D ** -0.5),
        (blk + ("attn", "wk"), (L, D, K, hd), D ** -0.5),
        (blk + ("attn", "wv"), (L, D, K, hd), D ** -0.5),
        (blk + ("attn", "wo"), (L, H, hd, D), (H * hd) ** -0.5),
        (blk + ("norm2", "scale"), (L, D), 0.1),
    ]
    if m["moe_experts"]:
        E, Fe = m["moe_experts"], m["moe_d_ff"]
        out += [(blk + ("moe", "router"), (L, D, E), 0.02),
                (blk + ("moe", "wi"), (L, E, D, Fe), D ** -0.5),
                (blk + ("moe", "wg"), (L, E, D, Fe), D ** -0.5),
                (blk + ("moe", "wd"), (L, E, Fe, D), Fe ** -0.5)]
    else:
        Fd = m["d_ff"]
        out += [(blk + ("mlp", "wi"), (L, D, Fd), D ** -0.5),
                (blk + ("mlp", "wg"), (L, D, Fd), D ** -0.5),
                (blk + ("mlp", "wd"), (L, Fd, D), Fd ** -0.5)]
    return out


# ---------------------------------------------------------------------------
# the counts of forkbench/roofline.py
# ---------------------------------------------------------------------------


def _attn_params(m: dict) -> int:
    D, H, K, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    return D * H * hd + 2 * D * K * hd + H * hd * D + D          # q,k,v,o, norm1


def _mlp_params(m: dict, active: bool) -> int:
    D = m["d_model"]
    if m["moe_experts"]:
        e = m["moe_topk"] if active else m["moe_experts"]
        return e * 3 * D * m["moe_d_ff"] + D * m["moe_experts"] + D
    return 3 * D * m["d_ff"] + D                                 # gated, norm2


def block_params(m: dict, active: bool = True) -> int:
    """Parameters of the layer stack and the final norm a token passes
    through (``active``: its top-k experts only)."""
    return (m["num_layers"] * (_attn_params(m) + _mlp_params(m, active))
            + m["d_model"])


def state_bytes(m: dict) -> int:
    """Bytes of the whole state a fork moves."""
    head = 0 if m["tie_embeddings"] else m["d_model"] * m["vocab_size"]
    return F32 * (block_params(m, active=False)
                  + m["vocab_size"] * m["d_model"] + head)


def kv_bytes(m: dict, positions: int) -> int:
    """Bytes of the K and V of ``positions`` positions in every layer."""
    return (F32 * 2 * m["num_layers"] * positions * m["num_kv_heads"]
            * m["head_dim"])


def prefill_work(m: dict, P: int) -> tuple:
    """The prompt of ``P`` tokens: every token through the stack (its
    top-k experts only), causal attention, and the head at the last
    position; bytes: the weights once (top-k experts of each layer only,
    the least any routing reads), the prompt's embedding rows and its K/V
    written."""
    D, V, L = m["d_model"], m["vocab_size"], m["num_layers"]
    Hhd = m["num_heads"] * m["head_dim"]
    flops = (2 * block_params(m) * P + L * 4 * Hhd * P * (P + 1) / 2
             + 2 * D * V)
    nbytes = F32 * (block_params(m) + D * V + P * D) + kv_bytes(m, P)
    return flops, nbytes


def decode_work(m: dict, ctx: int) -> tuple:
    """One decoded token attending over ``ctx`` positions (its own
    included): the stack with its top-k experts, the head; bytes: those
    weights, one embedding row, ``ctx`` positions of K/V read and one
    written."""
    D, V, L = m["d_model"], m["vocab_size"], m["num_layers"]
    Hhd = m["num_heads"] * m["head_dim"]
    flops = 2 * block_params(m) + L * 4 * Hhd * ctx + 2 * D * V
    nbytes = (F32 * (block_params(m) + D * V + D) + kv_bytes(m, ctx)
              + kv_bytes(m, 1))
    return flops, nbytes


def attention_bytes(m: dict, P: int, n_out: int) -> int:
    """What the paged attention kernel needs over a request's decode
    steps: each step's K/V context, its queries read and its output
    written, in every layer."""
    Hhd = m["num_heads"] * m["head_dim"]
    return sum(kv_bytes(m, c) + F32 * m["num_layers"] * 2 * Hhd
               for c in roofline.decode_contexts(P, n_out))
