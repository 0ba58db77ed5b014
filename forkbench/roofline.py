"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes an invocation needs, computed from the configuration's shapes alone
(a frozen copy of the counting in ``repro_torch/models/flops.py``, plus
bytes), so that the same work is counted whatever implements it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W): 67 TFLOP/s in float32 outside the tensor cores (the benchmark's
precision: float32 with TF32 off) and 3.35 TB/s of HBM3.  The least time
of a piece of work is the larger of its operations over the first and its
bytes over the second; a share of a peak is least time over measured time,
printed beside the card's power limit (``card``).
"""
from __future__ import annotations

import subprocess

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


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


def fork_least_s(m: dict) -> float:
    """A fork reads the state once and writes it once."""
    return least_s(0.0, 2 * state_bytes(m))


def prefill_least_s(m: dict, P: int) -> float:
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
    return least_s(flops, nbytes)


def decode_least_s(m: dict, ctx: int) -> float:
    """One decoded token attending over ``ctx`` positions (its own
    included): the stack with its top-k experts, the head; bytes: those
    weights, one embedding row, ``ctx`` positions of K/V read and one
    written."""
    D, V, L = m["d_model"], m["vocab_size"], m["num_layers"]
    Hhd = m["num_heads"] * m["head_dim"]
    flops = 2 * block_params(m) + L * 4 * Hhd * ctx + 2 * D * V
    nbytes = (F32 * (block_params(m) + D * V + D) + kv_bytes(m, ctx)
              + kv_bytes(m, 1))
    return least_s(flops, nbytes)


def decode_contexts(P: int, n_out: int):
    """The contexts of a request's decode steps: the first token comes
    from the prefill, each later one from a step over the prompt, the
    tokens so far and itself."""
    return [P + j + 1 for j in range(n_out - 1)]


def serve_least_s(m: dict, P: int, n_out: int) -> float:
    return prefill_least_s(m, P) + sum(decode_least_s(m, c)
                                       for c in decode_contexts(P, n_out))


def attention_bytes(m: dict, P: int, n_out: int) -> int:
    """What the paged attention kernel needs over a request's decode
    steps: each step's K/V context, its queries read and its output
    written, in every layer."""
    Hhd = m["num_heads"] * m["head_dim"]
    return sum(kv_bytes(m, c) + F32 * m["num_layers"] * 2 * Hhd
               for c in decode_contexts(P, n_out))


def copy_bytes(pages: int, page_elems: int) -> int:
    """A page copy reads its page once and writes it once."""
    return 2 * pages * page_elems * F32


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"name": None, "power_limit": None}
    name, limit = (s.strip() for s in out.split(",", 1))
    return {"name": name, "power_limit": limit}
