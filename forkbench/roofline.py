"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes an invocation needs, computed from the configuration's shapes alone
(a frozen copy of the counting in ``repro_torch/models/flops.py``, plus
bytes), so that the same work is counted whatever implements it.  The
counts that depend on the architecture come from its module
(``forkbench/archs/<arch>.py``).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W): 67 TFLOP/s in float32 outside the tensor cores (the benchmark's
precision: float32 with TF32 off) and 3.35 TB/s of HBM3.  The least time
of a piece of work is the larger of its operations over the first and its
bytes over the second; a share of a peak is least time over measured time,
printed beside the card's power limit (``card``).
"""
from __future__ import annotations

import subprocess

from forkbench import archs

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def block_params(m: dict, active: bool = True) -> int:
    """Parameters of the layer stack and the final norm a token passes
    through (``active``: the experts it is routed to only)."""
    return archs.load(m).block_params(m, active)


def state_bytes(m: dict) -> int:
    """Bytes of the whole state a fork moves."""
    return archs.load(m).state_bytes(m)


def fork_least_s(m: dict) -> float:
    """A fork reads the state once and writes it once."""
    return least_s(0.0, 2 * state_bytes(m))


def prefill_least_s(m: dict, P: int) -> float:
    """The prompt of ``P`` tokens (the architecture's ``prefill_work``)."""
    return least_s(*archs.load(m).prefill_work(m, P))


def decode_least_s(m: dict, ctx: int) -> float:
    """One decoded token attending over ``ctx`` positions, its own
    included (the architecture's ``decode_work``)."""
    return least_s(*archs.load(m).decode_work(m, ctx))


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
    steps (the architecture's count)."""
    return archs.load(m).attention_bytes(m, P, n_out)


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
