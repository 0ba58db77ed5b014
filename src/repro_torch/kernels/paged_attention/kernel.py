"""ctypes launcher of the paged_attention kernel in
``csrc/paged_attention.cu``: each (sequence, kv head) split across blocks
by ``plan.split_plan``, K and V rows brought into shared memory by TMA bulk
copies (the ``tma`` route) or, where rows or pools are not 16-byte
aligned, by plain loads (the ``loads`` route); online fp32 softmax over
the tokens in ``[starts[b], lengths[b])``, and a combine pass over the
splits when there is more than one.  One call is one count in
``dispatch``, with its route.  The launches go on PyTorch's current stream
and do not synchronise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.paged_attention import plan

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_G = 16          # query heads per kv head (the kernel's largest bucket)
MAX_HEAD_DIM = 256  # one thread per head dimension
NEG_INF = -1e30     # masked scores and the running max's seed (kNegInf)
TMA, LOADS = "tma", "loads"

_sm_counts: dict = {}


def _ptr(t):
    return None if t is None else t.data_ptr()


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA ``device``, cached."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def route(kv_pages_k: torch.Tensor, kv_pages_v: torch.Tensor) -> str:
    """``tma`` where the pools and their rows are 16-byte aligned (the
    kernel's rule for bulk copies), else ``loads``."""
    row = kv_pages_k.shape[-1] * kv_pages_k.element_size()
    if (row | kv_pages_k.data_ptr() | kv_pages_v.data_ptr()) & 15:
        return LOADS
    return TMA


def paged_attention(q: torch.Tensor, kv_pages_k: torch.Tensor,
                    kv_pages_v: torch.Tensor, page_table: torch.Tensor,
                    v_page_table: torch.Tensor, lengths: torch.Tensor,
                    starts: torch.Tensor) -> torch.Tensor:
    """q (B, K, G, hd); pools (F, Tp, K, hd); tables (B, P) int32;
    lengths and starts (B,) int32, starts None for all 0 — all contiguous
    on one CUDA device."""
    B, K, G, hd = q.shape
    F, Tp, Kp, hdp = kv_pages_k.shape
    P = page_table.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention kernel needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if (Kp, hdp) != (K, hd) or kv_pages_v.shape != kv_pages_k.shape:
        raise ValueError("k/v pools must be (F, Tp, K, hd) matching q")
    if not 1 <= G <= MAX_G or not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"kernel supports G <= {MAX_G} and head_dim <= "
                         f"{MAX_HEAD_DIM}, got G={G} hd={hd}")
    if P < 1:
        raise ValueError("page tables need at least one column")
    for t in (q, kv_pages_k, kv_pages_v):
        if t.device != dev or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("q and the pools must be contiguous, on one "
                             "device and of one dtype")
    tables = [(page_table, (B, P)), (v_page_table, (B, P)), (lengths, (B,))]
    if starts is not None:
        tables.append((starts, (B,)))
    for t, shape in tables:
        if (t.device != dev or t.dtype != torch.int32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"tables must be contiguous int32 {shape} on "
                             f"{dev}")
    out = torch.empty_like(q)
    splits, cols = plan.split_plan(B, K, P, sm_count(dev))
    ws = (torch.empty(B * K * splits * G * (hd + 2), dtype=torch.float32,
                      device=dev) if splits > 1 else None)
    r = route(kv_pages_k, kv_pages_v)
    fn = build.function("paged_attention", "paged_attention",
                        [_P] * 9 + [_I] * 10 + [_F, _I, _P])
    dispatch.count_launch("paged_attention", route=r)
    err = fn(q.data_ptr(), kv_pages_k.data_ptr(), kv_pages_v.data_ptr(),
             page_table.data_ptr(), v_page_table.data_ptr(),
             lengths.data_ptr(), _ptr(starts), out.data_ptr(), _ptr(ws),
             B, K, G, hd, Tp, P, splits, cols, plan.tile_tokens(Tp),
             int(r == TMA), hd ** -0.5, _DTYPES[q.dtype], build.stream(dev))
    build.check(err, "paged_attention")
    return out
