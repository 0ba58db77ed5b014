"""ctypes launcher of the paged_attention kernel in
``csrc/paged_attention.cu``: one block per (sequence, kv head), online
fp32 softmax over the tokens in ``[starts[b], lengths[b])``.  The launch
goes on PyTorch's current stream and does not synchronise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dispatch

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_G = 16          # query heads per kv head held in shared memory
MAX_HEAD_DIM = 256  # one thread per head dimension


def paged_attention(q: torch.Tensor, kv_pages_k: torch.Tensor,
                    kv_pages_v: torch.Tensor, page_table: torch.Tensor,
                    v_page_table: torch.Tensor, lengths: torch.Tensor,
                    starts: torch.Tensor) -> torch.Tensor:
    """q (B, K, G, hd); pools (F, Tp, K, hd); tables (B, P) int32;
    lengths/starts (B,) int32 — all contiguous on one CUDA device."""
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
    for t in (q, kv_pages_k, kv_pages_v):
        if t.device != dev or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("q and the pools must be contiguous, on one "
                             "device and of one dtype")
    for t, shape in ((page_table, (B, P)), (v_page_table, (B, P)),
                     (lengths, (B,)), (starts, (B,))):
        if (t.device != dev or t.dtype != torch.int32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"tables must be contiguous int32 {shape} on "
                             f"{dev}")
    out = torch.empty_like(q)
    fn = build.function("paged_attention", "paged_attention",
                        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _F, _I, _P])
    dispatch.count_launch("paged_attention")
    err = fn(q.data_ptr(), kv_pages_k.data_ptr(), kv_pages_v.data_ptr(),
             page_table.data_ptr(), v_page_table.data_ptr(),
             lengths.data_ptr(), starts.data_ptr(), out.data_ptr(),
             B, K, G, hd, Tp, P, hd ** -0.5, _DTYPES[q.dtype],
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "paged_attention")
    return out
