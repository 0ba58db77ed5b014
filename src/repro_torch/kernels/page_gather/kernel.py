"""ctypes launchers of the page_gather kernels in ``csrc/paging.cu``.

``page_gather`` copies frame ``ids[i]`` to output row ``i``;
``page_gather_runs`` copies frame ``starts[i] + j`` to row ``offs[i] + j``.
Both write into a destination tensor the caller may provide, stopping at
its last element, so an assembled tensor whose last page is partial is
filled in the same pass.  The launch goes on PyTorch's current stream and
does not synchronise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dispatch

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _check_args(frames: torch.Tensor, out: torch.Tensor, *tables) -> None:
    if frames.device.type != "cuda" or out.device != frames.device:
        raise ValueError("page_gather kernels need frames and out on one "
                         f"CUDA device, got {frames.device} / {out.device}")
    if frames.dim() != 2 or not frames.is_contiguous():
        raise ValueError("frames must be a contiguous (F, E) tensor")
    if not out.is_contiguous() or out.dtype != frames.dtype:
        raise ValueError("out must be contiguous and of the frames' dtype")
    for t in tables:
        if t.dtype != torch.int32 or t.device != frames.device \
                or not t.is_contiguous():
            raise ValueError("index tables must be contiguous int32 on the "
                             "frames' device")


def page_gather(frames: torch.Tensor, ids: torch.Tensor,
                out: torch.Tensor = None) -> torch.Tensor:
    """frames (F, E); ids (n,) int32 on the same device -> ``out`` (by
    default a new (n, E) tensor), rows past ``out``'s end dropped."""
    n, E = int(ids.numel()), frames.shape[1]
    if out is None:
        out = torch.empty((n, E), dtype=frames.dtype, device=frames.device)
    _check_args(frames, out, ids)
    isz = frames.element_size()
    row, limit = E * isz, out.numel() * isz
    fn = build.function("paging", "page_gather",
                        [_P, _P, _P, _L, _L, _L, _I, _P])
    unit = build.copy_unit(row, limit, frames, out)
    dispatch.count_launch("page_gather")
    err = fn(frames.data_ptr(), ids.data_ptr(), out.data_ptr(), n, row,
             limit, unit, torch.cuda.current_stream(frames.device).cuda_stream)
    build.check(err, "page_gather")
    return out


def page_gather_runs(frames: torch.Tensor, starts: torch.Tensor,
                     offs: torch.Tensor, n_out: int,
                     out: torch.Tensor = None) -> torch.Tensor:
    """Run-table gather: starts/offs (runs,) int32 with ``offs`` the
    exclusive cumsum of run lengths >= 1; ``n_out`` = sum of lengths."""
    E = frames.shape[1]
    if out is None:
        out = torch.empty((n_out, E), dtype=frames.dtype,
                          device=frames.device)
    _check_args(frames, out, starts, offs)
    isz = frames.element_size()
    row, limit = E * isz, out.numel() * isz
    fn = build.function("paging", "page_gather_runs",
                        [_P, _P, _P, _I, _P, _L, _L, _L, _I, _P])
    unit = build.copy_unit(row, limit, frames, out)
    dispatch.count_launch("page_gather_runs")
    err = fn(frames.data_ptr(), starts.data_ptr(), offs.data_ptr(),
             int(starts.numel()), out.data_ptr(), int(n_out), row, limit,
             unit, torch.cuda.current_stream(frames.device).cuda_stream)
    build.check(err, "page_gather_runs")
    return out
