"""Launchers of the cow_scatter kernels.

Both write in place into ``dst``: ``cow_scatter`` copies payload row ``i``
to row ``ids[i]``, ``cow_scatter_runs`` copies payload row ``offs[i] + j``
to row ``starts[i] + j``.  ``dst`` is read as rows of ``row_elems``
elements and writes stop at its last element, so a tensor whose last page
is partial is patched in place.  Destination rows must be unique.
``cow_scatter`` runs the bulk-copy kernel (``csrc/bulk_copy.cu``), or
``copy_rows`` (``csrc/paging.cu``) where rows or addresses are not 16-byte
multiples; ``cow_scatter_runs`` runs ``copy_rows``.  The launch goes on
PyTorch's current stream and does not synchronise.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, bulk_copy, dispatch

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _check_args(dst: torch.Tensor, pages: torch.Tensor, row_elems: int,
                *tables) -> None:
    if dst.device.type != "cuda" or pages.device != dst.device:
        raise ValueError("cow_scatter kernels need dst and pages on one "
                         f"CUDA device, got {dst.device} / {pages.device}")
    if not dst.is_contiguous() or not pages.is_contiguous():
        raise ValueError("dst and pages must be contiguous")
    if pages.dtype != dst.dtype:
        raise ValueError(f"pages dtype {pages.dtype} != dst dtype {dst.dtype}")
    if pages.dim() != 2 or pages.shape[1] != row_elems:
        raise ValueError(f"pages must be (n, {row_elems}), got "
                         f"{tuple(pages.shape)}")
    for t in tables:
        if t.dtype != torch.int32 or t.device != dst.device \
                or not t.is_contiguous():
            raise ValueError("index tables must be contiguous int32 on the "
                             "destination's device")


def cow_scatter(dst: torch.Tensor, ids, pages: torch.Tensor,
                row_elems: int) -> torch.Tensor:
    """dst rows ``ids[i]`` <- pages[i], in place; returns ``dst``.  ``ids``
    is a range-checked contiguous int32 numpy array or an int32 tensor on
    dst's device."""
    if isinstance(ids, torch.Tensor):
        _check_args(dst, pages, row_elems, ids)
    else:
        _check_args(dst, pages, row_elems)
    isz = dst.element_size()
    row, limit = row_elems * isz, dst.numel() * isz
    route = bulk_copy.scatter_ids(dst, pages, ids, row, limit)
    if route is None:
        if isinstance(ids, np.ndarray):
            ids = torch.from_numpy(ids).to(dst.device)
        fn = build.function("paging", "cow_scatter",
                            [_P, _P, _P, _L, _L, _L, _I, _P])
        unit = build.copy_unit(row, limit, dst, pages)
        err = fn(dst.data_ptr(), ids.data_ptr(), pages.data_ptr(),
                 int(ids.numel()), row, limit, unit, build.stream(dst.device))
        build.check(err, "cow_scatter")
        route = "copy_rows"
    dispatch.count_launch("cow_scatter", pages=len(ids), route=route)
    return dst


def cow_scatter_runs(dst: torch.Tensor, starts: torch.Tensor,
                     offs: torch.Tensor, pages: torch.Tensor,
                     row_elems: int) -> torch.Tensor:
    """dst rows ``starts[i] + j`` <- pages[offs[i] + j], in place, for the
    run lengths ``offs`` delimits; returns ``dst``."""
    _check_args(dst, pages, row_elems, starts, offs)
    isz = dst.element_size()
    row, limit = row_elems * isz, dst.numel() * isz
    fn = build.function("paging", "cow_scatter_runs",
                        [_P, _P, _P, _I, _P, _L, _L, _L, _I, _P])
    unit = build.copy_unit(row, limit, dst, pages)
    dispatch.count_launch("cow_scatter_runs", pages=int(pages.shape[0]),
                          route="copy_rows")
    err = fn(dst.data_ptr(), starts.data_ptr(), offs.data_ptr(),
             int(starts.numel()), pages.data_ptr(), int(pages.shape[0]), row,
             limit, unit, build.stream(dst.device))
    build.check(err, "cow_scatter_runs")
    return dst
