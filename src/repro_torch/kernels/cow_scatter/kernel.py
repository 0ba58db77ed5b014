"""Launchers of the cow_scatter kernels.

Both write in place into ``dst``: ``cow_scatter`` copies payload row ``i``
to row ``ids[i]``, ``cow_scatter_runs`` copies payload row ``offs[i] + j``
to row ``starts[i] + j`` (``offs`` the exclusive cumsum of the run
lengths).  ``dst`` is read as rows of ``row_elems`` elements and writes
stop at its last element, so a tensor whose last page is partial is
patched in place.  Destination rows must be unique.  Both run the
bulk-copy kernel (``csrc/bulk_copy.cu``): ``cow_scatter`` over its ids,
``cow_scatter_runs`` over one span a run, its span table built from the
host runs inside the launch up to the by-value capacity (past it, the
table is uploaded).  Where rows or addresses are not 16-byte multiples
both take ``copy_rows`` (``csrc/paging.cu``).  Each launch is counted
with its route.  The launch goes on PyTorch's current stream and does not
synchronise.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, bulk_copy, dispatch
from repro_torch.kernels.page_gather.plan import run_offsets

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


def cow_scatter_runs(dst: torch.Tensor, starts: np.ndarray,
                     lens: np.ndarray, pages: torch.Tensor,
                     row_elems: int) -> torch.Tensor:
    """dst rows ``starts[i] + j`` <- pages[offs[i] + j], in place, for
    ``j < lens[i]``; returns ``dst``.  ``starts``, ``lens``: host 1-D int64
    arrays, ``lens >= 1``, range-checked by the caller."""
    _check_args(dst, pages, row_elems)
    if starts.dtype != np.int64 or lens.dtype != np.int64 \
            or starts.ndim != 1 or starts.shape != lens.shape:
        raise ValueError("starts and lens must be 1-D int64 arrays of one "
                         "length")
    isz = dst.element_size()
    row, limit = row_elems * isz, dst.numel() * isz
    route = bulk_copy.scatter_runs(dst, pages, starts, lens, row, limit)
    if route is None:
        copy_rows_runs(dst, *run_offsets(starts, lens, dst.device), pages,
                       row_elems)
        route = "copy_rows"
    dispatch.count_launch("cow_scatter_runs", pages=int(pages.shape[0]),
                          route=route)
    return dst


def copy_rows_runs(dst: torch.Tensor, starts: torch.Tensor,
                   offs: torch.Tensor, pages: torch.Tensor,
                   row_elems: int) -> None:
    """``cow_scatter_runs``' ``copy_rows`` launch, from the device int32
    tables of ``plan.run_offsets``."""
    _check_args(dst, pages, row_elems, starts, offs)
    isz = dst.element_size()
    row, limit = row_elems * isz, dst.numel() * isz
    fn = build.function("paging", "cow_scatter_runs",
                        [_P, _P, _P, _I, _P, _L, _L, _L, _I, _P])
    unit = build.copy_unit(row, limit, dst, pages)
    err = fn(dst.data_ptr(), starts.data_ptr(), offs.data_ptr(),
             int(starts.numel()), pages.data_ptr(), int(pages.shape[0]), row,
             limit, unit, build.stream(dst.device))
    build.check(err, "cow_scatter_runs")
