"""Launchers of the page_gather kernels.

``page_gather`` copies frame ``ids[i]`` to output row ``i``;
``page_gather_runs`` copies frame ``starts[i] + j`` to row ``offs[i] + j``.
Both write into a destination tensor the caller may provide, stopping at
its last element, so an assembled tensor whose last page is partial is
filled in the same pass.  Both run the bulk-copy kernel
(``csrc/bulk_copy.cu``).  ``page_gather`` takes its host ids in the launch
up to the by-value capacity, uploads more, and reads ids already on the
device where they are (cutting a long id list into runs, so that an
embedding's 9,216 consecutive pages travel as one span, cost more host
time on an H100 than the upload it saves; ``PERF.md``).
``page_gather_runs`` moves one span a run, its span table built from the
host runs inside the launch up to the by-value capacity (past it,
``plan.run_spans``' table is uploaded).  Where rows or addresses are not
16-byte multiples both take ``copy_rows`` (``csrc/paging.cu``).  Each
launch is counted with its route.  The launch goes on PyTorch's current
stream and does not synchronise.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, bulk_copy, dispatch
from repro_torch.kernels.page_gather.plan import run_offsets

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


def page_gather(frames: torch.Tensor, ids, out: torch.Tensor = None
                ) -> torch.Tensor:
    """frames (F, E); ids a range-checked contiguous int32 numpy array or
    an int32 tensor on the frames' device -> ``out`` (by default a new
    (n, E) tensor), rows past ``out``'s end dropped."""
    n, E = len(ids), frames.shape[1]
    if out is None:
        out = frames.new_empty((n, E))
    if isinstance(ids, torch.Tensor):
        _check_args(frames, out, ids)
    else:
        _check_args(frames, out)
    size = out.numel()
    if n == 0 or size == 0:
        return out
    isz = frames.element_size()
    row, limit = E * isz, size * isz
    route = bulk_copy.gather_ids(out, frames, ids, row, limit)
    if route is None:
        if isinstance(ids, np.ndarray):
            ids = torch.from_numpy(ids).to(frames.device)
        fn = build.function("paging", "page_gather",
                            [_P, _P, _P, _L, _L, _L, _I, _P])
        unit = build.copy_unit(row, limit, frames, out)
        err = fn(frames.data_ptr(), ids.data_ptr(), out.data_ptr(), n, row,
                 limit, unit, build.stream(frames.device))
        build.check(err, "page_gather")
        route = "copy_rows"
    dispatch.count_launch("page_gather", pages=n, route=route)
    return out


def page_gather_runs(frames: torch.Tensor, starts: np.ndarray,
                     lens: np.ndarray, n_out: int, out: torch.Tensor = None
                     ) -> torch.Tensor:
    """Run-table gather: host (starts, lens) 1-D int64 arrays with ``lens
    >= 1``, range-checked, and ``n_out = sum(lens)`` -> ``out`` (by default
    a new (n_out, E) tensor)."""
    E = frames.shape[1]
    if out is None:
        out = frames.new_empty((n_out, E))
    _check_args(frames, out)
    if starts.dtype != np.int64 or lens.dtype != np.int64 \
            or starts.ndim != 1 or starts.shape != lens.shape:
        raise ValueError("starts and lens must be 1-D int64 arrays of one "
                         "length")
    isz = frames.element_size()
    row, limit = E * isz, out.numel() * isz
    route = bulk_copy.gather_runs(out, frames, starts, lens, row, limit)
    if route is None:
        st, offs = run_offsets(starts, lens, frames.device)
        fn = build.function("paging", "page_gather_runs",
                            [_P, _P, _P, _I, _P, _L, _L, _L, _I, _P])
        unit = build.copy_unit(row, limit, frames, out)
        err = fn(frames.data_ptr(), st.data_ptr(), offs.data_ptr(),
                 int(st.numel()), out.data_ptr(), n_out, row, limit, unit,
                 build.stream(frames.device))
        build.check(err, "page_gather_runs")
        route = "copy_rows"
    dispatch.count_launch("page_gather_runs", pages=n_out, route=route)
    return out
