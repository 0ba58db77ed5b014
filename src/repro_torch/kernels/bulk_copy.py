"""ctypes launchers of ``csrc/bulk_copy.cu``: page copies planned in bytes
and moved with the Tensor Memory Accelerator's bulk copies.

``scatter_ids`` serves cow_scatter and scatter_patch; ``gather_ids``
page_gather and gather_assemble; ``gather_runs`` the run-table gather
(page_gather_runs) and ``scatter_runs`` the run-table scatter
(cow_scatter_runs), twins whose span tables the kernel library builds from
the host runs.  Past the by-value capacity they hand the same plans in
numpy (``page_gather/plan.py:run_spans``, ``scatter_spans``) to
``copy_spans``.  A table of host ids or runs within the kernel's by-value
capacity (:func:`limits`) travels inside the launch, passed as ``bytes``:
no allocation, no host-to-device copy, no synchronisation.  A larger host
table is copied to the device first, and ids already on the device are
read there, by the same kernel.  Each returns the route it took
(``bulk-value`` or ``bulk-device``), or None when the addresses or sizes
are not 16-byte multiples and nothing was launched or uploaded: the caller
then takes ``copy_rows`` (``csrc/paging.cu``).  Launches go on PyTorch's
current stream and do not synchronise.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.page_gather.plan import run_spans, scatter_spans

# _B: a bytes object (``ndarray.tobytes()``), passed as a pointer to its
# buffer: cheaper per call than an array's ``ctypes.data``
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_B = ctypes.c_char_p
NOT_BULK = -1                  # csrc/bulk_copy.cu: kNotBulk
BULK_VALUE, BULK_DEVICE = "bulk-value", "bulk-device"

_limits = None


def limits() -> dict:
    """By-value capacities of the built kernel: ``ids`` and ``spans``
    entries, and the kernel parameter limit (bytes) they assume."""
    global _limits
    if _limits is None:
        vals = [ctypes.c_int() for _ in range(3)]
        fn = build.function("bulk_copy", "bulk_copy_limits", [_P] * 3)
        build.check(fn(*(ctypes.byref(v) for v in vals)), "bulk_copy_limits")
        _limits = dict(zip(("ids", "spans", "param_bytes"),
                           (v.value for v in vals)))
    return _limits


def span_table(src_off, dst_off, nbytes) -> np.ndarray:
    """The kernel's (3, n) int64 table: offsets and cumulative ends."""
    table = np.empty((3, len(nbytes)), np.int64)
    table[0], table[1] = src_off, dst_off
    np.cumsum(nbytes, out=table[2])
    return table


def spans_aligned(table: np.ndarray, *ptrs: int) -> bool:
    """The bulk path's alignment rule for a span table, as
    ``bulk_copy_spans`` applies it: 16-byte base pointers and offsets, and
    every span but the last a multiple of 16 bytes."""
    return not (any(p & 15 for p in ptrs) or (table[:2] & 15).any()
                or (table[2, :-1] & 15).any())


def ids_route(ids, row_bytes: int, capacity: int, *ptrs: int):
    """The route a row-id copy takes, decided on the host before anything
    is uploaded: ``bulk-value`` for host ids within the by-value
    ``capacity``, ``bulk-device`` for larger host ids and for ids already
    on the device, None where the bulk path cannot take the rows (base
    pointers or rows off 16 bytes; the kernel applies the same rule)."""
    bits = row_bytes
    for p in ptrs:
        bits |= p
    if bits & 15:
        return None
    if isinstance(ids, np.ndarray) and ids.size <= capacity:
        return BULK_VALUE
    return BULK_DEVICE


def runs_route(n_runs: int, row_bytes: int, limit_bytes: int,
               capacity: int, *ptrs: int):
    """The route a run-table gather or scatter takes, decided on the host
    before anything is uploaded: ``bulk-value`` for up to ``capacity``
    runs, ``bulk-device`` past it, None where the rows, the destination's
    end or the base pointers are off 16 bytes.  Every span of either
    starts at a multiple of the row on both sides and is a multiple of the
    row long, or ends at the destination's end, so a bulk route is taken
    only where :func:`spans_aligned` holds on its table."""
    bits = row_bytes | limit_bytes
    for p in ptrs:
        bits |= p
    if bits & 15:
        return None
    return BULK_VALUE if n_runs <= capacity else BULK_DEVICE


def ids_entry(entry: str):
    """The C entry ``bulk_scatter_ids`` or ``bulk_gather_ids`` (dst, src,
    host ids, device ids, n, row_bytes, limit_bytes, stream), its host ids
    passed as ``bytes``."""
    return build.function("bulk_copy", entry, (_P, _P, _B, _P, _L, _L, _L, _P))


def _ids_copy(entry: str, dst: torch.Tensor, src: torch.Tensor, ids,
              row_bytes: int, limit_bytes: int):
    dp, sp = dst.data_ptr(), src.data_ptr()
    route = ids_route(ids, row_bytes, limits()["ids"], dp, sp)
    if route is None:
        return None                    # not bulk: upload nothing
    host = dev = None
    if route == BULK_VALUE:
        host = ids.tobytes()
    else:
        if isinstance(ids, np.ndarray):
            ids = torch.from_numpy(ids).to(dst.device)
        dev = ids.data_ptr()
    err = ids_entry(entry)(dp, sp, host, dev, len(ids), row_bytes,
                           limit_bytes, build.stream(dst.device))
    build.check(err, entry)
    return route


def scatter_ids(dst: torch.Tensor, src: torch.Tensor, ids, row_bytes: int,
                limit_bytes: int):
    """dst byte rows ``ids[i]`` <- src byte row ``i``, in place, stopping at
    dst byte ``limit_bytes``.  ``ids``: a contiguous int32 numpy array
    (range-checked by the caller) or an int32 tensor on dst's device."""
    return _ids_copy("bulk_scatter_ids", dst, src, ids, row_bytes,
                     limit_bytes)


def gather_ids(dst: torch.Tensor, src: torch.Tensor, ids, row_bytes: int,
               limit_bytes: int):
    """dst byte row ``i`` <- src byte row ``ids[i]``, writing dst bytes
    ``[0, min(len(ids) * row_bytes, limit_bytes))``; ids may repeat.
    ``ids`` as for :func:`scatter_ids`."""
    return _ids_copy("bulk_gather_ids", dst, src, ids, row_bytes,
                     limit_bytes)


def copy_spans(dst: torch.Tensor, src: torch.Tensor, table: np.ndarray):
    """dst bytes ``[dst_off, dst_off + n)`` <- src bytes ``[src_off,
    src_off + n)`` for every span of ``table`` (see :func:`span_table`)."""
    fn = build.function("bulk_copy", "bulk_copy_spans",
                        (_P, _P, _P, _P, _I, _P))
    n = table.shape[1]
    dev, route = None, BULK_VALUE
    if n > limits()["spans"]:
        if not spans_aligned(table, dst.data_ptr(), src.data_ptr()):
            return None                # not bulk: upload nothing
        dev = torch.from_numpy(table).to(dst.device)
        route = BULK_DEVICE
    err = fn(dst.data_ptr(), src.data_ptr(), table.ctypes.data,
             None if dev is None else dev.data_ptr(), n,
             build.stream(dst.device))
    if err == NOT_BULK:
        return None
    build.check(err, "bulk_copy_spans")
    return route


def runs_entry(entry: str):
    """The C entry ``bulk_gather_runs`` or ``bulk_scatter_runs`` (dst, src,
    starts, lens, n, row_bytes, limit_bytes, stream), its tables passed as
    ``bytes``."""
    return build.function("bulk_copy", entry, (_P, _P, _B, _B, _I, _L, _L, _P))


def _runs_copy(entry: str, plan, dst: torch.Tensor, src: torch.Tensor,
               starts: np.ndarray, lens: np.ndarray, row_bytes: int,
               limit_bytes: int):
    dp, sp = dst.data_ptr(), src.data_ptr()
    route = runs_route(len(starts), row_bytes, limit_bytes,
                       limits()["spans"], dp, sp)
    if route is None:
        return None                    # not bulk: upload nothing
    if route == BULK_DEVICE:
        return copy_spans(dst, src, span_table(
            *plan(starts, lens, row_bytes, limit_bytes)))
    err = runs_entry(entry)(dp, sp, starts.tobytes(), lens.tobytes(),
                            len(starts), row_bytes, limit_bytes,
                            build.stream(dst.device))
    if err == NOT_BULK:
        return None
    build.check(err, entry)
    return route


def gather_runs(dst: torch.Tensor, src: torch.Tensor, starts: np.ndarray,
                lens: np.ndarray, row_bytes: int, limit_bytes: int):
    """dst byte row ``offs[i] + j`` <- src byte row ``starts[i] + j`` for
    ``j < lens[i]`` (``offs`` the exclusive cumsum of ``lens``), writing
    dst bytes ``[0, min(sum(lens) * row_bytes, limit_bytes))``.
    ``starts``, ``lens``: host 1-D int64 arrays, ``lens >= 1``,
    range-checked by the caller.  Past the by-value capacity the table of
    ``plan.run_spans`` goes through :func:`copy_spans`."""
    return _runs_copy("bulk_gather_runs", run_spans, dst, src, starts, lens,
                      row_bytes, limit_bytes)


def scatter_runs(dst: torch.Tensor, src: torch.Tensor, starts: np.ndarray,
                 lens: np.ndarray, row_bytes: int, limit_bytes: int):
    """dst byte rows ``starts[i] + j`` <- src byte row ``offs[i] + j`` for
    ``j < lens[i]`` (``offs`` the exclusive cumsum of ``lens``), in place,
    stopping at dst byte ``limit_bytes``.  Tables as for
    :func:`gather_runs`; runs must not overlap.  Past the by-value capacity
    the table of ``plan.scatter_spans`` goes through :func:`copy_spans`."""
    return _runs_copy("bulk_scatter_runs", scatter_spans, dst, src, starts,
                      lens, row_bytes, limit_bytes)
