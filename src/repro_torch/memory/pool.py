"""Paged memory pools — the "physical memory" of a node.

A ``PagePool`` holds, per dtype, a single frames array of shape
(num_frames, PAGE_ELEMS).  Tensors are packed into pages
(memory/paging.py); page tables (core/pagetable.py) map tensor pages to
frames.  This is the analogue of the parent's physical memory that MITOSIS
children read over RDMA.

Two flavors share one interface:

* **host pool** (``device=None``, the default) — frames are a host numpy
  array mutated in place (bfloat16 held as its uint16 bit pattern).  The
  data plane is *run-coalesced*: gathers and scatters are decomposed into
  maximal contiguous extents and moved as slice copies (one memcpy per
  extent) instead of per-page fancy indexing, mirroring on the CPU
  exactly what the doorbell-batched wire path does with SGEs.
* **device pool** (``device=<torch device>``) — frames are one torch
  tensor per dtype on that device and the data plane routes through the
  kernels: ``write_pages`` is a ``cow_scatter`` commit in place,
  ``read_pages``/``assemble`` are ``page_gather`` launches (the CUDA
  kernels on a CUDA device, their plain versions on the CPU —
  kernels/dispatch.py).  This is the §5 "CPU out of the byte-moving
  loop" configuration.

``assemble`` is the fused gather->reassemble path: faulted pages land
directly in the destination tensor layout, with no intermediate page
list.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import _dtypes
from repro_torch.kernels import dispatch
from repro_torch.kernels.cow_scatter.ops import cow_scatter, cow_scatter_runs
from repro_torch.kernels.page_gather.ops import (gather_assemble, page_gather,
                                                 page_gather_runs)

PAGE_ELEMS = 32768  # elements per page (128 KiB fp32 / 64 KiB bf16)

# host gather/scatter switches to per-extent slice copies when the average
# run is at least this long; shorter runs stay on one fancy-index op (the
# python loop per run would dominate)
HOST_RUN_MIN_AVG = 4


def frame_runs(frames) -> Tuple[np.ndarray, np.ndarray]:
    """Decompose a frame list into maximal contiguous runs: (starts, lens).
    The doorbell/SGE shape — shared by the host slice-copy data plane, the
    run-table kernels, and the paging roofline's bucket accounting."""
    idx = np.atleast_1d(np.asarray(frames, np.int64)).ravel()
    if idx.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    breaks = np.nonzero(np.diff(idx) != 1)[0] + 1
    bounds = np.concatenate([[0], breaks, [idx.size]])
    return idx[bounds[:-1]].copy(), np.diff(bounds)


class OutOfFrames(RuntimeError):
    pass


class PagePool:
    """Frames are held as a host numpy array (in-place writes — the node's
    simulated physical memory) or, with ``device`` set, as a tensor on
    that device whose data plane is the page_gather/cow_scatter kernels.

    ``kernel_backend`` is the dispatch request for device-pool kernel
    launches (see kernels/dispatch.py); ``meter`` is an optional
    Counter-like that receives the ``kernel.{name}.{impl}`` choice counts
    and ``pool.*`` data-plane counters (NodeRuntime wires the network
    meter in, so benchmarks see which backend actually moved the bytes).
    """

    def __init__(self, page_elems: int = PAGE_ELEMS, grow_frames: int = 256,
                 initial_frames: int = 0, device=None,
                 kernel_backend: str = "auto", meter=None):
        self.page_elems = page_elems
        self.grow_frames = grow_frames
        # reserve this many frames per dtype up front: every growth step
        # copies the whole pool, so clusters that know their working set
        # reserve it and never pay a copy
        self.initial_frames = initial_frames
        self.device = None if device is None else torch.device(device)
        self.kernel_backend = kernel_backend
        self.meter = meter
        self._frames: Dict[str, object] = {}    # dtype name -> (F, page_elems)
        self._free: Dict[str, List[int]] = {}       # kept sorted ascending
        self._allocated: Dict[str, set] = {}

    # -- bookkeeping ---------------------------------------------------------

    def _dt(self, dtype) -> str:
        return _dtypes.name(dtype)

    def _count(self, key: str, n: int = 1) -> None:
        if self.meter is not None:
            self.meter[key] += n

    def _drain_kernel_meters(self) -> None:
        # surface the dispatch layer's chosen-impl counts (recorded by the
        # ops call that just ran) in this pool's meter
        dispatch.drain_meters_into(self.meter)

    def _zeros(self, dt: str, n: int):
        if self.device is None:
            return np.zeros((n, self.page_elems), _dtypes.numpy_dtype(dt))
        return torch.zeros((n, self.page_elems),
                           dtype=_dtypes.torch_dtype(dt), device=self.device)

    def _ensure_capacity(self, dt: str, n: int):
        if dt not in self._frames:
            self._frames[dt] = self._zeros(dt, self.initial_frames)
            self._free[dt] = list(range(self.initial_frames))
            self._allocated[dt] = set()
        while len(self._free[dt]) < n:
            old = self._frames[dt]
            # geometric growth: each concatenate copies the whole pool, so
            # growing by a constant amortizes to O(F^2) over a replay that
            # churns thousands of instances — doubling keeps it O(F)
            grow = max(self.grow_frames, n - len(self._free[dt]),
                       old.shape[0])
            if self.device is None:
                self._frames[dt] = np.concatenate([old, self._zeros(dt, grow)])
            else:
                self._frames[dt] = torch.cat([old, self._zeros(dt, grow)])
            self._free[dt].extend(range(old.shape[0], old.shape[0] + grow))

    # -- alloc/free ----------------------------------------------------------
    # The allocator is extent-aware: the free list is kept sorted so free
    # frames form coalesced runs, and alloc() hands out the best-fit
    # contiguous run (falling back to the largest runs when fragmented).
    # Contiguity is what makes a VMA's pages one scatter-gather entry on
    # the wire — the transport charges per contiguous run, so a seed
    # packed into extents is read with a handful of doorbell ops instead
    # of one op per page.

    def _free_runs(self, dt: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(free_frames, run_starts, run_lens) over the sorted free list."""
        arr = np.asarray(self._free[dt], np.int32)
        if arr.size == 0:
            return arr, np.zeros(0, np.int64), np.zeros(0, np.int64)
        breaks = np.nonzero(np.diff(arr) != 1)[0] + 1
        starts = np.concatenate([[0], breaks]).astype(np.int64)
        ends = np.concatenate([breaks, [arr.size]]).astype(np.int64)
        return arr, starts, ends - starts

    def free_extents(self, dtype) -> List[Tuple[int, int]]:
        """[(first_frame, run_len)] of the coalesced free runs (diagnostics)."""
        dt = self._dt(dtype)
        if dt not in self._free:
            return []
        arr, starts, lens = self._free_runs(dt)
        return [(int(arr[s]), int(l)) for s, l in zip(starts, lens)]

    def alloc(self, dtype, n: int) -> np.ndarray:
        dt = self._dt(dtype)
        if n <= 0:
            return np.zeros(0, np.int32)
        self._ensure_capacity(dt, n)
        if n == 1:
            # fault/COW hot path: pop the highest free frame — O(1), and
            # taking a run's tail frame never splits an extent
            f = self._free[dt].pop()
            self._allocated[dt].add(f)
            return np.asarray([f], np.int32)
        arr, starts, lens = self._free_runs(dt)
        fits = np.nonzero(lens >= n)[0]
        if fits.size:
            # best fit: the smallest run that holds the request whole, so
            # large extents survive for large allocations.  arr indexes the
            # sorted free list positionally, so the hot path removes one
            # slice instead of rebuilding the list.
            i = int(fits[np.argmin(lens[fits])])
            s = int(starts[i])
            take = arr[s:s + n].copy()
            del self._free[dt][s:s + n]
        else:
            # fragmented: span the largest runs first to minimize the
            # number of extents the allocation straddles
            parts, need = [], n
            for i in np.argsort(-lens):
                s, l = int(starts[i]), int(min(lens[i], need))
                parts.append(arr[s:s + l])
                need -= l
                if need == 0:
                    break
            take = np.concatenate(parts)
            taken = set(take.tolist())
            self._free[dt] = [f for f in self._free[dt] if f not in taken]
        self._allocated[dt].update(take.tolist())
        return np.asarray(take, np.int32)

    def free(self, dtype, frames) -> None:
        dt = self._dt(dtype)
        alloc = self._allocated[dt]
        returned = sorted({f for f in np.asarray(frames).tolist()
                           if f in alloc})
        if not returned:
            return
        alloc.difference_update(returned)
        if len(returned) == 1:       # common single-frame case: no re-sort
            bisect.insort(self._free[dt], returned[0])
        else:                        # one merge of two sorted lists
            self._free[dt] = sorted(self._free[dt] + returned)

    def num_allocated(self, dtype=None) -> int:
        if dtype is not None:
            return len(self._allocated.get(self._dt(dtype), ()))
        return sum(len(v) for v in self._allocated.values())

    def bytes_allocated(self) -> int:
        tot = 0
        for dt, alloc in self._allocated.items():
            tot += len(alloc) * self.page_elems * _dtypes.itemsize(dt)
        return tot

    def bytes_reserved(self) -> int:
        return sum(a.shape[0] * self.page_elems * _dtypes.itemsize(dt)
                   for dt, a in self._frames.items())

    # -- data plane ----------------------------------------------------------

    def _host_payload(self, dt: str, data) -> np.ndarray:
        """Payload as a numpy array in the pool's storage dtype."""
        if isinstance(data, torch.Tensor):
            return _dtypes.to_numpy(data.to(_dtypes.torch_dtype(dt)))
        data = np.asarray(data)
        want = _dtypes.numpy_dtype(dt)
        return data if data.dtype == want else data.astype(want)

    def _device_payload(self, dt: str, data) -> torch.Tensor:
        if isinstance(data, torch.Tensor):
            return data
        return _dtypes.from_numpy(np.asarray(data), dt, self.device)

    def write_pages(self, dtype, frames, pages) -> None:
        """COW-commit ``pages`` into ``frames``.  Device pools route through
        the cow_scatter kernel (one fused scatter per run table); host pools
        land each contiguous extent as one slice copy."""
        dt = self._dt(dtype)
        idx = np.asarray(frames, np.int32)
        if idx.size == 0:
            return
        self._count("pool.scatter_pages", int(idx.size))
        if self.device is not None:
            payload = self._device_payload(dt, pages)
            starts, lens = frame_runs(idx)
            if starts.size * 2 <= idx.size:
                cow_scatter_runs(self._frames[dt], starts, lens, payload,
                                 backend=self.kernel_backend)
            else:
                cow_scatter(self._frames[dt], idx, payload,
                            backend=self.kernel_backend)
            self._drain_kernel_meters()
            return
        dst = self._frames[dt]
        pages = self._host_payload(dt, pages)
        starts, lens = frame_runs(idx)
        if starts.size * HOST_RUN_MIN_AVG <= idx.size:
            # extent-run commit: one memcpy per contiguous run
            self._count("pool.scatter_runs", int(starts.size))
            o = 0
            for s, l in zip(starts.tolist(), lens.tolist()):
                dst[s:s + l] = pages[o:o + l]
                o += l
        else:
            dst[idx] = pages

    def write_rows(self, dtype, frames, slots, rows, row_elems: int) -> None:
        """In-place row update within pages: frames (B,), slots (B,),
        rows (B, row_elems). Used by the serving engine's token appends."""
        dt = self._dt(dtype)
        fidx = np.asarray(frames, np.int64)
        sidx = np.asarray(slots, np.int64)
        F = self._frames[dt].shape[0]
        view = self._frames[dt].reshape(F, -1, row_elems)
        if self.device is not None:
            view.index_put_(
                (torch.from_numpy(fidx).to(self.device),
                 torch.from_numpy(sidx).to(self.device)),
                self._device_payload(dt, rows).to(
                    device=self.device, dtype=view.dtype
                ).reshape(len(fidx), row_elems))
            return
        view[fidx, sidx] = self._host_payload(dt, rows)

    def _gather_host(self, dt: str, idx: np.ndarray,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
        """Run-coalesced host gather: one slice copy per contiguous extent
        when runs are long, one fancy-index op otherwise; lands directly in
        ``out`` when given (no intermediate page-list concatenate)."""
        src = self._frames[dt]
        starts, lens = frame_runs(idx)
        if out is None:
            out = np.empty((idx.size, self.page_elems), src.dtype)
        if starts.size * HOST_RUN_MIN_AVG <= idx.size:
            self._count("pool.gather_runs", int(starts.size))
            o = 0
            for s, l in zip(starts.tolist(), lens.tolist()):
                out[o:o + l] = src[s:s + l]
                o += l
        else:
            np.take(src, idx, axis=0, out=out)
        return out

    def read_pages(self, dtype, frames) -> torch.Tensor:
        """Gather frames -> (n, page_elems). The local-read data plane."""
        dt = self._dt(dtype)
        idx = np.asarray(frames, np.int32)
        self._count("pool.gather_pages", int(idx.size))
        if self.device is not None:
            starts, lens = frame_runs(idx)
            if starts.size * 2 <= idx.size:
                out = page_gather_runs(self._frames[dt], starts, lens,
                                       backend=self.kernel_backend)
            else:
                out = page_gather(self._frames[dt], idx,
                                  backend=self.kernel_backend)
            self._drain_kernel_meters()
            return out
        return _dtypes.from_numpy(self._gather_host(dt, idx), dt)

    def read_pages_host(self, dtype, frames,
                        out: Optional[np.ndarray] = None) -> np.ndarray:
        """Gather frames -> (n, page_elems) as a HOST numpy array in the
        pool's storage dtype.  This is what moves on the wire: the RNIC
        analogue DMAs physical frames, and the payload only becomes a
        device tensor at adoption/assembly time.  ``out`` (optionally
        pre-allocated by the caller) receives the pages in place."""
        dt = self._dt(dtype)
        idx = np.asarray(frames, np.int32)
        if self.device is not None:
            data = _dtypes.to_numpy(self.read_pages(dtype, frames))
            if out is not None:
                out[...] = data
                return out
            return data
        self._count("pool.gather_pages", int(idx.size))
        return self._gather_host(dt, idx, out=out)

    def assemble(self, dtype, frames, shape) -> torch.Tensor:
        """Fused gather->reassemble: gather ``frames`` and land them
        directly in the destination tensor layout (trim the final page's
        padding, reshape) — the fault handler's tensor-assembly fast path.

        Device pools run this as ONE page_gather launch writing straight
        into the destination tensor; host pools gather run-coalesced into
        a flat host buffer and return it as a CPU tensor."""
        dt = self._dt(dtype)
        idx = np.asarray(frames, np.int32)
        self._count("pool.assemble_pages", int(idx.size))
        size = int(np.prod(shape)) if len(tuple(shape)) else 1
        if self.device is not None:
            out = gather_assemble(self._frames[dt], idx, shape,
                                  backend=self.kernel_backend)
            self._drain_kernel_meters()
            return out
        flat = np.empty(idx.size * self.page_elems,
                        self._frames[dt].dtype)
        self._gather_host(dt, idx, out=flat.reshape(idx.size,
                                                    self.page_elems))
        return _dtypes.from_numpy(flat[:size].reshape(shape), dt)

    def frames_array(self, dtype):
        """Expose raw physical frames (what the RNIC reads): the device
        tensor itself, or a CPU tensor sharing the host pool's memory."""
        dt = self._dt(dtype)
        if self.device is not None:
            return self._frames[dt]
        return _dtypes.from_numpy(self._frames[dt], dt)
