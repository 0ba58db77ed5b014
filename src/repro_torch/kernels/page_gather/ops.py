"""Public wrappers for page_gather: shape checks, the shared backend
dispatch (the CUDA kernel for CUDA tensors, the plain version for CPU
tensors — see kernels/dispatch.py), the run-table (doorbell-shaped) form,
and the fused gather->reassemble path the fault handler uses for tensor
assembly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _dtypes
from repro_torch.kernels import dispatch
from repro_torch.kernels.page_gather import kernel
from repro_torch.kernels.page_gather.ref import (page_gather_ref,
                                                 page_gather_runs_ref)


# Up to this many ids or runs, kernel_ids and run_table check them as
# Python ints: numpy's reductions cost more than the loop (the replay's
# tables hold 1-2 ids or runs).
SMALL_RUNS = 64


def kernel_ids(page_ids, num_frames: int, device):
    """Page ids in their one form on the kernel path: a tensor becomes a
    contiguous int32 tensor on ``device`` (not read back, which would
    synchronise); host ids become a contiguous int32 numpy array,
    range-checked here, where it costs no device round trip: a kernel would
    read or write out of bounds where PyTorch indexing raises.  The pool's
    own tables (1-D contiguous int32) pass through as they are, uncopied.
    Plain versions make their own tensors from either form."""
    if isinstance(page_ids, torch.Tensor):
        return page_ids.to(device=device, dtype=torch.int32).reshape(-1) \
            .contiguous()
    ids = np.asarray(page_ids)
    own = ids.dtype == np.int32 and ids.ndim == 1 and ids.flags.c_contiguous
    if not own:
        ids = np.atleast_1d(np.asarray(ids, np.int64)).ravel()
    if ids.size <= SMALL_RUNS:
        i = ids.tolist()
        bad = i and (min(i) < 0 or max(i) >= num_frames)
    elif own:          # one reduction: negatives wrap past the end
        bad = ids.size and ids.view(np.uint32).max() >= num_frames
    else:
        bad = ids.size and (ids.min() < 0 or ids.max() >= num_frames)
    if bad:
        raise IndexError(f"page ids out of range [0, {num_frames})")
    return ids if own else ids.astype(np.int32)


def run_table(starts, lens, num_frames: int):
    """Filter zero-length runs and range-check: host (starts, lens) int64,
    and the pages they hold, ``sum(lens)``."""
    starts = np.asarray(starts, np.int64).reshape(-1)
    lens = np.asarray(lens, np.int64).reshape(-1)
    if starts.size == lens.size <= SMALL_RUNS:
        s, n = starts.tolist(), lens.tolist()
        if min(n, default=1) > 0:      # nothing to filter
            if any(a < 0 or a + b > num_frames for a, b in zip(s, n)):
                raise IndexError(f"runs out of range [0, {num_frames})")
            return starts, lens, sum(n)
    keep = lens > 0
    if not keep.all():
        starts, lens = starts[keep], lens[keep]
    if starts.size and (starts.min() < 0
                        or (starts + lens).max() > num_frames):
        raise IndexError(f"runs out of range [0, {num_frames})")
    return starts, lens, int(lens.sum())


def _check_frames(frames) -> None:
    if frames.dim() != 2:
        raise ValueError(f"frames must be (F, page_elems), got "
                         f"{tuple(frames.shape)}")


def page_gather(frames: torch.Tensor, page_ids, *, backend: str = "auto"):
    """Gather pool frames by page id: frames (F, E); page_ids (n,) ->
    (n, E).  Duplicate ids are allowed."""
    _check_frames(frames)
    ids = kernel_ids(page_ids, frames.shape[0], frames.device)
    if len(ids) == 0:
        return frames.new_zeros((0, frames.shape[1]))
    impl = dispatch.resolve_backend(backend, kernel_name="page_gather",
                                    device=frames.device)
    if impl == dispatch.IMPL_TORCH:
        return page_gather_ref(frames, ids)
    return kernel.page_gather(frames, ids)


def page_gather_runs(frames: torch.Tensor, starts, lens, *,
                     backend: str = "auto"):
    """Run-table gather — the doorbell-batch shape: each (start, len) pair
    is one contiguous frame extent (one SGE).  Returns (sum(lens), E),
    run-major.  Zero-length runs are filtered here; the kernel requires
    ``lens >= 1``."""
    _check_frames(frames)
    starts, lens, n_out = run_table(starts, lens, frames.shape[0])
    if n_out == 0:
        return frames.new_zeros((0, frames.shape[1]))
    impl = dispatch.resolve_backend(backend, kernel_name="page_gather",
                                    device=frames.device)
    if impl == dispatch.IMPL_TORCH:
        return page_gather_runs_ref(frames, starts, lens)
    return kernel.page_gather_runs(frames, starts, lens, n_out)


def gather_assemble(frames: torch.Tensor, page_ids, shape, *,
                    out_dtype=None, backend: str = "auto"):
    """Fused gather->reassemble: the pages land directly in the
    destination tensor layout (flatten, trim the last page's padding,
    reshape) with no intermediate page list.  ``out_dtype`` other than the
    frames' dtype is a cast afterwards."""
    _check_frames(frames)
    ids = kernel_ids(page_ids, frames.shape[0], frames.device)
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape)) if shape else 1
    if size > len(ids) * frames.shape[1]:
        raise ValueError(f"{len(ids)} pages of {frames.shape[1]} cannot "
                         f"fill shape {shape}")
    impl = dispatch.resolve_backend(backend, kernel_name="page_gather",
                                    device=frames.device)
    if impl == dispatch.IMPL_TORCH:
        pages = page_gather_ref(frames, ids)
        out = pages.reshape(-1)[:size].reshape(shape)
    else:
        out = frames.new_empty(shape)
        kernel.page_gather(frames, ids, out=out)
    if out_dtype is not None:
        out = out.to(_dtypes.torch_dtype(out_dtype))
    return out
