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


def page_ids_tensor(page_ids, num_frames: int, device) -> torch.Tensor:
    """Page ids as a contiguous int32 tensor on ``device``.  Host ids are
    range-checked here, where it costs no device round trip: a kernel
    would read or write out of bounds where PyTorch indexing raises."""
    if isinstance(page_ids, torch.Tensor):
        return page_ids.to(device=device, dtype=torch.int32).contiguous()
    ids = np.atleast_1d(np.asarray(page_ids, np.int64)).ravel()
    if ids.size and (ids.min() < 0 or ids.max() >= num_frames):
        raise IndexError(f"page ids out of range [0, {num_frames})")
    return torch.from_numpy(ids.astype(np.int32)).to(device)


def run_table(starts, lens, num_frames: int):
    """Filter zero-length runs and range-check: host (starts, lens) int64."""
    starts = np.atleast_1d(np.asarray(starts, np.int64)).ravel()
    lens = np.atleast_1d(np.asarray(lens, np.int64)).ravel()
    keep = lens > 0
    starts, lens = starts[keep], lens[keep]
    if starts.size and (starts.min() < 0
                        or (starts + lens).max() > num_frames):
        raise IndexError(f"runs out of range [0, {num_frames})")
    return starts, lens


def run_offsets(starts, lens, device):
    """Device (starts, offs) int32 tables; offs = exclusive cumsum."""
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return (torch.from_numpy(starts.astype(np.int32)).to(device),
            torch.from_numpy(offs.astype(np.int32)).to(device))


def _check_frames(frames) -> None:
    if frames.dim() != 2:
        raise ValueError(f"frames must be (F, page_elems), got "
                         f"{tuple(frames.shape)}")


def page_gather(frames: torch.Tensor, page_ids, *, backend: str = "auto"):
    """Gather pool frames by page id: frames (F, E); page_ids (n,) ->
    (n, E).  Duplicate ids are allowed."""
    _check_frames(frames)
    ids = page_ids_tensor(page_ids, frames.shape[0], frames.device)
    if ids.numel() == 0:
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
    starts, lens = run_table(starts, lens, frames.shape[0])
    if starts.size == 0:
        return frames.new_zeros((0, frames.shape[1]))
    impl = dispatch.resolve_backend(backend, kernel_name="page_gather",
                                    device=frames.device)
    if impl == dispatch.IMPL_TORCH:
        return page_gather_runs_ref(frames, starts, lens)
    st, offs = run_offsets(starts, lens, frames.device)
    return kernel.page_gather_runs(frames, st, offs, int(lens.sum()))


def gather_assemble(frames: torch.Tensor, page_ids, shape, *,
                    out_dtype=None, backend: str = "auto"):
    """Fused gather->reassemble: the pages land directly in the
    destination tensor layout (flatten, trim the last page's padding,
    reshape) with no intermediate page list.  ``out_dtype`` other than the
    frames' dtype is a cast afterwards."""
    _check_frames(frames)
    ids = page_ids_tensor(page_ids, frames.shape[0], frames.device)
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape)) if shape else 1
    if size > ids.numel() * frames.shape[1]:
        raise ValueError(f"{ids.numel()} pages of {frames.shape[1]} cannot "
                         f"fill shape {shape}")
    impl = dispatch.resolve_backend(backend, kernel_name="page_gather",
                                    device=frames.device)
    if impl == dispatch.IMPL_TORCH:
        pages = page_gather_ref(frames, ids)
        out = pages.reshape(-1)[:size].reshape(shape)
    else:
        out = torch.empty(shape, dtype=frames.dtype, device=frames.device)
        kernel.page_gather(frames, ids, out=out)
    if out_dtype is not None:
        out = out.to(_dtypes.torch_dtype(out_dtype))
    return out
