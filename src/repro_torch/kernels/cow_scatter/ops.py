"""Public wrappers for cow_scatter: backend dispatch (kernels/dispatch.py),
the run-table (extent-run) commit form, and the tensor-patch path used by
incremental reassembly.

Unlike the reference, whose arrays are immutable, ``cow_scatter`` and
``cow_scatter_runs`` commit into ``frames`` IN PLACE (the pool's frames
are the node's physical memory) and return it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.cow_scatter import kernel
from repro_torch.kernels.cow_scatter.ref import cow_scatter_ref
from repro_torch.kernels.page_gather.ops import kernel_ids, run_table
from repro_torch.kernels.page_gather.ref import expand_runs


def _payload(pages: torch.Tensor, n: int, like: torch.Tensor,
             dtype: torch.dtype, row_elems: int) -> torch.Tensor:
    """Payload rows as a contiguous (n, row_elems) tensor of ``dtype`` on
    ``like``'s device — the cast to the pool dtype of the reference."""
    if not isinstance(pages, torch.Tensor):
        raise TypeError(f"pages must be a tensor, got {type(pages)}")
    if (pages.dtype == dtype and pages.device == like.device
            and pages.shape == (n, row_elems) and pages.is_contiguous()):
        return pages
    pages = pages.to(device=like.device, dtype=dtype)
    if pages.numel() != n * row_elems:
        raise ValueError(f"payload of {tuple(pages.shape)} is not "
                         f"({n}, {row_elems})")
    return pages.reshape(n, row_elems).contiguous()


def cow_scatter(frames: torch.Tensor, page_ids, pages, *,
                backend: str = "auto") -> torch.Tensor:
    """Commit COW pages into pool frames: frames (F, E); page_ids (n,)
    unique; pages (n, E).  Updates ``frames`` in place and returns it."""
    ids = kernel_ids(page_ids, frames.shape[0], frames.device)
    if len(ids) == 0:
        return frames
    impl = dispatch.resolve_backend(backend, kernel_name="cow_scatter",
                                    device=frames.device)
    E = frames.shape[1]
    payload = _payload(pages, len(ids), frames, frames.dtype, E)
    if impl == dispatch.IMPL_TORCH:
        return cow_scatter_ref(frames, torch.as_tensor(ids,
                                                       device=frames.device),
                               payload)
    return kernel.cow_scatter(frames, ids, payload, E)


def cow_scatter_runs(frames: torch.Tensor, starts, lens, pages, *,
                     backend: str = "auto") -> torch.Tensor:
    """Run-table COW commit: each (start, len) pair is one contiguous
    destination extent; pages is the run-major payload (sum(lens), E).
    Runs must not overlap (fresh frames from the allocator)."""
    starts, lens, n = run_table(starts, lens, frames.shape[0])
    if n == 0:
        return frames
    impl = dispatch.resolve_backend(backend, kernel_name="cow_scatter",
                                    device=frames.device)
    E = frames.shape[1]
    payload = _payload(pages, n, frames, frames.dtype, E)
    if impl == dispatch.IMPL_TORCH:
        ids = torch.from_numpy(expand_runs(starts, lens)).to(frames.device)
        return cow_scatter_ref(frames, ids, payload)
    return kernel.cow_scatter_runs(frames, starts, lens, payload, E)


def scatter_patch(t: torch.Tensor, page_ids, rows, *, page_elems: int,
                  backend: str = "auto") -> torch.Tensor:
    """Patch changed pages into an already-assembled tensor ``t`` (the
    incremental-reassembly path), returning a new tensor.  ``rows`` is
    (n, page_elems) page payload; page ``p`` covers flat elements
    ``[p*page_elems, (p+1)*page_elems)`` of ``t`` (the final page's
    padding is trimmed).  Never re-gathers unchanged pages."""
    size = t.numel()
    npages = -(-size // page_elems)
    ids = kernel_ids(page_ids, npages, t.device)
    if len(ids) == 0:
        return t
    impl = dispatch.resolve_backend(backend, kernel_name="cow_scatter",
                                    device=t.device)
    rows = _payload(rows, len(ids), t, rows.dtype, page_elems)
    if impl == dispatch.IMPL_TORCH:
        buf = torch.zeros(npages * page_elems, dtype=rows.dtype,
                          device=t.device)
        buf[:size] = t.reshape(-1).to(rows.dtype)
        buf.view(npages, page_elems).index_copy_(
            0, torch.as_tensor(ids, device=t.device).to(torch.long), rows)
        return buf[:size].reshape(t.shape).to(t.dtype)
    out = torch.empty(t.shape, dtype=rows.dtype, device=t.device)
    out.copy_(t)
    kernel.cow_scatter(out, ids, rows, page_elems)
    return out.to(t.dtype)
