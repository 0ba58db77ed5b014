"""Plain PyTorch versions of page_gather and its run-table form."""
from __future__ import annotations

import numpy as np
import torch


def page_gather_ref(frames: torch.Tensor, page_ids: torch.Tensor):
    """frames: (F, page_elems); page_ids: (n,) int -> (n, page_elems)."""
    return torch.index_select(frames, 0, page_ids.to(torch.long))


def expand_runs(starts, lens) -> np.ndarray:
    """(starts, lens) run table -> flat page-id list, run-major.  Host-side
    numpy (the table is fault-handler metadata, never payload); zero-length
    runs contribute nothing."""
    starts = np.atleast_1d(np.asarray(starts, np.int64)).ravel()
    lens = np.atleast_1d(np.asarray(lens, np.int64)).ravel()
    keep = lens > 0
    starts, lens = starts[keep], lens[keep]
    if starts.size == 0:
        return np.zeros(0, np.int32)
    total = int(lens.sum())
    # vectorized concatenate-of-aranges: boundary deltas + one cumsum
    deltas = np.ones(total, np.int64)
    offs = np.cumsum(lens)[:-1]              # start index of runs 1..R-1
    deltas[offs] = starts[1:] - (starts[:-1] + lens[:-1]) + 1
    deltas[0] = starts[0]
    return np.cumsum(deltas).astype(np.int32)


def page_gather_runs_ref(frames: torch.Tensor, starts, lens):
    """Run-table gather: frames (F, E); starts/lens (num_runs,) with
    lens >= 0 -> (sum(lens), E), run-major."""
    ids = torch.from_numpy(expand_runs(starts, lens).astype(np.int64))
    return torch.index_select(frames, 0, ids.to(frames.device))
