"""Plain PyTorch version of cow_scatter."""
from __future__ import annotations

import torch


def cow_scatter_ref(frames: torch.Tensor, page_ids: torch.Tensor,
                    pages: torch.Tensor) -> torch.Tensor:
    """frames: (F, E); page_ids: (n,) unique; pages: (n, E).  Writes the
    given pages into ``frames`` in place (COW commit) and returns it."""
    return frames.index_copy_(0, page_ids.to(torch.long),
                              pages.to(frames.dtype))
