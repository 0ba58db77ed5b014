"""Tensor <-> page packing."""
from __future__ import annotations

import math

import numpy as np
import torch


def num_pages(size: int, page_elems: int) -> int:
    return max(1, math.ceil(size / page_elems))


def to_pages(arr, page_elems: int):
    """Flatten + pad a tensor into (n_pages, page_elems).  Host numpy
    arrays stay numpy (packing is memory layout, not compute); tensors
    stay on their device."""
    if isinstance(arr, np.ndarray):
        flat = np.ravel(arr)
        n = num_pages(flat.size, page_elems)
        pad = n * page_elems - flat.size
        if pad:
            flat = np.pad(flat, (0, pad))
        return flat.reshape(n, page_elems)
    flat = arr.reshape(-1)
    n = num_pages(flat.numel(), page_elems)
    pad = n * page_elems - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(n, page_elems)

