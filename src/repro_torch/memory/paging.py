"""Tensor <-> page packing."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import _dtypes


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



def from_pages(pages, shape, dtype):
    """The inverse of ``to_pages``: the first ``prod(shape)`` elements,
    reshaped and cast to ``dtype`` (a name or dtype).  numpy pages give a
    numpy array (bfloat16 as its ``uint16`` storage, which the pages must
    already hold); tensors stay on their device."""
    size = int(np.prod(shape)) if shape else 1
    if isinstance(pages, np.ndarray):
        want = _dtypes.numpy_dtype(dtype)
        if _dtypes.name(dtype) == "bfloat16" and pages.dtype != want:
            raise TypeError(f"bfloat16 pages must be uint16, got {pages.dtype}")
        return np.ravel(pages)[:size].reshape(shape).astype(want)
    flat = pages.reshape(-1)[:size]
    return flat.reshape(tuple(shape)).to(_dtypes.torch_dtype(dtype))
