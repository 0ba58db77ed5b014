"""Dtype names, item sizes and the torch <-> numpy bridge.

The fork path keys pools, page tables and descriptors by dtype NAME
(``"float32"``, ``"bfloat16"``, ...), exactly as the reference package
does.  numpy has no bfloat16 without ``ml_dtypes``, so host-side bf16
data is carried as a ``uint16`` view: the same bytes and the same
``itemsize``, so wire meters (``pages.size * pages.dtype.itemsize``)
come out equal.
"""
from __future__ import annotations

import numpy as np
import torch

_TORCH = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_NAME = {v: k for k, v in _TORCH.items()}
# numpy storage dtype per name: bf16 rides as its uint16 bit pattern
_NUMPY = {k: np.dtype(k) for k in _TORCH if k != "bfloat16"}
_NUMPY["bfloat16"] = np.dtype(np.uint16)


def name(dtype) -> str:
    """Canonical name of a torch dtype, numpy dtype or name string."""
    if isinstance(dtype, torch.dtype):
        return _NAME[dtype]
    if isinstance(dtype, str):
        if dtype not in _TORCH:
            raise TypeError(f"unsupported dtype name {dtype!r}")
        return dtype
    n = np.dtype(dtype).name
    if n not in _TORCH:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return n


def torch_dtype(dtype) -> torch.dtype:
    return _TORCH[name(dtype)]


def numpy_dtype(dtype) -> np.dtype:
    """The numpy STORAGE dtype for ``dtype`` (uint16 for bfloat16)."""
    return _NUMPY[name(dtype)]


def itemsize(dtype) -> int:
    return _NUMPY[name(dtype)].itemsize


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host numpy array in its storage dtype (bf16 as uint16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
        return t.cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def from_numpy(a: np.ndarray, dtype, device=None) -> torch.Tensor:
    """Host storage array (uint16 for bfloat16) -> tensor of ``dtype``."""
    dt = name(dtype)
    a = np.ascontiguousarray(a)
    if dt == "bfloat16":
        if a.dtype != np.uint16:
            raise TypeError(f"bfloat16 storage must be uint16, got {a.dtype}")
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.astype(_NUMPY[dt], copy=False))
    return t if device is None else t.to(device)
