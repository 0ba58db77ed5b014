"""Carry parameters and optimizer state across from the reference package.

``params_from_numpy`` takes the reference's parameter tree with every
leaf already mapped to a numpy array (``jax.tree.map(np.asarray, p)`` on
the reference side) and returns the port's nested dict of tensors with the
same structure, names, shapes and dtypes.  bfloat16 leaves arrive as
numpy arrays of the ``bfloat16`` extension dtype; they are reinterpreted
through their 16-bit pattern, so this module needs no ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _dtypes


def _leaf_to_tensor(a, device="cuda") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = np.ascontiguousarray(a).view(np.uint16)
        return _dtypes.from_numpy(a.copy(), "bfloat16", device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device="cuda"):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return _leaf_to_tensor(tree, device)



def opt_state_from_numpy(state, device="cuda"):
    """The reference's AdamW state (``{"m", "v", "count"}``, every leaf a
    numpy array) -> the port's: ``m`` and ``v`` as ``params_from_numpy``
    gives them, ``count`` an int32 scalar tensor."""
    return {"m": params_from_numpy(state["m"], device),
            "v": params_from_numpy(state["v"], device),
            "count": torch.tensor(int(np.asarray(state["count"])),
                                  dtype=torch.int32, device=device)}
