"""Fault-tolerant checkpointing: per-leaf .npy + msgpack manifest, atomic
rename commit, optional async save thread, keep-last-k GC.

This is also the COLDSTART / C-R baseline of the paper's Table 1: restoring
from a checkpoint is what remote fork avoids.

The file layout and the manifest's keys are the reference's, so either
package reads the other's checkpoints.  The manifest is written by the
stdlib msgpack subset of ``core/descriptor.py`` (the same bytes as
``msgpack.packb``).  bfloat16 leaves are saved as their ``uint16`` bit
pattern (the reference's files hold the same bytes under the descr
``'<V2'``) and read back by the manifest's dtype name.

Sharded state (DTensor leaves) is saved to the same files by
``distributed/checkpoint.py``, around these functions.
"""
from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np
from torch.distributed.tensor import DTensor

from repro_torch import _dtypes
from repro_torch.core.descriptor import (flatten_with_names, packb,
                                         unflatten_from_paths, unpackb)


def _host_tree(tree):
    """(manifest entry, host arrays in their storage dtypes) of a tree of
    tensors; copies every leaf off the device now, since the caller goes
    on to update its tensors in place."""
    _, paths, leaves = flatten_with_names(tree)
    arrays = [_dtypes.to_numpy(t) for t in leaves]
    return {"paths": paths, "dtypes": [_dtypes.name(t.dtype) for t in leaves],
            "shapes": [list(a.shape) for a in arrays]}, arrays


def _load_tree(d: str, name: str, meta, device) -> Any:
    leaves = []
    for i, dt in enumerate(meta["dtypes"]):
        arr = np.load(os.path.join(d, f"{name}.{i}.npy"))
        if dt == "bfloat16":
            arr = arr.view(np.uint16)
        leaves.append(_dtypes.from_numpy(arr, dt, device))
    return unflatten_from_paths(meta["paths"], leaves)


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state=None,
                    extra: Optional[dict] = None, keep: int = 3,
                    async_save: bool = False):
    """Atomic: write into <dir>/tmp-<step>, fsync-free rename to step-<step>.
    The leaves are copied to the host before returning; with
    ``async_save`` the files are written by a thread, which is returned.
    Sharded state goes through ``distributed.checkpoint``."""
    if isinstance(flatten_with_names(params)[2][0], DTensor):
        raise TypeError("sharded state: save it with "
                        "repro_torch.distributed.checkpoint")
    trees = {"params": _host_tree(params)}
    if opt_state is not None:
        trees["opt"] = _host_tree(opt_state)

    def _do():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f"tmp-{step}")
        final = os.path.join(ckpt_dir, f"step-{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra or {}, "time": time.time()}
        for name, (meta, arrays) in trees.items():
            for i, arr in enumerate(arrays):
                np.save(os.path.join(tmp, f"{name}.{i}.npy"), arr)
            manifest[name] = meta
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(packb(manifest))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        _gc(ckpt_dir, keep)

    if async_save:
        t = threading.Thread(target=_do, daemon=True)
        t.start()
        return t
    _do()
    return None


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step-"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step-"))
    return int(steps[-1].split("-")[1]) if steps else None


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                    device="cuda") -> Tuple[int, Any, Any, dict]:
    """(step, params, opt_state or None, extra), every leaf a tensor on
    ``device`` of the manifest's dtype."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step-{step:08d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())
    params = _load_tree(d, "params", manifest["params"], device)
    opt = (_load_tree(d, "opt", manifest["opt"], device)
           if "opt" in manifest else None)
    return manifest["step"], params, opt, manifest.get("extra", {})


def checkpoint_nbytes(ckpt_dir: str, step: int) -> int:
    d = os.path.join(ckpt_dir, f"step-{step:08d}")
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
