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

Sharded state (DTensor leaves, ``distributed/train_step.py``) is saved to
the same files: every rank of the mesh calls ``save_checkpoint``, the
state is all-gathered and the mesh's first rank writes it.  A load with
an ``env`` reads the files on the mesh's first rank and hands each rank
its shard (``scatter_tree``).
"""
from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np

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
    DTensor state is gathered first (a collective: every rank of its mesh
    calls this) and only the mesh's first rank writes."""
    mesh = _mesh_of(params)
    if mesh is not None:
        from repro_torch.distributed import comm
        from repro_torch.distributed.train_step import gather_tree
        params = gather_tree(params)
        opt_state = None if opt_state is None else gather_tree(opt_state)
        if not comm.is_first(mesh):
            return None
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


def _mesh_of(tree):
    """The device mesh of a tree of DTensors, None for plain tensors."""
    leaf = flatten_with_names(tree)[2][0]
    return getattr(leaf, "device_mesh", None)


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
                    device="cuda", env=None,
                    cfg=None) -> Tuple[int, Any, Any, dict]:
    """(step, params, opt_state or None, extra), every leaf a tensor on
    ``device`` of the manifest's dtype.  With an ``AxisEnv`` (and the arch
    ``cfg`` its rules read), every rank of ``env.mesh`` calls it, the
    mesh's first rank reads the files, and params and ``m``/``v`` come back
    as DTensors of each rank's shard; ``count`` is broadcast."""
    if env is not None:
        return _load_sharded(ckpt_dir, step, device, env, cfg)
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


def _load_sharded(ckpt_dir, step, device, env, cfg):
    from repro_torch.distributed import comm
    from repro_torch.distributed.train_step import scatter_state, scatter_tree
    first = comm.is_first(env.mesh)
    step, params, opt, extra = (load_checkpoint(ckpt_dir, step, device)
                                if first else (None, None, None, None))
    step, extra, has_opt = comm.broadcast_object(
        (step, extra, opt is not None), env.mesh)
    if has_opt:
        params, opt = scatter_state(params, opt, cfg, env, device)
    else:
        params = scatter_tree(params, cfg, env, device)
    return step, params, opt, extra


def checkpoint_nbytes(ckpt_dir: str, step: int) -> int:
    d = os.path.join(ckpt_dir, f"step-{step:08d}")
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
