"""Sharded checkpoints: the single-device files of
``training/checkpoint.py``, written from and read into state laid out
over a mesh.

``save_checkpoint`` takes params and AdamW state whose leaves are DTensors
(sharded over the fsdp axes, over ``model``, or both): every rank of the
mesh calls it, the state is all-gathered and the mesh's first rank writes
the files.  ``load_checkpoint`` with an ``AxisEnv`` reads the files on
the mesh's first rank and hands each rank its shard of every leaf
(``train_step.scatter_state``); without one it is the single-device
load.  The files are the same either way, so a checkpoint saved on one
layout loads on any other, or on one device, bit for bit.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.core.descriptor import flatten_with_names
from repro_torch.distributed import comm
from repro_torch.distributed.train_step import (gather_tree, scatter_state,
                                                scatter_tree)
from repro_torch.training import checkpoint as single


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state=None,
                    extra: Optional[dict] = None, keep: int = 3,
                    async_save: bool = False):
    """``training.checkpoint.save_checkpoint`` of sharded state: gathered
    (a collective: every rank of the mesh calls this), then written by
    the mesh's first rank only (the others return None)."""
    mesh = flatten_with_names(params)[2][0].device_mesh
    params = gather_tree(params)
    opt_state = None if opt_state is None else gather_tree(opt_state)
    if not comm.is_first(mesh):
        return None
    return single.save_checkpoint(ckpt_dir, step, params, opt_state, extra,
                                  keep, async_save)


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                    device="cuda", env=None,
                    cfg=None) -> Tuple[int, Any, Any, dict]:
    """(step, params, opt_state or None, extra).  With an ``AxisEnv`` (and
    the arch ``cfg`` its rules read) every rank of ``env.mesh`` calls it,
    the mesh's first rank reads the files, and params and ``m``/``v``
    come back as DTensors of each rank's shard; ``count`` is broadcast.
    Without one, the single-device load."""
    if env is None:
        return single.load_checkpoint(ckpt_dir, step, device)
    first = comm.is_first(env.mesh)
    step, params, opt, extra = (single.load_checkpoint(ckpt_dir, step, device)
                                if first else (None, None, None, None))
    step, extra, has_opt = comm.broadcast_object(
        (step, extra, opt is not None), env.mesh)
    if has_opt:
        params, opt = scatter_state(params, opt, cfg, env, device)
    else:
        params = scatter_tree(params, cfg, env, device)
    return step, params, opt, extra
