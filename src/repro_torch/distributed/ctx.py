"""Activation-sharding context.

Model code is mesh-agnostic; launchers install an ``AxisEnv`` here and layers
pin their activations with ``constrain(x, dims)`` — logical dims 'dp'
(batch) / 'model' / None per axis, applied only when the dim size divides
the mesh axis.  Without an installed env every call is the identity, and
so is a call on a plain tensor: only a DTensor is redistributed.

In the reference this pinning keeps GSPMD from replicating the batch
inside scan bodies.  Here activations stay plain local tensors and the
layers split their own work: ``tp()`` says, in one place, whether the
installed env splits over ``model`` and which rank this is there, and
``batch_groups()`` whether the rows a layer sees are this rank's data
shard of a larger batch (the sharded step and serve functions install
the env with ``split_batch=True``).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import P, placements

_ENV = None
_SPLIT_BATCH = False


def set_env(env) -> None:
    global _ENV
    _ENV = env


def get_env():
    return _ENV


@contextlib.contextmanager
def use_env(env, split_batch: bool = False):
    global _ENV, _SPLIT_BATCH
    prev = _ENV, _SPLIT_BATCH
    _ENV, _SPLIT_BATCH = env, split_batch
    try:
        yield
    finally:
        _ENV, _SPLIT_BATCH = prev


class TP(NamedTuple):
    """A rank's place on the ``model`` axis."""
    env: object
    size: int
    rank: int
    group: object


def tp_of(env):
    """The ``TP`` of ``env`` on this rank, or None when ``model`` has
    size 1.  Only a ``DeviceMesh`` has ranks and groups."""
    if env is None or env.msize == 1:
        return None
    mesh = env.mesh
    if not hasattr(mesh, "get_group"):
        raise TypeError(f"tensor parallelism over {env.model!r} needs a "
                        f"DeviceMesh, not {type(mesh).__name__}")
    i = list(env.axes).index(env.model)
    return TP(env, env.msize, mesh.get_coordinate()[i], mesh.get_group(i))


def tp():
    """The installed env's ``TP`` (None without an env or when ``model``
    has size 1)."""
    return tp_of(_ENV)


def batch_groups():
    """[(group, size)] of every batch axis of size > 1, major first, when
    the rows the layers see are this rank's shard of the batch; else []."""
    env = _ENV
    if env is None or not _SPLIT_BATCH:
        return []
    names = list(env.axes)
    return [(env.mesh.get_group(names.index(a)), env.axes[a])
            for a in env.dp if env.axes[a] > 1]


def batch_index() -> int:
    """This rank's index among the data shards of ``batch_groups()``."""
    env = _ENV
    coord = dict(zip(env.axes, env.mesh.get_coordinate()))
    i = 0
    for a in env.dp:
        i = i * env.axes[a] + coord[a]
    return i


def _axis_size(env, name) -> int:
    if name == "dp":
        return env.dpsize
    return env.axes[name]


def constrain(x, dims):
    """dims: tuple of 'dp' | 'model' | None per axis of x."""
    env = _ENV
    if env is None or not isinstance(x, DTensor):
        return x
    spec = []
    for size, d in zip(x.shape, dims):
        if d is None:
            spec.append(None)
        elif size % _axis_size(env, d) == 0:
            spec.append(env.dp if d == "dp" else d)
        else:
            spec.append(None)
    return x.redistribute(x.device_mesh, placements(P(*spec), env))
