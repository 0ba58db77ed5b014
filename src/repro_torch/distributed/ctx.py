"""Activation-sharding context.

Model code is mesh-agnostic; launchers install an ``AxisEnv`` here and layers
pin their activations with ``constrain(x, dims)`` — logical dims 'dp'
(batch) / 'model' / None per axis, applied only when the dim size divides
the mesh axis.  Without an installed env every call is the identity, and
so is a call on a plain tensor: only a DTensor is redistributed.

In the reference this pinning keeps GSPMD from replicating the batch
inside scan bodies; here it is where tensor parallelism will place its
activations.
"""
from __future__ import annotations

import contextlib

from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import P, placements

_ENV = None


def set_env(env) -> None:
    global _ENV
    _ENV = env


def get_env():
    return _ENV


@contextlib.contextmanager
def use_env(env):
    global _ENV
    prev = _ENV
    _ENV = env
    try:
        yield
    finally:
        _ENV = prev


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
