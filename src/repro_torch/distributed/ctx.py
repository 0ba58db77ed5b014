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
the env with ``split_batch=True``), and ``seq_split(window)`` whether an
attention layer's cache is this rank's slice of its sequence axis (the
serve functions install the env with ``split_seq=cache_len`` when the
batch does not divide the data axes: ``cache_pspec``'s sequence-parallel
caches).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import P, placements

_ENV = None
_SPLIT_BATCH = False
_SPLIT_SEQ = 0


def set_env(env) -> None:
    global _ENV
    _ENV = env


def get_env():
    return _ENV


@contextlib.contextmanager
def use_env(env, split_batch: bool = False, split_seq: int = 0):
    """Installs ``env``; ``split_batch``: the rows are this rank's data
    shard; ``split_seq``: the whole cache length (``cache_len``) when the
    attention caches are split along their sequence axis, else 0."""
    global _ENV, _SPLIT_BATCH, _SPLIT_SEQ
    prev = _ENV, _SPLIT_BATCH, _SPLIT_SEQ
    _ENV, _SPLIT_BATCH, _SPLIT_SEQ = env, split_batch, split_seq
    try:
        yield
    finally:
        _ENV, _SPLIT_BATCH, _SPLIT_SEQ = prev


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


def _data_groups(env):
    names = list(env.axes)
    return [(env.mesh.get_group(names.index(a)), env.axes[a])
            for a in env.dp if env.axes[a] > 1]


def batch_groups():
    """[(group, size)] of every batch axis of size > 1, major first, when
    the rows the layers see are this rank's shard of the batch; else []."""
    env = _ENV
    if env is None or not _SPLIT_BATCH:
        return []
    return _data_groups(env)


def batch_index() -> int:
    """This rank's index among the data shards of ``batch_groups()``."""
    env = _ENV
    coord = dict(zip(env.axes, env.mesh.get_coordinate()))
    i = 0
    for a in env.dp:
        i = i * env.axes[a] + coord[a]
    return i


class SeqSplit(NamedTuple):
    """A rank's slice of an attention cache's sequence axis."""
    groups: list     # [(group, size)] of the data axes of size > 1
    index: int       # this rank's shard, major-to-minor over ``groups``
    first: int       # the slice's first position (a ring's first slot)
    length: int      # its positions (slots)

    @property
    def whole(self) -> int:
        """The cache's whole length (positions or ring slots)."""
        n = self.length
        for _, k in self.groups:
            n *= k
        return n


def seq_split(window=None):
    """The ``SeqSplit`` of the cache of an attention layer with ``window``
    (None: global) under the installed env, when it is this rank's slice:
    the caches are split along their sequence axis (``split_seq``) and
    the cache's whole length, ``cache_len`` or a ring's ``min(window,
    cache_len)`` slots, divides over the data axes, as ``cache_pspec``
    asks.  Else None: every data rank holds the cache whole."""
    env = _ENV
    if env is None or not _SPLIT_SEQ or env.dpsize == 1:
        return None
    n = _SPLIT_SEQ if window is None else min(window, _SPLIT_SEQ)
    if n % env.dpsize:
        return None
    length, i = n // env.dpsize, batch_index()
    return SeqSplit(_data_groups(env), i, i * length, length)


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
