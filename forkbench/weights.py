"""The benchmark's weights: made on the device from the run's seed, in one
draw, in the leaf layout the program takes (``repro_torch.models.lm``'s
nested dict: each block's leaves stacked over its group's repeats).

The architecture's module (``forkbench/archs``) lists the leaves in
order, each with its path, shape and scale: projections by
``1/sqrt(fan_in)``, the router and the token embedding by 0.02, and the
norms' scales (used as ``1 + scale``) by 0.1.  Every leaf is a view of
one float32 buffer filled by a single ``normal_`` from a generator
seeded with ``--seed``, in that order, then scaled leaf by leaf.  The
same seed on the same device gives the same weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from forkbench import archs

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], float]


def leaves(m: dict) -> List[Leaf]:
    """(path, shape, scale) of every leaf of model ``m``."""
    return archs.load(m).leaves(m)


def param_count(m: dict) -> int:
    return sum(math.prod(s) for _, s, _ in leaves(m))


def _lists(node):
    """The nested dict with every dict whose keys are all numbers turned
    into the list they index."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        keys = sorted(node, key=int)
        if [int(k) for k in keys] != list(range(len(keys))):
            raise ValueError(f"list indices {keys} are not 0..{len(keys) - 1}")
        return [_lists(node[k]) for k in keys]
    return {k: _lists(v) for k, v in node.items()}


def make(m: dict, seed: int, device) -> dict:
    """The nested weight dict of ``m``, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    spec = leaves(m)
    buf = torch.empty(sum(math.prod(s) for _, s, _ in spec),
                      dtype=torch.float32, device=device)
    buf.normal_(generator=gen)
    tree: Dict = {}
    off = 0
    for path, shape, scale in spec:
        n = math.prod(shape)
        t = buf[off:off + n].view(shape).mul_(scale)
        off += n
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return _lists(tree)


def flat(tree, prefix: str = ""):
    """(name, tensor) of every leaf of a nested dict/list, in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree
