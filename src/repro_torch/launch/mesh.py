"""Production and test meshes.  Functions, not module constants: importing
this file touches no device and no process group."""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 chips/pod; multi-pod adds a leading 2-pod axis (512).
    Shape-only: the sharding rules read it, no devices stand behind it."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_test_mesh(data: int = 2, model: int = 4, pod: int = 0,
                   device_type: str = "cuda", ranks=None):
    """A ``DeviceMesh`` over the process group already set up: ranks
    ``ranks`` (default: the first ``pod * data * model``) laid out row-major
    as (pod,) data, model.  Every rank of the group must call it, those
    outside the mesh included (creating its groups is collective)."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = (pod, data, model) if pod else (data, model)
    names = ("pod", "data", "model") if pod else ("data", "model")
    n = data * model * (pod or 1)
    ranks = torch.arange(n) if ranks is None else torch.as_tensor(ranks)
    return DeviceMesh(device_type, ranks.reshape(shape), mesh_dim_names=names)
