"""The sharded data-parallel training step, and the layout of its state.

``make_sharded_train_step(cfg, tcfg, env)`` is the counterpart of the
reference's ``jax.jit(make_train_step(cfg, tcfg))`` with params and AdamW
``m``/``v`` sharded by ``sharding.param_pspec`` (ZeRO-3 over the fsdp
axes) and the batch by ``sharding.batch_pspec``.  GSPMD derives the
collectives from those shardings; here the step makes them explicitly,
all through ``comm``:

1. take this rank's rows of the global batch (contiguous, as
   ``batch_pspec`` splits them);
2. all-gather every sharded param;
3. run the single-device loss and gradient
   (``training.train_step.make_loss_and_grads``) on the local rows;
4. reduce-scatter each gradient to its param's placements, as a mean over
   the batch axes (an all-reduce for a leaf replicated over them);
5. the global norm over the shards, one all-reduce
   (``training.optimizer.global_norm``);
6. AdamW on the local shards, in place.

The loss it reports is the mean over the batch axes of the ranks' losses.
Params, ``m`` and ``v`` are DTensors built with ``DTensor.from_local``
(no collective); ``count`` stays a plain int32 tensor, the same on every
rank.  Tensor parallelism over ``model`` is not here yet: the mesh's
model axis must have size 1.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch import _dtypes
from repro_torch.configs.base import ArchConfig
from repro_torch.core.descriptor import flatten_with_names, unflatten_from_paths
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import (AxisEnv, batch_pspec,
                                              local_shape, param_pspec,
                                              placements, spec_axes)
from repro_torch.training.optimizer import adamw_update
from repro_torch.training.schedule import warmup_cosine
from repro_torch.training.train_step import TrainConfig, make_loss_and_grads


def local_part(t, spec, env: AxisEnv) -> torch.Tensor:
    """The view of full tensor ``t`` that this rank holds under ``spec``:
    along a dim sharded over several axes the index runs major-to-minor
    in mesh order, as in JAX."""
    coord = dict(zip(env.axes, env.mesh.get_coordinate()))
    shape = local_shape(t.shape, spec, env)
    idx = []
    for d, entry in enumerate(spec):
        i = 0
        for a in spec_axes(entry):
            i = i * env.axes[a] + coord[a]
        idx.append(slice(i * shape[d], (i + 1) * shape[d]))
    return t[tuple(idx)]


def _shard(name, full, cfg, env) -> DTensor:
    spec = param_pspec(name, tuple(full.shape), cfg, env)
    local = local_part(full, spec, env).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, env.mesh, placements(spec, env),
                              run_check=False)


def shard_tree(tree, cfg: ArchConfig, env: AxisEnv):
    """A tree of full tensors that every rank of the mesh holds, laid out
    by ``param_pspec``: each leaf a DTensor of this rank's shard (a copy).
    No collective."""
    names, paths, leaves = flatten_with_names(tree)
    return unflatten_from_paths(
        paths, [_shard(n, t, cfg, env) for n, t in zip(names, leaves)])


def scatter_tree(tree, cfg: ArchConfig, env: AxisEnv, device):
    """``tree`` (full tensors) from the mesh's first rank, laid out over the
    mesh as ``shard_tree`` does: each leaf is broadcast and every rank keeps
    its shard.  Every rank of the mesh calls it; the others pass None."""
    first = comm.is_first(env.mesh)
    meta = None
    if first:
        names, paths, leaves = flatten_with_names(tree)
        meta = (names, paths, [(tuple(t.shape), _dtypes.name(t.dtype))
                               for t in leaves])
    names, paths, kinds = comm.broadcast_object(meta, env.mesh)
    out = []
    for i, (name, (shape, dt)) in enumerate(zip(names, kinds)):
        buf = (leaves[i].to(device) if first else
               torch.empty(shape, dtype=_dtypes.torch_dtype(dt),
                           device=device))
        out.append(_shard(name, comm.broadcast(buf, env.mesh), cfg, env))
    return unflatten_from_paths(paths, out)


def scatter_state(params, opt, cfg: ArchConfig, env: AxisEnv, device):
    """Params and AdamW state (full tensors) from the mesh's first rank, as
    ``scatter_tree`` lays them out; ``count`` is broadcast.  Every rank of
    the mesh calls it; the others pass None for both."""
    first = comm.is_first(env.mesh)
    count = (opt["count"].to(device) if first else
             torch.zeros((), dtype=torch.int32, device=device))
    part = lambda k: scatter_tree(opt[k] if first else None, cfg, env, device)
    return scatter_tree(params, cfg, env, device), {
        "m": part("m"), "v": part("v"),
        "count": comm.broadcast(count, env.mesh)}


def gather_tree(tree):
    """Every DTensor leaf's full tensor (an all-gather each; every rank of
    the mesh calls it); plain leaves as they are."""
    _, paths, leaves = flatten_with_names(tree)
    return unflatten_from_paths(paths, [comm.gather(x) for x in leaves])


def local_nbytes(tree) -> int:
    """Bytes of the tree this rank holds (its shards of DTensor leaves)."""
    return sum((x.to_local() if isinstance(x, DTensor) else x).nbytes
               for x in flatten_with_names(tree)[2])


def make_sharded_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                            env: AxisEnv):
    """Returns train_step(params, opt_state, tokens, labels) -> (params,
    opt_state, metrics), as ``training.train_step.make_train_step`` does,
    for params and ``m``/``v`` laid out by ``shard_tree`` over
    ``env.mesh`` and the global batch ``tokens``/``labels`` (every rank
    passes all of it).  Every rank of the mesh calls each step."""
    if env.msize != 1:
        raise NotImplementedError(
            f"tensor parallelism over {env.model!r} ({env.msize}): the "
            f"sharded step runs data parallelism only")
    mesh = env.mesh
    batch_dims = [i for i, a in enumerate(env.axes) if a in env.dp]
    loss_and_grads = make_loss_and_grads(cfg, tcfg)

    def train_step(params, opt_state, tokens, labels):
        spec = batch_pspec(tokens.shape[0], env)
        tok, lab = local_part(tokens, spec, env), local_part(labels, spec,
                                                              env)
        _, paths, leaves = flatten_with_names(params)
        full = [comm.gather(x) for x in leaves]
        loss, grads = loss_and_grads(paths, full, tok, lab)
        del full
        shards = []
        for i, x in enumerate(leaves):
            g, grads[i] = grads[i], None
            shards.append(DTensor.from_local(
                comm.reduce_mean(g, x.placements, mesh, batch_dims), mesh,
                x.placements, run_check=False))
        if spec:     # the ranks' losses are over different rows
            loss = comm.all_reduce_sum(loss.clone(), mesh,
                                       batch_dims) / env.dpsize
        lr = warmup_cosine(opt_state["count"], peak_lr=tcfg.peak_lr,
                           warmup=tcfg.warmup, total=tcfg.total_steps)
        params, opt_state, gnorm = adamw_update(
            params, unflatten_from_paths(paths, shards), opt_state, lr,
            tcfg.adamw)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return train_step
