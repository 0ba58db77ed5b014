"""The sharded training step, the sharded prefill and decode, and the
layout of their state.

``make_sharded_train_step(cfg, tcfg, env)`` is the counterpart of the
reference's ``jax.jit(make_train_step(cfg, tcfg))`` with params and AdamW
``m``/``v`` sharded by ``sharding.param_pspec`` (ZeRO-3 over the fsdp
axes, tensor parallelism over ``model``) and the batch by
``sharding.batch_pspec``.  GSPMD derives the collectives from those
shardings; here the step makes them explicitly, all through ``comm``:

1. take this rank's rows of the global batch: in each microbatch, its
   data shard of the reference's microbatch (``batch_rows``);
2. all-gather the embedding and the final norm over the fsdp axes,
   leaving their ``model`` shards local (``compute_params``); the group
   leaves stay DTensors, and the layer loop gathers each layer's slice
   as it comes to it (``lm._unit_params``, ``comm.gather_layer``), as
   GSPMD gathers each layer's inside the reference's scan: once per
   microbatch, and again in each checkpointed unit's recompute;
3. run the single-device loss and gradient
   (``training.train_step.make_loss_and_grads``) on the local rows, with
   the env installed (``ctx.use_env``): the layers split their work over
   ``model`` (``models/layers.py``) and the MoE takes its capacity over
   the whole microbatch;
4. sum over ``model`` the gradients that are parts there
   (``sharding.model_partial``);
5. reduce-scatter each gradient to its param's placements, as a mean over
   the batch axes (an all-reduce for a leaf replicated over them): 4 and
   5 for a group leaf's slice in the backward of its layer's gather, for
   the embedding and the final norm after the loss (``shard_grads``);
6. the global norm over the shards, one all-reduce
   (``training.optimizer.global_norm``);
7. AdamW on the local shards, in place.

The loss it reports is the mean over the batch axes of the ranks' losses.
Params, ``m`` and ``v`` are DTensors built with ``DTensor.from_local``
(no collective); ``count`` stays a plain int32 tensor, the same on every
rank.  ``make_sharded_serve_prefill`` / ``make_sharded_serve_decode``
are the reference's serve functions under the env: params laid out by
``param_pspec`` and gathered layer by layer, caches by ``cache_pspec``,
the batch over the data axes; a batch that does not divide them (batch-1
long-context decode) is replicated on every data rank, and the attention
caches are split along their sequence axis instead (``ctx.seq_split``).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch import _dtypes
from repro_torch.configs.base import ArchConfig
from repro_torch.core.descriptor import flatten_with_names, unflatten_from_paths
from repro_torch.distributed import comm, ctx
from repro_torch.distributed.sharding import (P, AxisEnv, batch_pspec,
                                              cache_pspec, local_shape,
                                              model_partial, param_pspec,
                                              placements, spec_axes)
from repro_torch.models import lm
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


def batch_rows(t, microbatches: int, env: AxisEnv):
    """(this rank's rows of the global batch ``t``, whether they are a
    data shard): in each of the ``microbatches`` microbatches
    ``t.reshape(mb, B // mb, ...)`` makes, its data shard as
    ``batch_pspec`` splits the microbatch, so that the rank's own
    microbatch ``i`` is its part of the reference's microbatch ``i``."""
    B, mb = t.shape[0], microbatches
    if B % mb:
        raise ValueError(f"batch {B} is not a multiple of {mb} "
                         f"microbatches")
    spec = batch_pspec(B // mb, env)
    if not spec:
        return t, False
    parts = t.reshape((mb, B // mb) + tuple(t.shape[1:]))
    return local_part(parts, P(None, spec[0]), env).reshape(
        (-1,) + tuple(t.shape[1:])), True


def _in_groups(name: str) -> bool:
    return name.startswith("groups/")


def compute_params(params, env: AxisEnv, groups: bool = True):
    """The leaves as the layers compute with them under ``env``: every
    DTensor gathered over the fsdp axes, its ``model`` shard kept; plain
    leaves as they are.  With ``groups`` False the leaves under
    ``groups`` stay DTensors, for the layer loop to gather one layer at a
    time (the sharded step and serve functions); only the embedding and
    the final norm are gathered here.  Every rank of the mesh calls it."""
    _, paths, leaves = flatten_with_names(params)
    return unflatten_from_paths(paths, [
        x if not groups and _in_groups("/".join(map(str, path)))
        else comm.gather(x, axes=env.fsdp)
        for path, x in zip(paths, leaves)])


def shard_grads(names, leaves, grads, cfg: ArchConfig, env: AxisEnv,
                groups: bool = True):
    """Each param's gradient (as the layers computed it from
    ``compute_params``, on this rank's rows) laid out as the param
    DTensor is: summed over ``model`` where it is a part there, then the
    mean over the batch axes reduce-scattered to the param's placements.
    With ``groups`` False the group leaves' gradients came so from the
    layer loop's gathers (``comm.gather_layer``) and are only laid out.
    ``grads`` is emptied as it goes."""
    tp = ctx.tp_of(env)
    batch_dims = [i for i, a in enumerate(env.axes) if a in env.dp]
    out = []
    for i, (name, x) in enumerate(zip(names, leaves)):
        g, grads[i] = grads[i], None
        if groups or not _in_groups(name):
            if tp is not None and model_partial(name, tuple(x.shape), cfg,
                                                env):
                g = comm.sum_over_model(g, tp)
            g = comm.reduce_mean(g, x.placements, env.mesh, batch_dims)
        out.append(DTensor.from_local(g, env.mesh, x.placements,
                                      run_check=False))
    return out


def make_sharded_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                            env: AxisEnv):
    """Returns train_step(params, opt_state, tokens, labels) -> (params,
    opt_state, metrics), as ``training.train_step.make_train_step`` does,
    for params and ``m``/``v`` laid out by ``shard_tree`` over
    ``env.mesh`` and the global batch ``tokens``/``labels`` (every rank
    passes all of it).  Every rank of the mesh calls each step."""
    mesh = env.mesh
    batch_dims = [i for i, a in enumerate(env.axes) if a in env.dp]
    loss_and_grads = make_loss_and_grads(cfg, tcfg)

    def train_step(params, opt_state, tokens, labels):
        mb = tcfg.microbatches
        (tok, split), (lab, _) = (batch_rows(tokens, mb, env),
                                  batch_rows(labels, mb, env))
        names, paths, leaves = flatten_with_names(params)
        full = flatten_with_names(compute_params(params, env,
                                                 groups=False))[2]
        with ctx.use_env(env, split_batch=split):
            loss, grads = loss_and_grads(paths, full, tok, lab)
        del full
        shards = shard_grads(names, leaves, grads, cfg, env, groups=False)
        if split:    # the ranks' losses are over different rows
            loss = comm.all_reduce_sum(loss.clone(), mesh,
                                       batch_dims) / env.dpsize
        lr = warmup_cosine(opt_state["count"], peak_lr=tcfg.peak_lr,
                           warmup=tcfg.warmup, total=tcfg.total_steps)
        params, opt_state, gnorm = adamw_update(
            params, unflatten_from_paths(paths, shards), opt_state, lr,
            tcfg.adamw)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return train_step


def _serve_env(t, env: AxisEnv, cache_len: int):
    """(this rank's rows of the batch ``t``, the ``ctx.use_env`` that
    serves them): a batch that divides the data axes is split over them;
    one that does not is replicated on every data rank, and the
    attention caches of length ``cache_len`` are split along their
    sequence axis instead (``cache_pspec``); recurrent states are then
    replicated."""
    rows, split = batch_rows(t, 1, env)
    return rows, ctx.use_env(env, split_batch=split,
                             split_seq=0 if split else cache_len)


def _laid_out(local, spec, env: AxisEnv, shape):
    """A DTensor of this rank's ``local`` part of a tensor of ``shape``."""
    if tuple(local.shape) != local_shape(shape, spec, env):
        raise ValueError(f"a part {tuple(local.shape)} of {tuple(shape)} "
                         f"is not laid out by {spec}")
    return DTensor.from_local(local.contiguous(), env.mesh,
                              placements(spec, env), run_check=False)


def _whole_cache_shape(name, local, cfg, batch, cache_len):
    """The whole shape of a cache leaf of which this rank holds ``local``
    (``cache_pspec`` splits the batch, or an attention cache's sequence,
    and its heads or head_dim: its whole length is ``cache_len``, or a
    ring's ``min(window, cache_len)`` slots, and its K and hd are the
    config's)."""
    shape = list(local)
    shape[1] = batch
    parts = name.split("/")         # groups/<g>/blocks/<b>/<k or v>
    if parts[-1] in ("k", "v"):
        window = cfg.groups[int(parts[1])].unit[int(parts[3])].window
        shape[2] = cache_len if window is None else min(window, cache_len)
        shape[-2:] = [cfg.num_kv_heads, cfg.head_dim]
    return tuple(shape)


def _serve_out(cfg, env, logits, caches, batch, shapes):
    """Logits (B, V) over the data axes (replicated for a batch that does
    not divide them) and caches by ``cache_pspec``; ``shapes`` the
    caches' whole shapes."""
    lspec = P(*(batch_pspec(batch, env) or (None,)),
              *[None] * (logits.dim() - 1))
    names, paths, leaves = flatten_with_names(caches)
    return (_laid_out(logits, lspec, env, (batch,) + tuple(logits.shape[1:])),
            unflatten_from_paths(paths, [
                _laid_out(c, cache_pspec(n, s, cfg, env, batch), env, s)
                for n, s, c in zip(names, shapes, leaves)]))


def lay_out_cache(name, whole, cfg: ArchConfig, env: AxisEnv, batch: int):
    """The whole cache leaf ``name`` that every rank of the mesh holds,
    laid out by ``cache_pspec`` for a global batch of ``batch``: a
    DTensor of this rank's part (a copy).  No collective."""
    spec = cache_pspec(name, tuple(whole.shape), cfg, env, batch)
    return _laid_out(local_part(whole, spec, env).clone(), spec, env,
                     tuple(whole.shape))


def make_sharded_serve_prefill(cfg: ArchConfig, cache_len: int,
                               env: AxisEnv, q_chunk: int = 1024):
    """prefill(params, tokens) -> (last_logits, caches) for the global
    batch ``tokens`` (every rank passes all of it) and params laid out by
    ``shard_tree`` (or already ``compute_params``): the logits a DTensor
    over the data axes, the caches DTensors laid out by ``cache_pspec``.
    Every rank of the mesh calls it."""
    def serve_prefill(params, tokens):
        tok, env_ = _serve_env(tokens, env, cache_len)
        with env_:
            logits, caches = lm.prefill(
                compute_params(params, env, groups=False), cfg, tok,
                cache_len, q_chunk=q_chunk)
        names, _, leaves = flatten_with_names(caches)
        return _serve_out(cfg, env, logits, caches, tokens.shape[0], [
            _whole_cache_shape(n, c.shape, cfg, tokens.shape[0], cache_len)
            for n, c in zip(names, leaves)])
    return serve_prefill


def make_sharded_serve_decode(cfg: ArchConfig, env: AxisEnv):
    """decode(params, caches, token, pos) -> (logits, caches): one token of
    the global batch (``token``, ``pos`` (B,)) from ``caches`` as
    ``make_sharded_serve_prefill`` lays them out."""
    def serve_decode(params, caches, token, pos):
        names, paths, leaves = flatten_with_names(caches)
        # the cache length: the longest attention cache's (a global
        # layer's; with only window layers, their rings' lengths follow
        # from the longest ring's as from the cache length)
        cache_len = max([c.shape[2] for n, c in zip(names, leaves)
                         if n.split("/")[-1] in ("k", "v")], default=0)
        (tok, env_), (p, _) = (_serve_env(token, env, cache_len),
                               batch_rows(pos, 1, env))
        local = unflatten_from_paths(paths, [c.to_local() for c in leaves])
        with env_:
            logits, new = lm.decode_step(
                compute_params(params, env, groups=False), cfg, local, tok,
                p)
        return _serve_out(cfg, env, logits, new, token.shape[0],
                          [tuple(c.shape) for c in leaves])
    return serve_decode
