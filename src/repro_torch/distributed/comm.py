"""Every collective of the sharded training path, counted.

The reference gets its collectives from GSPMD: ``jax.jit`` with the
shardings of ``sharding.params_shardings`` inserts an all-gather of each
FSDP-sharded param before its use, a reduce-scatter of its gradient to the
param's sharding, an all-reduce of the gradients of replicated params and
of the loss and the global norm, and ``jax.device_put`` of host arrays with
a sharding broadcasts them.  Here the sharded step calls them explicitly,
through this module only:

- ``gather``: a DTensor's shards into the full tensor (``all-gather``,
  ``dist.all_gather_into_tensor`` once per sharded mesh dim), or, for a
  check, into the mesh's first rank only (``gather``, ``dist.gather``);
- ``reduce_mean``: a full gradient into the param's shard, as a mean over
  the batch axes (``reduce-scatter``, ``dist.reduce_scatter_tensor``, on a
  mesh dim the param is sharded over; ``all-reduce``, ``dist.all_reduce``,
  on one it is replicated over);
- ``all_reduce_sum``: a scalar's sum over the mesh (``all-reduce``);
- ``broadcast`` / ``broadcast_object``: a tensor or a picklable object from
  the mesh's first rank to the others (``device_put`` of a host array;
  checkpoint loads and the join's layout);
- tensor parallelism over ``model`` (``tp``, the ``ctx.TP`` of the rank),
  where GSPMD partitions the layers' einsums: Megatron's two operators
  ``copy_to_model`` (identity forward, all-reduce of the gradient) and
  ``reduce_from_model`` (all-reduce forward, identity backward), both
  ``tp_all_reduce``; ``gather_model`` / ``slice_model`` along one dim
  (``tp_all_gather`` forward or backward); ``gather_shared``
  (``tp_all_gather`` forward, ``tp_reduce_scatter`` backward);
  ``all_reduce_max`` (``tp_all_reduce_max``, no gradient);
  ``sum_over_model``, a partial gradient's sum in the step
  (``tp_grad_all_reduce``);
- ``gather_counts``: the MoE's per-expert counts of every data shard of a
  microbatch (``moe_counts``, an all-gather over the batch axes);
- ``gather_layer``: one layer's slice of a param inside the layer loop,
  gathered over the fsdp axes (``fsdp_layer_gather``), its gradient
  summed over ``model`` where it is a part there and reduce-scattered
  (``tp_grad_all_reduce``, ``reduce_scatter`` / ``all_reduce``);
- ``sp_attn_combine``: decode attention over a sequence-parallel cache,
  each data shard's max, sum of exponentials and unnormalised output
  all-gathered over the batch axes and merged (``sp_attn_combine``).

The same collectives run on every backend and device: gloo takes
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` on CUDA tensors
(checked on the card by ``probe``), so nothing is staged through host
memory here (gloo itself copies CUDA tensors through the host).  Each call
adds to ``stats[kind]``: its calls, the bytes of its full tensor on this
rank (an all-gather's output, a reduce-scatter's input, the tensor of an
all-reduce or a broadcast, an object broadcast's pickle; of those, a ring
moves ``(k-1)/k`` in and out of each of ``k`` ranks, twice for an
all-reduce), and its wall seconds, synced on a CUDA device.  Under the
dry run (``op_analysis``, ``meter``) a call may count for several.  Not
counted: what creating a ``DeviceMesh``'s groups and ``probe`` exchange
(set-up, a few small messages).
"""
from __future__ import annotations

import pickle
import time
from collections import defaultdict

import torch
import torch.distributed as dist

stats = defaultdict(lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})


def reset() -> None:
    stats.clear()


def snapshot() -> dict:
    return {k: dict(v) for k, v in stats.items()}


# The dry run's meter (``op_analysis.analyze``), or None: called with each
# collective's kind and the bytes of its result on this rank (an
# all-gather's output, a reduce-scatter's part, an all-reduce's tensor);
# returns how many times to count the call (more than once for a loop run
# once for its trips, ``models/scan.py``).
meter = None


def _timed(kind, device, call, nbytes: int, result: int = None) -> None:
    """Runs one collective, ``call()``, into ``stats[kind]``; ``result``:
    its result's bytes where they are not ``nbytes``."""
    device = torch.device(device)
    t0 = time.perf_counter()
    call()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    n = 1 if meter is None else meter(kind, nbytes if result is None
                                      else result)
    s = stats[kind]
    s["calls"] += n
    s["bytes"] += n * nbytes
    s["seconds"] += time.perf_counter() - t0


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def gather(x, axes=None, first_only=False) -> torch.Tensor:
    """The full tensor of DTensor ``x``: its shards all-gathered, minor mesh
    dim first, along the dims they shard; with ``axes`` (mesh axis names)
    over those mesh dims only, the others' shards kept.  With
    ``first_only`` the shards are gathered into the mesh's first rank
    alone, which gets the full tensor, and every other rank gets None (a
    check's read: a quarter of the bytes of an all-gather on 4 ranks).
    Every rank of the mesh calls it; a plain tensor comes back as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    if not first_only:
        return _gather_dims(x.to_local(), mesh, x.placements, axes,
                            "all_gather")
    out = x.to_local()
    for i, p, k in _sharded_dims(mesh, x.placements, axes):
        out = _gather_first(out.contiguous(), mesh.get_group(i), k, p.dim)
        if out is None:     # so is every rank of its later groups
            return None
    return out if is_first(mesh) else None


def _sharded_dims(mesh, placements, axes):
    """(mesh dim, placement, size) of every mesh dim of size > 1 that
    ``placements`` shard, minor first; with ``axes`` of those only."""
    from torch.distributed.tensor import Shard
    for i in reversed(range(mesh.ndim)):
        p, k = placements[i], mesh.size(i)
        if (isinstance(p, Shard) and k > 1 and (
                axes is None or mesh.mesh_dim_names[i] in axes)):
            yield i, p, k


def _gather_dims(out, mesh, placements, axes, kind):
    """The local part ``out`` all-gathered along the dims its
    ``placements`` shard over the mesh dims named ``axes`` (all: None),
    minor mesh dim first."""
    for i, p, k in _sharded_dims(mesh, placements, axes):
        part = out.contiguous()
        buf = torch.empty((k * part.shape[0],) + tuple(part.shape[1:]),
                          dtype=part.dtype, device=part.device)
        _timed(kind, out.device, lambda: dist.all_gather_into_tensor(
            buf, part, group=mesh.get_group(i)), _nbytes(buf))
        out = torch.cat(buf.chunk(k), dim=p.dim)
    return out


def _gather_first(part, group, k, dim):
    """The ``k`` ranks' ``part``s of ``group`` concatenated along ``dim``
    on its first rank; None on the others."""
    first = dist.get_rank(group) == 0
    bufs = [torch.empty_like(part) for _ in range(k)] if first else None
    _timed("gather", part.device, lambda: dist.gather(
        part, bufs, dst=dist.get_global_rank(group, 0), group=group),
        _nbytes(part) * k)
    return torch.cat(bufs, dim=dim) if first else None


def reduce_mean(full, placements, mesh, batch_dims) -> torch.Tensor:
    """This rank's shard of the mean over the mesh dims ``batch_dims`` of
    every rank's ``full``: reduce-scattered along the dim a placement
    shards, all-reduced where it replicates.  Other mesh dims are left
    alone (they hold the same gradient)."""
    from torch.distributed.tensor import Shard
    out = full
    n = 1
    for i in batch_dims:
        k = mesh.size(i)
        if k == 1:
            continue
        n *= k
        p, group = placements[i], mesh.get_group(i)
        if isinstance(p, Shard):
            src = torch.cat(out.chunk(k, dim=p.dim))
            part = torch.empty((src.shape[0] // k,) + tuple(src.shape[1:]),
                               dtype=out.dtype, device=out.device)
            _timed("reduce_scatter", out.device,
                   lambda: dist.reduce_scatter_tensor(part, src, group=group),
                   _nbytes(src), _nbytes(part))
            out = part
        else:
            out = out.contiguous()
            _timed("all_reduce", out.device,
                   lambda: dist.all_reduce(out, group=group), _nbytes(out))
    return out.div_(n) if n > 1 else out


def all_reduce_sum(x, mesh, dims=None) -> torch.Tensor:
    """``x`` (a scalar tensor) summed over the mesh dims ``dims`` (all of
    them by default), in place."""
    dims = range(mesh.ndim) if dims is None else dims
    for i in dims:
        if mesh.size(i) > 1:
            group = mesh.get_group(i)
            _timed("all_reduce", x.device,
                   lambda: dist.all_reduce(x, group=group), _nbytes(x))
    return x


def broadcast(x, mesh) -> torch.Tensor:
    """``x`` from the rank at coordinate 0 of every mesh dim to all the
    mesh's ranks, in place (``x`` is a same-shaped buffer elsewhere)."""
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            group = mesh.get_group(i)
            src = dist.get_global_rank(group, 0)
            _timed("broadcast", x.device, lambda: dist.broadcast(
                x, src=src, group=group), _nbytes(x))
    return x


def broadcast_object(obj, mesh):
    """A picklable ``obj`` from the mesh's first rank (see ``broadcast``)
    to all its ranks; others pass anything and get the first rank's.  Its
    bytes are the pickled object's."""
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            group = mesh.get_group(i)
            box, src = [obj], dist.get_global_rank(group, 0)
            _timed("broadcast", "cpu", lambda: dist.broadcast_object_list(
                box, src=src, group=group), 0)
            obj = box[0]
            stats["broadcast"]["bytes"] += len(pickle.dumps(obj))
    return obj


# ---------------------------------------------------------------------------
# tensor parallelism over ``model``
# ---------------------------------------------------------------------------


def _all_reduce(x, tp, kind="tp_all_reduce", op=None) -> torch.Tensor:
    out = x.contiguous().clone()
    kw = {} if op is None else {"op": op}
    _timed(kind, out.device, lambda: dist.all_reduce(out, group=tp.group,
                                                     **kw), _nbytes(out))
    return out


def _all_gather(x, tp, dim) -> torch.Tensor:
    part = x.movedim(dim, 0).contiguous()
    buf = torch.empty((tp.size * part.shape[0],) + tuple(part.shape[1:]),
                      dtype=part.dtype, device=part.device)
    _timed("tp_all_gather", part.device, lambda: dist.all_gather_into_tensor(
        buf, part, group=tp.group), _nbytes(buf))
    return buf.movedim(0, dim)


def _reduce_scatter(x, tp, dim) -> torch.Tensor:
    """This rank's part along ``dim`` of the sum over ``model`` of every
    rank's ``x``."""
    src = x.movedim(dim, 0).contiguous()
    part = torch.empty((src.shape[0] // tp.size,) + tuple(src.shape[1:]),
                       dtype=src.dtype, device=src.device)
    _timed("tp_reduce_scatter", src.device, lambda: dist.reduce_scatter_tensor(
        part, src, group=tp.group), _nbytes(src), _nbytes(part))
    return part.movedim(0, dim)


def _own(x, tp, dim) -> torch.Tensor:
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * n, n)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _all_gather(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.tp, ctx.dim).contiguous(), None, None


class _GatherShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _all_gather(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.tp, ctx.dim), None, None


class _SliceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _own(x, tp, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.tp, ctx.dim), None, None


def copy_to_model(x, tp) -> torch.Tensor:
    """Enter a region split over ``model``: ``x`` as it is; its gradient,
    a part on each rank, summed over ``model``."""
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x, tp) -> torch.Tensor:
    """Leave a split region: the sum over ``model`` of each rank's part
    ``x``; the gradient passes as it is."""
    return _ReduceFromModel.apply(x, tp)


def gather_model(x, tp, dim) -> torch.Tensor:
    """The ranks' parts of a tensor split along ``dim`` over ``model``,
    concatenated in rank order; the gradient's own part comes back."""
    return _GatherModel.apply(x, tp, dim % x.dim())


def gather_shared(x, tp, dim) -> torch.Tensor:
    """``gather_model`` for a whole tensor that each rank uses for its own
    share of the work only, so that each rank's gradient of it is a part:
    the gradient is summed over ``model`` and this rank's part kept (a
    reduce-scatter, ``tp_reduce_scatter``)."""
    return _GatherShared.apply(x, tp, dim % x.dim())


def slice_model(x, tp, dim) -> torch.Tensor:
    """This rank's part of ``x`` along ``dim`` (the inverse of
    ``gather_model``): the gradient is gathered."""
    return _SliceModel.apply(x, tp, dim % x.dim())


def all_reduce_max(x, tp) -> torch.Tensor:
    """The elementwise max over ``model`` (no gradient)."""
    return _all_reduce(x.detach(), tp, "tp_all_reduce_max",
                       dist.ReduceOp.MAX)


def sum_over_model(g, tp) -> torch.Tensor:
    """A partial gradient summed over ``model``."""
    return _all_reduce(g, tp, "tp_grad_all_reduce")


def gather_counts(counts, groups) -> torch.Tensor:
    """Every data shard's ``counts`` (E,), stacked (n, E) in the global row
    order: ``groups`` is ``ctx.batch_groups()``'s (group, size) per batch
    axis, major first."""
    out = counts[None]
    for group, k in reversed(groups):
        part = out.contiguous()
        buf = torch.empty((k * part.shape[0],) + tuple(part.shape[1:]),
                          dtype=part.dtype, device=part.device)
        _timed("moe_counts", part.device, lambda: dist.all_gather_into_tensor(
            buf, part, group=group), _nbytes(buf))
        out = buf
    return out


class _GatherLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, mesh, placements, fsdp, batch_dims, tp):
        ctx.args = mesh, placements, batch_dims, tp
        return _gather_dims(part, mesh, placements, fsdp,
                            "fsdp_layer_gather")

    @staticmethod
    def backward(ctx, g):
        mesh, placements, batch_dims, tp = ctx.args
        if tp is not None:
            g = sum_over_model(g, tp)
        elif any(not placements[i].is_shard() and mesh.size(i) > 1
                 for i in batch_dims):
            g = g.clone()       # reduce_mean all-reduces that dim in place
        return (reduce_mean(g, placements, mesh, batch_dims),
                None, None, None, None, None)


def gather_layer(x, r, fsdp, batch_dims, tp=None) -> torch.Tensor:
    """One layer's slice of the DTensor leaf ``x`` as the layer computes
    with it: slice ``r`` of its local part along the stacked repeat axis
    (None: a shared block's leaf, whole), all-gathered over the mesh axes
    ``fsdp`` (``fsdp_layer_gather``); its ``model`` shard stays local.
    The slice's gradient comes back as this rank's shard of it: summed
    over ``model`` when ``tp`` is given (the leaf is a part there,
    ``sharding.model_partial``), then the mean over the mesh dims
    ``batch_dims`` reduce-scattered (``reduce_mean``), as the step's
    ``shard_grads`` lays out a whole leaf's."""
    from torch.distributed.tensor import Shard
    part, pl = x.to_local(), x.placements
    if r is not None:    # the repeat axis is never sharded
        part = part[r]
        pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                   for p in pl)
    return _GatherLayer.apply(part, x.device_mesh, pl, fsdp,
                              tuple(batch_dims), tp)


def sp_attn_combine(m, s, o, groups) -> torch.Tensor:
    """Attention over a sequence split over the data axes, merged: each
    shard's running max ``m`` (...), sum of exponentials ``s`` (...) and
    unnormalised output ``o`` (..., hd) are all-gathered over ``groups``
    (``ctx.SeqSplit.groups``, major first; ``sp_attn_combine``) and
    merged by log-sum-exp, the shards summed in their order: the
    softmax-weighted output (..., hd), in float32.  A shard with no
    valid position (``m`` at the mask value) weighs nothing."""
    out = torch.cat([m.float()[..., None], s.float()[..., None],
                     o.float()], -1)[None]
    for group, k in reversed(groups):
        part = out.contiguous()
        buf = torch.empty((k * part.shape[0],) + tuple(part.shape[1:]),
                          dtype=part.dtype, device=part.device)
        _timed("sp_attn_combine", part.device,
               lambda: dist.all_gather_into_tensor(buf, part, group=group),
               _nbytes(buf))
        out = buf
    top = out[..., 0].amax(0)
    w = torch.exp(out[..., 0] - top)
    total = (out[..., 1] * w).sum(0)
    return (out[..., 2:] * w[..., None]).sum(0) / total[..., None]


def is_first(mesh) -> bool:
    """Whether this rank is the mesh's first (coordinate 0 on every dim)."""
    coord = mesh.get_coordinate()
    return coord is not None and not any(coord)


def probe(group, device) -> dict:
    """Which collectives the backend of ``group`` takes on tensors on
    ``device``: {name: True or the error's text}.  A report only: no route
    above depends on it.  Every rank of ``group`` calls it."""
    k = dist.get_world_size(group)
    x = torch.ones(4, device=device)
    calls = {
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * k, device=device), x, group=group),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=device), torch.ones(4 * k, device=device),
            group=group),
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "broadcast": lambda: dist.broadcast(
            x.clone(), src=dist.get_global_rank(group, 0), group=group),
        "all_gather": lambda: dist.all_gather(
            [torch.empty(4, device=device) for _ in range(k)], x, group=group),
        "reduce": lambda: dist.reduce(
            x.clone(), dst=dist.get_global_rank(group, 0), group=group),
        "gather": lambda: dist.gather(
            x, [torch.empty(4, device=device) for _ in range(k)]
            if dist.get_rank(group) == 0 else None,
            dst=dist.get_global_rank(group, 0), group=group),
        "all_reduce_max": lambda: dist.all_reduce(
            x.clone(), op=dist.ReduceOp.MAX, group=group),
    }
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            out[name] = True
        except (RuntimeError, ValueError) as e:   # the backend refused it
            out[name] = str(e).splitlines()[0][:200]
        dist.barrier(group=group)
    return out
