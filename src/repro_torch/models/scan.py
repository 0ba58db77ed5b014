"""The loops over time steps and chunks of the recurrent blocks: the sLSTM
over tokens and the mLSTM over chunks (``models/xlstm.py``), the SSD over
chunks (``models/ssm.py``).  The reference runs them as ``lax.scan``.

``scan(step, carry, n, dim)`` runs ``carry, y_i = step(i, carry)`` for
``i`` in ``range(n)`` and returns the last carry and the ``y_i``
concatenated along ``dim``: in every normal run, a Python loop.

Under the dry run (an analysis of ``distributed/op_analysis.py`` counting
ops, every carry a meta tensor) a loop of more than three trips runs
three: the first, one in the middle and the last, so that both ends keep
what differs there (no gradient into the first carry, none out of the last
one).  The middle trip stands for the ``n - 2`` trips between them, as
the reference's ``hlo_analysis._multipliers`` counts a scan's body once
for its trip count: the analysis counts every op of its forward pass, and
every op that autograd runs for the nodes it created (its backward pass,
and the gradients it adds into what it read), ``n - 2`` times, and what
it leaves alive at the end of the loop (autograd's saved tensors, its
output) ``n - 2`` times over.  So the counts equal those of the loop run
in full, at the cost of three trips: a 32,768-token sLSTM traces in
seconds.  The output has its ``n`` parts, the middle one repeated.
"""
from __future__ import annotations

import torch

# the analyses counting ops now, innermost last (``op_analysis.analyze``)
COUNTERS = []


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for x in tree for t in _tensors(x)]


def scan(step, carry, n: int, dim: int = 1, source=None):
    """(the carry after ``n`` trips of ``step``, their outputs
    concatenated along ``dim``).  A trip's output is None, a tensor or a
    list of tensors (each concatenated over the trips on its own); every
    trip's has the same shapes.

    ``source``: the tensor the loop's inputs come from, for a loop whose
    carry starts from zeros.  When it needs a gradient, the loop's
    backward does what the reference's ``lax.scan`` does on every trip,
    the first and last included: it computes the gradient of the initial
    carry (then dropped) and runs the last trip's backward for a zero
    gradient of the final carry (``_Open``, ``_Close``).  Eager autograd
    would skip both, but the reference's dot FLOPs count them."""
    ends = (source is not None and torch.is_grad_enabled()
            and source.requires_grad)
    if ends:
        flat, rebuild = _flat(carry)
        carry = rebuild(_Open.apply(source, *flat))
    carry, ys = _scan(step, carry, n, dim)
    if ends:
        ys = _Close.apply(ys, *_flat(carry)[0])
    return carry, ys


def _flat(carry):
    """(the tensors of a tensor, tuple or dict ``carry``, a function that
    puts such tensors back in its place)."""
    if isinstance(carry, torch.Tensor):
        return [carry], lambda ts: ts[0]
    if isinstance(carry, dict):
        keys = list(carry)
        return [carry[k] for k in keys], lambda ts: dict(zip(keys, ts))
    return list(carry), tuple


def _scan(step, carry, n, dim):
    counter = COUNTERS[-1] if COUNTERS else None
    if (counter is None or n <= 3
            or not all(t.is_meta for t in _tensors(carry))):
        ys = []
        for i in range(n):
            carry, y = step(i, carry)
            ys.append(y)
        return carry, _join(ys, lambda parts: torch.cat(parts, dim))
    carry, first = step(0, carry)
    with counter.repeated(n - 2) as trips:
        carry, middle = step(1, carry)
        trips.carry = carry
    carry, last = step(n - 1, carry)
    return carry, _join([first, middle, last], lambda parts: _Spread.apply(
        dim, n, *parts))


def _join(ys, cat):
    """The trips' outputs ``ys`` joined by ``cat``, leaf by leaf."""
    if ys[0] is None:
        return None
    if isinstance(ys[0], torch.Tensor):
        return cat(ys)
    return [cat([y[j] for y in ys]) for j in range(len(ys[0]))]


class _Open(torch.autograd.Function):
    """The initial carry as it is, made to need a gradient (``source``
    does), which is dropped."""

    @staticmethod
    def forward(ctx, source, *carry):
        return tuple(c.view_as(c) for c in carry)

    @staticmethod
    def backward(ctx, *g):
        return (None,) * (len(g) + 1)


class _Close(torch.autograd.Function):
    """The loop's outputs as they are, with a zero gradient for the final
    carry."""

    @staticmethod
    def forward(ctx, ys, *carry):
        ctx.carry = [(c.shape, c.dtype) for c in carry]
        return ys.view_as(ys)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=g.device)
                            for s, d in ctx.carry)


class _Spread(torch.autograd.Function):
    """The outputs of a loop of ``n`` trips that ran three: ``first``,
    ``middle`` ``n - 2`` times and ``last``, concatenated along ``dim``.
    The gradient of each is one trip's part, as the loop's own ``cat``
    gives each trip its part."""

    @staticmethod
    def forward(ctx, dim, n, first, middle, last):
        ctx.dim, ctx.n, ctx.size = dim, n, middle.shape[dim]
        return torch.cat([first] + [middle] * (n - 2) + [last], dim)

    @staticmethod
    def backward(ctx, g):
        c = ctx.size
        return (None, None, g.narrow(ctx.dim, 0, c), g.narrow(ctx.dim, c, c),
                g.narrow(ctx.dim, (ctx.n - 1) * c, c))
