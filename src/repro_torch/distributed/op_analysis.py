"""Per-device cost of one step of the port, counted on the ops it runs:
the counterpart of the reference's ``distributed/hlo_analysis.py``.

The reference lowers a step with ``jax.jit`` for the production mesh and
reads the partitioned HLO text that XLA compiles.  Eager PyTorch compiles
no program, so there is no HLO to parse.  Instead the dry run
(``launch/dryrun.py``) runs the port's own sharded step once, as one rank
of a fake process group, on meta tensors (shapes, no data), and
``analyze`` counts what that rank runs, per device:

- **dot FLOPs**: ``torch.utils.flop_counter``'s formula for every op that
  has one (mm, addmm, bmm, baddbmm, convolutions, fused attention), each
  op decomposed first where it can be: what ``FlopCounterMode`` totals;
- **collectives**: every call through ``distributed/comm.py``, the port's
  meter (``comm.meter``), each port kind counted under the HLO kind it is
  (``KINDS``: ``tp_all_reduce`` is an ``all-reduce``, ``moe_counts`` an
  ``all-gather``...) with the reference's keys (``"all-gather"``,
  ``"all-gather_ops"``...) and its result's bytes as HLO counts them; the
  port's own kinds are kept beside them (``"port"``, ``comm.stats``'s
  calls and bytes).  ``total_collective_bytes`` is the reference's ring
  rule: an all-reduce counts twice;
- **HBM traffic**: the reference's documented model: every op's result
  is written once and read once (2 x its bytes), plus the step's inputs
  read once.  Views, allocations and the collectives' own calls move no
  bytes here (a collective's result counts as an op's); an in-place op
  writes the smaller of its result and its other operands (the
  reference's rule for XLA's in-place dynamic-update-slice).  Eager
  PyTorch fuses nothing, so this counts buffers that XLA's fusions never
  materialize (masks, casts, elementwise chains): it is the port's own
  traffic, larger than the reference's for the same step, and it is not
  scaled to look like XLA's;
- **peak live bytes**: every storage an op allocates is live from that op
  until its last reference is gone (views, in-place results and
  autograd's saved tensors hold it), beside the step's inputs; the most
  at once.  Storages are polled (``StorageWeakRef``) when the count would
  pass the peak, once the bytes allocated since the last poll reach
  1/256 of the peak, so the peak is exact to within that share.

A loop over time steps that the dry run runs once for its trips
(``models/scan.py``) counts for its trips: the ops of its middle trip
(forward, and the backward ops of the autograd nodes it created, found by
their sequence numbers) are weighted by the trips they stand for, and so
are the storages it leaves alive.
"""
from __future__ import annotations

import bisect
import contextlib
import sys
import warnings
from collections import Counter, defaultdict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import comm
from repro_torch.models import scan

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
KINDS = {"all_gather": "all-gather", "tp_all_gather": "all-gather",
         "moe_counts": "all-gather", "fsdp_layer_gather": "all-gather",
         "sp_attn_combine": "all-gather", "reduce_scatter": "reduce-scatter",
         "tp_reduce_scatter": "reduce-scatter", "all_reduce": "all-reduce",
         "tp_all_reduce": "all-reduce", "tp_grad_all_reduce": "all-reduce",
         "tp_all_reduce_max": "all-reduce"}

_aten = torch.ops.aten
# size queries, as FlopCounterMode skips them
_QUERIES = {_aten.sym_is_contiguous.default, _aten.is_contiguous.default,
            _aten.is_contiguous.memory_format,
            _aten.is_strides_like_format.default,
            _aten.is_non_overlapping_and_dense.default, _aten.size.default,
            _aten.sym_size.default, _aten.stride.default,
            _aten.sym_stride.default, _aten.storage_offset.default,
            _aten.sym_storage_offset.default, _aten.numel.default,
            _aten.sym_numel.default, _aten.dim.default,
            torch.ops.prim.layout.default}
# ops that move no bytes (their results are allocated, not written)
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_like.default,
             _aten.empty_strided.default, _aten.new_empty.default,
             _aten.new_empty_strided.default, _aten.lift_fresh.default,
             _aten.detach.default, _aten.alias.default}
_MODELS = "/repro_torch/models/"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _local(t) -> torch.Tensor:
    """A DTensor's local shard, or ``t``."""
    return getattr(t, "_local_tensor", t)


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _frame_label() -> str:
    """``file:line function`` of the innermost Python frame in
    ``src/repro_torch/models``, or ""."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if _MODELS in name:
            return (f"{name[name.index(_MODELS) + 1:]}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return ""


def _traceback_label(node) -> str:
    """The label of the forward frame that created autograd ``node``
    (anomaly mode records it), marked as its backward."""
    for line in reversed(node.metadata.get("traceback_", [])):
        head = line.lstrip().splitlines()[0] if line.strip() else ""
        if _MODELS in head:
            path = head[head.index(_MODELS) + 1:].split('"')[0]
            where = head.split(", line ")[1].replace(", in ", " ")
            return f"{path}:{where} (backward)"
    return "(backward)"


class _Trips:
    """The middle trip of a loop, standing for ``k`` trips
    (``scan.scan``); ``carry``: the carry it returned."""

    def __init__(self, mode, k):
        self.mode, self.k = mode, k
        self.carry = ()

    def __enter__(self):
        m = self.mode
        m._fwd.append((m._weight() * self.k, m._node()))
        self.seq0 = torch._C._autograd._get_sequence_nr()
        self.first = m._serial
        return self

    def __exit__(self, *exc):
        m = self.mode
        w = m._fwd.pop()[0]
        seq1 = torch._C._autograd._get_sequence_nr()
        if seq1 > self.seq0:      # the ranges of loops inside it come first
            i = bisect.bisect_left(m._lo, self.seq0)
            m._lo.insert(i, self.seq0)
            m._ranges.insert(i, (self.seq0, seq1, w))
        # what the trip leaves alive stands for k trips' (autograd's saved
        # tensors, its outputs), but for a carry that needs no gradient:
        # the next trip keeps no such carry for its backward
        m._poll(force=True)
        keep = {_local(t).untyped_storage()._cdata
                for t in scan._tensors(self.carry)
                if not (t.requires_grad and torch.is_grad_enabled())}
        for key, e in m._live.items():
            if e[3] >= self.first and key not in keep:
                m._now += (self.k - 1) * e[1] * e[2]
                e[2] *= self.k


class _Analysis(TorchDispatchMode):
    """Counts every op dispatched while it is on: see the module's
    docstring.  ``rows``: per-op attribution for ``inspect_cell``."""

    def __init__(self, rows: bool = False):
        super().__init__()
        self.flops = 0
        self.traffic = 0
        self.coll = Counter()
        self.rows = ({"collectives": defaultdict(lambda: [0, 0]),
                      "traffic": defaultdict(lambda: [0, 0]),
                      "dot flops": defaultdict(lambda: [0, 0])}
                     if rows else None)
        self._fwd = []                       # forward weights, innermost last
        # the autograd nodes of loops' middle trips: (first sequence
        # number, last + 1, weight), sorted; nested or apart
        self._lo, self._ranges = [], []
        # storage key -> [weakref, bytes, weight, serial]
        self._live = {}
        self._serial = 0
        self._polled = 0
        self._later = {}       # loop trip's range -> bytes freed after it
        self._now = 0
        self.peak = 0
        self._pending = 0

    # -- weights -----------------------------------------------------------

    def repeated(self, k: int) -> _Trips:
        return _Trips(self, k)

    def _range(self):
        """The innermost loop trip whose backward runs now (its range), or
        None."""
        if not self._lo:
            return None
        node = torch._C._current_autograd_node()
        if node is None:
            return None
        s = node._sequence_nr()
        for i in range(bisect.bisect_right(self._lo, s) - 1, -1, -1):
            if s < self._ranges[i][1]:
                return self._ranges[i]
        return None

    @staticmethod
    def _node():
        node = torch._C._current_autograd_node()
        return None if node is None else node._sequence_nr()

    def _weight(self) -> int:
        """How many times the op running now counts: the innermost loop
        trip's weight, of the forward pass it runs in (a trip entered
        while the current autograd node runs: a recompute) or of the
        backward node it runs for."""
        if self._fwd and self._fwd[-1][1] == self._node():
            return self._fwd[-1][0]
        r = self._range()
        if r is not None:
            return r[2]
        return self._fwd[-1][0] if self._fwd else 1

    @staticmethod
    def _label() -> str:
        """The model frame running the op now, else that of the forward
        pass that made the autograd node running it, else ""."""
        where = _frame_label()
        node = torch._C._current_autograd_node()
        return where if where or node is None else _traceback_label(node)

    # -- peak live bytes ---------------------------------------------------

    def hold(self, t) -> None:
        """Count ``t``'s storage live (once) from now until it is freed."""
        t = _local(t)
        st = t.untyped_storage()
        key = st._cdata
        e = self._live.get(key)
        if e is not None:
            if not e[0].expired():
                return
            self._now -= e[1] * e[2]         # a freed storage's address
        nbytes = st.nbytes()
        self._live[key] = [StorageWeakRef(st), nbytes, 1, self._serial]
        self._serial += 1
        self._now += nbytes
        self._pending += nbytes
        if self._now > self.peak:
            self._poll()

    def _poll(self, force: bool = False) -> None:
        """Drops the storages freed since the last poll.  A loop's storage
        weighed for its ``k`` trips and freed by the backward of its middle
        trip leaves one trip's share at once, and the rest once that
        backward is over: the loop run in full frees the trips' saved
        tensors one trip after another."""
        if not force and self._pending * 256 < self.peak and len(
                self._live) < 2 * self._polled:
            return
        back = (self._range() if not self._fwd
                or self._fwd[-1][1] != self._node() else None)
        for key in [k for k, e in self._live.items() if e[0].expired()]:
            e = self._live.pop(key)
            if e[2] > 1 and back is not None:
                self._now -= e[1]
                self._later[back] = (self._later.get(back, 0)
                                     + e[1] * (e[2] - 1))
            else:
                self._now -= e[1] * e[2]
        self._polled = len(self._live)
        self._pending = 0
        self.peak = max(self.peak, self._now)

    def _release(self, now=None) -> None:
        """Lets go of what the backward of loop trips other than ``now``
        freed (see ``_poll``)."""
        for i in [i for i in self._later if i != now]:
            self._now -= self._later.pop(i)

    # -- counting ----------------------------------------------------------

    def collective(self, kind: str, result_bytes: int) -> int:
        """``comm.meter``: counts one collective; returns its weight."""
        w = self._weight()
        hlo = KINDS.get(kind)
        if hlo is not None:
            self.coll[hlo] += w * result_bytes
            self.coll[hlo + "_ops"] += w
            self.traffic += 2 * w * result_bytes
            if self.rows is not None:
                r = self.rows["collectives"][(kind, self._label())]
                r[0] += w * result_bytes
                r[1] += w
        return w

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES or func.namespace == "c10d":
            return func(*args, **kwargs)
        # as FlopCounterMode: decompose where the op can
        with self:
            r = func.decompose(*args, **kwargs)
        if r is not NotImplemented:
            return r
        out = func(*args, **kwargs)
        w = self._weight()
        if self._later:
            self._release(self._range())
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = w * flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += flops
            if self.rows is not None and flops:
                r = self.rows["dot flops"][(str(packet), self._label())]
                r[0] += flops
                r[1] += w
        written = w * self._written(func, args, kwargs, out)
        self.traffic += 2 * written
        if self.rows is not None and written:
            r = self.rows["traffic"][(str(packet), self._label())]
            r[0] += 2 * written
            r[1] += w
        for t in _tensors(out):
            self.hold(t)
        return out

    @staticmethod
    def _written(func, args, kwargs, out) -> int:
        if func in _NO_BYTES or func.is_view:
            return 0
        res = sum(_nbytes(t) for t in _tensors(out))
        schema = func._schema
        if not schema.is_mutable:
            return res
        vals = list(args) + [kwargs.get(a.name)
                             for a in schema.arguments[len(args):]]
        src = sum(_nbytes(t) for a, v in zip(schema.arguments, vals)
                  if not (a.alias_info and a.alias_info.is_write)
                  for t in _tensors(v))
        return min(res, src) if src else res


def analyze(fn, *args, read_bytes: int = None, rows: bool = False) -> dict:
    """Runs ``fn(*args)`` once under the analysis: per-device totals
    ``{"dot_flops", "traffic_bytes", "collectives", "port_collectives",
    "peak_bytes", "input_bytes", "output"}`` (``output`` is what ``fn``
    returned) and, with ``rows``, per-op rows for ``inspect_cell``.  The
    inputs are every tensor in ``args`` (a DTensor's local shard), read
    once: ``read_bytes`` where the step reads less of them (its rows of
    a global batch)."""
    mode = _Analysis(rows)
    inputs = _tensors(args)
    before = comm.snapshot()
    prev = comm.meter
    comm.meter = mode.collective
    scan.COUNTERS.append(mode)
    with warnings.catch_warnings():     # anomaly mode's notice of its cost
        warnings.simplefilter("ignore")
        anomaly = (torch.autograd.detect_anomaly(check_nan=False) if rows
                   else contextlib.nullcontext())
    try:
        for t in inputs:
            mode.hold(t)
        with anomaly, mode:
            out = fn(*args)
        mode._poll(force=True)
        mode._release()
    finally:
        scan.COUNTERS.pop()
        comm.meter = prev
    port = {}
    for kind, now in comm.snapshot().items():
        was = before.get(kind, {"calls": 0, "bytes": 0})
        calls = now["calls"] - was["calls"]
        if calls:
            port[kind] = {"calls": calls, "bytes": now["bytes"] - was["bytes"]}
    entry = (sum(_nbytes(t) for t in inputs) if read_bytes is None
             else read_bytes)
    res = {"dot_flops": float(mode.flops),
           "traffic_bytes": float(mode.traffic + entry),
           "collectives": dict(mode.coll), "port_collectives": port,
           "peak_bytes": int(mode.peak), "input_bytes": int(entry),
           "output": out}
    if rows:
        res["rows"] = {k: dict(v) for k, v in mode.rows.items()}
    return res


def total_collective_bytes(coll) -> float:
    """Ring-model bytes per device: all-reduce ~2x payload (RS+AG phases)."""
    tot = 0.0
    for k in COLLECTIVES:
        b = coll.get(k, 0)
        tot += 2 * b if k == "all-reduce" else b
    return tot
