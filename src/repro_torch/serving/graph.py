"""The paged decode step as one CUDA graph.

A step's inputs live in static buffers (:class:`StepInputs`): tokens,
positions, effective lengths and the layer-major page tables, filled each
step by one copy from a host block (page-locked on a CUDA device).  The
step's body, which reads only those buffers, the weights and the pool's
frames tensor, is captured once for each key (:class:`StepGraph`) and
replayed on every later step with that key.  What the capture bakes in
(the batch, the tables' width, the frames tensor) is the caller's key.

The host does no work in a replay, so the host counts the body makes
(``tracing.count``'s, and the kernel layer's ``dispatch.counters``) are
taken out of the capture pass (:func:`held`) and added again at each
replay: a request's counts read as an eager step's.  Spans inside the
body open only while it is captured.

The capture runs on a side stream of the device (a graph cannot be
captured on the default stream), with no eager pass before it: on an H100
(PyTorch 2.11, CUDA 12.8) a first capture in a fresh process, every
kernel and library call of the body then launched for the first time,
replays correctly, and an eager pass would cost a request one more host
walk of its layers.  The capture uses the global mode: nothing else in
the program issues CUDA work from another thread while a request is
served.  Python's cyclic collector is off while a capture runs: garbage it
frees may hold a CUDA graph or page-locked memory, whose release calls
CUDA and so invalidates the capture.
"""
from __future__ import annotations

import contextlib
import gc
from collections import Counter
from typing import Callable, Dict

import torch

from repro_torch import tracing
from repro_torch.kernels import dispatch


class StepInputs:
    """One int32 block: tokens (B,), positions (B,), effective lengths
    (B,), then each of ``tables`` page tables layer-major (L, B, W); the
    host copy (page-locked on a CUDA device) is filled and copied to the
    device block in one go, whose views the body reads."""

    def __init__(self, B: int, L: int, W: int, tables: int, device):
        self.B, self.W = B, W
        n, size = 3 * B, L * B * W
        total = n + tables * size
        self.host = torch.empty(total, dtype=torch.int32,
                                pin_memory=device.type == "cuda")
        self.dev = torch.empty(total, dtype=torch.int32, device=device)
        h = self.host.numpy()
        self._rows = h[:n].reshape(3, B)
        self._tables = [h[n + i * size:n + (i + 1) * size].reshape(L, B, W)
                        for i in range(tables)]
        self.tokens, self.pos, self.eff = self.dev[:n].view(3, B)
        self.tables = [self.dev[n + i * size:n + (i + 1) * size].view(L, B, W)
                       for i in range(tables)]

    def load(self, tokens, lens, tables) -> None:
        """``tokens`` and ``lens`` (the lengths before this token) (B,), and
        the page tables, host (B, L, W) each, in one copy to the device."""
        self._rows[0] = tokens
        self._rows[1] = lens
        self._rows[2] = lens + 1
        for h, pt in zip(self._tables, tables):
            h[...] = pt.transpose(1, 0, 2)
        self.dev.copy_(self.host, non_blocking=True)


class Counts:
    """The host counts of one pass of a body: the tracer's, and each of
    ``dispatch.counters()``'s."""

    def __init__(self):
        self.traced = Counter()
        self.kernel = [Counter() for _ in dispatch.counters()]

    def add(self) -> None:
        for name, n in self.traced.items():
            tracing.count(name, n)
        for c, d in zip(dispatch.counters(), self.kernel):
            c.update(d)


@contextlib.contextmanager
def held():
    """Counts made inside are taken back out and kept in the
    :class:`Counts` this yields."""
    before = [Counter(c) for c in dispatch.counters()]
    out = Counts()
    try:
        with tracing.taped() as tape:
            yield out
    finally:
        out.traced.update(tape)
        for c, b, d in zip(dispatch.counters(), before, out.kernel):
            d.update({k: n - b[k] for k, n in c.items()
                      if k not in b or n != b[k]})
            c.clear()
            c.update(b)


# One capture stream per device, for the process: PyTorch gives each
# stream cuBLAS runs on a workspace of its own (32 MiB on an H100), held
# for good, so a stream per capture would hold one per stream of its pool.
_streams: Dict[torch.device, torch.cuda.Stream] = {}


def cuda_capture(body: Callable, device):
    """``body`` captured on the capture stream of ``device``: (the graph's
    replay, the outputs it rewrites).  Nothing runs until a replay."""
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device)
    g = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()     # a finalizer's CUDA call would invalidate the capture
    try:
        with torch.cuda.stream(stream):
            g.capture_begin()
            try:
                out = body()
            finally:
                g.capture_end()
    finally:
        if collecting:
            gc.enable()
    return g.replay, out


def captures(device) -> bool:
    """Whether a step on ``device`` runs from a graph: on a CUDA device."""
    return device.type == "cuda"


class StepGraph:
    """``body`` captured under ``key`` by :func:`cuda_capture`, counted in
    ``serve.graph_captures``; each :meth:`replay` counted in
    ``serve.graph_replays``."""

    def __init__(self, key, body: Callable, device):
        self.key = key
        with tracing.span("serve.capture"), held() as self.counts:
            self._replay, self.out = cuda_capture(body, device)
        tracing.count("serve.graph_captures", 1)

    def replay(self):
        """Run the step on the current stream: the body's outputs."""
        self._replay()
        self.counts.add()
        tracing.count("serve.graph_replays", 1)
        return self.out
