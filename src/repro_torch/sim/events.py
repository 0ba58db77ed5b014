"""Deterministic discrete-event core of ``repro_torch.sim``.

The :class:`EventLoop` owns one sim-time heap and one seeded RNG.  No
wall-clock anywhere: "now" is whatever event is being dispatched, and the
platform's notion of time is the network's resource clock
(:attr:`Network.sim_time`), which the loop synchronizes at every dispatch.

Clock semantics
---------------
The network clock is the *current handler's local time*, not a global
frontier.  At each dispatch the loop rewinds/advances ``net.sim_time`` to
the event's timestamp; the handler then drives real platform calls (fork,
demand paging, RPCs) that push the clock forward as they charge wire time.
Rewinding between handlers is safe — and is precisely how two concurrent
invocations contend — because every shared resource (per-(src, dst)
channels, per-node link lanes) is stamped with *absolute* busy-until times
that only move forward: a transfer issued at t=5.0 by one handler starts
no earlier than the lane stamps a t=4.9 handler left behind, so FCFS
queueing falls out of the reservations rather than from handler ordering.

A handler's end-to-end latency is simply ``net.sim_time - arrival_time``
after it returns.

Determinism
-----------
Ties in the heap break on a declared ``priority`` first (lower runs
earlier) and then on schedule order (a monotone sequence number), the
only randomness is the loop's own ``random.Random(seed)`` (arrival jitter),
and the loop keeps a structured event log — ``(time, label)`` per dispatch
— whose canonical digest is byte-identical across runs of the same trace
and seed (``tests/test_sim_engine.py`` pins this).

Priorities exist so that same-time ordering is *intent*, not an accident
of scheduling order: the replay engine runs arrivals/completions/crashes
at priority 0, GC sweeps at 10 and timeline sampling at 20 — exactly the
order the sequence numbers happened to produce before, so pinned digests
are unchanged.  What priorities leave untied is by definition
order-independent, and ``tiebreak_seed`` makes that claim testable: a
non-None seed shuffles dispatch order *within* each (time, priority)
class, and the race detector (``repro_torch.analysis.races``) diffs the
resulting digests to find handlers that secretly depended on incidental
ordering.
"""
from __future__ import annotations

import heapq
import itertools
import random
from typing import Callable, List, Optional, Tuple

from .metrics import canonical_digest


class SimClock:
    """A callable clock that reads the network's sim time.

    Hand this to ``NodeRuntime(clock=...)`` / ``Coordinator(clock=...)``
    (or ``make_cluster(clock="sim")``) so lease deadlines, renewals, cache
    keepalive and GC all tick in replayed seconds instead of host
    ``time.monotonic()`` — the end-to-end lease wiring the replay engine
    relies on.
    """

    def __init__(self, network):
        self.network = network

    def __call__(self) -> float:
        return self.network.sim_time


class EventLoop:
    """Single-heap discrete-event scheduler, synchronized with a Network."""

    def __init__(self, network=None, seed: int = 0,
                 tiebreak_seed: Optional[int] = None):
        self.network = network
        self.rng = random.Random(seed)
        self.seed = seed
        self.now = 0.0
        self._heap: List[tuple] = []
        self._seq = itertools.count()
        self.events_run = 0
        self.log: List[Tuple[float, str]] = []
        # race-detector mode: shuffle dispatch order WITHIN each
        # (time, priority) tie class.  None (the default) keeps the
        # monotone schedule-order tiebreak, bit-identical to before.
        self.tiebreak_seed = tiebreak_seed
        self._tiebreak_rng = (None if tiebreak_seed is None
                              else random.Random(tiebreak_seed))

    # -- scheduling ----------------------------------------------------------

    def at(self, when: float, fn: Callable, *args,
           label: Optional[str] = None, priority: int = 0):
        """Schedule ``fn(*args)`` at absolute sim time ``when``.  Same-time
        events dispatch in ``priority`` order (lower first), then schedule
        order — declare ordering intent with ``priority`` instead of
        leaning on scheduling sequence."""
        if when < 0:
            raise ValueError(f"cannot schedule at negative sim time {when}")
        tie = (0.0 if self._tiebreak_rng is None
               else self._tiebreak_rng.random())
        heapq.heappush(self._heap,
                       (when, priority, tie, next(self._seq),
                        label or getattr(fn, "__name__", "event"), fn, args))

    def after(self, delay: float, fn: Callable, *args,
              label: Optional[str] = None, priority: int = 0):
        """Schedule ``fn(*args)`` ``delay`` seconds after the current event."""
        self.at(self.now + delay, fn, *args, label=label, priority=priority)

    def every(self, interval: float, fn: Callable, *,
              until: float, start: Optional[float] = None,
              label: Optional[str] = None, priority: int = 0):
        """Recurring event at ``start, start+interval, ...`` up to ``until``
        inclusive — bounded so periodic housekeeping (GC sweeps, timeline
        sampling) cannot keep an otherwise-drained replay alive forever."""
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval}")
        lbl = label or getattr(fn, "__name__", "tick")

        def fire(when: float):
            fn()
            nxt = when + interval
            if nxt <= until:
                self.at(nxt, fire, nxt, label=lbl, priority=priority)

        first = interval if start is None else start
        if first <= until:
            self.at(first, fire, first, label=lbl, priority=priority)

    # -- dispatch ------------------------------------------------------------

    def run(self, until: Optional[float] = None) -> int:
        """Dispatch events in time order (schedule order on ties) until the
        heap drains or the next event is past ``until``.  Returns the number
        of events dispatched by this call."""
        ran = 0
        while self._heap and (until is None or self._heap[0][0] <= until):
            when, _prio, _tie, _seq, label, fn, args = heapq.heappop(self._heap)
            self.now = when
            if self.network is not None:
                # the handler's local time — see the module docstring for
                # why rewinding between handlers is safe (absolute,
                # monotone resource stamps carry the contention)
                self.network.sim_time = when
            self.log.append((round(when, 9), label))
            fn(*args)
            ran += 1
            self.events_run += 1
        if until is not None and until > self.now:
            self.now = until
        return ran

    def pending(self) -> int:
        return len(self._heap)

    def next_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def log_digest(self) -> str:
        """sha256 over the canonical event log — the byte-identity witness
        for 'same trace + same seed => same replay'."""
        return canonical_digest(self.log)
