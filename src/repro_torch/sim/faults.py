"""Deterministic fault plane: seeded crash/flap/degrade/timeout injection.

MITOSIS §6.2's deployability argument is that remote fork survives
failure: leases bound orphaned children, and a child whose parent dies
falls back instead of hanging on a dead RDMA peer.  This module makes
failure *causable* — and exactly reproducible — inside the ``repro_torch.sim``
replay engine:

* a :class:`FaultPlan` is pure data: node crashes at sim times, NIC
  *flaps* (windows during which every op touching the node times out),
  NIC *degrades* (windows during which transfers through the node run at
  a fraction of line rate), and an optional per-op timeout probability;
* :class:`FaultInjector` is the live hook the :class:`~repro_torch.net.network.
  Network` consults (``net.faults``): transports call ``op_fault`` ahead
  of every data-plane op and ``penalty`` on every transfer's wire time.

Determinism: flap/degrade windows are pure functions of ``net.sim_time``
(no mutable toggles, so a handler that advanced its local clock past a
window edge sees the edge immediately); the per-op coin is drawn from the
plan's own seeded RNG in transport-call order — the same order the replay
engine's single event heap fixes.  Crashes are scheduled as labeled
events on the :class:`~repro_torch.sim.events.EventLoop`, so they land in the
replay's event-log digest.  An *empty* plan draws nothing, schedules
nothing and penalizes nothing: installing it is byte-identical to running
without a fault plane at all (the fig22 crash_rate=0 gate).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Crash:
    """Fail-stop of ``node`` at sim time ``t`` (never comes back)."""
    t: float
    node: str


@dataclasses.dataclass(frozen=True)
class Flap:
    """NIC outage on ``node`` over [t0, t1): every op with the node as
    either endpoint times out; the node itself stays alive (its seeds,
    pool and leases survive — only the fabric path is dark)."""
    t0: float
    t1: float
    node: str


@dataclasses.dataclass(frozen=True)
class Degrade:
    """Bandwidth degradation on ``node`` over [t0, t1): transfers touching
    the node run at ``bw_factor`` of line rate (0 < bw_factor <= 1)."""
    t0: float
    t1: float
    node: str
    bw_factor: float


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A reproducible failure schedule.  Pure data + one seed."""

    seed: int = 0
    crashes: Tuple[Crash, ...] = ()
    flaps: Tuple[Flap, ...] = ()
    degrades: Tuple[Degrade, ...] = ()
    op_fail_rate: float = 0.0       # per-attempt timeout probability

    def __post_init__(self):
        if not 0.0 <= self.op_fail_rate <= 1.0:
            raise ValueError(
                f"op_fail_rate must be in [0, 1], got {self.op_fail_rate}")
        for f in self.flaps:
            if f.t1 <= f.t0:
                raise ValueError(f"flap window inverted: {f}")
        for d in self.degrades:
            if d.t1 <= d.t0:
                raise ValueError(f"degrade window inverted: {d}")
            if not 0.0 < d.bw_factor <= 1.0:
                raise ValueError(f"bw_factor must be in (0, 1], got {d}")

    def empty(self) -> bool:
        return (not self.crashes and not self.flaps and not self.degrades
                and self.op_fail_rate == 0.0)

    def describe(self) -> dict:
        """Deterministic JSON-able summary for replay artifacts."""
        return {
            "seed": self.seed,
            "crashes": [[round(c.t, 9), c.node] for c in self.crashes],
            "flaps": [[round(f.t0, 9), round(f.t1, 9), f.node]
                      for f in self.flaps],
            "degrades": [[round(d.t0, 9), round(d.t1, 9), d.node,
                          d.bw_factor] for d in self.degrades],
            "op_fail_rate": self.op_fail_rate,
        }

    @classmethod
    def random(cls, seed: int, node_ids: Sequence[str], duration_s: float,
               crash_rate: float = 0.0, flap_rate: float = 0.0,
               flap_len_s: float = 5.0, degrade_rate: float = 0.0,
               degrade_len_s: float = 30.0, bw_factor: float = 0.25,
               op_fail_rate: float = 0.0) -> "FaultPlan":
        """Generate a plan: ``crash_rate`` / ``flap_rate`` / ``degrade_rate``
        are the fraction of nodes hit over ``duration_s`` (a rate of 0
        generates nothing of that class — the zero plan is exactly the
        empty plan).  Victims and times come from one ``random.Random(seed)``
        in a fixed draw order, so equal arguments always yield equal plans.
        Event times land in the middle 80% of the run so faults hit live
        traffic, not the warmup or drain tail."""
        rng = random.Random(seed)
        ids = sorted(node_ids)

        def _times(n: int) -> List[float]:
            return sorted(rng.uniform(0.1 * duration_s, 0.9 * duration_s)
                          for _ in range(n))

        def _victims(n: int) -> List[str]:
            return rng.sample(ids, min(n, len(ids)))

        n_crash = int(round(crash_rate * len(ids)))
        crashes = tuple(Crash(t, v) for t, v in
                        zip(_times(n_crash), _victims(n_crash)))
        n_flap = int(round(flap_rate * len(ids)))
        flaps = tuple(Flap(t, t + flap_len_s, v) for t, v in
                      zip(_times(n_flap), _victims(n_flap)))
        n_deg = int(round(degrade_rate * len(ids)))
        degrades = tuple(Degrade(t, t + degrade_len_s, v, bw_factor)
                         for t, v in zip(_times(n_deg), _victims(n_deg)))
        return cls(seed=seed, crashes=crashes, flaps=flaps,
                   degrades=degrades, op_fail_rate=op_fail_rate)


class FaultInjector:
    """The live fault hook a Network consults (``net.faults``).

    Window checks are time-pure (computed from ``net.sim_time``), the
    per-op coin is seeded (``plan.seed``) and consumed only when
    ``op_fail_rate > 0`` — so an all-zero plan never touches the RNG and
    perturbs nothing.
    """

    def __init__(self, net, plan: FaultPlan):
        self.net = net
        self.plan = plan
        self._rng = random.Random(plan.seed ^ 0x5EED_FA17)
        self._flaps: Dict[str, List[Tuple[float, float]]] = {}
        for f in plan.flaps:
            self._flaps.setdefault(f.node, []).append((f.t0, f.t1))
        # earliest crash instant per node: the DATA plane sees the node
        # dark the moment the (handler-local) clock passes this, even
        # though the crash EVENT — the control-plane teardown — only
        # dispatches between loop events.  Without this, a handler whose
        # reads straddle the crash instant would keep reading a dead peer.
        self._crashed: Dict[str, float] = {}
        for c in plan.crashes:
            t = self._crashed.get(c.node)
            self._crashed[c.node] = c.t if t is None else min(t, c.t)
        self._degrades: Dict[str, List[Tuple[float, float, float]]] = {}
        for d in plan.degrades:
            self._degrades.setdefault(d.node, []).append(
                (d.t0, d.t1, d.bw_factor))
        self.crashes_fired = 0

    # -- what transports ask --------------------------------------------------

    def flapped(self, node_id: str) -> bool:
        """True while ``node_id``'s NIC is dark at the current sim time."""
        now = self.net.sim_time
        return any(t0 <= now < t1
                   for t0, t1 in self._flaps.get(node_id, ()))

    def dark(self, node_id: str) -> bool:
        """True when ``node_id`` is unreachable right now: NIC flapped, or
        past its crash instant (time-pure — valid even before the crash
        event's teardown has dispatched)."""
        t = self._crashed.get(node_id)
        if t is not None and self.net.sim_time >= t:
            return True
        return self.flapped(node_id)

    def op_fault(self, transport_name: str, op: str, src: str,
                 dst: str) -> bool:
        """Should this op attempt time out?  Called once per attempt, in
        transport-call order (the determinism contract)."""
        if self.dark(src) or self.dark(dst):
            return True
        rate = self.plan.op_fail_rate
        return rate > 0.0 and self._rng.random() < rate

    def penalty(self, src: str, dst: str) -> float:
        """Wire-time multiplier (>= 1.0) for a transfer between src and
        dst right now: 1/bw_factor of the most-degraded endpoint."""
        factor = 1.0
        now = self.net.sim_time
        for node in (src, dst) if src != dst else (src,):
            for t0, t1, f in self._degrades.get(node, ()):
                if t0 <= now < t1:
                    factor = min(factor, f)
        return 1.0 / factor

    # -- scheduling (crashes are loop events; windows are time-pure) ----------

    def schedule(self, loop, crash_fn) -> None:
        """Put every planned crash on the event loop as a labeled event
        (so it lands in the determinism digest); ``crash_fn(node_id)`` is
        the engine's crash hook."""
        for c in self.plan.crashes:
            loop.at(c.t, self._fire_crash, crash_fn, c.node,
                    label=f"fault:crash:{c.node}")

    def _fire_crash(self, crash_fn, node_id: str) -> None:
        self.crashes_fired += 1
        crash_fn(node_id)
