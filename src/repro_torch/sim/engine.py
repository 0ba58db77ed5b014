"""ReplayEngine — trace-driven replay through the real fork/placement stack.

The engine turns a :class:`~repro_torch.sim.trace.Trace` into arrival events on a
:class:`~repro_torch.sim.events.EventLoop` and serves each arrival through the
actual platform: ``Coordinator`` seed store and GC, ``ForkHandle`` /
``ShardedSeed`` resume paths, demand paging and prefetch over the metered
``Network`` with per-node link lanes.  There is **no analytical latency
model** for the fork path — an invocation's latency is whatever the data
plane charges between its arrival and its completion event.  The only
modeled constants are container lifecycle costs the repo does not simulate
(cold boot, warm unpause) plus the function's own ``exec_sim_time``.

Per invocation the engine:

1. dispatches the arrival event (``net.sim_time`` = arrival time),
2. asks the autoscaler policy for a container (warm / fork / cold — fork
   runs the real descriptor-fetch + auth + paging machinery),
3. runs the function behavior (page touches charge wire time on contended
   lanes) and advances by ``exec_sim_time``,
4. schedules a completion event at the resulting clock, at which point the
   policy releases the container (back to the warm pool, or freed).

Housekeeping rides the same loop: ``Coordinator.gc()`` fires every
``gc_every`` sim seconds (lease expiry, cache keepalive, dangling-seed
reclamation — all on the sim clock via :class:`~repro_torch.sim.events.SimClock`)
and memory/backlog timelines sample every ``sample_every`` seconds.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from repro_torch.net import ReproError
from repro_torch.net.model import NetModel
from repro_torch.net.network import Network
from repro_torch.placement.scheduler import RoundRobinScheduler
from repro_torch.platform.coordinator import Coordinator, FunctionDef
from repro_torch.platform.node import NodeRuntime

from .autoscaler import AutoscalePolicy
from .events import EventLoop, SimClock
from .faults import FaultInjector, FaultPlan
from .metrics import (TelemetryStream, Timeline, canonical_digest,
                      latency_row)
from .trace import Invocation, Trace

SIM_PAGE_ELEMS = 4096          # 16 KiB fp32 pages — matches benchmarks

# Pristine container state is immutable (zeros) and containers copy it into
# their own pool frames at boot, so the host-side source array can be shared
# across every boot of the same function shape.  Allocating it fresh per
# coldstart costs an mmap/munmap pair plus first-touch faults per container,
# which dominates replays that cold-boot thousands of containers.  A device
# pool uploads the shared template at packing time.
_PARAMS_TEMPLATES: Dict[tuple, dict] = {}


@dataclasses.dataclass(frozen=True)
class SimFunction:
    """A synthetic serverless function for replay: state size/layout plus
    the lifecycle costs the platform does not itself simulate."""

    name: str
    state_bytes: int = 1 << 20      # pristine container state
    vmas: int = 1                   # leaves the state is split across
    touch_frac: float = 0.5         # fraction of pages the handler touches
    exec_s: float = 0.030           # pure execution time (paper fig20: 30 ms)
    coldstart_s: float = 0.167      # local cold boot (paper §2: 167 ms)
    warm_start_s: float = 0.0005    # unpause of a cached container
    # container occupancy per invocation (checkout -> return-to-pool /
    # teardown), >= exec_s; None means exec_s.  FaaS containers serve one
    # request at a time and platforms hold them well past raw exec
    # (routing, repause, agent overhead) — fig20 sets this to the trace's
    # 60 s minute granularity, which is exactly the legacy analytical
    # model's occupancy assumption (one call per cached container per
    # minute), now enforced by completion events instead of bookkeeping.
    hold_s: Optional[float] = None

    def make_params(self):
        key = (self.state_bytes, self.vmas)
        if key not in _PARAMS_TEMPLATES:
            elems = max(1, self.state_bytes // 4 // max(1, self.vmas))
            _PARAMS_TEMPLATES[key] = {f"v{i}": np.zeros(elems, np.float32)
                                      for i in range(self.vmas)}
        return _PARAMS_TEMPLATES[key]

    def behavior(self, inst, inputs):
        """Touch ``touch_frac`` of every VMA — on a forked child this is
        demand paging over the wire; on warm/cold containers the pages are
        local and cost nothing."""
        for name, vma in inst.aspace.items():
            n = max(1, int(round(vma.npages * self.touch_frac)))
            inst.fetch_pages(name, np.arange(n))
        return {}

    def to_fdef(self) -> FunctionDef:
        return FunctionDef(name=self.name, arch=f"sim/{self.name}",
                           make_params=self.make_params,
                           behavior=self.behavior,
                           exec_sim_time=self.exec_s)


@dataclasses.dataclass
class ReplayResult:
    """Everything one replay produced, deterministically."""

    policy: dict
    trace: str
    seed: int
    nodes: int
    invocations: int
    decisions: Dict[str, int]
    latency: Dict[str, Dict[str, int]]       # end-to-end, per function + "all"
    startup: Dict[str, Dict[str, int]]       # arrival -> container ready
    memory: Timeline
    backlog: Timeline
    telemetry: TelemetryStream
    meter: Dict[str, float]
    conn: Dict[str, Dict[str, float]]        # per-backend pool counters
    lease: Dict[str, Dict[str, int]]
    payload_pages: Dict[str, int]            # rdma/rpc/cached page counts
    end_time: float
    events_run: int
    event_log_digest: str
    # fault-plane roll-up: None when the replay ran without a FaultPlan, so
    # fault-free summaries (and their digests) are byte-identical to
    # pre-fault-plane replays
    faults: Optional[dict] = None

    def summary(self) -> dict:
        """Deterministic, JSON-able digest (what benchmarks pin)."""
        gc_sweeps = self.telemetry.of_kind("gc")
        reclaimed = sum(r["seeds"] for r in gc_sweeps)
        rereplicated = sum(r["rereplicated"] for r in gc_sweeps)
        cache_expired = sum(r["cached"] for r in gc_sweeps)
        return {
            "policy": self.policy,
            "trace": self.trace,
            "seed": self.seed,
            "nodes": self.nodes,
            "invocations": self.invocations,
            "decisions": dict(sorted(self.decisions.items())),
            "latency": {k: dict(v) for k, v in sorted(self.latency.items())},
            "startup": {k: dict(v) for k, v in sorted(self.startup.items())},
            "mem_peak_node_mb": round(self.memory.peak_node() / 2**20, 3),
            "mem_peak_total_mb": round(self.memory.peak_total() / 2**20, 3),
            "mem_final_total_mb": round(self.memory.final_total() / 2**20, 3),
            "backlog_peak_s": round(self.backlog.peak_node(), 9),
            "gc": {"sweeps": len(gc_sweeps), "seeds_reclaimed": reclaimed,
                   "cached_expired": cache_expired,
                   "rereplicated": rereplicated},
            "lease": {f: dict(sorted(c.items()))
                      for f, c in sorted(self.lease.items())},
            "payload_pages": dict(sorted(self.payload_pages.items())),
            # connection control plane: per-backend pool state at replay
            # end (live slots) + churn counters — backends that never
            # connected are omitted so connectionless replays stay stable
            "conn": {name: dict(sorted(c.items()))
                     for name, c in sorted(self.conn.items())},
            "end_time_s": round(self.end_time, 9),
            "events": self.events_run,
            "event_log_digest": self.event_log_digest,
            **({"faults": self.faults} if self.faults is not None else {}),
        }

    def digest(self) -> str:
        return canonical_digest(self.summary())

    def to_json(self) -> str:
        return json.dumps(self.summary(), sort_keys=True, indent=1)


def build_cluster(n_nodes: int, transport: str = "dct",
                  page_elems: int = SIM_PAGE_ELEMS,
                  model: Optional[NetModel] = None,
                  pool_frames: int = 4096,
                  sanitize: Optional[bool] = None,
                  device="cuda"):
    """(network, nodes) wired to the sim clock: every node's lease clock
    reads ``net.sim_time``, so renewals and expiries happen in replayed
    seconds.  Construction is O(n): channel and link-lane state is lazy
    per pair/node, and each node pre-reserves ``pool_frames`` of frame
    capacity so container churn never pays growth copies.
    ``device`` places every node's pool: a torch device (default
    ``"cuda"``) holds the frames there and moves pages through the copy
    kernels (their plain versions on ``"cpu"``); ``None`` keeps host numpy
    pools.  ``sanitize=True`` runs the cluster under SimSan (None defers to
    the ``REPRO_SIMSAN`` environment switch, see
    repro_torch.analysis.simsan)."""
    net = Network(model=model, transport=transport, sanitize=sanitize)
    clock = SimClock(net)
    nodes = [NodeRuntime(f"n{i}", net, page_elems=page_elems, clock=clock,
                         pool_frames=pool_frames,
                         device_pool=device is not None, device=device)
             for i in range(n_nodes)]
    return net, nodes


class ReplayEngine:
    """Drive one (trace, policy) pair through the platform."""

    def __init__(self, trace: Trace, policy: AutoscalePolicy,
                 functions: List[SimFunction], *, n_nodes: int = 64,
                 seed: int = 0, transport: str = "dct",
                 page_elems: int = SIM_PAGE_ELEMS,
                 network: Optional[Network] = None,
                 nodes: Optional[List[NodeRuntime]] = None,
                 scheduler=None, reroute_backlog: Optional[float] = None,
                 gc_every: float = 30.0, sample_every: float = 30.0,
                 drain_margin: float = 120.0, keep_node_timelines: bool = False,
                 faults: Optional[FaultPlan] = None,
                 tiebreak_seed: Optional[int] = None,
                 device="cuda"):
        self.trace = trace
        self.policy = policy
        self.seed = seed
        if network is None or nodes is None:
            # device: where the nodes' pools live (build_cluster)
            network, nodes = build_cluster(n_nodes, transport=transport,
                                           page_elems=page_elems,
                                           device=device)
        self.net = network
        self.nodes = nodes
        # tiebreak_seed is the race detector's knob (repro_torch.analysis.races):
        # it shuffles same-(time, priority) dispatch order and must leave
        # every digest untouched on a race-free engine
        self.loop = EventLoop(network, seed=seed, tiebreak_seed=tiebreak_seed)
        self.coord = Coordinator(
            network, nodes, clock=SimClock(network),
            scheduler=scheduler or RoundRobinScheduler(),
            reroute_backlog=reroute_backlog)
        self.functions = {f.name: f for f in functions}
        for fname in trace.functions:
            if fname not in self.functions:
                raise ValueError(f"trace references unknown function {fname!r}")
        for f in functions:
            self.coord.register_function(f.to_fdef())
        self.gc_every = gc_every
        self.sample_every = sample_every
        self.drain_margin = drain_margin
        # telemetry & metrics
        self.telemetry = TelemetryStream()
        self.memory = Timeline("memory_bytes", keep_nodes=keep_node_timelines)
        self.backlog = Timeline("link_backlog_s",
                                keep_nodes=keep_node_timelines)
        self.decisions: Counter = Counter()
        self.latencies: Dict[str, List[float]] = {}
        self.startups: Dict[str, List[float]] = {}
        self.payload_pages: Counter = Counter()
        self.end_time = 0.0
        self._inflight = 0
        self._mem_peak_live: Dict[str, float] = {}
        # fault plane: the plan is installed as net.faults at run() so the
        # transports consult it; crashes ride the event loop (digest-visible)
        self.faults = faults
        self.injector: Optional[FaultInjector] = None
        self.failures = 0

    # -- modeled lifecycle costs --------------------------------------------

    def charge_coldstart(self, func: str) -> None:
        self.net.advance(self.functions[func].coldstart_s)

    def charge_warm_start(self, func: str) -> None:
        self.net.advance(self.functions[func].warm_start_s)

    # -- event handlers ------------------------------------------------------

    _PAYLOAD_KEYS = ("pages_rdma", "pages_rpc", "pages_cached",
                     "prefetch_wasted")

    def _payload_before(self, inst) -> Dict[str, int]:
        return {k: inst.stats.get(k, 0) for k in self._PAYLOAD_KEYS}

    def _fold_payload(self, inst, before: Dict[str, int]) -> None:
        for k, v0 in before.items():
            self.payload_pages[k] += inst.stats.get(k, 0) - v0

    def _degrade_to_cold(self, inv: Invocation, failed_inst, before):
        """The recovery chain's last rung: the fork path (or a mid-run
        remote read) failed beyond repair, so fold the failed child's
        partial payload stats (bytes it DID move stay accounted), free it,
        and cold-boot a pristine container on a live node.  Returns None —
        counting the invocation as failed — only when no live node can even
        coldstart."""
        if failed_inst is not None:
            self._fold_payload(failed_inst, before)
            if failed_inst.aspace:
                failed_inst.free()
        try:
            inst = self.coord.coldstart(inv.func, self.coord.pick_node())
        except ReproError:
            self.failures += 1
            return None
        self.charge_coldstart(inv.func)
        self.net.meter["degraded_cold"] += 1
        return inst

    def _on_arrival(self, inv: Invocation) -> None:
        t0 = self.net.sim_time
        try:
            kind, inst = self.policy.acquire(self, inv)
        except ReproError:
            # the policy's own path is gone (e.g. every scheduler candidate
            # crashed mid-trace): degrade straight to a coldstart
            kind, inst = "degraded", self._degrade_to_cold(inv, None, {})
            if inst is None:
                self.decisions["failed"] += 1
                return
        ready = self.net.sim_time
        before = self._payload_before(inst)
        fdef = self.coord.functions[inv.func]
        try:
            fdef.behavior(inst, {})
        except ReproError:
            # remote reads failed beyond the sibling/re-seed rungs
            kind, inst = "degraded", self._degrade_to_cold(inv, inst, before)
            if inst is None:
                self.decisions["failed"] += 1
                return
            ready = self.net.sim_time
            before = self._payload_before(inst)
            fdef.behavior(inst, {})     # pristine local pages: no fabric
        self.decisions[kind] += 1
        self.net.advance(fdef.exec_sim_time)
        done = self.net.sim_time
        self.latencies.setdefault(inv.func, []).append(done - t0)
        self.startups.setdefault(inv.func, []).append(ready - t0)
        self._fold_payload(inst, before)
        self._inflight += 1
        f = self.functions[inv.func]
        hold_end = max(done, t0 + (f.hold_s if f.hold_s is not None
                                   else f.exec_s))
        self.end_time = max(self.end_time, hold_end)
        # the completion label carries the serving decision and latency, so
        # the event-log digest witnesses per-invocation OUTCOMES, not just
        # the (policy-independent) dispatch schedule
        self.loop.at(hold_end, self._on_complete, inv, inst,
                     label=f"done:{inv.func}:{kind}:{int((done - t0) * 1e6)}us")

    def _on_complete(self, inv: Invocation, inst) -> None:
        self.policy.release(self, inv, inst)
        self._inflight -= 1

    def _on_crash(self, node_id: str) -> None:
        node = self.coord.nodes.get(node_id)
        if node is not None and node.alive:
            node.crash()
            self.telemetry.emit(self.net.sim_time, "crash", node=node_id)

    def _gc_tick(self) -> None:
        freed = self.coord.gc()
        self.telemetry.emit(
            self.net.sim_time, "gc", seeds=freed["seeds"],
            cached=freed["cached"], dangling=freed["dangling"],
            rereplicated=freed["rereplicated"])
        self.policy.on_gc(self, freed)

    def _sample(self) -> None:
        mem = {n.node_id: float(n.memory_bytes()) for n in self.nodes}
        self.memory.record(self.loop.now, mem)
        self.backlog.record(self.loop.now, self.net.backlog_snapshot()
                            or {self.nodes[0].node_id: 0.0})

    # -- run -----------------------------------------------------------------

    def run(self) -> ReplayResult:
        if self.faults is not None:
            # installed even when the plan is empty: the fig22 crash_rate=0
            # gate proves a live-but-empty injector perturbs nothing (the
            # zero plan draws no RNG, its penalty is an exact *1.0)
            self.injector = FaultInjector(self.net, self.faults)
            self.net.faults = self.injector
            self.injector.schedule(self.loop, self._on_crash)
        self.policy.on_start(self)
        arrivals = self.trace.arrivals(self.loop.rng)
        for inv in arrivals:
            self.loop.at(inv.t, self._on_arrival, inv,
                         label=f"arrive:{inv.func}")
        horizon = self.trace.duration_s + self.drain_margin
        # same-time ordering is declared, not incidental: invocation-facing
        # events (arrivals/completions/crashes) run first at a shared
        # timestamp, then GC sweeps, then timeline sampling — the order the
        # old schedule-sequence tiebreak happened to produce, now pinned by
        # priority so the tiebreak shuffle cannot flip gc/sample collisions
        # (every 60 s both fire at the same instant)
        self.loop.every(self.gc_every, self._gc_tick, until=horizon,
                        label="gc", priority=10)
        self.loop.every(self.sample_every, self._sample, until=horizon,
                        start=0.0, label="sample", priority=20)
        self.loop.run()
        def rollup(per_func: Dict[str, List[float]]) -> Dict[str, Dict[str, int]]:
            rows, flat = {}, []
            for func in sorted(per_func):
                rows[func] = latency_row(per_func[func])
                flat.extend(per_func[func])
            rows["all"] = latency_row(flat)
            return rows

        latency = rollup(self.latencies)
        startup = rollup(self.startups)
        meter = {k: (round(v, 9) if isinstance(v, float) else v)
                 for k, v in sorted(self.net.meter.items())}
        conn = {}
        for name, pb in self.net.per_backend().items():
            if pb["setups"] or pb["conn_live"] or pb["conn_evicted"]:
                conn[name] = {"live": pb["conn_live"],
                              "setups": pb["setups"],
                              "setup_s": round(pb["setup_s"], 9),
                              "evicted": pb["conn_evicted"],
                              "reestablished": pb["conn_reestablished"]}
        return ReplayResult(
            policy=self.policy.describe(), trace=self.trace.name,
            seed=self.seed, nodes=len(self.nodes),
            invocations=len(arrivals), decisions=dict(self.decisions),
            latency=latency, startup=startup,
            memory=self.memory, backlog=self.backlog,
            telemetry=self.telemetry, meter=meter, conn=conn,
            lease={f: dict(c) for f, c in self.coord.lease_telemetry.items()},
            payload_pages=dict(self.payload_pages),
            end_time=self.end_time, events_run=self.loop.events_run,
            event_log_digest=self.loop.log_digest(),
            faults=self._faults_rollup(len(arrivals)))

    def _faults_rollup(self, invocations: int) -> Optional[dict]:
        """Deterministic fault-plane summary section; None for fault-free
        replays AND for installed-but-empty plans, so a zero-rate plan's
        full summary digest is bit-identical to no plan at all."""
        if self.faults is None or self.faults.empty():
            return None
        m = self.net.meter
        return {
            "plan": self.faults.describe(),
            "crashes_fired": self.injector.crashes_fired,
            "timeouts": int(m.get("timeouts", 0)),
            "retries": int(m.get("retries", 0)),
            "backoff_wait_s": round(float(m.get("backoff_wait_s", 0.0)), 9),
            "recovery": {
                "pages": int(m.get("recovery.pages", 0)),
                "bytes": int(m.get("recovery.bytes", 0)),
                "sibling": int(m.get("recovery.sibling", 0)),
                "reseed": int(m.get("recovery.reseed", 0)),
                "reseed_fetches": int(m.get("recovery.reseed_fetches", 0)),
            },
            "degraded": int(m.get("degraded_cold", 0)),
            "failed": self.failures,
            "completion_rate": round(
                1.0 - self.failures / max(1, invocations), 6),
        }
