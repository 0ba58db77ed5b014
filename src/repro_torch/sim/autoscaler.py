"""Autoscaler policies — who serves each invocation, and at what cost.

A policy decides, per arrival, whether the invocation lands on a warm
container, a freshly forked child, or a cold boot — and it does so by
driving the *real* platform: ``Coordinator.deploy_seed`` / fork-path
``acquire_instance`` / ``release`` / ``gc``, with lease renewal and cache
keepalive ticking on the replay's sim clock.  The only modeled constants
are the container lifecycle costs the repo does not simulate (process
boot, runtime init): ``coldstart_s`` on a cold boot and ``warm_start_s``
on an unpause, both charged by advancing the network clock.  Everything on
the fork path — descriptor fetch, authentication RPC, demand paging over
contended link lanes — is charged by the data plane itself.

Occupancy matters: a container acquired at t serves until its completion
event, so it is *out* of the warm pool for the whole execution. Keep-warm
capacity therefore tracks real concurrency (the paper's provisioning
argument) instead of one container magically serving a whole spike.

Policies:

* :class:`ForkOnDemand` — MITOSIS: S seed replicas per function, every
  invocation forks a child and frees it on completion.  Seeds stay alive
  through use-driven lease renewal and die of lease expiry when idle.
* :class:`KeepWarm` — Fn/OpenWhisk-style caching: released containers
  park in the coordinator's cached pool (LIFO reuse — the most recently
  parked container is the next one handed out), expire after ``ttl`` via
  ``Coordinator.gc``, optionally capped by ``budget``.
* :class:`Hybrid` — a bounded warm pool backed by fork spill: warm first,
  fork when the pool is empty, cold only if both fail.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.core.instance import ModelInstance
from repro_torch.platform.coordinator import DEFAULT_SEED_KEEPALIVE


class AutoscalePolicy:
    """Base policy.  Subclasses implement ``acquire``/``release``; the
    engine calls ``on_start`` once before the first arrival and ``on_gc``
    after every GC sweep."""

    name = "base"

    def on_start(self, engine) -> None:
        pass

    def acquire(self, engine, inv) -> Tuple[str, ModelInstance]:
        """Serve one arrival.  Returns (kind, instance) with kind in
        {"warm", "fork", "cold"}; all setup cost must be charged to the
        network clock before returning."""
        raise NotImplementedError

    def release(self, engine, inv, inst: ModelInstance) -> None:
        """Called at the invocation's completion event."""
        raise NotImplementedError

    def on_gc(self, engine, freed: dict) -> None:
        pass

    def describe(self) -> dict:
        return {"policy": self.name}


class ForkOnDemand(AutoscalePolicy):
    """Remote fork per invocation from S long-lived seed replicas."""

    name = "fork"

    def __init__(self, replicas: int = 1, lease: float = DEFAULT_SEED_KEEPALIVE,
                 renew_every: float = 60.0, lazy: bool = True,
                 prefetch: int = 1):
        self.replicas = replicas
        self.lease = lease
        self.renew_every = renew_every
        self.lazy = lazy
        self.prefetch = prefetch
        self._last_renew: dict = {}

    def on_start(self, engine) -> None:
        # keep the coordinator's auto-reseed path (coldstart fallback after
        # a lease expiry) at the same replica count as the initial deploy
        engine.coord.seed_replicas = self.replicas
        for func in engine.trace.functions:
            engine.coord.deploy_seed(func, replicas=self.replicas,
                                     keep_alive=self.lease)
            self._last_renew[func] = engine.net.sim_time

    def acquire(self, engine, inv) -> Tuple[str, ModelInstance]:
        coord = engine.coord
        now = engine.net.sim_time
        # use-driven keepalive: traffic renews the seed lease; an idle
        # function simply stops renewing and its seed ages out via gc()
        if now - self._last_renew.get(inv.func, 0.0) >= self.renew_every:
            coord.renew_seed(inv.func)
            self._last_renew[inv.func] = now
        had_seed = inv.func in coord.seed_store
        inst = coord.acquire_instance(inv.func, policy="fork",
                                      lazy=self.lazy, prefetch=self.prefetch)
        if inst.ancestry:
            return "fork", inst
        # the seed was gone (expired / reclaimed) and acquire fell back to
        # a coldstart that re-registered it — charge the cold boot
        engine.charge_coldstart(inv.func)
        self._last_renew[inv.func] = engine.net.sim_time
        if had_seed:
            engine.telemetry.emit(engine.net.sim_time, "seed_refresh",
                                  func=inv.func)
        return "cold", inst

    def release(self, engine, inv, inst: ModelInstance) -> None:
        engine.coord.release(inv.func, inst, "fork")

    def describe(self) -> dict:
        return {"policy": self.name, "replicas": self.replicas,
                "lease_s": self.lease, "renew_every_s": self.renew_every}


class KeepWarm(AutoscalePolicy):
    """Caching baseline: boot cold, park released containers warm.

    ``ttl`` maps to ``Coordinator.cache_keepalive`` so expiry is enforced
    by the platform's own GC on the sim clock.  Reuse is LIFO — the most
    recently parked container serves next, so the oldest entries are the
    ones that age out.  (The legacy fig20 model got this backwards: it
    consumed the *longest-lived* pool entries first, which both overstated
    warm capacity late in a spike and understated it early.)  ``budget``
    caps the pool per function, evicting oldest-parked first; ``prewarm``
    boots N containers per function at t=0 — the equal-warm-budget handle
    benchmarks use to compare against S fork replicas.
    """

    name = "cache"

    def __init__(self, ttl: float = 60.0, budget: Optional[int] = None,
                 prewarm: int = 0):
        self.ttl = ttl
        self.budget = budget
        self.prewarm = prewarm

    def on_start(self, engine) -> None:
        coord = engine.coord
        coord.cache_keepalive = self.ttl
        coord.auto_seed = False          # pure caching: no seed state at all
        for func in engine.trace.functions:
            pool = coord.cached.setdefault(func, [])
            for _ in range(self.prewarm):
                inst = coord.coldstart(func, coord.pick_node())
                pool.append((inst, engine.net.sim_time))

    def _pop_warm(self, engine, func: str) -> Optional[ModelInstance]:
        pool: List[tuple] = engine.coord.cached.get(func, [])
        while pool:
            inst, _ts = pool.pop()       # LIFO: most recently parked first
            if inst.aspace:              # husks (freed underneath) dropped
                return inst
        return None

    def acquire(self, engine, inv) -> Tuple[str, ModelInstance]:
        inst = self._pop_warm(engine, inv.func)
        if inst is not None:
            engine.charge_warm_start(inv.func)
            return "warm", inst
        inst = engine.coord.coldstart(inv.func, engine.coord.pick_node())
        engine.charge_coldstart(inv.func)
        return "cold", inst

    def release(self, engine, inv, inst: ModelInstance) -> None:
        coord = engine.coord
        coord.release(inv.func, inst, "cache")
        pool = coord.cached.get(inv.func, [])
        if self.budget is not None and len(pool) > self.budget:
            over = len(pool) - self.budget
            for victim, _ts in pool[:over]:    # evict oldest-parked first
                if victim.aspace:
                    victim.free()
            del pool[:over]
            engine.telemetry.emit(engine.net.sim_time, "evicted",
                                  func=inv.func, count=over)

    def describe(self) -> dict:
        return {"policy": self.name, "ttl_s": self.ttl,
                "budget": self.budget, "prewarm": self.prewarm}


class Hybrid(KeepWarm):
    """Bounded warm pool with fork spill: warm hit if the pool has a live
    container, else fork a child from the seed (``spill_to_fork=True``),
    else cold boot.  Fork children are freed on completion; warm containers
    go back to the pool (capped at ``pool``)."""

    name = "hybrid"

    def __init__(self, pool: int = 2, ttl: float = 60.0,
                 spill_to_fork: bool = True, replicas: int = 1,
                 lease: float = DEFAULT_SEED_KEEPALIVE, lazy: bool = True,
                 prefetch: int = 1):
        super().__init__(ttl=ttl, budget=pool, prewarm=pool)
        self.spill_to_fork = spill_to_fork
        self.replicas = replicas
        self.lease = lease
        self.lazy = lazy
        self.prefetch = prefetch

    def on_start(self, engine) -> None:
        coord = engine.coord
        coord.cache_keepalive = self.ttl
        for func in engine.trace.functions:
            if self.spill_to_fork:
                engine.coord.deploy_seed(func, replicas=self.replicas,
                                         keep_alive=self.lease)
            pool = coord.cached.setdefault(func, [])
            for _ in range(self.prewarm):
                inst = coord.coldstart(func, coord.pick_node())
                pool.append((inst, engine.net.sim_time))

    def acquire(self, engine, inv) -> Tuple[str, ModelInstance]:
        inst = self._pop_warm(engine, inv.func)
        if inst is not None:
            engine.charge_warm_start(inv.func)
            return "warm", inst
        if self.spill_to_fork and inv.func in engine.coord.seed_store:
            inst = engine.coord.acquire_instance(
                inv.func, policy="fork", lazy=self.lazy,
                prefetch=self.prefetch)
            if inst.ancestry:
                return "fork", inst
            engine.charge_coldstart(inv.func)
            return "cold", inst
        inst = engine.coord.coldstart(inv.func, engine.coord.pick_node())
        engine.charge_coldstart(inv.func)
        return "cold", inst

    def release(self, engine, inv, inst: ModelInstance) -> None:
        coord = engine.coord
        if inst.ancestry:
            # spilled fork children are never cached (§6.2)
            coord.release(inv.func, inst, "fork")
            return
        super().release(engine, inv, inst)

    def describe(self) -> dict:
        return {"policy": self.name, "pool": self.budget, "ttl_s": self.ttl,
                "spill_to_fork": self.spill_to_fork,
                "replicas": self.replicas}


class ColdStart(AutoscalePolicy):
    """Control: every invocation boots cold and is torn down after."""

    name = "coldstart"

    def on_start(self, engine) -> None:
        engine.coord.auto_seed = False

    def acquire(self, engine, inv) -> Tuple[str, ModelInstance]:
        inst = engine.coord.coldstart(inv.func, engine.coord.pick_node())
        engine.charge_coldstart(inv.func)
        return "cold", inst

    def release(self, engine, inv, inst: ModelInstance) -> None:
        inst.free()
