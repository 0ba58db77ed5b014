"""RoutePlan — the explicit per-VMA route of one fork.

The implicit route of the single-parent design ("every VMA pages in from
``Descriptor.parent_node`` over the instance transport") becomes a
first-class object: one :class:`VMARoute` per VMA naming the owner node
that serves its pages and the transport it rides.  Placement policies
(:mod:`repro_torch.placement.policy`) build plans; ``ForkHandle.resume_on`` /
``ShardedSeed.resume_on`` apply them by stamping each child VMA's route
fields (``VMA.ancestry`` / ``VMA.transport``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch import _dtypes


@dataclasses.dataclass(frozen=True)
class VMAInfo:
    """What a placement policy sees of one VMA: name + payload size."""

    name: str
    nbytes: int


def descriptor_vma_infos(desc) -> List[VMAInfo]:
    """VMAInfo list for a descriptor's page tables (metadata only)."""
    return [VMAInfo(name=vd["name"],
                    nbytes=int(np.prod(vd["shape"]))
                    * _dtypes.itemsize(vd["dtype"]))
            for vd in desc.vmas]


@dataclasses.dataclass(frozen=True)
class VMARoute:
    """One VMA's route: the parent replica serving its pages and the
    transport name the reads ride (None = the policy/network default)."""

    owner: str
    transport: Optional[str] = None


@dataclasses.dataclass
class RoutePlan:
    """vma name -> VMARoute for one resume.  Serializable (descriptors and
    control-plane messages carry it as plain dicts)."""

    routes: Dict[str, VMARoute] = dataclasses.field(default_factory=dict)

    def __getitem__(self, name: str) -> VMARoute:
        return self.routes[name]

    def __contains__(self, name: str) -> bool:
        return name in self.routes

    def owners(self) -> List[str]:
        """Distinct owner nodes, in first-use order."""
        seen: Dict[str, None] = {}
        for r in self.routes.values():
            seen.setdefault(r.owner, None)
        return list(seen)

    def transports(self) -> List[Optional[str]]:
        """Distinct transport names (None = default), in first-use order."""
        seen: Dict[Optional[str], None] = {}
        for r in self.routes.values():
            seen.setdefault(r.transport, None)
        return list(seen)

    def by_owner(self) -> Dict[str, List[str]]:
        """owner -> [vma names] it serves under this plan."""
        out: Dict[str, List[str]] = {}
        for name, r in self.routes.items():
            out.setdefault(r.owner, []).append(name)
        return out

    def reroute(self, lost_owner: str, plan: "RoutePlan") -> int:
        """Replace every route through ``lost_owner`` with the matching
        route from ``plan``.  Serves both the degradation path (a replica
        died between planning and fetch) and the Router's hot-spot path (a
        live replica's link backlog crossed the policy threshold); a VMA
        the fallback plan has no entry for keeps its current route.
        Returns the number of VMAs re-routed."""
        moved = 0
        for name, r in list(self.routes.items()):
            if r.owner == lost_owner and name in plan.routes:
                self.routes[name] = plan.routes[name]
                moved += 1
        return moved

    def to_dict(self) -> Dict[str, dict]:
        return {n: {"owner": r.owner, "transport": r.transport}
                for n, r in self.routes.items()}

    @classmethod
    def from_dict(cls, d: Dict[str, dict]) -> "RoutePlan":
        return cls(routes={n: VMARoute(owner=r["owner"],
                                       transport=r.get("transport"))
                           for n, r in d.items()})


@dataclasses.dataclass(frozen=True)
class ReplicaSource:
    """One sibling replica's copy of one VMA: the frame table its pages
    live in, the DC key guarding them, and the payload size — everything a
    Router needs to serve the VMA from that replica instead."""

    frames: np.ndarray
    dc_key: int
    nbytes: int


class Router:
    """Dynamic hot-spot re-routing for one routed child (ROADMAP: live
    load triggering ``RoutePlan.reroute``, not just crash degradation).

    The fault handler and the async PrefetchEngine consult the Router
    (via ``ModelInstance._hop_groups``) before every hop-1 read.  When the
    planned owner's link backlog (``Network.link_backlog``) exceeds the
    policy threshold — or the owner left the network entirely — and a
    sibling replica holds the same bytes, the Router re-plans every VMA
    routed through that owner across the cooler replicas
    (``RoutePlan.reroute``) and re-stamps the faulting VMA's page table
    from the alternate's frame table.  Other re-routed VMAs re-stamp
    lazily on their next fault.  A re-route moves the SAME pages from a
    different NIC: sweeps stay byte-identical to the static plan, only
    their queueing differs.
    """

    def __init__(self, net, plan: "RoutePlan",
                 sources: Dict[str, Dict[str, ReplicaSource]],
                 threshold: float, src: Optional[str] = None):
        self.net = net
        self.plan = plan
        self.sources = sources
        self.threshold = threshold
        # the child node reads originate from: with it known, fallback
        # candidates are priced with the establishment the pools say a
        # (src, candidate) route would owe — a replica this child already
        # holds a warm connection to beats an equally-cool cold one
        self.src = src
        self.reroutes = 0           # VMAs moved off a hot/lost owner
        # owner -> (sim_time, backlog) of the last replan that moved
        # nothing: until the clock or the owner's backlog changes, the
        # alternates can only be the same or hotter, so retrying the
        # greedy fallback plan on every fault would be pure wasted work
        self._stay_put: Dict[str, tuple] = {}

    def _owner_backlog(self, owner: str) -> float:
        if owner not in self.net.nodes:
            return float("inf")     # crash degradation: infinitely hot
        return self.net.link_backlog(owner)

    def _usable(self, name: str, owner: str) -> bool:
        src = self.sources.get(name, {}).get(owner)
        return (src is not None and owner in self.net.nodes
                and self.net.target_valid(owner, src.dc_key))

    def _fallback_plan(self, hot: str) -> "RoutePlan":
        """Spread every VMA currently planned on ``hot`` across the cooler
        replicas, greedily loading the least-backlogged link first (wire
        seconds estimated from each VMA's bytes over its routed fabric).
        VMAs with no viable alternate are left out (they keep their
        route)."""
        backlog = self._owner_backlog(hot)
        load: Dict[str, float] = {}
        fallback = RoutePlan()
        pending = sorted(
            ((n, r) for n, r in self.plan.routes.items() if r.owner == hot),
            key=lambda e: -self.sources.get(e[0], {}).get(hot, _NO_SRC).nbytes)
        for name, route in pending:
            cands = [o for o in self.sources.get(name, {})
                     if o != hot and self._usable(name, o)]
            if not cands:
                continue
            for o in cands:
                if o not in load:
                    load[o] = self.net.link_backlog(o)
                    if self.src is not None:
                        # observed pool state: a cold candidate owes its
                        # connection setup before the first byte moves
                        load[o] += self.net.setup_owed(
                            route.transport or self.net.transport,
                            self.src, o)
            best = min(cands, key=lambda o: (load[o], o))
            # a VMA the hot owner can no longer serve at all (revoked key)
            # moves to ANY usable sibling, however loaded
            if load[best] >= backlog and self._usable(name, hot):
                continue            # everyone is at least as hot: stay put
            fallback.routes[name] = VMARoute(owner=best,
                                             transport=route.transport)
            t = self.net.transport_obj(route.transport)
            load[best] += self.sources[name][best].nbytes / t.bandwidth()
        return fallback

    def sync(self, vma) -> None:
        """Bring ``vma``'s stamped route up to date before a hop-1 read:
        re-route its planned owner if hot/lost, then re-point the page
        table at the routed replica's frames when the plan moved."""
        route = self.plan.routes.get(vma.name)
        if route is None or not vma.ancestry:
            return
        stale = vma.ancestry[0] != route.owner  # plan moved on an earlier
        #                                         fault; stamp lags behind
        backlog = self._owner_backlog(route.owner)
        if (backlog > self.threshold
                or (stale and not self._usable(vma.name, route.owner))):
            # the planned owner is hot, lost, or (if we are about to lazily
            # re-stamp onto it) no longer able to serve this VMA at all —
            # re-plan its whole share before resolving the read, unless an
            # identical attempt already came up empty
            state = (self.net.sim_time, backlog)
            if self._stay_put.get(route.owner) != state:
                moved = self.plan.reroute(route.owner,
                                          self._fallback_plan(route.owner))
                if moved:
                    self.reroutes += moved
                    self.net.meter["reroutes"] += moved
                    self._stay_put.pop(route.owner, None)
                else:
                    self._stay_put[route.owner] = state
            route = self.plan.routes[vma.name]
        if vma.ancestry[0] == route.owner:
            return                  # stamp already matches the plan
        if not self._usable(vma.name, route.owner):
            return                  # never re-stamp onto a dead/revoked
            #                         owner: keep serving from the stamp
        # the plan moved (here or on an earlier fault): re-stamp the still
        # remote hop-1 pages onto the new owner's frame table and key
        src = self.sources[vma.name][route.owner]
        remote = (vma.owner_hop == 1) & vma.missing_mask()
        vma.frames[remote] = src.frames[remote]
        vma.dc_keys[1] = src.dc_key
        vma.ancestry = [route.owner] + vma.ancestry[1:]
        vma.transport = route.transport or vma.transport


_NO_SRC = ReplicaSource(frames=None, dc_key=-1, nbytes=0)


def route_demand(owners: Iterable[str],
                 transports: Iterable[Optional[str]]) -> List[tuple]:
    """(owner, transport) pairs a scheduler scores a candidate child node
    against — the cross product of a seed's replica set and its policy's
    transport mix."""
    return [(o, t) for o in owners for t in transports]
