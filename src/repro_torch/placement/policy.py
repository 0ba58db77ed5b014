"""PlacementPolicy — who serves each VMA, and over which fabric.

Faasm's key observation is that per-region state policy (hot vs cold) is
what makes stateful serverless fast; MITOSIS's is that fan-out bandwidth
must not funnel through one parent NIC.  A placement policy owns both
decisions for one seed: given the VMAs of a descriptor and the live parent
replica set, it emits a :class:`~repro_torch.placement.route.RoutePlan` naming,
per VMA, the replica that serves it and the transport the pages ride.

Built-ins:

* :class:`SpreadPolicy` — balance VMA bytes across the replica set (LPT
  greedy), one transport for everything.  The sharded-seed default.
* :class:`HotColdPolicy` — classify VMAs hot/cold by name pattern (cold:
  optimizer state, EMA shadows, ...), route hot VMAs over the fast fabric
  (``dct``/``tpu_ici``) and cold ones over the cheap one (``shared_fs``),
  spreading both classes across replicas.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence

from repro_torch.net import resolve_transport
from repro_torch.placement.route import RoutePlan, VMAInfo, VMARoute

# optimizer / shadow state: read rarely, tolerates checkpoint-fabric latency
DEFAULT_COLD_PATTERN = r"(^|/)(opt|optimizer|adam|momentum|ema|shadow)(/|$)"


class PlacementPolicy:
    """Base: route every VMA to the first replica over the default
    transport (exactly the legacy single-parent behavior)."""

    def plan(self, vmas: Sequence[VMAInfo], replicas: Sequence[str],
             offset: int = 0) -> RoutePlan:
        if not replicas:
            raise ValueError("cannot place VMAs on an empty replica set")
        return RoutePlan(routes={v.name: VMARoute(owner=replicas[0])
                                 for v in vmas})

    def plan_for(self, desc, replicas: Sequence[str],
                 offset: int = 0) -> RoutePlan:
        """Plan from a descriptor's page tables (metadata only)."""
        from repro_torch.placement.route import descriptor_vma_infos
        return self.plan(descriptor_vma_infos(desc), replicas, offset=offset)

    def transport_hints(self) -> List[Optional[str]]:
        """Transport names this policy may route over (None = default);
        used by schedulers to estimate setup costs before any descriptor
        exists."""
        return [None]


def _spread(vmas: Sequence[VMAInfo], replicas: Sequence[str],
            offset: int) -> dict:
    """LPT greedy: biggest VMA first onto the least-loaded replica, so
    per-replica serve bytes stay balanced.  ``offset`` rotates the replica
    order per child, spreading tie-broken assignments (and thus channel
    load) across the fleet deterministically."""
    order = [replicas[(i + offset) % len(replicas)]
             for i in range(len(replicas))]
    load = {r: 0 for r in order}
    owners = {}
    for v in sorted(vmas, key=lambda v: (-v.nbytes, v.name)):
        owner = min(order, key=lambda r: load[r])
        owners[v.name] = owner
        load[owner] += v.nbytes
    return owners


class SpreadPolicy(PlacementPolicy):
    """Balance VMA bytes across the replica set; single transport."""

    def __init__(self, transport: Optional[str] = None):
        if transport is not None:
            resolve_transport(transport)        # unknown name -> ValueError
        self.transport = transport

    def plan(self, vmas: Sequence[VMAInfo], replicas: Sequence[str],
             offset: int = 0) -> RoutePlan:
        if not replicas:
            raise ValueError("cannot place VMAs on an empty replica set")
        owners = _spread(vmas, replicas, offset)
        return RoutePlan(routes={
            v.name: VMARoute(owner=owners[v.name], transport=self.transport)
            for v in vmas})

    def transport_hints(self) -> List[Optional[str]]:
        return [self.transport]


class HotColdPolicy(PlacementPolicy):
    """Hot VMAs (weights) over the fast fabric, cold VMAs (optimizer /
    shadow state, matched by ``cold_pattern``) over the cheap one; both
    classes spread across the replica set by bytes."""

    def __init__(self, hot: Optional[str] = "dct",
                 cold: Optional[str] = "shared_fs",
                 cold_pattern: str = DEFAULT_COLD_PATTERN):
        for name in (hot, cold):
            if name is not None:
                resolve_transport(name)
        self.hot = hot
        self.cold = cold
        self._cold_re = re.compile(cold_pattern)

    def is_cold(self, name: str) -> bool:
        return self._cold_re.search(name) is not None

    def plan(self, vmas: Sequence[VMAInfo], replicas: Sequence[str],
             offset: int = 0) -> RoutePlan:
        if not replicas:
            raise ValueError("cannot place VMAs on an empty replica set")
        owners = _spread(vmas, replicas, offset)
        return RoutePlan(routes={
            v.name: VMARoute(owner=owners[v.name],
                             transport=self.cold if self.is_cold(v.name)
                             else self.hot)
            for v in vmas})

    def transport_hints(self) -> List[Optional[str]]:
        return [self.hot, self.cold]
