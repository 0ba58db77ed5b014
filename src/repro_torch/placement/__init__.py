"""repro_torch.placement — the seed placement/routing plane.

Sits between the fork control plane (:mod:`repro_torch.fork`) and the pluggable
transports (:mod:`repro_torch.net`): sharded multi-parent seeds
(:class:`ShardedSeed`), explicit per-VMA routes (:class:`RoutePlan` /
:class:`VMARoute`) chosen by a :class:`PlacementPolicy`
(:class:`SpreadPolicy`, :class:`HotColdPolicy`), and transport-/load-aware
node scheduling (:class:`RoundRobinScheduler`,
:class:`TransportAwareScheduler`).  See ``docs/placement.md``.
"""
from repro_torch.placement.policy import (DEFAULT_COLD_PATTERN, HotColdPolicy,
                                          PlacementPolicy, SpreadPolicy)
from repro_torch.placement.route import (ReplicaSource, Router, RoutePlan,
                                         VMAInfo, VMARoute,
                                         descriptor_vma_infos, route_demand)
from repro_torch.placement.scheduler import (RoundRobinScheduler,
                                             TransportAwareScheduler)
from repro_torch.placement.sharded import ShardedSeed

__all__ = [
    "DEFAULT_COLD_PATTERN",
    "HotColdPolicy",
    "PlacementPolicy",
    "ReplicaSource",
    "RoundRobinScheduler",
    "Router",
    "RoutePlan",
    "ShardedSeed",
    "SpreadPolicy",
    "TransportAwareScheduler",
    "VMAInfo",
    "VMARoute",
    "descriptor_vma_infos",
    "route_demand",
]
