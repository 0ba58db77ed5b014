"""repro_torch.sim — deterministic discrete-event trace replay over the real stack.

The subsystem behind the rebuilt fig20: per-minute invocation traces
(Azure-format CSV or synthetic generators) are expanded into arrival
events on a single sim-time heap, each served through the actual
platform — Coordinator seed store, ForkHandle/ShardedSeed resume paths,
demand paging on contended link lanes, lease renewal/expiry/GC — under a
pluggable autoscaler policy.  No wall clock, no analytical fork-latency
shortcuts; one seed, one schedule, byte-identical metrics.

See ``docs/replay.md`` for the event model and how to add a policy.
"""
from .autoscaler import (AutoscalePolicy, ColdStart, ForkOnDemand, Hybrid,
                         KeepWarm)
from .engine import (ReplayEngine, ReplayResult, SimFunction, build_cluster)
from .events import EventLoop, SimClock
from .faults import Crash, Degrade, FaultInjector, FaultPlan, Flap
from .metrics import (TelemetryStream, Timeline, canonical_digest, cdf_points,
                      latency_row, percentile)
from .trace import (SPIKE_660323, Invocation, Trace, correlated_spikes,
                    diurnal, load_azure_csv, multi_function, spike_660323)

__all__ = [
    "AutoscalePolicy", "ColdStart", "ForkOnDemand", "Hybrid", "KeepWarm",
    "ReplayEngine", "ReplayResult", "SimFunction", "build_cluster",
    "EventLoop", "SimClock",
    "Crash", "Degrade", "FaultInjector", "FaultPlan", "Flap",
    "TelemetryStream", "Timeline", "canonical_digest", "cdf_points",
    "latency_row", "percentile",
    "SPIKE_660323", "Invocation", "Trace", "correlated_spikes", "diurnal",
    "load_azure_csv", "multi_function", "spike_660323",
]
