"""Replay metrics — tail-latency CDFs, per-node timelines, telemetry.

Everything the :class:`~repro_torch.sim.engine.ReplayEngine` emits is built from
the deterministic sim clock and the network meter, so two replays of the
same trace under the same RNG seed produce *byte-identical* metrics (and
event logs) — the determinism contract ``tests/test_sim_engine.py`` pins.

``percentile`` is also the fix for the legacy fig20 tail-index bug: the old
``lat[min(int(0.99 * len(lat)), len(lat) - 1)]`` clamp silently reports the
*maximum* on any trace shorter than 100 samples.  Here percentiles
interpolate linearly between order statistics (numpy's default), so a p99
on a short trace is a tail estimate, not a disguised p100.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


def percentile(samples: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) with linear interpolation between
    order statistics.  Unlike the legacy fig20 index clamp, this never
    silently degrades to the maximum on short traces."""
    arr = np.asarray(samples, np.float64)
    if arr.size == 0:
        return 0.0
    return float(np.percentile(arr, q))


def latency_row(samples: Sequence[float]) -> Dict[str, int]:
    """The standard tail-latency digest (microseconds, ints so committed
    benchmark artifacts stay byte-stable across platforms)."""
    arr = np.asarray(samples, np.float64)
    if arr.size == 0:
        return {"count": 0, "mean_us": 0, "p50_us": 0, "p99_us": 0,
                "p999_us": 0, "max_us": 0}
    return {
        "count": int(arr.size),
        "mean_us": int(arr.mean() * 1e6),
        "p50_us": int(percentile(arr, 50) * 1e6),
        "p99_us": int(percentile(arr, 99) * 1e6),
        "p999_us": int(percentile(arr, 99.9) * 1e6),
        "max_us": int(arr.max() * 1e6),
    }


def cdf_points(samples: Sequence[float],
               qs: Iterable[float] = (50, 90, 99, 99.9)) -> Dict[str, int]:
    """{"p50_us": ..., ...} CDF points for plotting/pinning."""
    return {f"p{str(q).rstrip('0').rstrip('.')}_us":
            int(percentile(samples, q) * 1e6) for q in qs}


@dataclasses.dataclass
class Timeline:
    """Per-node samples over sim time: ``rows`` is [(t, {node: value})].

    The full per-node matrix is kept only when ``keep_nodes`` — at fleet
    scale (thousands of nodes) the aggregate columns are what benchmarks
    pin, and the matrix would dominate the result payload.
    """

    name: str
    keep_nodes: bool = False
    rows: List[Tuple[float, Dict[str, float]]] = dataclasses.field(
        default_factory=list)
    # aggregate columns, one entry per sample: (t, total, max, mean)
    samples: List[Tuple[float, float, float, float]] = dataclasses.field(
        default_factory=list)

    def record(self, t: float, by_node: Dict[str, float]) -> None:
        vals = list(by_node.values())
        total = float(sum(vals))
        mx = float(max(vals)) if vals else 0.0
        mean = total / len(vals) if vals else 0.0
        self.samples.append((t, total, mx, mean))
        if self.keep_nodes:
            self.rows.append((t, dict(by_node)))

    def peak_total(self) -> float:
        return max((s[1] for s in self.samples), default=0.0)

    def peak_node(self) -> float:
        """The busiest single node seen at any sample point."""
        return max((s[2] for s in self.samples), default=0.0)

    def peak_mean(self) -> float:
        return max((s[3] for s in self.samples), default=0.0)

    def final_total(self) -> float:
        return self.samples[-1][1] if self.samples else 0.0

    def series(self) -> List[Dict[str, float]]:
        return [{"t": round(t, 6), "total": total, "max_node": mx,
                 "mean_node": mean} for t, total, mx, mean in self.samples]


class TelemetryStream:
    """Structured replay telemetry: GC sweeps, lease churn, autoscaler
    decisions — each record is (sim_time, kind, payload) and the stream
    serializes canonically for the determinism digest."""

    def __init__(self):
        self.records: List[dict] = []

    def emit(self, t: float, kind: str, **payload) -> None:
        self.records.append({"t": round(t, 9), "kind": kind, **payload})

    def of_kind(self, kind: str) -> List[dict]:
        return [r for r in self.records if r["kind"] == kind]

    def last(self, kind: str) -> Optional[dict]:
        recs = self.of_kind(kind)
        return recs[-1] if recs else None

    def to_json(self) -> str:
        return json.dumps(self.records, sort_keys=True)


def canonical_digest(obj) -> str:
    """sha256 over a canonical JSON encoding — the byte-identity check for
    event logs and metric summaries (same trace + seed => same digest)."""
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()
