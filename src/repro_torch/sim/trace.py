"""Invocation traces — per-minute counts expanded into arrival events.

Traces follow the Azure Functions dataset convention (the workload source
for the paper's Fig. 20): one row per function, one integer column per
minute.  ``load_azure_csv`` reads that format directly; the synthetic
generators build the same shape programmatically — including the paper's
function-660323 spike (1 rps jumping to ~120 rps inside two minutes).

A :class:`Trace` is purely *counts*.  Arrival times are materialized by
``arrivals(rng)``: each minute's count becomes that many uniformly
jittered timestamps inside the minute, drawn from the replay's seeded RNG
in a fixed order (functions sorted by name, minutes ascending) — so the
same trace and seed always yield the same arrival schedule.
"""
from __future__ import annotations

import csv
import dataclasses
import math
import random
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

# The per-minute invocation counts of the paper's motivating function
# (HashFunction 660323 of the Azure trace): flat ~1/min, a 100x+ burst
# over two minutes, then decay back to baseline.
SPIKE_660323: Tuple[int, ...] = (1, 1, 2, 1, 1, 40, 120, 30, 2, 1, 1, 1)


@dataclasses.dataclass(frozen=True)
class Invocation:
    """One arrival: sim time (s), function name, global index."""
    t: float
    func: str
    idx: int


@dataclasses.dataclass(frozen=True)
class Trace:
    """Per-minute invocation counts for one or more functions."""

    name: str
    per_minute: Mapping[str, Tuple[int, ...]]

    def __post_init__(self):
        frozen = {f: tuple(int(c) for c in counts)
                  for f, counts in self.per_minute.items()}
        if not frozen:
            raise ValueError("trace has no functions")
        for f, counts in frozen.items():
            if any(c < 0 for c in counts):
                raise ValueError(f"negative count in trace for {f!r}")
        object.__setattr__(self, "per_minute", frozen)

    @property
    def functions(self) -> List[str]:
        return sorted(self.per_minute)

    @property
    def minutes(self) -> int:
        return max(len(c) for c in self.per_minute.values())

    @property
    def duration_s(self) -> float:
        return self.minutes * 60.0

    def total_invocations(self) -> int:
        return sum(sum(c) for c in self.per_minute.values())

    def peak_per_minute(self) -> int:
        return max((max(c, default=0) for c in self.per_minute.values()),
                   default=0)

    def scaled(self, factor: int) -> "Trace":
        """Multiply every per-minute count (load scaling for smoke vs full)."""
        return Trace(f"{self.name}x{factor}",
                     {f: tuple(c * factor for c in counts)
                      for f, counts in self.per_minute.items()})

    def arrivals(self, rng: random.Random) -> List[Invocation]:
        """Expand counts into time-sorted arrivals with uniform in-minute
        jitter.  RNG consumption order is fixed (sorted functions, minutes
        ascending), so a given (trace, seed) is one schedule, always."""
        out: List[Invocation] = []
        for func in self.functions:
            for minute, count in enumerate(self.per_minute[func]):
                base = minute * 60.0
                for _ in range(count):
                    out.append(Invocation(base + rng.uniform(0.0, 60.0),
                                          func, 0))
        out.sort(key=lambda inv: (inv.t, inv.func))
        return [Invocation(inv.t, inv.func, i) for i, inv in enumerate(out)]


# -- synthetic generators ----------------------------------------------------

def spike_660323(scale: int = 1, func: str = "spike",
                 name: str = "fig20-spike") -> Trace:
    """The paper's Fig. 20 load spike, optionally scaled."""
    return Trace(name, {func: tuple(c * scale for c in SPIKE_660323)})


def diurnal(minutes: int = 60, base: int = 2, peak: int = 30,
            period_minutes: int = 60, phase: float = 0.0,
            func: str = "diurnal", name: str = "diurnal") -> Trace:
    """Sinusoidal day/night load: base..peak over ``period_minutes``."""
    counts = []
    for m in range(minutes):
        x = 2.0 * math.pi * (m / period_minutes + phase)
        level = base + (peak - base) * 0.5 * (1.0 - math.cos(x))
        counts.append(int(round(level)))
    return Trace(name, {func: tuple(counts)})


def multi_function(traces: Iterable[Trace], name: str = "mix") -> Trace:
    """Merge single-function traces into one multi-function workload."""
    merged: Dict[str, Tuple[int, ...]] = {}
    for tr in traces:
        for f, counts in tr.per_minute.items():
            if f in merged:
                raise ValueError(f"duplicate function {f!r} in mix")
            merged[f] = counts
    return Trace(name, merged)


def correlated_spikes(n_functions: int = 4, scale: int = 1,
                      stagger_minutes: int = 0, base: int = 1,
                      name: str = "correlated") -> Trace:
    """The fleet-level worst case: the same spike hitting ``n_functions``
    at once (``stagger_minutes=0``) or rippling across them with a fixed
    offset — correlated demand is what makes keep-warm provisioning
    explode, since every function's pool peaks together."""
    shape = tuple(max(base, c) * scale for c in SPIKE_660323)
    width = len(shape) + stagger_minutes * max(0, n_functions - 1)
    per: Dict[str, Tuple[int, ...]] = {}
    for i in range(n_functions):
        off = i * stagger_minutes
        counts = [base * scale] * width
        for m, c in enumerate(shape):
            counts[off + m] = c
        per[f"fn{i:03d}"] = tuple(counts)
    return Trace(name, per)


# -- Azure Functions CSV -----------------------------------------------------

def load_azure_csv(path: str, functions: Optional[Sequence[str]] = None,
                   minutes: Optional[int] = None, top: Optional[int] = None,
                   name: Optional[str] = None) -> Trace:
    """Load an Azure-Functions-format invocation trace.

    Expected columns: a function id column (``HashFunction``, or the first
    non-numeric column) plus per-minute count columns named ``"1".."1440"``.
    ``functions`` selects specific rows by id; ``top`` keeps the N busiest
    rows; ``minutes`` truncates the horizon.  Function ids are shortened to
    their first 8 chars (Azure hashes are 64 hex chars) with a numeric
    suffix on collision.
    """
    with open(path, newline="") as fh:
        reader = csv.DictReader(fh)
        if reader.fieldnames is None:
            raise ValueError(f"{path}: empty CSV")
        minute_cols = [c for c in reader.fieldnames if c.strip().isdigit()]
        minute_cols.sort(key=int)
        if not minute_cols:
            raise ValueError(
                f"{path}: no per-minute columns (expected numeric headers)")
        if minutes is not None:
            minute_cols = minute_cols[:minutes]
        id_col = ("HashFunction" if "HashFunction" in reader.fieldnames
                  else next(c for c in reader.fieldnames
                            if not c.strip().isdigit()))
        rows: List[Tuple[str, Tuple[int, ...]]] = []
        wanted = set(functions) if functions is not None else None
        for row in reader:
            fid = row[id_col]
            if wanted is not None and fid not in wanted:
                continue
            counts = tuple(int(float(row[c] or 0)) for c in minute_cols)
            rows.append((fid, counts))
    if wanted is not None and len(rows) < len(wanted):
        missing = wanted - {fid for fid, _ in rows}
        raise ValueError(f"{path}: functions not found: {sorted(missing)}")
    if top is not None:
        rows.sort(key=lambda r: (-sum(r[1]), r[0]))
        rows = rows[:top]
    per: Dict[str, Tuple[int, ...]] = {}
    for fid, counts in rows:
        short = fid[:8]
        while short in per:
            short = f"{short[:8]}~{len(per)}"
        per[short] = counts
    return Trace(name or f"azure:{path}", per)
