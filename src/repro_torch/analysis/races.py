"""Sim-time race detector: find handlers that depend on incidental ordering.

The event loop dispatches same-time events by declared ``priority`` and
then by schedule order.  Everything a replay *pins* (latency percentiles,
meters, digests) is supposed to be a function of the trace and the seed —
not of which same-``(time, priority)`` event happened to be scheduled
first.  That claim is exactly what ``EventLoop(tiebreak_seed=...)`` makes
testable: a non-None seed shuffles dispatch order *within* each
(time, priority) tie class while leaving cross-class order alone.

The detector replays the same workload once with the deterministic
tiebreak (the baseline) and N times with seeded shuffles, then compares

* the **semantic digest** — ``ReplayResult.summary()`` minus the
  ``event_log_digest`` entry (the log legitimately reorders within a tie
  class, results must not); and
* the **time-grouped event log** — for each sim time, the multiset of
  dispatched labels.  A race-free replay dispatches the *same work* at
  every instant regardless of intra-tie order; a shuffle that makes
  different events exist at some time means an earlier handler's effect
  leaked into scheduling.

On divergence the report pinpoints the first sim time whose label
multiset differs (the earliest observable symptom, usually right where
the racy handlers collided) plus which summary keys changed.

Usage::

    from repro_torch.analysis.races import detect
    report = detect(lambda tiebreak_seed: ReplayEngine(
        trace, policy, funcs, seed=0, tiebreak_seed=tiebreak_seed))
    assert not report.racy, report.describe()

or from the command line (a fig20-style smoke replay)::

    PYTHONPATH=src python -m repro_torch.analysis.races --smoke
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

DEFAULT_SEEDS: Tuple[int, ...] = (1, 2, 3)


@dataclasses.dataclass
class RaceReport:
    """Outcome of one detection run (baseline vs N shuffled replays)."""

    racy: bool
    baseline_digest: str                 # semantic digest of the baseline
    seeds_tried: List[int]
    # first shuffle that diverged (None when race-free):
    racy_seed: Optional[int] = None
    changed_keys: List[str] = dataclasses.field(default_factory=list)
    # earliest sim time whose dispatched-label multiset differs, with the
    # two multisets at that time — the race's first observable symptom
    first_divergence: Optional[Dict[str, Any]] = None

    def describe(self) -> str:
        if not self.racy:
            return (f"race-free across tiebreak seeds {self.seeds_tried} "
                    f"(digest {self.baseline_digest[:12]})")
        lines = [f"RACE: tiebreak seed {self.racy_seed} changed the result"]
        if self.changed_keys:
            lines.append(f"  summary keys changed: {self.changed_keys}")
        d = self.first_divergence
        if d is not None:
            lines.append(
                f"  first divergence at t={d['time']}: "
                f"baseline dispatched {d['baseline']}, "
                f"shuffled dispatched {d['shuffled']}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# -- comparison machinery ----------------------------------------------------

def semantic_summary(summary: dict) -> dict:
    """A replay summary with the order-sensitive log digest removed: what
    must be invariant under same-(time, priority) dispatch shuffles."""
    return {k: v for k, v in summary.items() if k != "event_log_digest"}


def _semantic_digest(summary: dict) -> str:
    from repro_torch.sim.metrics import canonical_digest
    return canonical_digest(semantic_summary(summary))


def _time_groups(log: Sequence[Tuple[float, str]]) -> List[
        Tuple[float, List[str]]]:
    """Collapse an event log to (time, sorted label multiset) groups —
    the order-insensitive view a race-free replay must preserve."""
    groups: List[Tuple[float, List[str]]] = []
    for when, label in log:
        if groups and groups[-1][0] == when:
            groups[-1][1].append(label)
        else:
            groups.append((when, [label]))
    return [(when, sorted(labels)) for when, labels in groups]


def first_log_divergence(base_log: Sequence[Tuple[float, str]],
                         other_log: Sequence[Tuple[float, str]]
                         ) -> Optional[Dict[str, Any]]:
    """Earliest sim time where the two logs dispatch different work
    (different label multisets), or None when equivalent."""
    a, b = _time_groups(base_log), _time_groups(other_log)
    for (ta, la), (tb, lb) in zip(a, b):
        if ta != tb or la != lb:
            return {"time": min(ta, tb), "baseline": la, "shuffled": lb}
    if len(a) != len(b):
        longer, which = (a, "baseline") if len(a) > len(b) else (b, "shuffled")
        t, labels = longer[min(len(a), len(b))]
        return {"time": t, "baseline": labels if which == "baseline" else [],
                "shuffled": labels if which == "shuffled" else []}
    return None


def _changed_keys(base: dict, other: dict) -> List[str]:
    keys = sorted(set(base) | set(other))
    return [k for k in keys if base.get(k) != other.get(k)]


def compare_runs(run_fn: Callable[[Optional[int]], Tuple[Sequence[tuple],
                                                         dict]],
                 seeds: Sequence[int] = DEFAULT_SEEDS) -> RaceReport:
    """Low-level API: ``run_fn(tiebreak_seed)`` performs one replay and
    returns ``(event_log, summary)``.  The baseline runs with
    ``tiebreak_seed=None`` (deterministic schedule-order ties); each seed
    runs shuffled and is compared semantically."""
    base_log, base_summary = run_fn(None)
    base_sem = semantic_summary(base_summary)
    base_digest = _semantic_digest(base_summary)
    tried: List[int] = []
    for seed in seeds:
        tried.append(seed)
        log, summary = run_fn(seed)
        sem = semantic_summary(summary)
        diverged_log = first_log_divergence(base_log, log)
        if sem != base_sem or diverged_log is not None:
            return RaceReport(
                racy=True, baseline_digest=base_digest, seeds_tried=tried,
                racy_seed=seed, changed_keys=_changed_keys(base_sem, sem),
                first_divergence=diverged_log)
    return RaceReport(racy=False, baseline_digest=base_digest,
                      seeds_tried=tried)


def detect(engine_factory: Callable[[Optional[int]], Any],
           seeds: Sequence[int] = DEFAULT_SEEDS) -> RaceReport:
    """Run the detector on replay engines.  ``engine_factory(tiebreak_seed)``
    must build a FRESH :class:`~repro_torch.sim.engine.ReplayEngine` (same trace,
    policy and seed every call) with the given tiebreak seed."""
    def run(tiebreak_seed: Optional[int]):
        eng = engine_factory(tiebreak_seed)
        res = eng.run()
        return list(eng.loop.log), res.summary()
    return compare_runs(run, seeds=seeds)


# -- CLI ---------------------------------------------------------------------

def _smoke_factory(scale: int, n_nodes: int, seed: int, device="cuda"):
    """A small fig20-style spike replay (the same workload the replay
    benchmark pins), parameterized by tiebreak seed, with the nodes'
    pools on ``device`` (None: host pools)."""
    from repro_torch.sim import (ForkOnDemand, ReplayEngine, SimFunction,
                                 spike_660323)
    page_elems = 1024
    fn = SimFunction("spike", state_bytes=16 * page_elems * 4,
                     touch_frac=0.05, exec_s=0.030, coldstart_s=0.167,
                     hold_s=60.0)

    def factory(tiebreak_seed: Optional[int]):
        return ReplayEngine(spike_660323(scale=scale),
                            ForkOnDemand(replicas=4, prefetch=0), [fn],
                            n_nodes=n_nodes, seed=seed,
                            page_elems=page_elems,
                            tiebreak_seed=tiebreak_seed, device=device)
    return factory


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.races",
        description="replay-shuffle race detector (fig20-style smoke trace)")
    ap.add_argument("--smoke", action="store_true",
                    help="alias for the default small replay (CI entry)")
    ap.add_argument("--scale", type=int, default=2,
                    help="spike-trace scale factor (default 2)")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--seed", type=int, default=20260809)
    ap.add_argument("--tiebreak-seeds", type=int, nargs="+",
                    default=list(DEFAULT_SEEDS),
                    help="shuffle seeds to try (default: 1 2 3)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the nodes' pools, or 'host' for "
                         "host numpy pools (default: cuda)")
    args = ap.parse_args(argv)
    device = None if args.device == "host" else args.device
    report = detect(_smoke_factory(args.scale, args.nodes, args.seed,
                                   device),
                    seeds=args.tiebreak_seeds)
    if args.json:
        print(json.dumps(report.to_dict(), sort_keys=True, indent=1))
    else:
        print(report.describe())
    return 1 if report.racy else 0


if __name__ == "__main__":
    sys.exit(main())
