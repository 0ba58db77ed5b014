"""The program's own spans and counters (``repro_torch.tracing``) in a
traced run of a cell, and the per-layer readings taken from them.

The harness keeps them: a ``--trace 1`` window turns the tracer on as its
profiled sub-window opens and off as it closes, and its record
(``harness.Run``) holds the spans, the counters, the sub-window's device
events and bounds, and the forks the tracer saw.  The metric readers
(``forkbench/metrics/<reading>.<cell kind>.py``) call ``readings``.

Run as a script, this reports more than the metrics do, and measures the
tracer's cost:

  python3 forkbench/spans.py --workload stablelm-3b.coldstart \\
      --seed 7 8 --seconds 51 --tracer on off --out chiprun_out/spans.jsonl

``--tracer on`` is the benchmark's traced run; ``off`` leaves the tracer
off (the profiler runs as in any traced run), so that runs in turns give
the tracer's cost.  Each run (every seed with every tracer
setting, in one process) prints a line of JSON on standard output: the
harness's own result (``result``, whose ``breakdown`` names the device's
idle gaps by the host's innermost op, ``repro.*`` ranges among them), and
``spans``: the readings below, each invocation's account and the
device's idle time by the program's innermost span (``idle_by_span``).
The tracer's ranges put nothing on the device's timeline, so the
harness's ``busy_s`` means the same with it on.

Readings (``readings``), each over the profiled sub-window's
invocations:

- ``resume_s``: the mean ``fork.resume`` span of a fork;
- ``wire_read_s``, ``adopt_s``: per fork, the summed ``net.read_pages``
  and ``instance.adopt`` spans (each ends in a sync that is already
  there: the copy to numpy, and the upload of the host payload);
- ``staged_gb``: per fork, the bytes copied through host memory in both
  directions (``stage.dtoh_bytes.*`` and ``stage.htod_bytes``), in 1e9;
- ``decode_gap_ms``: the mean time of a ``serve.decode`` span in which
  the device ran nothing;
- ``moe_useful_pct``: ``moe.routed_rows`` over ``moe.expert_rows``.

A reading with nothing to read (no fork, no MoE layer, no device events)
is left out.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict
from typing import List

if __package__ in (None, ""):                 # run as a script
    from run import ROOT, _environment
else:
    from forkbench.run import ROOT, _environment

FORK_PARTS = ("fork.resume", "instance.fault", "pool.assemble")
SERVE_PARTS = ("serve.prefill", "serve.decode")


# ---------------------------------------------------------------------------
# the readings
# ---------------------------------------------------------------------------


def idle_by_span(dev, bounds, spans) -> List[list]:
    """The device's idle time in the profiled sub-window by the innermost
    program span open on the host at each instant (``outside`` where none
    is), largest first.  Spans nest (one thread opens them), so a sweep
    over their starts and ends knows the innermost one."""
    from forkbench import profiling
    lo, hi = bounds
    marks = []
    for s in spans:
        if s.end_ns is not None and s.end_ns >= lo and s.start_ns <= hi:
            marks += [(max(s.start_ns, lo), 1, s.name),
                      (min(s.end_ns, hi), 0, s.name)]
    marks.sort(key=lambda m: m[:2])           # an end before a start
    pieces, stack, t = [], [], lo
    for at, opens, name in marks + [(hi, 0, None)]:
        if at > t:
            pieces.append((t, at, stack[-1] if stack else "outside"))
            t = at
        if opens:
            stack.append(name)
        elif stack and name is not None:
            stack.pop()
    out = defaultdict(float)
    k = 0
    for a, b in profiling._gaps(dev, lo, hi):
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            s0, s1, name = pieces[j]
            out[name] += (min(b, s1) - max(a, s0)) / 1e9
            j += 1
    return [[n, v] for n, v in sorted(out.items(), key=lambda kv: -kv[1])]


def _idle_ns(gaps, starts, a: int, b: int) -> int:
    """Nanoseconds of [a, b] that the sorted, disjoint idle stretches
    ``gaps`` (their starts ``starts``) cover."""
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0
    while k < len(gaps) and gaps[k][0] < b:
        total += max(0, min(gaps[k][1], b) - max(gaps[k][0], a))
        k += 1
    return total


def readings(run) -> dict:
    """The per-layer readings of the module docstring from a traced run's
    record (``harness.Run``)."""
    from forkbench import profiling
    spans, counters, forks = run.spans, run.counters, run.forks_traced
    out = {}
    total = lambda name: sum(s.seconds for s in spans if s.name == name)
    if forks:
        resumes = [s.seconds for s in spans if s.name == "fork.resume"]
        if resumes:
            out["resume_s"] = sum(resumes) / len(resumes)
        out["wire_read_s"] = total("net.read_pages") / forks
        out["adopt_s"] = total("instance.adopt") / forks
        staged = sum(v for k, v in counters.items()
                     if k.startswith("stage."))
        out["staged_gb"] = staged / forks / 1e9
    if run.device_events and run.profiled is not None:
        lo, hi = run.profiled
        gaps = profiling._gaps(run.device_events, lo, hi)
        starts = [a for a, _ in gaps]
        idle = [_idle_ns(gaps, starts, s.start_ns, s.end_ns) for s in spans
                if s.name == "serve.decode" and s.end_ns is not None
                and lo <= s.start_ns and s.end_ns <= hi]
        if idle:
            out["decode_gap_ms"] = sum(idle) / len(idle) / 1e6
    if counters.get("moe.expert_rows"):
        out["moe_useful_pct"] = (100.0 * counters["moe.routed_rows"]
                                 / counters["moe.expert_rows"])
    return out


def accounts(run) -> List[dict]:
    """Each invocation the tracer saw: its index, the harness's ``fork_s``
    and ``serve_s``, the ``invoke`` and ``release`` spans, the seconds of
    each part of the fork and of serving (spans directly under
    ``invoke``), and the share of ``fork_s`` and ``serve_s`` they cover."""
    rows = []
    by_request = defaultdict(list)
    for k, s in enumerate(run.spans):
        if s.end_ns is not None:
            by_request[s.request].append((k, s))
    for inv in run.invocations:
        if inv.request is None or inv.failed:
            continue
        mine = by_request[inv.request]
        root = next(k for k, s in mine if s.name == "invoke")
        parts = defaultdict(float)
        for k, s in mine:
            if s.parent == root or s.name in ("invoke", "release"):
                parts[s.name] += s.seconds
        row = {"index": inv.index, "forked": inv.forked,
               "serve_s": inv.answer - inv.submit,
               "parts": dict(parts)}
        row["serve_cover"] = sum(parts[p] for p in SERVE_PARTS) \
            / row["serve_s"]
        if inv.forked:
            row["fork_s"] = inv.tree_at - inv.start
            row["fork_cover"] = sum(parts[p] for p in FORK_PARTS) \
                / row["fork_s"]
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def run(cell, seed: int, seconds: float, device, t0: float,
        tracer: str = "on") -> dict:
    """One ``--trace 1`` run of ``cell`` by the harness, with the tracer
    ``on`` or ``off`` in the profiled sub-window.  Returns ``{"result":
    the harness's result, "spans": what this module reads}``."""
    from forkbench import harness
    result, rec = harness.run_record(cell, seed, seconds, True, device, t0,
                                     tracer=tracer == "on")
    rows = accounts(rec)
    return {"result": result, "spans": {
        "tracer": tracer, "n_spans": len(rec.spans), "counters": rec.counters,
        "readings": readings(rec),
        "invocations": rows,
        "fork_cover_min": min((r["fork_cover"] for r in rows
                               if "fork_cover" in r), default=None),
        "serve_cover_min": min((r["serve_cover"] for r in rows),
                               default=None),
        "idle_by_span": idle_by_span(rec.device_events, rec.profiled,
                                     rec.spans)
        if rec.device_events and rec.profiled is not None else []}}


def main(argv=None) -> int:
    import time
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracer", nargs="+", default=["on"],
                    choices=("on", "off"))
    ap.add_argument("--out", default=None,
                    help="also append each line to this file")
    args = ap.parse_args(argv)
    _environment()
    import torch
    if not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 2
    from forkbench import harness
    cell = harness.load_cell(ROOT, args.workload)
    for seed in args.seed:
        for tracer in args.tracer:
            out = run(cell, seed, args.seconds, torch.device("cuda", 0), t0,
                      tracer)
            t0 = time.perf_counter()
            out = {"workload": args.workload, "seed": seed,
                   "card": torch.cuda.get_device_name(0), **out}
            line = json.dumps(out)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            r = out["spans"]
            print(f"[spans] {args.workload} seed {seed} tracer {tracer}: "
                  f"{json.dumps(r['readings'])} fork_cover_min "
                  f"{r['fork_cover_min']} serve_cover_min "
                  f"{r['serve_cover_min']}", file=sys.stderr, flush=True)
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
