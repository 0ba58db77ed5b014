"""The program's own spans and counters (``repro_torch.tracing``) in a
traced run of a cell: a run of the harness with the tracer on through the
window, and the per-layer numbers read from what it recorded.

  python3 forkbench/spans.py --workload stablelm-3b.coldstart \\
      --seed 7 8 --seconds 51 --tracer on off --out chiprun_out/spans.jsonl

``--tracer on`` turns the tracer on as the window opens and off as it
closes (after set-up, so the warm-up records nothing); ``off`` leaves it
off; ``alternate`` turns it on for the window's odd invocations only, so
that neighbouring invocations compare with it on and off.  The profiler
runs as in any ``--trace 1`` run.  Each run (every seed with every
tracer setting, in one process) prints a line of JSON on standard
output: the harness's own result (``result``, whose ``breakdown`` names
the device's idle gaps by the host's innermost op, ``repro.*`` ranges
among them), and ``spans``: the readings below, each invocation's
account, the device's idle time by the program's innermost span
(``idle_by_span``), and how far the spans lie from their profiler events.
The tracer's ranges put nothing on the device's timeline, so the
harness's ``busy_s`` means the same with it on.

Readings (``readings``), each over the window's invocations:

- ``resume_s``: the mean ``fork.resume`` span of a fork;
- ``wire_read_s``, ``adopt_s``: per fork, the summed ``net.read_pages``
  and ``instance.adopt`` spans (each ends in a sync that is already
  there: the copy to numpy, and the upload of the host payload);
- ``staged_gb``: per fork, the bytes copied through host memory in both
  directions (``stage.dtoh_bytes.*`` and ``stage.htod_bytes``), in 1e9;
- ``decode_gap_ms``: inside the profiled sub-window, the mean time of a
  ``serve.decode`` span in which the device ran nothing;
- ``moe_useful_pct``: ``moe.routed_rows`` over ``moe.expert_rows``.

A reading with nothing to read (no fork, no MoE layer) is left out.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List, Optional

if __package__ in (None, ""):                 # run as a script
    from run import ROOT, _environment
else:
    from forkbench.run import ROOT, _environment

PREFIX = "repro."                 # repro_torch.tracing.PREFIX
FORK_PARTS = ("fork.resume", "instance.fault", "pool.assemble")
SERVE_PARTS = ("serve.prefill", "serve.decode")


# ---------------------------------------------------------------------------
# the profiler's events
# ---------------------------------------------------------------------------


def clock_error(prof, spans, bounds) -> Optional[dict]:
    """How far each span's start and end lie from those of its ``repro.*``
    host event (the k-th span of a name against the k-th event of that
    name, both in time order), over the profiled sub-window ``bounds``: the
    worst and the median in ns, and the five worst as [name, k, start
    error, end error].  None where the spans and the events do not pair
    up."""
    from forkbench import profiling
    lo, hi = bounds
    inside = lambda a, b: lo <= a and b <= hi
    events = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(PREFIX) and not profiling._is_device(e):
            s = profiling._ns(e, "start")
            if inside(s, s + e.duration_ns()):
                events[name[len(PREFIX):]].append((s, s + e.duration_ns()))
    events.pop("enable", None)           # the tracer's own warm-up range
    mine = defaultdict(list)
    for s in spans:
        if s.end_ns is not None and inside(s.start_ns, s.end_ns):
            mine[s.name].append((s.start_ns, s.end_ns))
    if not events or set(events) != set(mine):
        return None
    rows = []
    for name, evs in events.items():
        if len(mine[name]) != len(evs):
            return None
        for k, ((a, b), (c, d)) in enumerate(zip(mine[name], sorted(evs))):
            rows.append([name, k, a - c, b - d])
    worst = lambda r: max(abs(r[2]), abs(r[3]))
    rows.sort(key=worst, reverse=True)
    errs = sorted(worst(r) for r in rows)
    return {"worst_ns": errs[-1], "median_ns": errs[len(errs) // 2],
            "pairs": len(rows), "top": rows[:5]}


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


# ---------------------------------------------------------------------------
# the readings
# ---------------------------------------------------------------------------


def _union_ns(dev, lo, hi) -> int:
    from forkbench import profiling
    return profiling._union(dev, lo, hi)


def readings(spans, counters, forks: int, dev=None, bounds=None) -> dict:
    """The per-layer readings of the module docstring; ``forks`` the
    window's forks, ``dev`` the device events (``profiling.raw_events``) and
    ``bounds`` the profiled sub-window, for ``decode_gap_ms`` (read only
    where the profiler saw the device)."""
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
    if dev and bounds is not None:
        lo, hi = bounds
        gaps = [s.end_ns - s.start_ns - _union_ns(dev, s.start_ns, s.end_ns)
                for s in spans if s.name == "serve.decode"
                and lo <= s.start_ns and s.end_ns <= hi]
        if gaps:
            out["decode_gap_ms"] = sum(gaps) / len(gaps) / 1e6
    if counters.get("moe.expert_rows"):
        out["moe_useful_pct"] = (100.0 * counters["moe.routed_rows"]
                                 / counters["moe.expert_rows"])
    return out


def accounts(invs, requests: Dict[int, int], spans) -> List[dict]:
    """Each invocation the tracer saw: its index, the harness's ``fork_s``
    and ``serve_s``, the ``invoke`` and ``release`` spans, the seconds of
    each part of the fork and of serving (spans directly under
    ``invoke``), and the share of ``fork_s`` and ``serve_s`` they cover."""
    rows = []
    by_request = defaultdict(list)
    for k, s in enumerate(spans):
        if s.end_ns is not None:
            by_request[s.request].append((k, s))
    for inv in invs:
        r = requests.get(inv.index)
        if r is None or inv.failed:
            continue
        mine = by_request[r]
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
    ``on``, ``off`` or on for the odd invocations (``alternate``) through
    the window.  The harness has no hook for this: for the call its
    ``window`` and ``profile`` are wrapped, to switch the tracer around
    each invocation and keep the profiler.  Returns ``{"result": the
    harness's result, "spans": what this module reads}``."""
    from forkbench import harness, profiling
    from repro_torch import tracing
    kept = {}
    real_window, real_profile = harness.window, harness.profile

    def profile(*args, **kw):
        kept["prof"] = real_profile(*args, **kw)
        return kept["prof"]

    def window(prog, reqs, mix, secs, trace, dev):
        requests = kept["requests"] = {}
        real_invoke = prog.invoke

        def invoke(req, i, policy, due=None):
            on = tracer == "on" or (tracer == "alternate" and i % 2 == 1)
            if not on:
                tracing.disable()
            elif not tracing.enabled():
                tracing.enable()
            n = len(tracing.snapshot()["spans"])
            inv = real_invoke(req, i, policy, due)
            new = tracing.snapshot()["spans"][n:]
            r = next((s.request for s in new if s.name == "invoke"), None)
            if r is not None:
                requests[i] = r
            return inv
        prog.invoke = invoke
        tracing.reset()
        try:
            out = real_window(prog, reqs, mix, secs, trace, dev)
        finally:
            tracing.disable()
            del prog.invoke
        kept["snap"] = tracing.snapshot()
        kept["invs"] = out[0]
        tracing.reset()
        return out

    harness.window, harness.profile = window, profile
    try:
        result = harness.run(cell, seed, seconds, True, device, t0)
    finally:
        harness.window, harness.profile = real_window, real_profile
    spans, counters = kept["snap"]["spans"], kept["snap"]["counters"]
    invs, prof = kept["invs"], kept.get("prof")
    forks = sum(1 for v in invs if v.forked and v.index in kept["requests"])
    bounds = dev = None
    if prof is not None:
        labels, dev, _ = profiling.raw_events(prof)
        bounds = labels.get(profiling.LABEL + "profiled")
    rows = accounts(invs, kept["requests"], spans)
    return {"result": result, "spans": {
        "tracer": tracer, "n_spans": len(spans), "counters": counters,
        "readings": readings(spans, counters, forks, dev, bounds),
        "invocations": rows,
        "fork_cover_min": min((r["fork_cover"] for r in rows
                               if "fork_cover" in r), default=None),
        "serve_cover_min": min((r["serve_cover"] for r in rows),
                               default=None),
        "idle_by_span": idle_by_span(dev, bounds, spans)
        if dev and bounds is not None else [],
        "clock": clock_error(prof, spans, bounds)
        if bounds is not None else None}}


def main(argv=None) -> int:
    import time
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracer", nargs="+", default=["on"],
                    choices=("on", "off", "alternate"))
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
