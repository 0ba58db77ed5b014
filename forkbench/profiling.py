"""Reading the traced run: ``torch.profiler``'s events, kept in memory and
reduced here to what the per-layer readers need.  No trace is written.

The benchmark labels its own calls with ``record_function``:
``forkbench.profiled`` around the traced sub-window, and for invocation
``i`` ``forkbench.fork.<i>`` (the call to ``invoke`` until the child's
tree is materialized) and ``forkbench.serve.<i>`` (the engine made and
the request submitted, to the answer).  Each label closes
after a device sync, so the device work a label's calls started lies
inside it.  Device events are the kernels, copies and sets on the card
(``device_type`` CUDA), the labels' own device-side copies left out.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

LABEL = "forkbench."
COPY_KERNELS = ("bulk_copy", "copy_rows")       # the port's page copies
ATTENTION = ("paged_attention",)                 # the port's paged attention
LATENT = ("latent_attention",)                   # its latent attention
DTOH, HTOD = "Memcpy DtoH", "Memcpy HtoD"
GAPS_NAMED = 2000         # the longest idle gaps given a host op's name
NAME_CHARS = 120          # a kernel's name in the breakdown, cut to this


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return f()
    return getattr(e, f"{what}_us")() * 1000


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def raw_events(prof):
    """(label spans {name: (start, end)}, device events [(start, end,
    name)], host ops [(start, end, name)]), times in ns."""
    labels, dev, host = {}, [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = _ns(e, "start")
        end = start + e.duration_ns() if hasattr(e, "duration_ns") \
            else _ns(e, "end")
        if name.startswith(LABEL):
            if not _is_device(e):
                labels[name] = (start, end)
            continue
        (dev if _is_device(e) else host).append((start, end, name))
    dev.sort()
    host.sort()
    return labels, dev, host


def _union(intervals, lo, hi) -> float:
    """Nanoseconds of [lo, hi] covered by the sorted ``intervals``."""
    total, cur_s, cur_e = 0, None, None
    for s, e, *_ in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _sums(dev, lo, hi) -> dict:
    """Device seconds by category of the events that start in [lo, hi]."""
    out = defaultdict(float)
    for s, e, name in dev:
        if s < lo or s > hi:
            continue
        d = (e - s) / 1e9
        out["all"] += d
        if DTOH in name:
            out["memcpy_dtoh"] += d
        elif HTOD in name:
            out["memcpy_htod"] += d
        elif any(k in name for k in COPY_KERNELS):
            out["copy_kernels"] += d
        elif any(k in name for k in ATTENTION):
            out["attention_kernels"] += d
        elif any(k in name for k in LATENT):
            out["latent_kernels"] += d
    return dict(out)


def _gaps(dev, lo, hi):
    """Idle stretches of the device in [lo, hi]: (start, end)."""
    out, t = [], lo
    for s, e, _ in dev:
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def _host_op(host, starts, t) -> str:
    """The innermost host op running at ``t`` (the latest to start among
    those that cover it), or "python" where none does."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(i - 4000, -1), -1):
        s, e, name = host[j]
        if e >= t:
            best = name
            break
    return best or "python"


def summarize(raw, labels_of) -> dict:
    """The traced sub-window of ``raw`` (``raw_events``): its length, the
    device's busy time, device seconds by category in each invocation's
    fork and serve spans, the device ops that took most time and the idle
    gaps by what the host was doing.  ``labels_of``: invocation index ->
    label suffix."""
    labels, dev, host = raw
    lo, hi = labels.get(LABEL + "profiled", (None, None))
    if lo is None:
        return {}
    busy = _union(dev, lo, hi)
    per = {}
    for i in labels_of:
        row = {}
        for part in ("fork", "serve"):
            span = labels.get(f"{LABEL}{part}.{i}")
            if span is not None:
                row[part] = {"s": (span[1] - span[0]) / 1e9,
                             "busy_s": _union(dev, *span) / 1e9,
                             **_sums(dev, *span)}
        if row:
            per[i] = row
    by_op = defaultdict(float)
    for s, e, name in dev:
        if lo <= s <= hi:
            by_op[name[:NAME_CHARS]] += (e - s) / 1e9
    spans = sorted((v[0], v[1], k[len(LABEL):].split(".")[0])
                   for k, v in labels.items()
                   if k.startswith((LABEL + "fork.", LABEL + "serve.")))
    span_starts = [s for s, _, _ in spans]
    starts = [s for s, _, _ in host]
    idle = defaultdict(float)
    gaps = sorted(_gaps(dev, lo, hi), key=lambda g: g[0] - g[1])
    for s, e in gaps[:GAPS_NAMED]:
        mid = (s + e) // 2
        k = bisect.bisect_right(span_starts, mid) - 1
        where = spans[k][2] if k >= 0 and spans[k][1] >= mid else "between"
        idle[f"{where}: {_host_op(host, starts, mid)}"] += (e - s) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "invocations": per, "device_ops": top(by_op),
            "idle_gaps": top(idle), "device_events": len(dev)}
