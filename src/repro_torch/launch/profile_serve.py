"""Where the serve path's time goes on the card.

Runs the serve driver once (kernel build, allocation and first calls out
of the way), then traces one more remote fork (resume + materialize) and
one more request with ``torch.profiler`` and prints, for each phase, the
wall time and the device time by category: the port's kernels, copies
between host and device, other device work, and the device's idle share.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch gemma3-1b

The timeline goes to ``--trace`` (Chrome trace format) when given.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.fork import ForkPolicy
from repro_torch.launch import serve
from repro_torch.serving.engine import ServingEngine

PORT_KERNELS = ("copy_rows", "bulk_copy", "paged_attention_")


def _category(name: str) -> str:
    if any(k in name for k in PORT_KERNELS):
        return "port_kernels"
    if "Memcpy HtoD" in name:
        return "memcpy_htod"
    if "Memcpy DtoH" in name:
        return "memcpy_dtoh"
    return "other_device"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _breakdown(prof, wall_s: float) -> dict:
    """Device time of device-side events only (kernels and copies): the
    host ops that enqueue them carry the same time and are skipped."""
    cats, top = {}, []
    for e in prof.key_averages():
        us = _device_us(e)
        if us <= 0 or getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        c = _category(e.key)
        cats[c] = cats.get(c, 0.0) + us / 1e6
        top.append((us / 1e6, e.key, e.count))
    busy = sum(cats.values())
    top.sort(reverse=True)
    return {"wall_s": wall_s, "device_busy_s": busy,
            "device_idle_share": (1.0 - busy / wall_s) if wall_s else None,
            "device_s_by_category": cats,
            "top_device_ops": [{"name": k, "s": s, "calls": n}
                               for s, k, n in top[:8]]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None,
                    help="write the profiled timeline here (.json)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    st = serve.main(["--arch", args.arch, "--nodes", "3", "--requests", "2",
                     "--device", args.device])
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = {}
    # forget node1's sibling-cache entries, so the traced fork reads every
    # page over the modelled network like the first one did
    st.nodes[1].clear_page_cache()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        child = st.handle.resume_on(st.nodes[1],
                                    ForkPolicy(lazy=True, prefetch=1))
        params = child.materialize_pytree()
        sync()
        fork_s = time.perf_counter() - t0
    out["fork"] = _breakdown(prof, fork_s)
    out["fork"]["pages_rdma"] = child.stats["pages_rdma"]
    eng = ServingEngine(st.cfg, params, device=dev)
    with profile(activities=acts) as prof2:
        t0 = time.perf_counter()
        rid = eng.submit(st.prompts[0], max_tokens=8)
        eng.run_to_completion()
        sync()
        serve_s = time.perf_counter() - t0
    out["request"] = _breakdown(prof2, serve_s)
    out["request"]["tokens"] = len(eng.requests[rid].out_tokens)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print("[profile] " + json.dumps(out))
    return out


if __name__ == "__main__":
    main()
