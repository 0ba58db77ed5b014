#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises on failure (exit code 1, no result line):

1. require a CUDA device; print the card's name and power limit; turn
   TF32 off for float32 matmuls and convolutions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   one process per source, in parallel);
3. hold each of the five kernels against its plain PyTorch version on the
   card, at the main path's shapes and at a larger one, in fp32 and bf16:
   copies must be bit-equal, attention within 3e-5 (fp32) / 3e-2 (bf16);
   each copy case must take the route it is built for (the bulk-copy
   kernel with its table in the launch or in device memory, or
   ``copy_rows``): index tables of exactly the by-value capacity and one
   more, ids already on the card, odd row sizes, a misaligned payload or
   output, ``scatter_patch`` onto a partial last page, and the replay
   phase's 4 KiB fp32 pages (one page, a 16-page run, 64 pages over two
   VMAs, each table off a 16 KB boundary); each attention case
   its route (``tma``, or ``loads`` for rows off 16 bytes) and the number
   of splits its plan gives, including a long sequence and empty ranges
   split across blocks; time kernel, plain version and library call with
   CUDA events (the kernel from host ids through its wrapper, the library
   call with ids already on the card), the device time alone (CUDA-graph
   replay) and the host time of one call; split one page's
   ``cow_scatter`` call into its host stages, and one long sequence's
   attention into the device time of its two kernels;
4. run the port's serve path (``repro_torch.launch.serve.main``) for
   gemma3-1b at full width: 3 nodes, a seed packed on node0, two children
   forked over the modelled RDMA network, 4 requests and the
   copy-on-write fork demo.  Every kernel's launch count must be > 0,
   page_gather, page_gather_runs and cow_scatter must have gone through
   the bulk-copy kernel, every child's parameters must equal the seed's,
   and every request's paged-engine logits must be close to the non-paged
   model's on the same card; the pages each kernel moved and the route
   counts are printed;
5. the serverless platform for gemma3-1b at full width: four nodes, one
   ``Coordinator(seed_replicas=2)``.  A function whose behaviour
   materializes its instance and answers one prompt through the
   ``ServingEngine`` is invoked three times with ``policy="fork"``: the
   first coldstarts and becomes a sharded seed (its second replica made
   by an eager fork), the next two fork children whose VMAs are routed
   across both replicas.  Every child's parameters must equal the seed's,
   its tokens the seed's tokens, and both replica parents must have
   served pages.  Then one ``StragglerMonitor.mitigate`` backup fork, and
   the FINRA workflow (``build_finra``, a 6 MB market tensor, 8 audit
   rules) by fork and by message: equal results, and every audit child
   faulted in the market's pages only.  All four copy kernels must have
   launched, page_gather, page_gather_runs and cow_scatter through the
   bulk-copy kernel;
6. trace replay on pools on the card: Figure 20's spike (10,050
   invocations, 64 nodes, 4 KiB pages) under ``ForkOnDemand`` and
   ``KeepWarm``, whose event-log digests must equal ``BENCH_spikes.json``'s
   ``mitosis`` and ``caching`` (the ``mitosis`` row also on host pools,
   timed beside it); Figure 22's targeted crash of a seed parent (1,608
   invocations, 32 nodes), whose digest must equal ``BENCH_faults.json``'s
   ``crash``; then one crash plan on a small cluster,
   replayed on the card and on host pools, with equal summary digests.
   Copy kernels must have launched;
7. print one JSON line with every kernel's numbers, the card line again,
   and last ``{"ok": true, "device": {...}}``.

Launches made in phase 3 and in phase 4's checks are not in the counts:
the counts are reset just before the serve run and read just after it.
Phases 5 and 6 reset them before they start and print their own.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory, data sheet
FP32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside tensor cores
ATTN_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
LOGIT_TOL = 1e-4                 # paged kernel vs dense model, fp32, card
KERNELS = ("page_gather", "page_gather_runs", "cow_scatter",
           "cow_scatter_runs", "paged_attention")
REPLACES = {
    "page_gather": "src/repro/kernels/page_gather/kernel.py:53",
    "page_gather_runs": "src/repro/kernels/page_gather/kernel.py:101",
    "cow_scatter": "src/repro/kernels/cow_scatter/kernel.py:55",
    "cow_scatter_runs": "src/repro/kernels/cow_scatter/kernel.py:107",
    "paged_attention": "src/repro/kernels/paged_attention/kernel.py:101",
}
SOURCE = {k: "src/repro_torch/kernels/csrc/bulk_copy.cu" for k in KERNELS}
SOURCE["paged_attention"] = "src/repro_torch/kernels/csrc/paged_attention.cu"
SOURCE["cow_scatter_runs"] = "src/repro_torch/kernels/csrc/paging.cu"
DESIGN = {"page_gather": "bulk-tma", "page_gather_runs": "bulk-tma",
          "cow_scatter": "bulk-tma", "cow_scatter_runs": "copy_rows",
          "paged_attention": "split-tma"}
BULK = ("bulk-value", "bulk-device")
COPY_KERNELS = KERNELS[:4]
# Figure 20's replay (benchmarks/fig20_spikes.py), copied: 4 KiB pages,
# 16 pages of state of which 5% are touched, 30 ms of execution, a 167 ms
# coldstart, containers held for the trace's 60 s minute, 4 seed replicas
# against 4 prewarmed containers, the spike at x50 over 64 nodes
FIG20 = dict(page_elems=1024, state_pages=16, touch=0.05, exec_s=0.030,
             coldstart_s=0.167, hold_s=60.0, budget=4, ttl=60.0, scale=50,
             nodes=64, seed=20260809)
# Figure 22's targeted crash (benchmarks/fig22_faults.py), copied: the spike
# at x8 over 32 nodes of 8 links, 64 pages over 2 VMAs paged in across a
# 0.5 s execution, 2 replicas, re-routing past 0.05 s of backlog, and the
# seed's parent n0 crashing 25 s into the burst minute
FIG22 = dict(scale=8, nodes=32, links=8, page_elems=1024, state_pages=64,
             vmas=2, touch=0.5, exec_s=0.5, hold_s=60.0, replicas=2,
             reroute=0.05, crash_t=325.0, op_fail_rate=0.02, seed=20260809)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, reps: int) -> float:
    """Device time of one ``fn()`` alone: ``reps`` calls captured in a CUDA
    graph and replayed, so that none of them waits for the host."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_us(torch, fn, reps: int = 50) -> float:
    """Host time of one ``fn()`` in microseconds, until it returns: the
    median of ``reps`` calls, each made with the card idle."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def copy_cases(limits):
    """dicts of kernel, label, dtype, F, E, spec (ids or (starts, lens)) and
    the route the case must take.  The first case of each kernel is the
    main path's largest call: the gemma3-1b embedding, 9,216 pages of 32,768
    elements (assembly gathers it page by page, the owner's read and the
    child's adopt move it as one run).  ``limits`` are the bulk-copy
    kernel's by-value capacities."""
    rng = np.random.default_rng(0)
    E, n_emb = 32768, 9216
    cap_ids, cap_spans = limits["ids"], limits["spans"]

    def case(name, label, dtype, F, E, spec, route, **kw):
        return dict(name=name, label=label, dtype=dtype, F=F, E=E,
                    spec=spec, route=route, **kw)

    def runs(k):                     # k runs of 1-2 pages, 1-page gaps
        lens = 1 + np.arange(k) % 2
        return (np.cumsum(lens + 1) - lens - 1, lens)
    return [
        case("page_gather", "embed-assemble", "float32", n_emb + 64, E,
             np.arange(64, 64 + n_emb), "bulk-device"),
        case("page_gather", "embed-ids-on-device", "float32", n_emb + 64, E,
             np.arange(64, 64 + n_emb), "bulk-device", device_ids=True),
        case("page_gather", "scattered-dup", "bfloat16", 4096, E,
             rng.integers(0, 4096, 3000), "bulk-value"),
        case("page_gather", "single-page", "float32", 64, E, np.array([7]),
             "bulk-value"),
        case("page_gather", "ids-at-capacity", "bfloat16", cap_ids + 64,
             4096, rng.integers(0, cap_ids + 64, cap_ids), "bulk-value"),
        case("page_gather", "ids-past-capacity", "bfloat16", cap_ids + 64,
             4096, rng.integers(0, cap_ids + 64, cap_ids + 1),
             "bulk-device"),
        case("page_gather", "odd-row", "bfloat16", 256, 1001,
             rng.integers(0, 256, 100), "copy_rows"),
        case("page_gather", "misaligned-out", "float32", 64, 4096,
             np.array([3, 9, 10, 3]), "copy_rows", misaligned=True),
        case("page_gather_runs", "embed-read", "float32", n_emb + 64, E,
             ([64], [n_emb]), "bulk-value"),
        # page_gather's embed-assemble ids, cut into runs on the host: the
        # alternative to uploading ids past the by-value capacity
        case("page_gather_runs", "embed-assemble-ids-cut-into-runs",
             "float32", n_emb + 64, E, np.arange(64, 64 + n_emb),
             "bulk-value", cut_ids=True),
        case("page_gather_runs", "skewed-runs", "bfloat16", 8192, E,
             ([0, 3000, 5000, 7000], [2500, 1, 1999, 900]), "bulk-value"),
        case("page_gather_runs", "spans-at-capacity", "bfloat16",
             3 * cap_spans + 3, 4096, runs(cap_spans), "bulk-value"),
        case("page_gather_runs", "spans-past-capacity", "bfloat16",
             3 * cap_spans + 6, 4096, runs(cap_spans + 1), "bulk-device"),
        case("page_gather_runs", "odd-row", "bfloat16", 256, 1001,
             ([0, 50, 120], [40, 3, 100]), "copy_rows"),
        case("cow_scatter", "single-page", "float32", 64, E, np.array([9]),
             "bulk-value"),
        case("cow_scatter", "kv-column", "float32", 1024, 4096,
             rng.permutation(1024)[:26], "bulk-value"),
        case("cow_scatter", "scattered", "bfloat16", 8192, E,
             rng.permutation(8192)[:3000], "bulk-value"),
        case("cow_scatter", "ids-at-capacity", "bfloat16", cap_ids + 64,
             4096, rng.permutation(cap_ids + 64)[:cap_ids], "bulk-value"),
        case("cow_scatter", "ids-past-capacity", "bfloat16", cap_ids + 64,
             4096, rng.permutation(cap_ids + 64)[:cap_ids + 1],
             "bulk-device"),
        case("cow_scatter", "ids-on-device", "float32", 1024, 4096,
             rng.permutation(1024)[:26], "bulk-device", device_ids=True),
        case("cow_scatter", "odd-row", "float32", 256, 1001,
             rng.permutation(256)[:100], "copy_rows"),
        case("cow_scatter", "misaligned-payload", "float32", 64, 4096,
             np.array([3, 9, 10]), "copy_rows", misaligned=True),
        case("cow_scatter_runs", "embed-adopt", "float32", n_emb + 64, E,
             ([32], [n_emb]), "copy_rows"),
        case("cow_scatter_runs", "skewed-runs", "bfloat16", 8192, E,
             ([0, 3000, 5000, 7000], [2500, 1, 1999, 900]), "copy_rows"),
    ] + replay_cases(case)


def replay_cases(case):
    """The replay phase's copies, for each copy kernel: fp32 pages of
    1,024 elements (4 KiB rows, four to a 16 KB bulk-copy chunk) in a
    pool of ``build_cluster``'s 4,096 frames, with the replay's id shapes: one page out of a
    16-page VMA, a 16-page run and 64 pages over 2 VMAs.  Every table
    starts off a 16 KB boundary."""
    shapes = (("one-page-of-16", [37], [1]), ("16-page-run", [33], [16]),
              ("64-pages-2-vmas", [101, 170], [32, 32]))
    route = {"page_gather": "bulk-value", "page_gather_runs": "bulk-value",
             "cow_scatter": "bulk-value", "cow_scatter_runs": "copy_rows"}
    out = []
    for name in COPY_KERNELS:
        for label, starts, lens in shapes:
            spec = ((starts, lens) if name.endswith("_runs") else
                    np.concatenate([np.arange(s, s + n)
                                    for s, n in zip(starts, lens)]))
            out.append(case(name, f"replay-{label}", "float32",
                            4096, FIG20["page_elems"],
                            spec, route[name]))
    return out


def routes_of(dispatch, call):
    """Run ``call()`` and return the routes its launches took."""
    before = dict(dispatch.routes)
    call()
    return sorted(k.split(".", 1)[1] for k, v in dispatch.routes.items()
                  if v != before.get(k, 0))


def run_copy_case(torch, case):
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.cow_scatter import ops as cs
    from repro_torch.kernels.page_gather import kernel as pgk, ops as pg
    from repro_torch.kernels.page_gather.ref import (expand_runs,
                                                     page_gather_ref)
    from repro_torch.memory.pool import frame_runs
    name, label, F, E, spec = (case[k] for k in
                               ("name", "label", "F", "E", "spec"))
    dtype = getattr(torch, case["dtype"])
    dev = torch.device("cuda")
    frames = torch.randn(F, E, device=dev).to(dtype)
    runs = name.endswith("_runs")
    cut = case.get("cut_ids")        # an id list, cut into runs per call
    # host ids as the pool passes them (int32 numpy)
    ids = (expand_runs(*spec) if runs and not cut
           else np.asarray(spec, np.int32))
    n = int(ids.size)
    ids_dev = torch.from_numpy(ids.astype(np.int64)).to(dev)
    pages = torch.randn(n * E + 1, device=dev).to(dtype)
    pages = pages[1:] if case.get("misaligned") else pages[:-1]
    pages = pages.view(n, E)
    if case.get("device_ids"):
        ids = ids_dev.to(torch.int32)
    if name.startswith("page_gather"):
        if cut:
            def call(backend):
                return pg.page_gather_runs(frames, *frame_runs(ids),
                                           backend=backend)
        elif runs:
            def call(backend):
                return pg.page_gather_runs(frames, *spec, backend=backend)
        elif case.get("misaligned"):
            # into a view of an output buffer one element off 16 bytes
            buf = torch.empty(n * E + 1, dtype=dtype, device=dev)

            def call(backend):
                if backend == "torch":
                    return page_gather_ref(frames, ids)
                return pgk.page_gather(frames, ids,
                                       out=buf[1:].view(n, E))
        else:
            def call(backend):
                return pg.page_gather(frames, ids, backend=backend)
        got = []
        route = routes_of(dispatch, lambda: got.append(call("kernel")))
        want = call("torch")
        torch.cuda.synchronize()
        ok = torch.equal(got[0], want)

        def library():
            return frames.index_select(0, ids_dev)
    else:
        fk, fp = frames.clone(), frames.clone()
        if runs:
            def call(backend, f=None):
                return cs.cow_scatter_runs(f, *spec, pages, backend=backend)
        else:
            def call(backend, f=None):
                return cs.cow_scatter(f, ids, pages, backend=backend)
        route = routes_of(dispatch, lambda: call("kernel", fk))
        call("torch", fp)
        torch.cuda.synchronize()
        ok = torch.equal(fk, fp)
        untouched = np.setdiff1d(np.arange(F), ids_dev.cpu().numpy())
        if untouched.size:
            u = torch.from_numpy(untouched).to(dev)
            ok = ok and torch.equal(fk[u], frames[u])
        lib_frames = frames.clone()

        def library():
            return lib_frames.index_copy_(0, ids_dev, pages)
        kernel_target, plain_target = fk, fp
    if not ok:
        raise AssertionError(f"{name}/{label}: kernel differs from plain")
    if route != [case["route"]]:
        raise AssertionError(f"{name}/{label}: took {route}, expected "
                             f"{case['route']}")
    if name.startswith("page_gather"):
        def kern():
            return call("kernel")

        def plain():
            return call("torch")
    else:
        def kern():
            return call("kernel", kernel_target)

        def plain():
            return call("torch", plain_target)
    nbytes = 2 * n * E * frames.element_size()
    reps = 10 if nbytes > (256 << 20) else 20
    # device-only times where the call uploads nothing (a graph cannot
    # capture a copy from pageable host memory); the run-table scatter's
    # wrapper uploads its tables, so its kernel is timed from tables
    # uploaded beforehand
    if name == "cow_scatter_runs":
        from repro_torch.kernels.cow_scatter import kernel as csk
        from repro_torch.kernels.page_gather.plan import run_offsets
        tables = run_offsets(*(np.asarray(x, np.int64) for x in spec), dev)

        def kern_alone():
            return csk.cow_scatter_runs(kernel_target, *tables, pages, E)
    elif route[0] == "bulk-value" or case.get("device_ids"):
        kern_alone = kern
    else:
        kern_alone = None
    return {"name": name, "case": label, "dtype": case["dtype"],
            "design": "bulk-tma" if route[0] in BULK else "copy_rows",
            "route": route[0], "pages": n, "page_elems": E,
            "max_abs_err": 0.0, "ms": time_ms(torch, kern),
            "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, library),
            "device_ms": (device_ms(torch, kern_alone, reps) if kern_alone
                          else None),
            "library_device_ms": device_ms(torch, library, reps),
            "host_us": host_us(torch, kern),
            "library_host_us": host_us(torch, library),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": nbytes}


def host_stages(torch):
    """Host microseconds of each stage of a one-page fp32 ``cow_scatter``
    through its wrapper, beside the whole call and ``index_copy_``."""
    import ctypes
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.cow_scatter import kernel, ops as cs
    from repro_torch.kernels.page_gather.ops import kernel_ids
    E = 32768
    dev = torch.device("cuda", torch.cuda.current_device())
    frames = torch.zeros(64, E, device=dev)
    pages = torch.ones(1, E, device=dev)
    ids = np.array([9], np.int32)
    ids_dev = torch.from_numpy(ids.astype(np.int64)).to(dev)
    isz = frames.element_size()
    fn = build.function("bulk_copy", "bulk_scatter_ids",
                        (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 3
                        + (ctypes.c_void_p,))
    fp, pp = frames.data_ptr(), pages.data_ptr()
    stream = build.stream(dev)
    stages = {
        "kernel_ids": lambda: kernel_ids(ids, 64, dev),
        "resolve_backend": lambda: dispatch.resolve_backend(
            "auto", kernel_name="cow_scatter", device=dev),
        "payload": lambda: cs._payload(pages, 1, frames, frames.dtype, E),
        "check_args": lambda: kernel._check_args(frames, pages, E),
        "stream": lambda: build.stream(dev),
        "ids_pointer": lambda: ids.ctypes.data,
        "c_call_and_launch": lambda: fn(fp, pp, ids.ctypes.data, None, 1,
                                        E * isz, 64 * E * isz, stream),
        "count_launch": lambda: dispatch.count_launch(
            "cow_scatter", pages=1, route="bulk-value"),
        "whole_wrapper": lambda: cs.cow_scatter(frames, ids, pages),
        "index_copy_": lambda: frames.index_copy_(0, ids_dev, pages),
    }
    return {k: host_us(torch, f, 2000) for k, f in stages.items()}


def patch_cases():
    """(label, dtype, tensor size, page elems, page ids): scatter_patch onto
    a tensor whose last page is partial — a tail of 12 bytes alone, a bulk
    body with a 4-byte tail, and a bf16 weight page with a 10-byte tail."""
    return [
        ("partial-tail-only", "float32", 5 * 4096 + 3, 4096, [4, 5, 1]),
        ("partial-body-tail", "float32", 5 * 4096 + 1001, 4096, [5, 0]),
        ("partial-weight-page", "bfloat16", 3 * 32768 + 5, 32768, [3, 1]),
    ]


def run_patch_case(torch, case):
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.cow_scatter import ops as cs
    label, dt, size, E, ids = case
    dtype = getattr(torch, dt)
    dev = torch.device("cuda")
    t = torch.randn(size, device=dev).to(dtype)
    rows = torch.randn(len(ids), E, device=dev).to(dtype)

    def call(backend):
        return cs.scatter_patch(t, ids, rows, page_elems=E, backend=backend)
    got = []
    route = routes_of(dispatch, lambda: got.append(call("kernel")))
    want = call("torch")
    torch.cuda.synchronize()
    if not torch.equal(got[0], want):
        raise AssertionError(f"scatter_patch/{label}: kernel differs")
    if route != ["bulk-value"]:
        raise AssertionError(f"scatter_patch/{label}: took {route}")
    isz = t.element_size()
    nbytes = 2 * size * isz + 2 * sum(min(E, size - i * E) for i in ids) * isz
    return {"name": "cow_scatter", "case": f"scatter_patch-{label}",
            "dtype": dt, "design": "bulk-tma", "route": route[0],
            "pages": len(ids), "page_elems": E, "max_abs_err": 0.0,
            "ms": time_ms(torch, lambda: call("kernel")),
            "plain_ms": time_ms(torch, lambda: call("torch")),
            "library_ms": None,
            "device_ms": device_ms(torch, lambda: call("kernel"), 20),
            "host_us": host_us(torch, lambda: call("kernel")),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": nbytes}


def attention_cases():
    """(label, B, K, G, hd, Tp, length per seq, window or explicit starts,
    page-table columns or None for the lengths' pages and one padded
    column) — the first is the main path's decode at gemma3-1b's head shape
    (4 fork-demo sequences of about 8 tokens in a one-column table, one
    split); then a long
    window batch and one long sequence with no window (split across the
    SMs), other head shapes (rows of 99 elements take the plain-load
    route), and empty ranges (starts == lengths, and a
    zero length) over a wide table, split too, where the output is the
    mean of V over every slot of the sequence's table."""
    return [
        ("gemma-decode", 4, 1, 4, 256, 16, [8, 9, 9, 9], 512, 1),
        ("gemma-long-window", 8, 1, 4, 256, 16,
         [2048, 2000, 1999, 1500, 2048, 700, 1024, 2047], 512, None),
        ("gemma-global-long", 1, 1, 4, 256, 16, [8192], None, None),
        ("qwen2-heads", 3, 4, 7, 128, 16, [40, 77, 5], None, None),
        ("mha-global", 2, 2, 1, 64, 16, [100, 33], None, None),
        ("odd-head-dim", 2, 2, 3, 99, 8, [50, 17], None, None),
        ("empty-ranges", 4, 1, 4, 256, 16, [8, 0, 9, 32], [8, 0, 0, 32],
         64),
    ]


def run_attention_case(torch, case, dtype):
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.paged_attention import kernel, ops as pa, plan
    label, B, K, G, hd, Tp, lens, window, P = case
    explicit = window if isinstance(window, list) else None
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    P = P or max(-(-l // Tp) for l in lens) + 1      # one padded column
    F = B * P + 8
    q = torch.randn(B, K, G, hd, device=dev).to(dtype)
    pool = torch.randn(F, Tp, K, hd, device=dev).to(dtype)
    kt = torch.from_numpy(rng.permutation(F)[:B * P].reshape(B, P)
                          .astype(np.int32)).to(dev)
    vt = torch.from_numpy(rng.permutation(F)[:B * P].reshape(B, P)
                          .astype(np.int32)).to(dev)
    for b, l in enumerate(lens):                     # padding -> frame 0
        kt[b, -(-l // Tp):] = 0
        vt[b, -(-l // Tp):] = 0
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    if explicit is not None:
        starts = torch.tensor(explicit, dtype=torch.int32, device=dev)
    elif window is not None:
        starts = torch.clamp(lengths - window, min=0)
    else:
        starts = torch.zeros_like(lengths)

    def call(backend):
        return pa.paged_attention(q, pool, pool, kt, lengths, v_page_table=vt,
                                  starts=starts, backend=backend)
    got = []
    route = routes_of(dispatch, lambda: got.append(call("kernel")))
    want = call("torch")
    torch.cuda.synchronize()
    err = float((got[0].float() - want.float()).abs().max())
    tol = ATTN_TOL[str(dtype)[6:]]
    if not err < tol:
        raise AssertionError(f"paged_attention/{label}/{dtype}: max abs "
                             f"err {err} >= {tol}")
    want_route = "loads" if hd * q.element_size() % 16 else "tma"
    if route != [want_route]:
        raise AssertionError(f"paged_attention/{label}: took {route}, "
                             f"expected {want_route}")
    splits, _ = plan.split_plan(B, K, P, kernel.sm_count(dev))
    if (label == "gemma-decode") != (splits == 1):
        raise AssertionError(f"paged_attention/{label}: {splits} splits")
    ms = time_ms(torch, lambda: call("kernel"))
    plain_ms = time_ms(torch, lambda: call("torch"))
    dev_ms = device_ms(torch, lambda: call("kernel"), 20)
    tokens = int((lengths - starts).clamp(min=0).sum())
    n_empty = int((starts >= lengths).sum())
    isz = q.element_size()
    nbytes = (2 * q.numel() * isz + 2 * tokens * K * hd * isz
              + n_empty * P * Tp * K * hd * isz        # V of every slot
              + 2 * int(sum(-(-l // Tp) for l in lens) + n_empty * P) * 4
              + 2 * B * 4)
    flops = 4 * tokens * K * G * hd
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
    return {"name": "paged_attention", "case": label,
            "dtype": str(dtype)[6:], "B": B, "K": K, "G": G, "hd": hd,
            "P": P, "splits": splits, "route": route[0], "design":
            DESIGN["paged_attention"], "tokens": tokens, "max_abs_err": err,
            "tol": tol, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "device_ms": dev_ms,
            "host_us": host_us(torch, lambda: call("kernel")),
            "bound_ms": bound_s * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / FP32_FLOPS_PER_S else "operations"),
            "bytes": nbytes, "flops": flops}


def attention_kernel_split(torch, reps: int = 20) -> dict:
    """Device microseconds per call of each of paged_attention's two
    kernels (the split kernel and the combine), from ``torch.profiler``,
    on one fp32 sequence of 8,192 tokens at gemma3-1b's head shape."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.launch.profile_serve import _device_us
    dev = torch.device("cuda")
    Tp, hd, tokens = 16, 256, 8192
    P = tokens // Tp + 1
    q = torch.randn(1, 1, 4, hd, device=dev)
    pool = torch.randn(P + 8, Tp, 1, hd, device=dev)
    kt = torch.randperm(P + 8, device=dev)[:P].to(torch.int32)[None]
    lengths = torch.tensor([tokens], dtype=torch.int32, device=dev)

    def call():
        return pa.paged_attention(q, pool, pool, kt, lengths)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        for k in ("paged_attention_kernel", "paged_attention_combine"):
            if k in e.key:
                split[k] = split.get(k, 0.0) + _device_us(e) / reps
    if len(split) != 2:
        raise AssertionError(f"profiler saw {split}, not both kernels")
    return split


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def flat_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from flat_leaves(x, f"{path}/{i}")
    else:
        yield path, tree


def reference_logits(torch, lm, params, cfg, prefix, feed):
    """Non-paged model: prefill ``prefix``, then decode ``feed`` tokens one
    at a time.  Returns [prefill logits] + [logits after each fed token]."""
    dev = params["embed"]["tok"].device
    cache_len = -(-(len(prefix) + len(feed) + 1) // 16) * 16
    toks = torch.tensor(prefix, dtype=torch.int32, device=dev)[None]
    logits, caches = lm.prefill(params, cfg, toks, cache_len)
    out = [logits[0].float().cpu()]
    for i, t in enumerate(feed):
        pos = torch.tensor([len(prefix) + i], dtype=torch.int32, device=dev)
        logits, caches = lm.decode_step(
            params, cfg, caches, torch.tensor([t], dtype=torch.int32,
                                              device=dev), pos)
        out.append(logits[0].float().cpu())
    return out


def check_request(torch, lm, params, cfg, req, forked: bool):
    """Paged logits against the model's on the same tokens (the engine's
    own, so a near-tie cannot make the two runs diverge).  Returns
    (max abs err, near-tie steps)."""
    if forked:
        ref = reference_logits(torch, lm, params, cfg, req.prompt[:-1],
                               [req.prompt[-1]] + req.out_tokens[:-1])[1:]
    else:
        ref = reference_logits(torch, lm, params, cfg, req.prompt,
                               req.out_tokens[:-1])
    if len(ref) != len(req.logits):
        raise AssertionError(f"req {req.req_id}: {len(req.logits)} logits "
                             f"kept, {len(ref)} expected")
    err, ties = 0.0, []
    for step, (got, want) in enumerate(zip(req.logits, ref)):
        err = max(err, float((got - want).abs().max()))
        top2 = torch.topk(want, 2).values
        gap = float(top2[0] - top2[1])
        if int(torch.argmax(want)) != req.out_tokens[step]:
            if gap >= LOGIT_TOL:
                raise AssertionError(
                    f"req {req.req_id} step {step}: token "
                    f"{req.out_tokens[step]} != reference "
                    f"{int(torch.argmax(want))} (top-2 gap {gap})")
            ties.append({"req": req.req_id, "step": step, "gap": gap})
    if not err < LOGIT_TOL:
        raise AssertionError(f"req {req.req_id}: logits max abs err {err} "
                             f">= {LOGIT_TOL}")
    return err, ties


def main_path(torch):
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    argv = ["--arch", "gemma3-1b", "--nodes", "3", "--requests", "4",
            "--fork-demo", "--keep-logits", "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    dispatch.reset_meters()      # phase 3's choices stay out of the meters
    t0 = time.perf_counter()
    st = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: int(dispatch.launches.get(k, 0)) for k in KERNELS}
    pages = {k: int(dispatch.pages_moved.get(k, 0)) for k in KERNELS}
    routes = dict(dispatch.routes)
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}: "
                             f"{launches}")
    for k in ("page_gather", "cow_scatter", "page_gather_runs"):
        if not any(routes.get(f"{k}.{r}", 0) for r in BULK):
            raise AssertionError(f"main path never took {k}'s bulk-copy "
                                 f"kernel: {routes}")

    seed = dict(flat_leaves(st.params))
    for i, cp in enumerate(st.child_params):
        got = dict(flat_leaves(cp))
        if sorted(got) != sorted(seed):
            raise AssertionError(f"child {i}: leaf names differ from seed")
        for name, t in seed.items():
            if got[name].device.type != "cuda" \
                    or not torch.equal(got[name], t):
                raise AssertionError(f"child {i}: leaf {name} differs")

    cfg = st.cfg
    demo = st.fork_demo
    errs, ties, n_checked = [], [], 0
    for eng, child_params in zip(st.engines, st.child_params):
        for req in eng.requests.values():
            forked = eng is demo.engine and req.req_id in demo.children
            e, t = check_request(torch, lm, child_params, cfg, req, forked)
            errs.append(e)
            ties.extend(t)
            n_checked += 1
    for t in ties:
        print(f"[smoke] near-tie step (tokens may differ): {json.dumps(t)}")
    for eng in st.engines:
        for req in eng.requests.values():
            if not all(0 <= t < cfg.vocab_size for t in req.out_tokens):
                raise AssertionError(f"token out of vocab: {req.out_tokens}")
    snap = st.net.snapshot()
    summary = {
        "arch": cfg.name, "d_model": cfg.d_model, "layers": cfg.num_layers,
        "vocab": cfg.vocab_size, "seed_bytes": st.seed.total_bytes(),
        "fork_seconds": st.fork_seconds, "serve_wall_s": wall,
        "pages_moved_rdma": int(snap.get("page_pages_moved", 0)),
        "children_pages_rdma": [c.stats["pages_rdma"] for c in st.children],
        "sim_time_s": snap.get("sim_time"),
        "peak_device_bytes": peak, "launches": launches,
        "pages_moved": pages, "routes": routes,
        "pages_per_launch": {k: pages[k] / launches[k] for k in KERNELS
                             if k != "paged_attention"},
        "requests_checked": n_checked, "logits_max_abs_err": max(errs),
        "logits_tol": LOGIT_TOL, "near_ties": len(ties),
    }
    print("[smoke] main path: " + json.dumps(summary))
    print("[smoke] network meter: " + json.dumps(snap))
    return launches, pages, routes


# ---------------------------------------------------------------------------
# phases 5 and 6: the serverless platform and trace replay
# ---------------------------------------------------------------------------


def phase_counts():
    from repro_torch.kernels import dispatch
    return ({k: int(dispatch.launches.get(k, 0)) for k in KERNELS},
            {k: int(dispatch.pages_moved.get(k, 0)) for k in KERNELS},
            dict(dispatch.routes))


def check_phase(phase, launches, routes, required, bulk=()):
    """Fail unless every ``required`` kernel launched in the phase and every
    ``bulk`` kernel took a bulk-copy route at least once."""
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"{phase}: never launched {missing}: "
                             f"{launches}")
    for k in bulk:
        if not any(routes.get(f"{k}.{r}", 0) for r in BULK):
            raise AssertionError(f"{phase}: {k} never took the bulk-copy "
                                 f"kernel: {routes}")


def same_leaves(torch, got, want, what):
    got, want = dict(flat_leaves(got)), dict(flat_leaves(want))
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: leaf names differ from the seed's")
    for name, t in want.items():
        if got[name].device != t.device or not torch.equal(got[name], t):
            raise AssertionError(f"{what}: leaf {name} differs")


def platform_phase(torch, dev, arch="gemma3-1b", market_mb=6.0,
                   n_rules=8):
    """Phase 5 on ``dev``; returns its summary.  The kernel counts are the
    caller's to reset and read."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import lm
    from repro_torch.net import Network
    from repro_torch.placement import ShardedSeed
    from repro_torch.platform.coordinator import Coordinator, FunctionDef
    from repro_torch.platform.node import NodeRuntime
    from repro_torch.platform.straggler import StragglerMonitor
    from repro_torch.platform.workflow import build_finra, run_workflow
    from repro_torch.serving.engine import ServingEngine

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = dataclasses.replace(get_arch(arch), compute_dtype="float32")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    net = Network()
    nodes = [NodeRuntime(f"inv{i}", net, device_pool=True, device=dev)
             for i in range(4)]
    coord = Coordinator(net, nodes, seed_replicas=2)
    prompt = torch.randint(0, cfg.vocab_size, (6,),
                           generator=torch.Generator().manual_seed(1)).tolist()
    marks = {}

    def answer(inst, ctx):
        tree = inst.materialize_pytree()
        sync()
        marks["materialized"] = time.perf_counter()
        eng = ServingEngine(cfg, tree, device=dev)
        rid = eng.submit(prompt, max_tokens=4)
        return {"tokens": list(eng.run_to_completion()[rid])}

    coord.register_function(FunctionDef("gemma", cfg.name, lambda: params,
                                        answer))
    invocations, seed_tokens = [], None
    for i in range(3):
        busy0 = {n.node_id: net.node_busy(n.node_id) for n in nodes}
        sim0 = net.sim_time
        t0 = time.perf_counter()
        out, inst = coord.invoke("gemma", policy="fork")
        sync()
        wall = time.perf_counter() - t0
        seed = coord.seed_store["gemma"]
        if not isinstance(seed, ShardedSeed) or seed.replicas != 2:
            raise AssertionError(f"gemma's seed is {seed!r}, not 2 replicas")
        parents = seed.parent_nodes
        row = {"invocation": i, "node": inst.node.node_id,
               "kind": "fork" if inst.ancestry else "coldstart",
               "fork_wall_s": marks["materialized"] - t0,
               "invoke_wall_s": wall,
               "pages_rdma": inst.stats["pages_rdma"],
               "sim_time_s": net.sim_time - sim0, "tokens": out["tokens"],
               "parents": parents,
               "busy_s": {p: net.node_busy(p) - busy0[p] for p in parents}}
        if i == 0:
            if inst.ancestry:
                raise AssertionError("the first invocation did not coldstart")
            seed_tokens = out["tokens"]
        else:
            owners = sorted({v.ancestry[0] for v in inst.aspace.values()})
            row["owners"] = owners
            if owners != sorted(parents):
                raise AssertionError(f"child {i}: VMAs routed to {owners}, "
                                     f"not across {parents}")
            if not all(b > 0 for b in row["busy_s"].values()):
                raise AssertionError(f"child {i}: a replica parent served "
                                     f"no page: {row['busy_s']}")
            same_leaves(torch, inst.materialize_pytree(), params,
                        f"child {i}")
            if out["tokens"] != seed_tokens:
                raise AssertionError(f"child {i}: tokens {out['tokens']} != "
                                     f"the seed's {seed_tokens}")
        invocations.append(row)
        print("[smoke] platform invocation " + json.dumps(row))
        coord.release("gemma", inst, "fork")

    # straggler: back up the worker state of the slow replica's node
    seed = coord.seed_store["gemma"]
    slow = seed.handles[0]
    mon = StragglerMonitor(net, threshold=2.0)
    for _ in range(5):
        for n in nodes:
            mon.report(n.node_id, 0.4 if n.node_id == slow.parent_node
                       else 0.1)
    if mon.stragglers() != [slow.parent_node]:
        raise AssertionError(f"stragglers: {mon.stragglers()}")
    spare = next(n for n in nodes if n.node_id not in seed.parent_nodes)
    t0 = time.perf_counter()
    backup = mon.mitigate(slow.parent_node, slow, spare)
    same_leaves(torch, backup.materialize_pytree(), params, "backup")
    sync()
    straggler = {"straggler": slow.parent_node, "backup_on": spare.node_id,
                 "backup_wall_s": time.perf_counter() - t0,
                 "pages_rdma": backup.stats["pages_rdma"]}
    mon.resolve(slow.parent_node, winner=spare.node_id)
    backup.free()
    print("[smoke] platform straggler " + json.dumps(straggler))

    # FINRA: fetch pre-materializes the market, the audit rules read it
    market = torch.randn(int(market_mb * 2**20 / 4), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    market_pages = -(-market.numel() // nodes[0].pool.page_elems)
    audits = []

    def fetch(inst, ctx):
        if ctx["transfer"] == "message":
            return {"market": market}
        inst.add_tensor("globals/market", market)
        return {"rows": market.numel()}

    def audit(inst, ctx):
        if "msg:fetchData" in ctx:
            data = ctx["msg:fetchData"]["market"]      # deserialized copy
            v = int((np.abs(data) > 3.5).sum())
        else:
            v = int((inst.ensure_tensor("globals/market").abs() > 3.5).sum())
        audits.append((ctx["transfer"], inst.stats["pages_rdma"]))
        return {"violations": v}

    coord.register_function(FunctionDef("finra-fetch", cfg.name,
                                        lambda: params, fetch))
    coord.register_function(FunctionDef("finra-audit", cfg.name,
                                        lambda: params, audit))
    wf = build_finra(coord, market_mb=market_mb, n_rules=n_rules)
    finra = {}
    for transfer in ("fork", "message"):
        sim0, msg0 = net.sim_time, net.meter["msg_bytes"]
        t0 = time.perf_counter()
        res = run_workflow(coord, wf, {"transfer": transfer},
                           transfer=transfer,
                           fan_out={"runAuditRule": n_rules})
        sync()
        finra[transfer] = {
            "wall_s": time.perf_counter() - t0,
            "sim_time_s": net.sim_time - sim0,
            "msg_bytes": net.meter["msg_bytes"] - msg0,
            "audit_pages_rdma": [p for t, p in audits if t == transfer],
            "violations": [r["violations"] for r in res["runAuditRule"]]}
    if finra["fork"]["violations"] != finra["message"]["violations"] \
            or len(finra["fork"]["violations"]) != n_rules:
        raise AssertionError(f"FINRA results differ: {finra}")
    for p in finra["fork"]["audit_pages_rdma"]:
        if not market_pages <= p <= market_pages + 1:
            raise AssertionError(f"an audit child faulted {p} pages, not the "
                                 f"market's {market_pages} (+1 prefetch)")
    if finra["fork"]["msg_bytes"] or not finra["message"]["msg_bytes"]:
        raise AssertionError(f"FINRA message bytes: {finra}")
    print("[smoke] platform finra " + json.dumps(finra))
    return {"arch": cfg.name, "d_model": cfg.d_model,
            "layers": cfg.num_layers, "vocab": cfg.vocab_size,
            "seed_pages": sum(v.npages for v in
                              coord.nodes[seed.parent_node].seeds[
                                  seed.handler_id].instance.aspace.values()),
            "invocations": invocations, "straggler": straggler,
            "finra": finra, "market_pages": market_pages,
            "gc": {k: v for k, v in coord.gc().items()
                   if k in ("seeds", "cached", "dangling", "rereplicated")}}


def fig22_replay(device, faults=None):
    """Figure 22's replay (``FIG22``) with every pool on ``device`` (None:
    host pools) under ``faults(node_ids, trace_seconds)``, by default the
    crash of the seed's parent n0 at ``crash_t``; returns the result."""
    from repro_torch.net import NetModel
    from repro_torch.sim import (Crash, FaultPlan, ForkOnDemand,
                                 ReplayEngine, SimFunction, build_cluster,
                                 spike_660323)

    @dataclasses.dataclass(frozen=True)
    class PhasedFunction(SimFunction):
        """Half the working set paged in at the start, the rest half an
        execution later: a parent lost mid-run leaves remote pages."""

        def behavior(self, inst, inputs):
            for name, vma in inst.aspace.items():
                n = max(1, int(round(vma.npages * self.touch_frac)))
                inst.fetch_pages(name, np.arange(n // 2))
                inst.node.network.advance(self.exec_s / 2)
                inst.fetch_pages(name, np.arange(n // 2, n))
            return {}

    g = FIG22
    trace = spike_660323(scale=g["scale"])
    net, nodes = build_cluster(g["nodes"], model=NetModel(node_links=g[
        "links"]), page_elems=g["page_elems"], device=device)
    plan = (faults([n.node_id for n in nodes], trace.duration_s) if faults
            else FaultPlan(seed=1, crashes=(Crash(g["crash_t"], "n0"),),
                           op_fail_rate=g["op_fail_rate"]))
    return ReplayEngine(
        trace, ForkOnDemand(replicas=g["replicas"], prefetch=0),
        [PhasedFunction("spike", state_bytes=g["state_pages"]
                        * g["page_elems"] * 4, vmas=g["vmas"],
                        touch_frac=g["touch"], exec_s=g["exec_s"],
                        hold_s=g["hold_s"])],
        network=net, nodes=nodes, seed=g["seed"],
        reroute_backlog=g["reroute"], faults=plan).run()


def replay_phase(torch, dev):
    """Phase 6 with every node's pool on ``dev``; returns its summary."""
    from repro_torch.sim import (Crash, FaultPlan, ForkOnDemand, KeepWarm,
                                 ReplayEngine, SimFunction, Trace,
                                 spike_660323)
    f = FIG20
    fn = SimFunction("spike", state_bytes=f["state_pages"] * f["page_elems"]
                     * 4, touch_frac=f["touch"], exec_s=f["exec_s"],
                     coldstart_s=f["coldstart_s"], hold_s=f["hold_s"])
    want = json.loads((ROOT / "BENCH_spikes.json").read_text())[
        "replay"]["event_log_digest"]
    rows = []
    # the MITOSIS row once more on host pools: the same digest, and the
    # wall time apart tells the device pools' share of the per-fork cost
    for label, pools, policy in (
            ("mitosis", "card", ForkOnDemand(replicas=f["budget"],
                                             prefetch=0)),
            ("caching", "card", KeepWarm(ttl=f["ttl"], prewarm=f["budget"])),
            ("mitosis", "host", ForkOnDemand(replicas=f["budget"],
                                             prefetch=0))):
        device = dev if pools == "card" else None
        eng = ReplayEngine(spike_660323(scale=f["scale"]), policy, [fn],
                           n_nodes=f["nodes"], seed=f["seed"],
                           page_elems=f["page_elems"], device=device)
        if any(n.pool.device != device for n in eng.nodes):
            raise AssertionError(f"a replay node's pool is not on {device}")
        t0 = time.perf_counter()
        res = eng.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        s = res.summary()
        row = {"policy": label, "pools": pools,
               "invocations": s["invocations"], "nodes": s["nodes"],
               "wall_s": wall, "wall_per_invocation_ms":
               wall / s["invocations"] * 1e3,
               "p50_us": s["latency"]["all"]["p50_us"],
               "p99_us": s["latency"]["all"]["p99_us"],
               "mem_peak_node_mb": s["mem_peak_node_mb"],
               "decisions": s["decisions"],
               "pages_rdma": s["payload_pages"].get("pages_rdma", 0),
               "event_log_digest": s["event_log_digest"],
               "bench_digest": want[label]}
        if s["event_log_digest"] != want[label]:
            raise AssertionError(f"{label} on {pools} pools: event log "
                                 f"digest {s['event_log_digest']} != "
                                 f"BENCH_spikes.json's {want[label]}")
        rows.append(row)
        print("[smoke] replay " + json.dumps(row))
        del eng, res
        gc.collect()

    # Figure 22's targeted crash on pools on the card
    bench22 = json.loads((ROOT / "BENCH_faults.json").read_text())["fig22"]
    t0 = time.perf_counter()
    s = fig22_replay(dev).summary()
    fig22 = {"plan": "crash", "invocations": s["invocations"],
             "nodes": s["nodes"], "wall_s": time.perf_counter() - t0,
             "p99_us": s["latency"]["all"]["p99_us"],
             "faults": s["faults"], "lease": s["lease"],
             "event_log_digest": s["event_log_digest"],
             "bench_digest": bench22["event_log_digest"]["crash"]}
    if fig22["event_log_digest"] != fig22["bench_digest"]:
        raise AssertionError(f"fig22 crash: event log digest differs from "
                             f"BENCH_faults.json's: {fig22}")
    print("[smoke] replay fig22 " + json.dumps(fig22))
    gc.collect()

    # one crash of the seed's first parent, replayed on the card and on
    # host pools in the same process
    crash = FaultPlan(crashes=(Crash(20.0, "n0"),))
    crashed = {}
    for where, device in (("card", dev), ("host", None)):
        small = SimFunction("f", state_bytes=8 * 1024 * 4, touch_frac=0.5,
                            hold_s=30.0)
        t0 = time.perf_counter()
        res = ReplayEngine(Trace("chaos", {"f": (4, 3, 4)}),
                           ForkOnDemand(replicas=2, prefetch=0), [small],
                           n_nodes=6, seed=7, page_elems=1024, faults=crash,
                           device=device).run()
        s = res.summary()
        crashed[where] = {"digest": res.digest(),
                          "wall_s": time.perf_counter() - t0,
                          "faults": s["faults"], "lease": s["lease"],
                          "decisions": s["decisions"]}
    if crashed["card"]["digest"] != crashed["host"]["digest"]:
        raise AssertionError(f"crash replay: card and host pools differ: "
                             f"{crashed}")
    if crashed["card"]["lease"].get("f", {}).get("parent_lost", 0) < 1 \
            or crashed["card"]["faults"]["crashes_fired"] != 1:
        raise AssertionError(f"the crash missed the seed: {crashed}")
    print("[smoke] replay crash " + json.dumps(crashed))
    return {"rows": rows, "fig22": fig22, "crash": crashed}


def run_phase(torch, name, fn, required, bulk=()):
    """Reset the kernel counts, run ``fn()``, check and print the phase's
    launches, pages and routes; returns fn's summary and the counts."""
    from repro_torch.kernels import dispatch
    gc.collect()            # the last phase's cluster (reference cycles)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    dispatch.reset_meters()
    t0 = time.perf_counter()
    summary = fn()
    torch.cuda.synchronize()
    launches, pages, routes = phase_counts()
    check_phase(name, launches, routes, required, bulk)
    print(f"[smoke] {name} phase: " + json.dumps({
        "wall_s": time.perf_counter() - t0, "launches": launches,
        "pages_moved": pages, "routes": routes,
        "peak_device_bytes": torch.cuda.max_memory_allocated()}))
    return summary, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    from repro_torch.kernels import build, bulk_copy

    card = card_line()
    print(f"[smoke] card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    build.build_all(verbose=True)
    print(f"[smoke] kernels built in {time.perf_counter() - t0:.1f} s")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60)
    limits = bulk_copy.limits()
    print(f"[smoke] nvcc: {nvcc.stdout.strip().splitlines()[-1]}; "
          f"bulk_copy by-value tables: {json.dumps(limits)}")

    print("[smoke] kernel rows: ms, plain_ms and library_ms are CUDA-event "
          "times of one call each (the kernel from host ids through its "
          "wrapper, the library call with ids already on the card); "
          "device_ms and library_device_ms are device time alone (CUDA-graph "
          "replay); host_us and library_host_us the host time of one call")
    rows = []
    for case in copy_cases(limits):
        r = run_copy_case(torch, case)
        print("[smoke] kernel " + json.dumps(r))
        rows.append(r)
    for case in patch_cases():
        r = run_patch_case(torch, case)
        print("[smoke] kernel " + json.dumps(r))
        rows.append(r)
    print("[smoke] cow_scatter host stages, one fp32 page (us): "
          + json.dumps(host_stages(torch)))
    for case in attention_cases():
        for dtype in (torch.float32, torch.bfloat16):
            r = run_attention_case(torch, case, dtype)
            print("[smoke] kernel " + json.dumps(r))
            rows.append(r)
    print("[smoke] paged_attention device us per call, by kernel, one "
          "fp32 sequence of 8,192 tokens (torch.profiler): "
          + json.dumps(attention_kernel_split(torch)))
    torch.cuda.synchronize()

    launches, pages, routes = main_path(torch)

    dev = torch.device("cuda", torch.cuda.current_device())
    run_phase(torch, "platform", lambda: platform_phase(torch, dev),
              required=KERNELS,
              bulk=("page_gather", "page_gather_runs", "cow_scatter"))
    _, replay_launches = run_phase(torch, "replay",
                                   lambda: replay_phase(torch, dev),
                                   required=())
    if not sum(replay_launches[k] for k in COPY_KERNELS):
        raise AssertionError(f"replay launched no copy kernel: "
                             f"{replay_launches}")

    kernels = []
    for name in KERNELS:
        main_row = next(r for r in rows if r["name"] == name)  # main shape
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "design": DESIGN[name],
            "launches": launches[name], "pages": pages[name],
            "routes": {k.split(".", 1)[1]: v for k, v in routes.items()
                       if k.split(".", 1)[0] == name},
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "device_ms": main_row["device_ms"],
            "library_device_ms": main_row.get("library_device_ms"),
            "host_us": main_row.get("host_us"),
            "library_host_us": main_row.get("library_host_us"),
            "case": main_row["case"], "dtype": main_row["dtype"]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
