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
   time kernel, plain version and library call with CUDA events;
4. run the port's serve path (``repro_torch.launch.serve.main``) for
   gemma3-1b at full width: 3 nodes, a seed packed on node0, two children
   forked over the modelled RDMA network, 4 requests and the
   copy-on-write fork demo.  Every kernel's launch count must be > 0,
   every child's parameters equal to the seed's, and every request's
   paged-engine logits close to the non-paged model's on the same card;
5. print one JSON line with every kernel's numbers, the card line again,
   and last ``{"ok": true, "device": {...}}``.

Launches made in phase 3 and in phase 4's checks are not in the counts:
the counts are reset just before the serve run and read just after it.
"""
from __future__ import annotations

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
SOURCE = {k: "src/repro_torch/kernels/csrc/paging.cu" for k in KERNELS}
SOURCE["paged_attention"] = "src/repro_torch/kernels/csrc/paged_attention.cu"


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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def copy_cases(torch):
    """(kernel, label, dtype, F, E, ids-or-runs) — the first case of each
    kernel is the main path's largest call: the gemma3-1b embedding,
    9,216 pages of 32,768 elements (assembly gathers it page by page,
    the owner's read and the child's adopt move it as one run)."""
    rng = np.random.default_rng(0)
    E, n_emb = 32768, 9216
    return [
        ("page_gather", "embed-assemble", torch.float32, n_emb + 64, E,
         np.arange(64, 64 + n_emb)),
        ("page_gather", "scattered-dup", torch.bfloat16, 4096, E,
         rng.integers(0, 4096, 3000)),
        ("page_gather", "single-page", torch.float32, 64, E, np.array([7])),
        ("page_gather_runs", "embed-read", torch.float32, n_emb + 64, E,
         ([64], [n_emb])),
        ("page_gather_runs", "skewed-runs", torch.bfloat16, 8192, E,
         ([0, 3000, 5000, 7000], [2500, 1, 1999, 900])),
        ("cow_scatter", "single-page", torch.float32, 64, E, np.array([9])),
        ("cow_scatter", "scattered", torch.bfloat16, 8192, E,
         rng.permutation(8192)[:3000]),
        ("cow_scatter_runs", "embed-adopt", torch.float32, n_emb + 64, E,
         ([32], [n_emb])),
        ("cow_scatter_runs", "skewed-runs", torch.bfloat16, 8192, E,
         ([0, 3000, 5000, 7000], [2500, 1, 1999, 900])),
    ]


def run_copy_case(torch, case):
    from repro_torch.kernels.cow_scatter import ops as cs
    from repro_torch.kernels.page_gather import ops as pg
    from repro_torch.kernels.page_gather.ref import expand_runs
    name, label, dtype, F, E, spec = case
    dev = torch.device("cuda")
    frames = torch.randn(F, E, device=dev).to(dtype)
    runs = name.endswith("_runs")
    ids = expand_runs(*spec) if runs else np.asarray(spec)
    n = int(ids.size)
    ids_dev = torch.from_numpy(ids.astype(np.int64)).to(dev)
    pages = torch.randn(n, E, device=dev).to(dtype)
    if name.startswith("page_gather"):
        if runs:
            def call(backend):
                return pg.page_gather_runs(frames, *spec, backend=backend)
        else:
            def call(backend):
                return pg.page_gather(frames, ids, backend=backend)
        got, want = call("kernel"), call("torch")
        torch.cuda.synchronize()
        ok = torch.equal(got, want)

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
        call("kernel", fk)
        call("torch", fp)
        torch.cuda.synchronize()
        ok = torch.equal(fk, fp)
        untouched = np.setdiff1d(np.arange(F), ids)
        if untouched.size:
            u = torch.from_numpy(untouched).to(dev)
            ok = ok and torch.equal(fk[u], frames[u])
        lib_frames = frames.clone()

        def library():
            return lib_frames.index_copy_(0, ids_dev, pages)
        kernel_target, plain_target = fk, fp
    if not ok:
        raise AssertionError(f"{name}/{label}: kernel differs from plain")
    if name.startswith("page_gather"):
        ms = time_ms(torch, lambda: call("kernel"))
        plain_ms = time_ms(torch, lambda: call("torch"))
    else:
        ms = time_ms(torch, lambda: call("kernel", kernel_target))
        plain_ms = time_ms(torch, lambda: call("torch", plain_target))
    lib_ms = time_ms(torch, library)
    nbytes = 2 * n * E * frames.element_size()
    return {"name": name, "case": label, "dtype": str(dtype)[6:],
            "pages": n, "page_elems": E, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": nbytes}


def attention_cases():
    """(label, B, K, G, hd, Tp, length per seq, window) — the first is the
    main path's decode at gemma3-1b's head shape (4 fork-demo sequences of
    about 8 tokens); then a long window batch."""
    return [
        ("gemma-decode", 4, 1, 4, 256, 16, [8, 9, 9, 9], 512),
        ("gemma-long-window", 8, 1, 4, 256, 16,
         [2048, 2000, 1999, 1500, 2048, 700, 1024, 2047], 512),
        ("qwen2-heads", 3, 4, 7, 128, 16, [40, 77, 5], None),
        ("mha-global", 2, 2, 1, 64, 16, [100, 33], None),
    ]


def run_attention_case(torch, case, dtype):
    from repro_torch.kernels.paged_attention import ops as pa
    label, B, K, G, hd, Tp, lens, window = case
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    P = max(-(-l // Tp) for l in lens) + 1           # one padded column
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
    starts = (torch.clamp(lengths - window, min=0) if window is not None
              else torch.zeros_like(lengths))

    def call(backend):
        return pa.paged_attention(q, pool, pool, kt, lengths, v_page_table=vt,
                                  starts=starts, backend=backend)
    got, want = call("kernel"), call("torch")
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = ATTN_TOL[str(dtype)[6:]]
    if not err < tol:
        raise AssertionError(f"paged_attention/{label}/{dtype}: max abs "
                             f"err {err} >= {tol}")
    ms = time_ms(torch, lambda: call("kernel"))
    plain_ms = time_ms(torch, lambda: call("torch"))
    tokens = int((lengths - starts).sum())
    isz = q.element_size()
    nbytes = (2 * q.numel() * isz + 2 * tokens * K * hd * isz
              + 2 * int(sum(-(-l // Tp) for l in lens)) * 4 + 2 * B * 4)
    flops = 4 * tokens * K * G * hd
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
    return {"name": "paged_attention", "case": label,
            "dtype": str(dtype)[6:], "B": B, "K": K, "G": G, "hd": hd,
            "tokens": tokens, "max_abs_err": err, "tol": tol, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_s * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / FP32_FLOPS_PER_S else "operations"),
            "bytes": nbytes, "flops": flops}


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
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}: "
                             f"{launches}")

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
        "requests_checked": n_checked, "logits_max_abs_err": max(errs),
        "logits_tol": LOGIT_TOL, "near_ties": len(ties),
    }
    print("[smoke] main path: " + json.dumps(summary))
    print("[smoke] network meter: " + json.dumps(snap))
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    from repro_torch.kernels import build

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

    rows = []
    for case in copy_cases(torch):
        r = run_copy_case(torch, case)
        print("[smoke] kernel " + json.dumps(r))
        rows.append(r)
    for case in attention_cases():
        for dtype in (torch.float32, torch.bfloat16):
            r = run_attention_case(torch, case, dtype)
            print("[smoke] kernel " + json.dumps(r))
            rows.append(r)
    torch.cuda.synchronize()

    launches = main_path(torch)

    kernels = []
    for name in KERNELS:
        main_row = next(r for r in rows if r["name"] == name)  # main shape
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "case": main_row["case"], "dtype": main_row["dtype"]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
