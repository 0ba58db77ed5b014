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
   output, ``scatter_patch`` onto a partial last page, a run-table gather
   into an output that ends inside its second run, and the replay
   phase's 4 KiB fp32 pages (one page, a 16-page run, 64 pages over two
   VMAs, each table off a 16 KB boundary); each attention case
   its route (``tma``, or ``loads`` for rows off 16 bytes) and the number
   of splits its plan gives, including a long sequence and empty ranges
   split across blocks; time kernel, plain version and library call with
   CUDA events (the kernel from host ids through its wrapper, the library
   call with ids already on the card), the device time alone (CUDA-graph
   replay, through the wrapper wherever the call uploads nothing) and the
   host time of one call; split one page's ``cow_scatter`` call, a
   16-page run's ``cow_scatter_runs`` call, and the replay's
   ``page_gather`` of one page and ``page_gather_runs`` of a 16-page run
   into their host stages (the gathers' lines beside the stages of the
   path they replaced), time the four copy wrappers and the library
   calls from the host at the replay's shapes in turns, and split one
   long sequence's attention into the device time of its two kernels;
   then hold the latent attention kernel (``kernels/paged_attention/
   latent.py``, which replaces no TPU kernel) against its plain version
   at the moonlight cell's shapes (16 heads, rows of 576, values of 512,
   contexts of 256 to 4,128 tokens, a batch of three, a zero length),
   within 3e-5, its launch counted, timed like the others
   (``latent_attention_cases``, ``run_latent_case``); then the routed
   experts kernel (``kernels/moe_experts.py``, which replaces no TPU
   kernel) against its plain version at Mixtral's (D 4,096, F 14,336, 8
   experts, top 2) and Moonlight's (D 2,048, F 1,408, 64 experts, top 6)
   widths, one token and a prefill of 1,024 / 4,096 (and Mixtral's 256,
   on the gemv tiles), within ``MOE_TOL``
   of the largest output, each case's route (``gemv`` or ``tiled``)
   counted, timed like the others, its bound the chosen experts' weight
   bytes once or the routed flops (``moe_experts_cases``,
   ``run_moe_case``);
4. run the port's serve path (``repro_torch.launch.serve.main``) for
   gemma3-1b at full width: 3 nodes, a seed packed on node0, two children
   forked over the modelled RDMA network, 4 requests and the
   copy-on-write fork demo.  Every kernel's launch count must be > 0,
   the four copy kernels must have gone through the bulk-copy kernel,
   every child's parameters must equal the seed's,
   and every request's paged-engine logits must be close to the non-paged
   model's on the same card; the pages each kernel moved and the route
   counts are printed;
4b. the decode step as a CUDA graph (``decode_graph_phase``): tiny dense
   GQA, MoE and latent configs served on the card and on the CPU, lone
   requests on fresh engines and a batch of a request and two children
   forked mid-column: equal tokens, logits within 1e-5, equal counters,
   one capture per request and frames tensor and a replay per step, the
   attention kernel launched once a layer and step; a profiled trace of 6
   replayed steps shows it once a layer and step and one host-to-device
   copy a step;
5. the serverless platform for gemma3-1b at full width: four nodes, one
   ``Coordinator(seed_replicas=2)``.  A function whose behaviour
   materializes its instance and answers one prompt through the
   ``ServingEngine`` is invoked three times with ``policy="fork"``: the
   first coldstarts and becomes a sharded seed (its second replica made
   by an eager fork), the next two fork children whose VMAs are routed
   across both replicas.  Every child's parameters must equal the seed's,
   its tokens the seed's tokens, and both replica parents must have
   served pages.  Then one ``StragglerMonitor.mitigate`` backup fork, and
   the FINRA workflow (``launch/finra``'s functions, a 6 MB market from
   numpy seed 0, 8 audit rules) by fork and by message: equal results,
   each a numpy count of the market, and every audit child faulted in
   the market's pages only.  All four copy kernels must have launched,
   page_gather, page_gather_runs and cow_scatter through the bulk-copy
   kernel;
5b. the last two entry points (*examples*), each through its own reset
   of the counts: ``launch.quickstart.run`` for gemma3-1b at full width
   (a seed on one node remote-forked to a second, materialized, and 8
   tokens served from parent and child): the child's tokens equal to the
   parent's, every seed page faulted over RDMA, all five kernels
   launched and the four copy kernels by a bulk route; then
   ``launch.finra.run`` (gemma3-1b, 8 rules, a 6 MB market), each
   transfer on a fresh 4-node cluster, held as in phase 5, the four copy
   kernels launched, each by a bulk route;
5c. the wire payload through page-locked host memory (*pinned
   staging*): a gemma3-1b seed at full width on one device-pool node,
   forked onto two more in turn with ``repro_torch.tracing`` on: each
   child bit-equal to the seed, and every byte staged through the host
   (``stage.*``) staged through page-locked memory (``pinned.*``, 100%).
   One line: each fork's download and upload rate and the pinned host
   memory the caching host allocator holds;
6. trace replay on pools on the card: Figure 20's spike (10,050
   invocations, 64 nodes, 4 KiB pages) under ``ForkOnDemand`` and
   ``KeepWarm``, whose event-log digests must equal ``BENCH_spikes.json``'s
   ``mitosis`` and ``caching`` (the ``mitosis`` row also on host pools,
   timed beside it); Figure 22's targeted crash of a seed parent (1,608
   invocations, 32 nodes), whose digest must equal ``BENCH_faults.json``'s
   ``crash``; then one crash plan on a small cluster,
   replayed on the card and on host pools, with equal summary digests.
   Copy kernels must have launched, each by a bulk route;
7. the model families (*models*): moonshot-v1-16b-a3b at full width, cut
   to 4 of its 48 layers, through the serve driver (seed on node0, one
   child on node1, 4 requests and the fork demo): the child bit-equal to
   the seed (its 2.95 GB expert leaves included), each request's paged
   logits close to the model's, the fork demo's close to the model's on
   the same batches, all five kernels launched and page_gather's
   device-table route taken; then zamba2-2.7b and xlstm-1.3b whole, each
   packed, forked to one child and run for a 6-token prompt and 8 greedy
   decode steps on seed and child: equal tokens and logits, bit for bit,
   decode close to prefill, the paged engine refusing them.  Each model
   resets the counts and prints a ``[smoke] models:`` line;
8. training (*train*), with TF32 still off: (a) gemma3-1b whole trains
   4 steps of 4 x 2048 tokens through ``launch/train`` (2 microbatches,
   full remat, the chunked window and global attention paths): every
   loss finite, the last below the first; step time, tokens/s, peak
   memory and the share of the fp32 peak are printed.  (b) gemma3-1b at
   full width cut to one window and one global layer takes one step on
   the card and one on the CPU from the same weights and tokens: loss and
   gnorm within ``STEP_TOL``, params within the bound ``train_vs_cpu``
   states.  (c) gemma3-1b takes 2 steps, then a joining worker
   remote-forks its training state (params, Adam ``m`` and ``v``, ~12 GB;
   registers ``step`` and ``count``) from the donor's device pool: bit
   for bit, and step 3 on donor and joiner gives the same loss, bit for
   bit.  (d) train-100m: 4 steps straight against 2, a checkpoint, a
   restore and 2 more, within ``RESTART_TOL``; the checkpoint's bytes and
   save and load times beside a fork of the same state.  The four copy
   kernels must have launched, each by a bulk route;
9. sharded data-parallel training (*distributed*): ``launch/elastic``
   (``--check``) spawns 4 ranks, processes that share the card over gloo.
   train-100m at full width, fp32, global batch 8 x 512, 12 steps: dp=2
   (params and AdamW state sharded by ``param_pspec``) for steps 0-3, a
   checkpoint and a "crash", a restart and steps 4-7, a worker's join by
   remote fork, then dp=4 for steps 8-11.  (a) steps 0 and 1 on 2 ranks,
   each against one rank's step from the same state and tokens (lr is 0
   at step 0, so step 1 holds the sharded AdamW update): loss and gnorm
   within ``STEP_TOL``, params within ``train_vs_cpu``'s bound, AdamW
   ``m`` (its gradient part) within the CPU parity tests' gradient
   tolerance;
   (b) the restored state equal to the saved one, bit for bit, on every
   rank; (c) the joiner's state and registers equal to the donor's, and
   the fork's pages those of phase 8(d)'s fork of the same state; (d)
   step 8 from the joiner's and from the donor's state: losses bit-equal,
   params equal but for ``embed/tok`` within ``2 lr``; (e) every loss
   finite, the last below the first; (f) the four copy kernels launched
   (in rank 0, which forks), each by a bulk route.  One
   ``[smoke] distributed:`` line: the collectives gloo takes on CUDA
   tensors, step times, per-rank state bytes and peak memory, the
   collectives' calls, bytes and seconds, the fork against the checkpoint;
10. tensor parallelism over ``model`` (*tensor_parallel*):
   ``launch/tensor_parallel`` spawns 4 ranks sharing the card over gloo,
   laid out as data=2 x model=2.  (a) gemma3-1b whole, fp32, 2 steps of 4
   x 1024 tokens (2 microbatches, full remat) under ``attn_policy`` "v1"
   (head_dim split: gemma has one KV head) and "qtp" (Q heads split, K/V
   whole), each step against rank 0's single-rank step: loss and gnorm
   within ``STEP_TOL``; after step 1 (params equal at step 0, lr 0),
   params within ``2 lr`` and the far share, AdamW ``m`` within the
   gradient tolerance; (b) the same params through the
   sharded prefill (caches laid out by ``cache_pspec``) and 8 greedy
   decode steps, batch 2, a 64-token prompt: logits within ``LOGIT_TOL``
   of rank 0's ``lm.prefill`` / ``lm.decode_step`` and equal tokens; (c)
   one moonshot MoE layer at full width, 2 x 512 tokens per data shard,
   experts split over ``model``, under ``moe_impl`` "shardmap" and
   "gspmd" at capacity factors 1.25 and 1.0 (where tokens must drop):
   output and gradients within ``TP_TOL`` of the largest magnitude of one
   rank's ``moe_mlp`` on each data shard / on the whole batch; (d) one
   zamba2 Mamba layer at full width with ``mamba_tp``: output, final
   state and gradients likewise; (e) one xlstm-1.3b mLSTM layer at full
   width (d 2048, 4 heads, d_inner 4096), whole heads on each rank:
   output, final state and gradients likewise.  A second spawn of 8
   ranks as data=1 x model=8: (e) the same mLSTM layer, half a head on
   each rank, and (f) musicgen-large's output head and loss at full width
   (D 2048, 4 x 2,048 codebooks, each over 2 ranks): loss and gradients
   likewise.  (g), in the first spawn: gemma3-1b whole at batch 1, which
   does not divide the data axes, so every attention cache is split
   along its sequence axis over ``data`` (and its head_dim over
   ``model``): a cache of long_500k's 524,288 positions seeded up to
   position 262,142 and 4 greedy decode steps, whose writes land on both
   data shards; then a 6,000-token prompt prefilled into a cache of
   8,192 and 4 greedy steps.  Against rank 0's ``lm.decode_step`` /
   ``lm.prefill`` on the whole cache: logits within ``LOGIT_TOL``, equal
   tokens, every rank's cache part equal to the same slice of the
   one-rank cache, bit for bit where no step wrote and within ``TP_TOL``
   of the largest magnitude where one did.  The sharded step, prefill
   and decode gather each layer's params over ``data`` inside the layer
   loop (``fsdp_layer_gather``).  One ``[smoke] tensor_parallel:`` line
   per case (wall times, per-rank state bytes and peak memory, rank 0's
   collectives by kind, errors beside their tolerances) and one line of
   the collectives gloo takes on the data and model groups.  No kernel is
   on this path (the step attends densely, as the reference does): every
   rank's launches are added up and must be 0;
11. the dry-run tools (*dryrun*, ``launch/dryrun``, ``distributed/
   {op_analysis,roofline,inspect_cell}``), on the CPU, meta tensors and a
   fake process group; no kernel launches.  ``HBM_PER_CHIP`` within 1% of
   the card's memory.  (a) The sweep: every arch x train_4k, prefill_32k,
   decode_32k and long_500k (batch 1: the three sub-quadratic archs; the
   reference's rule skips it for the other seven) on the 16x16 and the
   2x16x16 mesh, 66 cells, in parallel processes; every cell must end
   ``ok``; one line per cell (status, trace_s, dominant term,
   step_time_lb, fits_hbm).  (b) The dry run of phase 10's gemma3-1b
   train case (data=2 x model=2, ``v1`` and ``qtp``): its collective
   calls and bytes by kind must equal rank 0's measured step, its dot
   FLOPs rank 1's ``FlopCounterMode`` count, its peak bytes within
   ``DRY_PEAK_TOL`` of rank 1's measured peak.  (c) The roofline of phase
   8(a)'s one-card gemma3-1b step beside its measured step time.  (d)
   ``inspect_cell``'s three tables for gemma3-1b decode_32k.  Roofline
   numbers are model values for the H100's constants, not measurements;
12. print one JSON line with every kernel's numbers, the card line again,
   and last ``{"ok": true, "device": {...}}``.

Launches made in phase 3 and in phase 4's checks are not in the counts:
the counts are reset just before the serve run and read just after it.
Phases 5, each half of 5b, 6, each model of 7, 8, 9, 10 and 11 reset them
before they start and print their own (phase 9 adds in those of rank 0's
process, phase 10 every rank's).
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
# routed experts against the plain version, fp32, as a share of the largest
# output: two sums of up to 14,336 products in other orders, each off by
# ~2^-24 sqrt(n), ~7e-6 of it
MOE_TOL = 3e-5
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
DESIGN = {"page_gather": "bulk-tma", "page_gather_runs": "bulk-tma",
          "cow_scatter": "bulk-tma", "cow_scatter_runs": "bulk-tma",
          "paged_attention": "split-tma"}
BULK = ("bulk-value", "bulk-device")
BULK_KERNELS = ("page_gather", "page_gather_runs", "cow_scatter",
                "cow_scatter_runs")
ONE_SPLIT = ("gemma-decode", "moonshot-decode")   # attention cases, P = 1
COPY_KERNELS = KERNELS[:4]
# phase 7: moonshot at full width, cut to 4 of its 48 layers (all 48 are
# 111 GB in fp32); zamba2 and xlstm whole.  Decode against prefill within
# tests/test_models.py's tolerance for the reference
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_LAYERS = 4
RECURRENT_ARCHS = ("zamba2-2.7b", "xlstm-1.3b")
DECODE_TOL = {"rtol": 2e-2, "atol": 5e-3}
# phase 8: gemma3-1b trains whole; its card step against the CPU's (loss
# and gnorm relative; the share of params further than 1e-5 relative, see
# train_vs_cpu); a checkpoint restart of train-100m against 4 straight steps
TRAIN_ARCH = "gemma3-1b"
RESTART_ARCH = "train-100m"
STEP_TOL = {"loss": 1e-5, "gnorm": 1e-4, "far_share": 1e-3}
RESTART_TOL = 1e-5
# phase 9: train-100m whole on 2, then 4 ranks sharing the card over gloo
DIST_ARGV = ["--steps", "12", "--batch", "8", "--backend", "gloo", "--check"]
# phase 10: a sharded layer's outputs and gradients against one rank's,
# relative to the largest magnitude of each (fp32; summation order)
TP_TOL = 1e-4
# Figure 20's replay (benchmarks/fig20_spikes.py), copied: 4 KiB pages,
# 16 pages of state of which 5% are touched, 30 ms of execution, a 167 ms
# coldstart, containers held for the trace's 60 s minute, 4 seed replicas
# against 4 prewarmed containers, the spike at x50 over 64 nodes
FIG20 = dict(page_elems=1024, state_pages=16, touch=0.05, exec_s=0.030,
             coldstart_s=0.167, hold_s=60.0, budget=4, ttl=60.0, scale=50,
             nodes=64, seed=20260809)
# the replay's copies (replay_cases): one page out of a 16-page VMA, a
# 16-page run and 64 pages over 2 VMAs, as (label, starts, lens)
REPLAY_SHAPES = (("one-page-of-16", [37], [1]), ("16-page-run", [33], [16]),
                 ("64-pages-2-vmas", [101, 170], [32, 32]))
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


def sync_dev(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(torch, dev):
    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)


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


def stage_us(torch, stages: dict, calls: int = 2000,
             rounds: int = 10) -> dict:
    """Host microseconds of each of ``stages`` (name -> fn): the median of
    ``calls`` calls each, made with the card idle, in ``rounds`` rounds
    that take the stages in turn, so that a drift of the host's speed
    reaches every stage alike."""
    times = {k: [] for k in stages}
    for _ in range(rounds):
        for k, fn in stages.items():
            for _ in range(calls // rounds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times[k].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {k: statistics.median(v) * 1e6 for k, v in times.items()}


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
    child's adopt move it as one run).  The models phase's largest, one of
    moonshot's expert leaves (22,528 fp32 pages, 2.95 GB: byte offsets
    past 2^31), follows it the same three ways.  ``limits`` are the
    bulk-copy kernel's by-value capacities."""
    rng = np.random.default_rng(0)
    E, n_emb, n_exp = 32768, 9216, 22528
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
        case("page_gather", "moe-expert-assemble", "float32", n_exp + 64, E,
             np.arange(64, 64 + n_exp), "bulk-device"),
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
        case("page_gather_runs", "moe-expert-read", "float32", n_exp + 64,
             E, ([64], [n_exp]), "bulk-value"),
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
        # into an output of 6.5 rows: the span table built in the launch
        # trims the second run's span and drops the two after it
        case("page_gather_runs", "trimmed-out", "float32", 4096,
             FIG20["page_elems"], ([10, 40, 100, 200], [5, 3, 4, 2]),
             "bulk-value", out_rows=6.5),
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
             ([32], [n_emb]), "bulk-value"),
        case("cow_scatter_runs", "moe-expert-adopt", "float32", n_exp + 64,
             E, ([32], [n_exp]), "bulk-value"),
        case("cow_scatter_runs", "skewed-runs", "bfloat16", 8192, E,
             ([0, 3000, 5000, 7000], [2500, 1, 1999, 900]), "bulk-value"),
        case("cow_scatter_runs", "runs-at-capacity", "bfloat16",
             3 * cap_spans + 3, 4096, runs(cap_spans), "bulk-value"),
        case("cow_scatter_runs", "runs-past-capacity", "bfloat16",
             3 * cap_spans + 6, 4096, runs(cap_spans + 1), "bulk-device"),
        case("cow_scatter_runs", "odd-row", "float32", 256, 1001,
             ([0, 50, 120], [40, 3, 100]), "copy_rows"),
        case("cow_scatter_runs", "misaligned-payload", "float32", 64, 4096,
             ([3, 20], [2, 5]), "copy_rows", misaligned=True),
    ] + replay_cases(case)


def replay_cases(case):
    """The replay phase's copies, for each copy kernel: fp32 pages of
    1,024 elements (4 KiB rows, four to a 16 KB bulk-copy chunk) in a
    pool of ``build_cluster``'s 4,096 frames, with the replay's id shapes: one page out of a
    16-page VMA, a 16-page run and 64 pages over 2 VMAs.  Every table
    starts off a 16 KB boundary."""
    out = []
    for name in COPY_KERNELS:
        for label, starts, lens in REPLAY_SHAPES:
            spec = ((starts, lens) if name.endswith("_runs") else
                    np.concatenate([np.arange(s, s + n)
                                    for s, n in zip(starts, lens)]))
            out.append(case(name, f"replay-{label}", "float32",
                            4096, FIG20["page_elems"],
                            spec, "bulk-value"))
    return out


def replay_host_us(torch):
    """Host microseconds of one call of each copy wrapper and of the
    library calls at the replay's shapes (as :func:`replay_cases`), taken
    in turns by :func:`stage_us`: shape -> call -> us."""
    from repro_torch.kernels.cow_scatter import ops as cs
    from repro_torch.kernels.page_gather import ops as pg
    E, F = FIG20["page_elems"], 4096
    dev = torch.device("cuda", torch.cuda.current_device())
    frames = torch.zeros(F, E, device=dev)
    out = {}
    for label, starts, lens in REPLAY_SHAPES:
        st, ln = np.array(starts, np.int64), np.array(lens, np.int64)
        ids = np.concatenate([np.arange(a, a + b, dtype=np.int32)
                              for a, b in zip(starts, lens)])
        ids_dev = torch.from_numpy(ids.astype(np.int64)).to(dev)
        pages = torch.ones(ids.size, E, device=dev)
        out[label] = stage_us(torch, {
            "page_gather": lambda: pg.page_gather(frames, ids),
            "page_gather_runs": lambda: pg.page_gather_runs(frames, st, ln),
            "cow_scatter": lambda: cs.cow_scatter(frames, ids, pages),
            "cow_scatter_runs": lambda: cs.cow_scatter_runs(frames, st, ln,
                                                            pages),
            "index_select": lambda: frames.index_select(0, ids_dev),
            "index_copy_": lambda: frames.index_copy_(0, ids_dev, pages),
        })
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
                                                     page_gather_ref,
                                                     page_gather_runs_ref)
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
        elif runs and case.get("out_rows"):
            st, ln = (np.asarray(x, np.int64) for x in spec)
            size = int(case["out_rows"] * E)

            def call(backend):
                if backend == "torch":
                    return page_gather_runs_ref(frames, st, ln) \
                        .reshape(-1)[:size]
                return pgk.page_gather_runs(
                    frames, st, ln, int(ln.sum()),
                    out=torch.empty(size, dtype=dtype, device=dev))
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

        lib_ids = ids_dev[:-(-int(case.get("out_rows", n) * E) // E)]

        def library():
            return frames.index_select(0, lib_ids)
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
    nbytes = 2 * int(case.get("out_rows", n) * E) * frames.element_size()
    # a graph keeps every call's output: 3 calls past 4 GiB moved
    reps = 3 if nbytes > (4 << 30) else 10 if nbytes > (256 << 20) else 20
    # device-only times, through the wrapper where the call uploads nothing
    # (a graph cannot capture a copy from pageable host memory, so these
    # show that it does not); the run-table scatter's copy_rows route
    # uploads its tables, so that kernel is timed from tables uploaded
    # beforehand
    if route[0] == "bulk-value" or case.get("device_ids"):
        kern_alone = kern
    elif name == "cow_scatter_runs" and route[0] == "copy_rows":
        from repro_torch.kernels.cow_scatter import kernel as csk
        from repro_torch.kernels.page_gather.plan import run_offsets
        tables = run_offsets(*(np.asarray(x, np.int64) for x in spec), dev)

        def kern_alone():
            return csk.copy_rows_runs(kernel_target, *tables, pages, E)
    else:
        kern_alone = None
    return {"name": name, "case": label, "dtype": case["dtype"],
            "design": DESIGN[name] if route[0] in BULK else "copy_rows",
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
    through its wrapper, beside the whole call and ``index_copy_``.
    ``ids_pointer`` (``ids.ctypes.data``) is how the ids were passed before
    they travelled as ``bytes`` (``tables_to_bytes``)."""
    from repro_torch.kernels import build, bulk_copy, dispatch
    from repro_torch.kernels.cow_scatter import kernel, ops as cs
    from repro_torch.kernels.page_gather.ops import kernel_ids
    E = 32768
    dev = torch.device("cuda", torch.cuda.current_device())
    frames = torch.zeros(64, E, device=dev)
    pages = torch.ones(1, E, device=dev)
    ids = np.array([9], np.int32)
    ids_dev = torch.from_numpy(ids.astype(np.int64)).to(dev)
    isz = frames.element_size()
    fn = bulk_copy.ids_entry("bulk_scatter_ids")
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
        "tables_to_bytes": lambda: ids.tobytes(),
        "c_call_and_launch": lambda: fn(fp, pp, ids.tobytes(), None, 1,
                                        E * isz, 64 * E * isz, stream),
        "count_launch": lambda: dispatch.count_launch(
            "cow_scatter", pages=1, route="bulk-value"),
        "whole_wrapper": lambda: cs.cow_scatter(frames, ids, pages),
        "index_copy_": lambda: frames.index_copy_(0, ids_dev, pages),
    }
    return stage_us(torch, stages)


def host_stages_runs(torch):
    """Host microseconds of each stage of ``cow_scatter_runs`` through its
    wrapper at the replay's 16-page run (fp32 pages of 1,024 elements, a
    pool of 4,096 frames), beside the whole call, ``cow_scatter`` of the
    same 16 pages and ``index_copy_``.  ``numpy_plan`` is what building
    the span table in numpy (``plan.scatter_spans``) would add: the
    by-value route builds it in C instead."""
    from repro_torch.kernels import build, bulk_copy, dispatch
    from repro_torch.kernels.cow_scatter import kernel, ops as cs
    from repro_torch.kernels.page_gather.ops import run_table
    from repro_torch.kernels.page_gather.plan import scatter_spans
    E, F = FIG20["page_elems"], 4096
    dev = torch.device("cuda", torch.cuda.current_device())
    frames = torch.zeros(F, E, device=dev)
    pages = torch.ones(16, E, device=dev)
    starts, lens = np.array([33], np.int64), np.array([16], np.int64)
    ids = np.arange(33, 49, dtype=np.int32)
    ids_dev = torch.from_numpy(ids.astype(np.int64)).to(dev)
    isz = frames.element_size()
    row, limit = E * isz, frames.numel() * isz
    fn = bulk_copy.runs_entry("bulk_scatter_runs")
    fp, pp = frames.data_ptr(), pages.data_ptr()
    stream = build.stream(dev)
    cap = bulk_copy.limits()["spans"]
    stages = {
        "run_table": lambda: run_table(starts, lens, F),
        "resolve_backend": lambda: dispatch.resolve_backend(
            "auto", kernel_name="cow_scatter", device=dev),
        "pages_sum": lambda: int(lens.sum()),
        "payload": lambda: cs._payload(pages, 16, frames, frames.dtype, E),
        "check_args": lambda: kernel._check_args(frames, pages, E),
        "runs_route": lambda: bulk_copy.runs_route(1, row, limit, cap, fp,
                                                   pp),
        "stream": lambda: build.stream(dev),
        "tables_to_bytes": lambda: (starts.tobytes(), lens.tobytes()),
        "c_call_and_launch": lambda: fn(fp, pp, starts.tobytes(),
                                        lens.tobytes(), 1, row, limit,
                                        stream),
        "count_launch": lambda: dispatch.count_launch(
            "cow_scatter_runs", pages=16, route="bulk-value"),
        "numpy_plan": lambda: bulk_copy.span_table(
            *scatter_spans(starts, lens, row, limit)),
        "whole_wrapper": lambda: cs.cow_scatter_runs(frames, starts, lens,
                                                     pages),
        "cow_scatter_whole_wrapper": lambda: cs.cow_scatter(frames, ids,
                                                            pages),
        "index_copy_": lambda: frames.index_copy_(0, ids_dev, pages),
    }
    return stage_us(torch, stages)


def _pointer_entry(lib: str, entry: str, argtypes):
    """A second ctypes handle on a C entry, with its own argument types
    (``build.function``'s handle keeps the wrapper's): the gathers' old
    path passed its host tables by ``ndarray.ctypes.data``."""
    import ctypes
    from repro_torch.kernels import build
    fn = build.library(lib)[entry]
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def _path_sums(r, common, old, new):
    """The sums of the old and the new path's stages, beside the stages."""
    r["old_path"] = sum(r[k] for k in common + old)
    r["new_path"] = sum(r[k] for k in common + new)
    return r


def host_stages_gather(torch):
    """Host microseconds of each stage of ``page_gather`` through its
    wrapper at the replay's commonest gather, one fp32 page of 1,024
    elements from a pool of 4,096 frames, beside the whole call and
    ``index_select``.  Reference stages of the path before this one:
    ``numpy_kernel_ids`` (the range check as one numpy reduction),
    ``old_alloc_out`` (``torch.empty`` with the dtype and device as
    keywords), ``ids_pointer`` (``ids.ctypes.data``) and
    ``old_c_call_and_launch`` (the C call with the ids by pointer).  ``old_path`` and ``new_path``
    sum each path's stages."""
    import ctypes
    from repro_torch.kernels import build, bulk_copy, dispatch
    from repro_torch.kernels.page_gather import kernel, ops as pg
    E, F = FIG20["page_elems"], 4096
    dev = torch.device("cuda", torch.cuda.current_device())
    frames = torch.zeros(F, E, device=dev)
    out = torch.empty((1, E), device=dev)
    ids = np.array([37], np.int32)
    ids_dev = torch.from_numpy(ids.astype(np.int64)).to(dev)
    row = limit = E * frames.element_size()
    fn = bulk_copy.ids_entry("bulk_gather_ids")
    P, L = ctypes.c_void_p, ctypes.c_int64
    old_fn = _pointer_entry("bulk_copy", "bulk_gather_ids",
                            (P, P, P, P, L, L, L, P))
    op, fp = out.data_ptr(), frames.data_ptr()
    stream = build.stream(dev)
    cap = bulk_copy.limits()["ids"]

    def numpy_kernel_ids():
        if ids.size and ids.view(np.uint32).max() >= F:
            raise IndexError("page ids out of range")
        return ids
    stages = {
        "kernel_ids": lambda: pg.kernel_ids(ids, F, dev),
        "resolve_backend": lambda: dispatch.resolve_backend(
            "auto", kernel_name="page_gather", device=dev),
        "alloc_out": lambda: frames.new_empty((1, E)),
        "check_args": lambda: kernel._check_args(frames, out),
        "ids_route": lambda: bulk_copy.ids_route(ids, row, cap, op, fp),
        "stream": lambda: build.stream(dev),
        "tables_to_bytes": lambda: ids.tobytes(),
        "c_call_and_launch": lambda: fn(op, fp, ids.tobytes(), None, 1,
                                        row, limit, stream),
        "count_launch": lambda: dispatch.count_launch(
            "page_gather", pages=1, route="bulk-value"),
        "numpy_kernel_ids": numpy_kernel_ids,
        "old_alloc_out": lambda: torch.empty((1, E), dtype=frames.dtype,
                                             device=frames.device),
        "ids_pointer": lambda: ids.ctypes.data,
        "old_c_call_and_launch": lambda: old_fn(op, fp, ids.ctypes.data,
                                                None, 1, row, limit, stream),
        "whole_wrapper": lambda: pg.page_gather(frames, ids),
        "index_select": lambda: frames.index_select(0, ids_dev),
    }
    r = stage_us(torch, stages)
    return _path_sums(r, ["resolve_backend", "check_args", "ids_route",
                          "stream", "count_launch"],
                      ["numpy_kernel_ids", "old_alloc_out",
                       "old_c_call_and_launch"],
                      ["kernel_ids", "alloc_out", "c_call_and_launch"])


def host_stages_gather_runs(torch):
    """Host microseconds of each stage of ``page_gather_runs`` through its
    wrapper at the replay's 16-page run (fp32 pages of 1,024 elements, a
    pool of 4,096 frames), beside the whole call, ``cow_scatter_runs`` of
    the same run and ``index_select``.  Reference stages of the path
    before this one: ``pages_sum`` (the output's rows as a numpy sum),
    ``old_alloc_out`` (as in :func:`host_stages_gather`), ``numpy_plan`` (``span_table(*run_spans(...))``), ``table_pointer``
    (``table.ctypes.data``) and ``old_c_call_and_launch`` (the C call of
    ``bulk_copy_spans`` with that pointer).  ``old_path`` and ``new_path``
    sum each path's stages."""
    import ctypes
    from repro_torch.kernels import build, bulk_copy, dispatch
    from repro_torch.kernels.cow_scatter import ops as cs
    from repro_torch.kernels.page_gather import kernel, ops as pg
    from repro_torch.kernels.page_gather.plan import run_spans
    E, F = FIG20["page_elems"], 4096
    dev = torch.device("cuda", torch.cuda.current_device())
    frames = torch.zeros(F, E, device=dev)
    out = torch.empty((16, E), device=dev)
    pages = torch.ones(16, E, device=dev)
    starts, lens = np.array([33], np.int64), np.array([16], np.int64)
    ids_dev = torch.arange(33, 49, device=dev)
    row = E * frames.element_size()
    limit = 16 * row
    fn = bulk_copy.runs_entry("bulk_gather_runs")
    P = ctypes.c_void_p
    old_fn = _pointer_entry("bulk_copy", "bulk_copy_spans",
                            (P, P, P, P, ctypes.c_int, P))
    op, fp = out.data_ptr(), frames.data_ptr()
    stream = build.stream(dev)
    cap = bulk_copy.limits()["spans"]
    table = bulk_copy.span_table(*run_spans(starts, lens, row, limit))
    stages = {
        "run_table": lambda: pg.run_table(starts, lens, F),
        "resolve_backend": lambda: dispatch.resolve_backend(
            "auto", kernel_name="page_gather", device=dev),
        "alloc_out": lambda: frames.new_empty((16, E)),
        "check_args": lambda: kernel._check_args(frames, out),
        "runs_route": lambda: bulk_copy.runs_route(1, row, limit, cap, op,
                                                   fp),
        "stream": lambda: build.stream(dev),
        "tables_to_bytes": lambda: (starts.tobytes(), lens.tobytes()),
        "c_call_and_launch": lambda: fn(op, fp, starts.tobytes(),
                                        lens.tobytes(), 1, row, limit,
                                        stream),
        "count_launch": lambda: dispatch.count_launch(
            "page_gather_runs", pages=16, route="bulk-value"),
        "pages_sum": lambda: int(lens.sum()),
        "old_alloc_out": lambda: torch.empty((16, E), dtype=frames.dtype,
                                             device=frames.device),
        "numpy_plan": lambda: bulk_copy.span_table(
            *run_spans(starts, lens, row, limit)),
        "table_pointer": lambda: table.ctypes.data,
        "old_c_call_and_launch": lambda: old_fn(op, fp, table.ctypes.data,
                                                None, 1, stream),
        "whole_wrapper": lambda: pg.page_gather_runs(frames, starts, lens),
        "cow_scatter_runs_whole_wrapper": lambda: cs.cow_scatter_runs(
            frames, starts, lens, pages),
        "index_select": lambda: frames.index_select(0, ids_dev),
    }
    r = stage_us(torch, stages)
    return _path_sums(r, ["run_table", "resolve_backend", "check_args",
                          "stream", "count_launch"],
                      ["pages_sum", "old_alloc_out", "numpy_plan",
                       "old_c_call_and_launch"],
                      ["alloc_out", "runs_route", "c_call_and_launch"])


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
    split), the second the models phase's at moonshot's (MHA: 16 kv heads
    of one query head each, hd 128, one split as well); then a long
    window batch and one long sequence with no window (split across the
    SMs), other head shapes (rows of 99 elements take the plain-load
    route), and empty ranges (starts == lengths, and a
    zero length) over a wide table, split too, where the output is the
    mean of V over every slot of the sequence's table."""
    return [
        ("gemma-decode", 4, 1, 4, 256, 16, [8, 9, 9, 9], 512, 1),
        ("moonshot-decode", 4, 16, 1, 128, 16, [8, 9, 9, 9], None, 1),
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
    if (label in ONE_SPLIT) != (splits == 1):
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


def _device_us(evt) -> float:
    """Device microseconds of a profiler average, by whichever name this
    PyTorch gives the field."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def attention_kernel_split(torch, reps: int = 20) -> dict:
    """Device microseconds per call of each of paged_attention's two
    kernels (the split kernel and the combine), from ``torch.profiler``,
    on one fp32 sequence of 8,192 tokens at gemma3-1b's head shape."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.paged_attention import ops as pa
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


def latent_attention_cases():
    """(label, lengths per sequence) at the moonlight cell's shapes: 16
    heads, latent rows of 576 floats (512 of latent, 64 of rope key),
    values of 512, pages of 16 tokens, fp32: one sequence of 256, 1,024
    and 4,128 tokens (the cell's batch of one, its shortest, median and
    longest contexts), a batch of three, and a zero length beside one
    token (zeros)."""
    return [("moonlight-256", [256]), ("moonlight-1024", [1024]),
            ("moonlight-4128", [4128]), ("batch-of-3", [300, 17, 2049]),
            ("empty-and-one", [0, 1])]


def run_latent_case(torch, case):
    """The latent kernel against its plain version on one case of
    ``latent_attention_cases``, with its launch counted, its split count,
    its times and its bound (every row in range read once, the queries
    read and the outputs written; 2 * H * (R + dv) flops a token)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.paged_attention import kernel, latent, plan
    label, lens = case
    H, R, dv, Tp = 16, 576, 512, 16
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    B = len(lens)
    P = max(-(-n // Tp) for n in lens) + 1           # one padded column
    F = B * P + 8
    q = torch.randn(B, H, R, device=dev)
    pool = torch.randn(F, Tp, R, device=dev)
    pt = torch.from_numpy(rng.permutation(F)[:B * P].reshape(B, P)
                          .astype(np.int32)).to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

    def call(backend):
        return latent.latent_attention(q, pool, pt, lengths, dv=dv,
                                       scale=192 ** -0.5, backend=backend)
    before = dispatch.launches["latent_attention"]
    got = call("kernel")
    if dispatch.launches["latent_attention"] != before + 1:
        raise AssertionError(f"latent_attention/{label}: launch not counted")
    want = call("torch")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = ATTN_TOL["float32"]
    if not err < tol:
        raise AssertionError(f"latent_attention/{label}: max abs err {err} "
                             f">= {tol}")
    if lens[0] == 0 and got[0].any():
        raise AssertionError(f"latent_attention/{label}: an empty sequence "
                             f"is not zero")
    splits, _ = plan.split_plan(B, 1, P, kernel.sm_count(dev))
    tokens = sum(lens)
    nbytes = latent.latent_bytes(lens, H, R, dv) + 4 * (B * P + B)
    flops = 2 * H * (R + dv) * tokens
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
    return {"name": "latent_attention", "case": label, "dtype": "float32",
            "B": B, "H": H, "R": R, "dv": dv, "P": P, "splits": splits,
            "tokens": tokens, "max_abs_err": err, "tol": tol,
            "ms": time_ms(torch, lambda: call("kernel")),
            "plain_ms": time_ms(torch, lambda: call("torch")),
            "library_ms": None,
            "device_ms": device_ms(torch, lambda: call("kernel"), 20),
            "host_us": host_us(torch, lambda: call("kernel")),
            "bound_ms": bound_s * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / FP32_FLOPS_PER_S else "operations"),
            "bytes": nbytes, "flops": flops}


def moe_experts_cases():
    """(label, D, F, experts, top k, tokens, route): Mixtral's and
    Moonlight's expert widths (the benchmark's two MoE configurations), a
    decode step of one token and a prefill (Mixtral 1,024 tokens,
    Moonlight 4,096: each cell's longest prompt); and Mixtral's cell's
    median prompt, 256 tokens, which the gemv tiles take."""
    return [("mixtral-decode", 4096, 14336, 8, 2, 1, "gemv"),
            ("mixtral-prefill-256", 4096, 14336, 8, 2, 256, "gemv"),
            ("mixtral-prefill", 4096, 14336, 8, 2, 1024, "tiled"),
            ("moonlight-decode", 2048, 1408, 64, 6, 1, "gemv"),
            ("moonlight-prefill", 2048, 1408, 64, 6, 4096, "tiled")]


def run_moe_case(torch, case):
    """The routed experts kernel against its plain version on one case of
    ``moe_experts_cases``: each token's top k of random scores, the rows
    sorted by expert as ``models/moe.py`` sorts them; the launch counted
    under its route; times and the bound (the chosen experts' weights
    read once with the rows in and out, or the routed flops at the fp32
    peak, whichever is longer)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import moe_experts as mx
    from repro_torch.models.moe import expert_counts
    label, D, Fd, E, K, T, route = case
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(3)
    w = [torch.randn(E, *s, generator=g, device=dev) * s[0] ** -0.5
         for s in ((D, Fd), (D, Fd), (Fd, D))]
    x = torch.randn(T, D, generator=g, device=dev)
    expert = torch.rand(T, E, generator=g, device=dev).topk(K, -1).indices
    flat = expert.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = expert_counts(flat, E)
    starts = torch.cumsum(counts, 0) - counts
    h = x[torch.arange(T, device=dev).repeat_interleave(K)[order]]

    def call(backend):
        return mx.moe_experts(h, counts, starts, *w, backend=backend)
    key = f"moe_experts.{route}"
    before = dispatch.routes[key]
    got = call("kernel")
    if dispatch.routes[key] != before + 1:
        raise AssertionError(f"moe_experts/{label}: no {key} launch counted")
    want = call("torch")
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not err <= MOE_TOL * scale:
        raise AssertionError(f"moe_experts/{label}: max abs err {err} > "
                             f"{MOE_TOL} x {scale}")
    if not torch.equal(call("kernel"), got):
        raise AssertionError(f"moe_experts/{label}: two calls differ")
    nbytes = mx.expert_bytes(counts.tolist(), D, Fd, True)
    flops = mx.expert_flops(T * K, D, Fd, True)
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
    r = {"name": "moe_experts", "case": label, "dtype": "float32",
         "route": route, "D": D, "F": Fd, "E": E, "K": K, "tokens": T,
         "experts_chosen": int((counts > 0).sum()), "max_abs_err": err,
         "scale": scale, "tol": MOE_TOL * scale,
         "ms": time_ms(torch, lambda: call("kernel")),
         "plain_ms": time_ms(torch, lambda: call("torch"), reps=5),
         "library_ms": None,
         "device_ms": device_ms(torch, lambda: call("kernel"), 10),
         "host_us": host_us(torch, lambda: call("kernel")),
         "bound_ms": bound_s * 1e3,
         "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                      >= flops / FP32_FLOPS_PER_S else "operations"),
         "bytes": nbytes, "flops": flops}
    r["bound_share"] = r["bound_ms"] / r["device_ms"]
    del w, h, got, want
    torch.cuda.empty_cache()
    return r


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


def check_step(torch, got, want, token, where, ties) -> float:
    """One step's logits against the reference's: returns the max abs
    error.  A token other than the reference's argmax fails unless the
    reference's top-2 gap is under LOGIT_TOL (a near-tie, appended to
    ``ties`` with ``where``)."""
    top2 = torch.topk(want, 2).values
    gap = float(top2[0] - top2[1])
    if int(torch.argmax(want)) != token:
        if gap >= LOGIT_TOL:
            raise AssertionError(f"{where}: token {token} != reference "
                                 f"{int(torch.argmax(want))} (top-2 gap "
                                 f"{gap})")
        ties.append(dict(where, gap=gap))
    return float((got - want).abs().max())


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
        err = max(err, check_step(torch, got, want, req.out_tokens[step],
                                  {"req": req.req_id, "step": step}, ties))
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
    for k in BULK_KERNELS:
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
# phase 4b: the paged decode step as a CUDA graph
# ---------------------------------------------------------------------------

GRAPH_TOL = 1e-5           # a card engine's logits against the CPU engine's
GRAPH_TP = 16              # page tokens, as the benchmark's cells
GRAPH_PROFILED = 6         # replayed steps in the profiled trace
GRAPH_ENTRY = {"gqa": "paged_attention", "moe": "paged_attention",
               "latent": "latent_attention"}


def graph_cfgs():
    """Tiny configs of the three kinds the step body serves: dense GQA
    (micro-hello at smoke size), GQA with experts (moonshot at smoke
    size), latent attention with sigmoid-routed and shared experts
    (Moonlight's blocks at small widths, as tests/test_torch_moonlight.py
    builds them)."""
    from repro_torch.configs.base import (GroupSpec, MLASpec, MoESpec,
                                          get_arch, reduce_for_smoke)
    small = lambda a: dataclasses.replace(reduce_for_smoke(get_arch(a)),
                                          compute_dtype="float32")
    attn = MLASpec(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                   v_head_dim=16)
    sparse = dataclasses.replace(attn, moe=MoESpec(routed_scale=2.446,
                                                   shared_d_ff=48))
    latent = dataclasses.replace(
        get_arch("moonlight-16b-a3b"), name="moonlight-tiny", d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=96, vocab_size=256,
        groups=(GroupSpec(unit=(attn,), repeat=1),
                GroupSpec(unit=(sparse,), repeat=2)),
        moe_experts=8, moe_topk=3, moe_d_ff=24, compute_dtype="float32")
    return {"gqa": small("micro-hello"), "moe": small(MOE_ARCH),
            "latent": latent}


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def graph_serve(torch, cfg, params, dev, drive):
    """``drive(engine)`` on a fresh engine with the tracer on: (the
    engine, its counters, its spans' names, the kernel launches and routes
    it added, the frames tensors its steps used)."""
    from collections import Counter
    from repro_torch import tracing
    from repro_torch.kernels import dispatch
    from repro_torch.serving.engine import ServingEngine
    launches, routes = Counter(dispatch.launches), Counter(dispatch.routes)
    tracing.reset()
    tracing.enable()
    eng = ServingEngine(cfg, params, page_tokens=GRAPH_TP, device=dev,
                        keep_logits=True)
    frames = set()
    step = eng.step

    def stepped():
        out = step()
        frames.add(eng.kv.frames_view().data_ptr())
        return out
    eng.step = stepped
    try:
        drive(eng)
    finally:
        tracing.disable()
        del eng.step                       # the engine, not a cycle, again
    snap = tracing.snapshot()
    return (eng, dict(snap["counters"]), [s.name for s in snap["spans"]],
            Counter(dispatch.launches) - launches,
            Counter(dispatch.routes) - routes, len(frames))


def graph_pair(torch, cfg, params, dev, drive, what):
    """``drive`` on an engine on ``dev`` and on one on the CPU: tokens
    equal, logits within GRAPH_TOL, counters equal but the graph's own;
    returns the card side's record and the largest logit error.  The CPU
    side's expert layers take the routed path too, through the kernel's
    plain version, as the card's do."""
    from repro_torch.models import moe
    cpu = torch.device("cpu")
    got = graph_serve(torch, cfg, map_tree(lambda t: t.to(dev), params),
                      dev, drive)
    with moe.routed_on("cpu"):
        want = graph_serve(torch, cfg, params, cpu, drive)
    err = 0.0
    for rid, r in want[0].requests.items():
        g = got[0].requests[rid]
        if g.out_tokens != r.out_tokens:
            raise AssertionError(f"{what}: request {rid} tokens "
                                 f"{g.out_tokens} != CPU {r.out_tokens}")
        for a, b in zip(g.logits, r.logits):
            err = max(err, float((a - b).abs().max()))
    if not err <= GRAPH_TOL:
        raise AssertionError(f"{what}: logits max abs err {err} > "
                             f"{GRAPH_TOL}")
    mine = lambda c: {k: v for k, v in c.items()
                      if not k.startswith("serve.graph_")}
    if mine(got[1]) != mine(want[1]):
        raise AssertionError(f"{what}: counters {got[1]} != CPU {want[1]}")
    return got, err


def graph_profile(torch, cfg, params, entry):
    """Device events of GRAPH_PROFILED replayed steps of one request:
    (launches of ``entry``'s kernel, host-to-device copies)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import ServingEngine
    dev = params["embed"]["tok"].device
    eng = ServingEngine(cfg, params, page_tokens=GRAPH_TP, device=dev)
    eng.submit(list(range(1, 41)), max_tokens=GRAPH_PROFILED + 3)
    eng.step()                         # prefill, capture, first replay
    eng.step()
    sync_dev(torch, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(GRAPH_PROFILED):
            eng.step()
        sync_dev(torch, dev)
    names = [e.name for e in prof.events()
             if str(e.device_type).endswith("CUDA")]
    return (sum(entry + "_kernel" in n for n in names),
            sum("HtoD" in n for n in names))


def decode_graph_phase(torch, dev, smoke=False) -> dict:
    """Each tiny config served on ``dev`` against the CPU engine: two lone
    requests on fresh engines, as the benchmark serves them (a prompt of 2
    Tp - 1 tokens, whose decode crosses a page column, and one of 37),
    each one capture per frames tensor its steps used and a replay per
    step, the kernel launched once a layer and step; then a batch of
    three on one engine, a request and two children forked from it
    mid-column (copy-on-write).  On a CUDA device, a profiled trace of
    replayed steps names the attention kernel once a layer and step and
    shows one host-to-device copy a step.  ``smoke`` is unused (the
    configs are tiny); the CPU rehearsal stands a capture in."""
    out = {}
    for kind, cfg in graph_cfgs().items():
        from repro_torch.models import lm
        params = lm.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
        entry = GRAPH_ENTRY[kind]
        layers = cfg.num_layers
        row = {"layers": layers, "requests": []}
        for n_prompt in (2 * GRAPH_TP - 1, 37):
            def lone(eng, n=n_prompt):
                eng.submit([(7 * i + 3) % cfg.vocab_size for i in range(n)],
                           max_tokens=9)
                eng.run_to_completion()
            (eng, counters, spans, launches, _, frames), err = graph_pair(
                torch, cfg, params, dev, lone, f"{kind} prompt {n_prompt}")
            steps = spans.count("serve.decode")
            got = (counters.get("serve.graph_captures", 0),
                   counters.get("serve.graph_replays", 0))
            if got != (frames, steps) or steps != 8:
                raise AssertionError(f"{kind}: captures, replays {got}; "
                                     f"frames tensors {frames}, steps "
                                     f"{steps}")
            if dev.type == "cuda" and launches[entry] != layers * steps:
                raise AssertionError(f"{kind}: {launches[entry]} {entry} "
                                     f"launches, {layers} x {steps} steps")
            row["requests"].append({"prompt": n_prompt, "captures": got[0],
                                    "replays": got[1], "launches":
                                    launches[entry], "max_abs_err": err})

        def demo(eng):
            r0 = eng.submit([(5 * i + 1) % cfg.vocab_size
                             for i in range(21)], max_tokens=8)
            eng.step()
            eng.step()
            for _ in range(2):
                eng.fork_request(r0, max_tokens=6)
            eng.run_to_completion()
        (eng, counters, spans, _, _, _), err = graph_pair(
            torch, cfg, params, dev, demo, f"{kind} fork demo")
        if counters.get("serve.graph_replays", 0) != \
                spans.count("serve.decode"):
            raise AssertionError(f"{kind} fork demo: {counters}")
        row["demo"] = {"captures": counters.get("serve.graph_captures", 0),
                       "replays": counters.get("serve.graph_replays", 0),
                       "max_abs_err": err}
        if dev.type == "cuda":
            kernels, copies = graph_profile(
                torch, cfg, map_tree(lambda t: t.to(dev), params), entry)
            if (kernels, copies) != (layers * GRAPH_PROFILED,
                                     GRAPH_PROFILED):
                raise AssertionError(
                    f"{kind}: {kernels} {entry} kernels and {copies} "
                    f"host-to-device copies in {GRAPH_PROFILED} replayed "
                    f"steps of {layers} layers")
            row["profiled"] = {"steps": GRAPH_PROFILED, "kernels": kernels,
                               "htod_copies": copies}
        print(f"[smoke] decode graph {kind}: " + json.dumps(row))
        out[kind] = row
    return out


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
    from repro_torch.launch import finra as finra_app
    from repro_torch.models import lm
    from repro_torch.net import Network
    from repro_torch.placement import ShardedSeed
    from repro_torch.platform.coordinator import Coordinator, FunctionDef
    from repro_torch.platform.node import NodeRuntime
    from repro_torch.platform.straggler import StragglerMonitor
    from repro_torch.serving.engine import ServingEngine

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
        sync_dev(torch, dev)
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
        sync_dev(torch, dev)
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
    sync_dev(torch, dev)
    straggler = {"straggler": slow.parent_node, "backup_on": spare.node_id,
                 "backup_wall_s": time.perf_counter() - t0,
                 "pages_rdma": backup.stats["pages_rdma"]}
    mon.resolve(slow.parent_node, winner=spare.node_id)
    backup.free()
    print("[smoke] platform straggler " + json.dumps(straggler))

    # FINRA: fetch pre-materializes the market, the audit rules read it
    market = finra_app.make_market(market_mb)
    finra = {}
    for transfer in finra_app.TRANSFERS:
        wf = finra_app.register_finra(coord, cfg, params, market, transfer,
                                      dev)
        finra[transfer] = finra_app.run_transfer(coord, wf, transfer,
                                                 n_rules, dev)
    market_pages = check_finra(finra, market, n_rules,
                               nodes[0].pool.page_elems)
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


def check_finra(finra, market, n_rules, page_elems) -> int:
    """Hold FINRA's two transfers (``launch.finra.run_transfer`` records)
    to each other and to the market: the same violations, a numpy count
    of ``market``, on every rule; every fork audit child faulted the
    market's pages (plus one of prefetch), never the model's; only the
    message path serialized.  Returns the market's pages."""
    from repro_torch.launch.finra import THRESHOLD
    want = [int((np.abs(market) > THRESHOLD).sum())] * n_rules
    for transfer, r in finra.items():
        if r["violations"] != want:
            raise AssertionError(f"FINRA {transfer}: violations "
                                 f"{r['violations']}, numpy counts {want}")
    pages = -(-market.size // page_elems)
    for p in finra["fork"]["audit_pages_rdma"]:
        if not pages <= p <= pages + 1:
            raise AssertionError(f"an audit child faulted {p} pages, not the "
                                 f"market's {pages} (+1 prefetch)")
    if finra["fork"]["msg_bytes"] or not finra["message"]["msg_bytes"]:
        raise AssertionError(f"FINRA message bytes: {finra}")
    return pages


def quickstart_example(dev, arch="gemma3-1b") -> dict:
    """Phase 5b, first half: ``launch.quickstart.run`` on ``dev``; the
    child's tokens must equal the parent's (``run`` raises otherwise) and
    it must have faulted every page of the seed."""
    from repro_torch.launch import quickstart
    rec = vars(quickstart.run(["--arch", arch, "--device", str(dev)]))
    if rec["pages_rdma"] != rec["seed_pages"]:
        raise AssertionError(f"quickstart: the child faulted "
                             f"{rec['pages_rdma']} pages of the seed's "
                             f"{rec['seed_pages']}")
    print("[smoke] examples quickstart " + json.dumps(rec))
    return rec


def finra_example(dev, arch="gemma3-1b", market_mb=6.0, n_rules=8) -> dict:
    """Phase 5b, second half: ``launch.finra.run`` on ``dev``, each
    transfer on a fresh 4-node cluster, held by ``check_finra``."""
    from repro_torch.launch import finra
    from repro_torch.memory.pool import PAGE_ELEMS
    rec = finra.run(["--arch", arch, "--rules", str(n_rules),
                     "--market-mb", str(market_mb), "--device", str(dev)])
    out = {"arch": rec.arch, "rules": rec.rules,
           "market_elems": rec.market_elems, **rec.transfers,
           "market_pages": check_finra(rec.transfers,
                                       finra.make_market(market_mb),
                                       n_rules, PAGE_ELEMS)}
    print("[smoke] examples finra " + json.dumps(out))
    return out


def pinned_staging(torch, dev, arch="gemma3-1b") -> dict:
    """Phase 5c on ``dev``; returns its line.  A seed of ``arch`` (the
    quickstart's model) on one device-pool node is forked onto two more,
    one after the other, with the tracer on.  Each child must be
    bit-equal to the seed, and every byte staged through the host must
    have gone through page-locked memory on a CUDA pool (the ``pinned.*``
    share of ``stage.*``: 100%; 0% on the CPU).  A fork's download and
    upload rates are its bytes over its summed ``net.read_pages`` and
    ``instance.adopt`` spans (the first fork page-locks the caching host
    allocator's blocks, the second reuses them)."""
    from repro_torch import tracing
    from repro_torch.configs.base import get_arch
    from repro_torch.core.instance import ModelInstance
    from repro_torch.fork import ForkPolicy
    from repro_torch.models import lm
    from repro_torch.net import Network
    from repro_torch.platform.node import NodeRuntime
    cfg = dataclasses.replace(get_arch(arch), compute_dtype="float32")
    net = Network()
    nodes = [NodeRuntime(f"node{i}", net, device_pool=True, device=dev)
             for i in range(3)]
    params = lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    handle = nodes[0].prepare_fork(
        ModelInstance.create(nodes[0], cfg.name, params))
    want = 100.0 if dev.type == "cuda" else 0.0
    forks = []
    for node in nodes[1:]:
        tracing.reset()
        tracing.enable()
        try:
            t0 = time.perf_counter()
            child = handle.resume_on(node, ForkPolicy(lazy=True, prefetch=1))
            tree = child.materialize_pytree()
            sync_dev(torch, dev)
            wall = time.perf_counter() - t0
        finally:
            tracing.disable()
        snap = tracing.snapshot()
        tracing.reset()
        same_leaves(torch, tree, params, f"pinned staging: {node.node_id}")
        c = snap["counters"]
        down = sum(v for k, v in c.items()
                   if k.startswith("stage.dtoh_bytes."))
        up = c.get("stage.htod_bytes", 0)
        pinned = c.get("pinned.dtoh_bytes", 0) + c.get("pinned.htod_bytes", 0)
        share = 100.0 * pinned / (down + up) if down + up else None
        if not down or up != down or share != want:
            raise AssertionError(f"pinned staging: {node.node_id} staged "
                                 f"{down} down, {up} up, {share}% pinned "
                                 f"(want {want}%): {c}")
        span_s = {n: sum(s.seconds for s in snap["spans"] if s.name == n)
                  for n in ("net.read_pages", "instance.adopt")}
        forks.append({"node": node.node_id, "fork_wall_s": wall,
                      "pages_rdma": child.stats["pages_rdma"],
                      "dtoh_bytes": down, "htod_bytes": up,
                      "pinned_pct": share, **{k + "_s": v
                                              for k, v in span_s.items()},
                      "dtoh_gbps": down / span_s["net.read_pages"] / 1e9,
                      "htod_gbps": up / span_s["instance.adopt"] / 1e9})
    line = {"arch": cfg.name, "seed_bytes": sum(
        t.numel() * t.element_size() for _, t in flat_leaves(params)),
        "forks": forks}
    if dev.type == "cuda":
        line["host_memory_stats"] = {
            k: v for k, v in torch.cuda.host_memory_stats().items()
            if "bytes" in k}
    print("[smoke] pinned staging: " + json.dumps(line))
    return line


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
        sync_dev(torch, dev)
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


# ---------------------------------------------------------------------------
# phase 7: the model families
# ---------------------------------------------------------------------------


def model_cfg(arch: str, smoke: bool):
    """(phase config, registered config) of ``arch``, float32: at smoke
    size for a CPU rehearsal, each unit first cut to one block of each
    kind (zamba2 keeps its shared attention, xlstm its sLSTM); else at
    full width, moonshot cut to ``MOE_LAYERS`` of its layers and the
    recurrent models whole."""
    from repro_torch.configs.base import get_arch, reduce_for_smoke
    full = get_arch(arch)
    if smoke:
        cfg = reduce_for_smoke(dataclasses.replace(full, groups=tuple(
            dataclasses.replace(g, unit=tuple(dict.fromkeys(g.unit)))
            for g in full.groups)))
    elif arch == MOE_ARCH:
        (g,) = full.groups
        cfg = dataclasses.replace(
            full, name=f"{arch}-{MOE_LAYERS}of{full.num_layers}",
            groups=(dataclasses.replace(g, repeat=MOE_LAYERS),))
    else:
        cfg = full
    return dataclasses.replace(cfg, compute_dtype="float32"), full


def greedy(torch, lm, params, cfg, prompt, n, cache_len):
    """``lm.prefill`` on ``prompt``, then ``n`` greedy ``lm.decode_step``s.
    Returns the n + 1 tokens, each step's logits (fp32, on the CPU), the
    prefill's seconds and the decode's seconds per step (device synced)."""
    dev = params["embed"]["tok"].device
    i32 = dict(dtype=torch.int32, device=dev)
    sync_dev(torch, dev)
    t0 = time.perf_counter()
    logits, caches = lm.prefill(params, cfg, torch.tensor(prompt, **i32)[None],
                                cache_len)
    sync_dev(torch, dev)
    prefill_s = time.perf_counter() - t0
    out = [logits[0].float().cpu()]
    tokens = [int(torch.argmax(out[0]))]
    t0 = time.perf_counter()
    for i in range(n):
        logits, caches = lm.decode_step(
            params, cfg, caches, torch.tensor([tokens[-1]], **i32),
            torch.tensor([len(prompt) + i], **i32))
        out.append(logits[0].float().cpu())
        tokens.append(int(torch.argmax(out[-1])))
    sync_dev(torch, dev)
    return tokens, out, prefill_s, (time.perf_counter() - t0) / n


def map_cache(fn, caches):
    return {"groups": [{"blocks": [{k: fn(v) for k, v in c.items()}
                                   for c in g["blocks"]]}
                       for g in caches["groups"]]}


def check_demo_batch(torch, lm, params, cfg, demo):
    """The fork demo's steps against ``lm.decode_step`` on the batches the
    engine decoded: the parent alone until the fork, then the parent and
    its children in the engine's order, each row leaving once its request
    is done.  MoE capacity (hence which tokens an expert drops) depends on
    the batch, so the rows must be the engine's.  Each row feeds the
    engine's own tokens.  Returns (max abs err, near-tie steps)."""
    eng = demo.engine
    parent = eng.requests[demo.parent]
    kids = [eng.requests[k] for k in demo.children]
    dev = params["embed"]["tok"].device
    fork_at = len(kids[0].prompt) - len(parent.prompt)
    last = max(len(r.prompt) + len(r.logits) for r in [parent] + kids)
    ties = []
    logits, caches = lm.prefill(
        params, cfg, torch.tensor(parent.prompt, dtype=torch.int32,
                                  device=dev)[None], -(-last // 16) * 16)
    err = check_step(torch, parent.logits[0], logits[0].float().cpu(),
                     parent.out_tokens[0], {"req": parent.req_id, "step": 0},
                     ties)
    rows, step = [parent], {parent.req_id: 1}
    while rows:
        if rows == [parent] and step[parent.req_id] == fork_at:
            rows = [parent] + kids
            step.update({k.req_id: 0 for k in kids})
            caches = map_cache(
                lambda t: t.repeat_interleave(len(rows), dim=1), caches)
        at = [len(r.prompt) - 1 + step[r.req_id] for r in rows]
        feed = [(r.prompt + r.out_tokens)[p] for r, p in zip(rows, at)]
        logits, caches = lm.decode_step(
            params, cfg, caches,
            torch.tensor(feed, dtype=torch.int32, device=dev),
            torch.tensor(at, dtype=torch.int32, device=dev))
        for j, r in enumerate(rows):
            i = step[r.req_id]
            err = max(err, check_step(
                torch, r.logits[i], logits[j].float().cpu(), r.out_tokens[i],
                {"req": r.req_id, "step": i, "batch": len(rows)}, ties))
            step[r.req_id] = i + 1
        keep = [j for j, r in enumerate(rows)
                if step[r.req_id] < len(r.logits)]
        if len(keep) < len(rows):
            idx = torch.tensor(keep, dtype=torch.long, device=dev)
            caches = map_cache(lambda t: t.index_select(1, idx), caches)
            rows = [rows[j] for j in keep]
    if not err < LOGIT_TOL:
        raise AssertionError(f"fork demo: logits max abs err {err} >= "
                             f"{LOGIT_TOL}")
    return err, ties


def model_line(torch, dev, cfg, full, **fields) -> dict:
    """The ``[smoke] models:`` line of one model: its size, the counts of
    the run so far, and ``fields``."""
    from repro_torch.models import flops
    launches, pages, routes = phase_counts()
    n = flops.param_counts(cfg)[0]
    line = {"arch": full.name, "layers": cfg.num_layers,
            "of_layers": full.num_layers, "d_model": cfg.d_model,
            "params": n, "param_gb": n * 4 / 1e9, **fields,
            "peak_device_bytes": peak_bytes(torch, dev),
            "launches": launches, "pages_moved": pages, "routes": routes}
    print("[smoke] models: " + json.dumps(line))
    return line


def moe_model(torch, dev, smoke=False) -> dict:
    """Phase 7(a): moonshot at full width, ``MOE_LAYERS`` layers, through
    ``launch/serve.main``: the seed on node0, one lazy child on node1
    (prefetch 1) serving 4 requests of 6 tokens for 8, one at a time, then
    the fork demo.  The child must equal the seed bit for bit, each
    request's paged logits the model's, the demo's the model's on the same
    batches; on the card page_gather must take its device-table route
    (the expert leaves pass its by-value capacity)."""
    from repro_torch.configs.base import register
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg, full = model_cfg(MOE_ARCH, smoke)
    register(cfg)
    print(f"[smoke] models: {full.name} at "
          f"{'smoke size' if smoke else 'full width'}, {cfg.num_layers} of "
          f"{full.num_layers} layers (all of them are 111 GB in fp32)")
    st = serve.main(["--arch", cfg.name, "--nodes", "2", "--requests", "4",
                     "--fork-demo", "--keep-logits", "--device", str(dev)])
    sync_dev(torch, dev)
    routes = phase_counts()[2]
    if dev.type == "cuda" and not routes.get("page_gather.bulk-device"):
        raise AssertionError(f"{cfg.name}: page_gather never read a device "
                             f"table: {routes}")
    (child,), (cp,) = st.children, st.child_params
    same_leaves(torch, cp, st.params, f"{cfg.name} child")
    demo = st.fork_demo
    errs, ties = [], []
    for req in demo.engine.requests.values():
        if req.req_id != demo.parent and req.req_id not in demo.children:
            e, t = check_request(torch, lm, cp, cfg, req, forked=False)
            errs.append(e)
            ties.extend(t)
    e, t = check_demo_batch(torch, lm, cp, cfg, demo)
    errs.append(e)
    ties.extend(t)
    for t in ties:
        print(f"[smoke] near-tie step (tokens may differ): {json.dumps(t)}")
    _, _, prefill_s, decode_s = greedy(torch, lm, cp, cfg, st.prompts[0], 8,
                                       16)
    snap = st.net.snapshot()
    return model_line(
        torch, dev, cfg, full, fork_wall_s=st.fork_seconds[0],
        pages_rdma=child.stats["pages_rdma"],
        sim_time_s=snap.get("sim_time"), prefill_ms=prefill_s * 1e3,
        decode_ms_per_token=decode_s * 1e3,
        requests_checked=len(errs) + len(demo.children),
        logits_max_abs_err=max(errs), logits_tol=LOGIT_TOL,
        near_ties=len(ties))


def recurrent_model(torch, dev, arch, smoke=False) -> dict:
    """Phase 7(b, c): ``arch`` whole, at full width: the seed packed on
    node0 and one lazy child (prefetch 1) forked to node1.  Seed and child
    each prefill a 6-token prompt (cache_len 16) and take 8 greedy decode
    steps: equal tokens and logits, bit for bit.  Each decode step's
    logits must match ``lm.prefill``'s on the prompt and the tokens so far
    (``DECODE_TOL``), and the paged engine must refuse the arch.  Prefill
    and decode are timed on the child's run, the model's second in the
    process (the seed's first prefill is printed apart)."""
    from repro_torch.core.instance import ModelInstance
    from repro_torch.fork import ForkPolicy
    from repro_torch.memory.paging import num_pages
    from repro_torch.memory.pool import PAGE_ELEMS
    from repro_torch.models import lm
    from repro_torch.net import Network
    from repro_torch.platform.node import NodeRuntime
    from repro_torch.serving.engine import ServingEngine
    cfg, full = model_cfg(arch, smoke)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    # reserve each pool's frames: a pool that grows doubles (copying), and
    # xlstm's 14 GB would then need 4x that for a moment
    frames = sum(num_pages(t.numel(), PAGE_ELEMS)
                 for _, t in flat_leaves(params))
    net = Network()
    nodes = [NodeRuntime(f"node{i}", net, cache_enabled=True,
                         device_pool=True, device=dev, pool_frames=frames)
             for i in range(2)]
    seed = ModelInstance.create(nodes[0], cfg.name, params)
    handle = nodes[0].prepare_fork(seed)
    t0 = time.perf_counter()
    child = handle.resume_on(nodes[1], ForkPolicy(lazy=True, prefetch=1))
    cp = child.materialize_pytree()
    sync_dev(torch, dev)
    fork_s = time.perf_counter() - t0
    for n in nodes:
        if n.pool.bytes_reserved() != frames * PAGE_ELEMS * 4:
            raise AssertionError(f"{n.node_id}'s pool grew past {frames}")
    same_leaves(torch, cp, params, f"{cfg.name} child")

    prompt = torch.randint(0, cfg.vocab_size, (6,),
                           generator=torch.Generator().manual_seed(1)).tolist()
    toks, logits, first_prefill_s, _ = greedy(torch, lm, params, cfg,
                                              prompt, 8, 16)
    ctoks, clogits, prefill_s, decode_s = greedy(torch, lm, cp, cfg, prompt,
                                                 8, 16)
    if ctoks != toks or not all(torch.equal(a, b)
                                for a, b in zip(clogits, logits)):
        raise AssertionError(f"{cfg.name}: the child's tokens {ctoks} or "
                             f"logits differ from the seed's {toks}")
    err = excess = 0.0
    for k in range(1, len(toks)):
        want = lm.prefill(params, cfg, torch.tensor(
            prompt + toks[:k], dtype=torch.int32, device=dev)[None], 16)[0]
        want = want[0].float().cpu()
        diff = (logits[k] - want).abs()
        err = max(err, float(diff.max()))
        excess = max(excess, float((diff - DECODE_TOL["atol"] - DECODE_TOL[
            "rtol"] * want.abs()).max()))
    if excess > 0:
        raise AssertionError(f"{cfg.name}: decode differs from prefill by "
                             f"{err} (past rtol/atol {DECODE_TOL})")
    try:
        ServingEngine(cfg, cp, device=dev)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"{cfg.name}: the paged engine took it")
    return model_line(
        torch, dev, cfg, full, fork_wall_s=fork_s,
        pages_rdma=child.stats["pages_rdma"], sim_time_s=net.sim_time,
        prefill_ms=prefill_s * 1e3, first_prefill_ms=first_prefill_s * 1e3,
        decode_ms_per_token=decode_s * 1e3, tokens=toks, child_equal=True,
        decode_vs_prefill_max_abs_err=err, decode_vs_prefill_tol=DECODE_TOL,
        engine_refused=refused)


# ---------------------------------------------------------------------------
# phase 8: training, and the elastic join by remote fork
# ---------------------------------------------------------------------------


def train_argv(smoke: bool):
    """(a)'s ``launch/train`` arguments: gemma3-1b whole, 4 steps of 4 x
    2048 tokens in 2 microbatches (q_chunk 512: the chunked window and
    global paths), full remat; at smoke size 4 x 64 tokens."""
    batch, seq = (4, 64) if smoke else (4, 2048)
    return (["--arch", TRAIN_ARCH] + (["--smoke"] if smoke else [])
            + ["--steps", "4", "--batch", str(batch), "--seq", str(seq),
               "--microbatches", "2", "--remat", "full", "--warmup", "1",
               "--lr", "1e-3", "--log-every", "1"])


def reset_peak(torch, dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def train_full(torch, dev, smoke=False) -> dict:
    """Phase 8(a): ``launch/train.run``; every loss finite and the last
    below the first.  Steps 2-4 give the step time, tokens/s and the share
    of the card's fp32 peak that ``model_flops`` (6 N per token, head
    included) takes."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train
    from repro_torch.models import flops
    reset_peak(torch, dev)
    argv = train_argv(smoke)
    run = train.run(argv + ["--device", str(dev)])
    losses = run.losses
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses} not finite and falling")
    batch, seq = int(argv[argv.index("--batch") + 1]), int(
        argv[argv.index("--seq") + 1])
    step_s = statistics.mean(run.step_s[1:])
    fl = flops.model_flops(run.cfg, ShapeConfig("train", seq, batch, "train"))
    line = {"arch": run.cfg.name, "params": flops.param_counts(run.cfg)[0],
            "batch": batch, "seq": seq, "losses": losses,
            "step_s": run.step_s, "first_step_s": run.step_s[0],
            "mean_step_s_2_4": step_s, "tokens_per_s": batch * seq / step_s,
            "model_flops_per_step": fl,
            "fp32_peak_share": fl / step_s / FP32_FLOPS_PER_S,
            "peak_device_bytes": peak_bytes(torch, dev)}
    print("[smoke] train (a): " + json.dumps(line))
    line["config"] = (run.cfg, run.tcfg)        # for phase 11(c)
    return line


def two_layer_cfg(smoke: bool):
    """(b)'s config: gemma3-1b at full width (smoke: its smoke cut) with
    one window layer and one global layer."""
    from repro_torch.configs.base import GroupSpec, get_arch, reduce_for_smoke
    full = get_arch(TRAIN_ARCH)
    local, glob = full.groups[0].unit[0], full.groups[0].unit[-1]
    cfg = dataclasses.replace(full, name=f"{TRAIN_ARCH}-2of{full.num_layers}",
                              groups=(GroupSpec(unit=(local, glob),
                                                repeat=1),))
    if smoke:
        cfg = reduce_for_smoke(cfg)
    return dataclasses.replace(cfg, compute_dtype="float32")


def train_vs_cpu(torch, dev, smoke=False) -> dict:
    """Phase 8(b): one ``make_train_step`` step of ``two_layer_cfg`` on the
    card and on the CPU from the same seeded weights and tokens (batch 1,
    seq 1024, q_chunk 256).  Loss within ``STEP_TOL["loss"]`` relative,
    gnorm within ``STEP_TOL["gnorm"]``.  Params: the first AdamW step
    moves each by ``lr * g s / (|g| s + eps)``, +-lr for most gradients,
    but a gradient at noise level (on the order of eps / s) can come out
    anywhere in between, or of the other sign, on the two devices; so
    every param must be within ``2 lr`` of the CPU's and fewer than
    ``STEP_TOL["far_share"]`` of them further than 1e-5 relative."""
    from repro_torch.core.descriptor import flatten_with_names
    from repro_torch.models import lm
    from repro_torch.training.data import TokenStream
    from repro_torch.training.optimizer import init_opt_state, tree_map
    from repro_torch.training.train_step import TrainConfig, make_train_step
    cfg = two_layer_cfg(smoke)
    seq, q_chunk = (64, 16) if smoke else (1024, 256)
    cpu = torch.device("cpu")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), cpu)
    tok, lab = (torch.from_numpy(a) for a in TokenStream(
        cfg.vocab_size, 1, seq, seed=0).batch_at(0))
    tcfg = TrainConfig(microbatches=1, q_chunk=q_chunk, xent_chunk=256,
                       warmup=0, peak_lr=1e-3, remat="none")
    step = make_train_step(cfg, tcfg)
    runs = []
    for where in (dev, cpu):
        p = tree_map(lambda t: t.to(where, copy=True), params)
        t0 = time.perf_counter()
        p, _, m = step(p, init_opt_state(p), tok.to(where), lab.to(where))
        sync_dev(torch, where)
        runs.append((p, {k: float(v) for k, v in m.items()},
                     time.perf_counter() - t0))
        del p
    (pd, md, card_s), (pc, mc, cpu_s) = runs
    loss_err = abs(md["loss"] - mc["loss"]) / mc["loss"]
    gnorm_err = abs(md["gnorm"] - mc["gnorm"]) / mc["gnorm"]
    max_diff, far, n = 0.0, 0, 0
    for a, b in zip(flatten_with_names(pd)[2], flatten_with_names(pc)[2]):
        d = (a.cpu() - b).abs()
        max_diff = max(max_diff, float(d.max()))
        far += int((d > 1e-5 * b.abs() + 1e-7).sum())
        n += d.numel()
    lr = mc["lr"]
    line = {"arch": cfg.name, "seq": seq, "q_chunk": q_chunk,
            "card_s": card_s, "cpu_s": cpu_s,
            "loss": md["loss"], "cpu_loss": mc["loss"],
            "loss_rel_err": loss_err, "gnorm": md["gnorm"],
            "cpu_gnorm": mc["gnorm"], "gnorm_rel_err": gnorm_err,
            "params_max_abs_diff": max_diff, "params_bound": 2 * lr,
            "params_far_share": far / n, "tol": STEP_TOL}
    print("[smoke] train (b): " + json.dumps(line))
    if (loss_err > STEP_TOL["loss"] or gnorm_err > STEP_TOL["gnorm"]
            or max_diff > 2 * lr + 1e-6 or far / n > STEP_TOL["far_share"]):
        raise AssertionError(f"train (b): the card's step differs from the "
                             f"CPU's past {STEP_TOL}")
    return line


def fork_state(torch, dev, arch, state, registers) -> dict:
    """``launch/elastic.fork_state``: pack ``state`` with ``registers`` on
    a donor node (device pools, frames reserved), fork it to a joiner
    (lazy, prefetch 1) and materialize it there; here every leaf and
    register must also equal the donor's.  Returns the joiner's tree, its
    registers and the fork's numbers (wall seconds from ``resume_on`` to
    materialized, synced)."""
    from repro_torch.launch import elastic
    got, regs, fork = elastic.fork_state(arch, state, registers, dev)
    same_leaves(torch, got, state, f"{arch} joiner")
    if regs != registers:
        raise AssertionError(f"{arch} joiner: registers {regs} != "
                             f"{registers}")
    return got, regs, fork


def step_tokens(torch, stream, step, dev):
    return [torch.from_numpy(a).to(dev) for a in stream.batch_at(step)]


def train_fork(torch, dev, smoke=False) -> dict:
    """Phase 8(c): gemma3-1b whole takes 2 steps (batch 2 x 1024), then a
    joining worker remote-forks its training state -- params, Adam ``m``
    and ``v``, registers ``step`` and ``count`` -- instead of reading a
    checkpoint (``examples/train_elastic.py``'s phase 2, on one card).
    The forked state must equal the donor's bit for bit; then both take
    step 3 on the same tokens: equal losses, bit for bit (a forward pass
    on identical state), and equal params, except that the token
    embedding's gradient gathers rows with atomics on the card, so it
    may differ at rounding level and its params by up to ``2 lr`` (the
    normalized step of a gradient at noise level; see ``train_vs_cpu``)."""
    from repro_torch.configs.base import get_arch, reduce_for_smoke
    from repro_torch.models import lm
    from repro_torch.training.data import TokenStream
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import TrainConfig, make_train_step
    cfg = get_arch(TRAIN_ARCH)
    if smoke:
        cfg = reduce_for_smoke(cfg)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    batch, seq, q_chunk = (2, 64, 16) if smoke else (2, 1024, 256)
    reset_peak(torch, dev)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    opt = init_opt_state(params)
    step = make_train_step(cfg, TrainConfig(
        microbatches=1, q_chunk=q_chunk, xent_chunk=256, warmup=1,
        peak_lr=1e-3, remat="full"))
    stream = TokenStream(cfg.vocab_size, batch, seq, seed=1)
    for s in range(2):
        params, opt, m = step(params, opt, *step_tokens(torch, stream, s,
                                                        dev))
    del m
    gc.collect()                      # the trainer's gradients and graph
    state = {"params": params, "opt_m": opt["m"], "opt_v": opt["v"]}
    got, regs, fork = fork_state(torch, dev, cfg.name, state,
                                 {"step": 2, "count": int(opt["count"])})
    fork_peak = peak_bytes(torch, dev)
    gc.collect()                      # the pools
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    jparams = got["params"]
    jopt = {"m": got["opt_m"], "v": got["opt_v"],
            "count": torch.tensor(regs["count"], dtype=torch.int32,
                                  device=dev)}
    tok, lab = step_tokens(torch, stream, regs["step"], dev)
    params, opt, m = step(params, opt, tok, lab)
    jparams, jopt, jm = step(jparams, jopt, tok, lab)
    if not torch.equal(m["loss"], jm["loss"]):
        raise AssertionError(f"train (c): step 3's loss {float(m['loss'])} "
                             f"on the donor != {float(jm['loss'])} on the "
                             f"joiner")
    lr = float(m["lr"])
    differ, max_diff = [], 0.0
    for (name, a), (_, b) in zip(flat_leaves(params), flat_leaves(jparams)):
        if not torch.equal(a, b):
            differ.append(name)
            max_diff = max(max_diff, float((a - b).abs().max()))
    if any(n != "/embed/tok" for n in differ) or max_diff > 2 * lr + 1e-6:
        raise AssertionError(f"train (c): step 3's params differ: {differ} "
                             f"by up to {max_diff}")
    line = {"arch": cfg.name, "batch": batch, "seq": seq, **fork,
            "state_gb": fork["state_bytes"] / 1e9,
            "step3_loss": float(m["loss"]), "step3_loss_bit_equal": True,
            "step3_params_bit_equal": not differ,
            "step3_params_differ": differ, "step3_params_max_diff": max_diff,
            "fork_peak_device_bytes": fork_peak,
            "peak_device_bytes": peak_bytes(torch, dev)}
    print("[smoke] train (c): " + json.dumps(line))
    return line


def train_restart(torch, dev, smoke=False) -> dict:
    """Phase 8(d): train-100m whole (batch 8 x 512), 4 steps straight
    against 2 steps, ``save_checkpoint``, ``load_checkpoint`` and 2 more:
    every loss within ``RESTART_TOL``.  The checkpoint's bytes and its
    save and load times (device to file and back, synced) stand beside a
    remote fork of the same state: the paper's C-R against fork."""
    import tempfile
    from repro_torch.configs.base import get_arch, reduce_for_smoke
    from repro_torch.models import lm
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import TokenStream
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import TrainConfig, make_train_step
    cfg = get_arch(RESTART_ARCH)
    if smoke:
        cfg = reduce_for_smoke(cfg)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    batch, seq = (4, 32) if smoke else (8, 512)
    step = make_train_step(cfg, TrainConfig(
        microbatches=1, q_chunk=seq, xent_chunk=min(256, seq), warmup=0,
        peak_lr=1e-3, remat="none"))
    stream = TokenStream(cfg.vocab_size, batch, seq, seed=0)

    def run(params, opt, lo, hi):
        losses = []
        for s in range(lo, hi):
            params, opt, m = step(params, opt, *step_tokens(torch, stream, s,
                                                            dev))
            losses.append(float(m["loss"]))
        return params, opt, losses

    def fresh():
        p = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
        return p, init_opt_state(p)

    _, _, straight = run(*fresh(), 0, 4)
    params, opt, first = run(*fresh(), 0, 2)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save_checkpoint(d, 2, params, opt)
        save_s = time.perf_counter() - t0
        nbytes = ckpt.checkpoint_nbytes(d, 2)
        t0 = time.perf_counter()
        _, lp, lo, _ = ckpt.load_checkpoint(d, device=dev)
        sync_dev(torch, dev)
        load_s = time.perf_counter() - t0
    same_leaves(torch, lp, params, f"{cfg.name} checkpoint")
    _, _, resumed = run(lp, lo, 2, 4)
    restarted = first + resumed
    err = max(abs(a - b) for a, b in zip(straight, restarted))
    if err > RESTART_TOL:
        raise AssertionError(f"train (d): restart losses {restarted} differ "
                             f"from {straight} by {err}")
    _, _, fork = fork_state(torch, dev, cfg.name,
                            {"params": params, "opt_m": opt["m"],
                             "opt_v": opt["v"]},
                            {"step": 2, "count": int(opt["count"])})
    line = {"arch": cfg.name, "batch": batch, "seq": seq,
            "losses_straight": straight, "losses_restarted": restarted,
            "max_loss_diff": err, "tol": RESTART_TOL,
            "checkpoint_bytes": nbytes, "save_s": save_s, "load_s": load_s,
            "fork": fork}
    print("[smoke] train (d): " + json.dumps(line))
    return line


def train_phase(torch, dev, smoke=False) -> dict:
    return {"a": train_full(torch, dev, smoke),
            "b": train_vs_cpu(torch, dev, smoke),
            "c": train_fork(torch, dev, smoke),
            "d": train_restart(torch, dev, smoke)}


# ---------------------------------------------------------------------------
# phase 9: sharded data-parallel training and the elastic join
# ---------------------------------------------------------------------------


def distributed_phase(torch, dev, smoke=False, fork_pages=None) -> dict:
    """Phase 9: ``launch/elastic.run`` with ``--check`` on ``dev`` (4 ranks,
    gloo; at smoke size the reference's smoke cut, 32 tokens a row), its
    checks (a)-(e) held here; rank 0's kernel counts are added to this
    process's, for ``run_phase``'s check (f).  ``fork_pages``: phase
    8(d)'s pages for a fork of the same state."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import elastic
    from repro_torch.models.flops import param_counts
    argv = DIST_ARGV + ["--device", dev.type, "--seq", "32" if smoke
                        else "512"] + ([] if smoke else ["--full-100m"])
    t0 = time.perf_counter()
    r = elastic.run(argv)
    wall = time.perf_counter() - t0
    dispatch.launches.update(r.kernels["launches"])
    dispatch.pages_moved.update(r.kernels["pages"])
    dispatch.routes.update(r.kernels["routes"])
    fail = []
    for s, a in r.checks["a"].items():
        if (a["loss_rel_err"] > STEP_TOL["loss"]
                or a["gnorm_rel_err"] > STEP_TOL["gnorm"]
                or a["lr"] != a["sharded_lr"]
                or a["params_max_abs_diff"] > 2 * a["lr"] + 1e-6
                or a["params_far_share"] > STEP_TOL["far_share"]
                or a["m_err_over_grad_tol"] > 1.0):
            fail.append(f"(a) {s} on 2 ranks against one: {a}")
    if not r.checks["a"]["step1"]["lr"] > 0:
        fail.append(f"(a) lr 0 at step 1: {r.checks['a']['step1']}")
    for rank in r.ranks[:2]:
        if not all(rank["checks"]["b"].values()):
            fail.append(f"(b) rank {rank['rank']}: {rank['checks']['b']}")
    c, fork = r.checks["c"], r.fork
    if (not all(c.values()) or fork["pages_rdma"] != fork["frames"]
            or fork_pages not in (None, fork["pages_rdma"])):
        fail.append(f"(c) joiner {c}, pages {fork['pages_rdma']} of "
                    f"{fork['frames']} (phase 8(d): {fork_pages})")
    for rank in r.ranks:
        d = rank["checks"]["d"]
        if (not d["loss_bit_equal"]
                or any(n != "embed/tok" for n in d["params_differ"])
                or d["params_max_abs_diff"] > 2 * d["lr"] + 1e-6):
            fail.append(f"(d) rank {rank['rank']}: {d}")
    losses = r.losses
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail.append(f"(e) losses {losses}")
    if r.allow_tf32:
        fail.append("TF32 on in the ranks")
    if fail:
        raise AssertionError("distributed: " + "; ".join(fail))
    median = lambda dp: statistics.median(
        s for s, k in zip(r.step_s, r.dp) if k == dp)
    line = {
        "arch": r.cfg.name, "params": param_counts(r.cfg)[0],
        "batch": int(argv[argv.index("--batch") + 1]),
        "seq": int(argv[argv.index("--seq") + 1]), "steps": len(losses),
        "note": "ranks are processes sharing one card; collectives are "
                "gloo loopback through host memory, not NVLink",
        "gloo_collectives": {"device": dev.type, **r.collectives},
        "losses": losses,
        "dp": r.dp, "step_s": r.step_s, "median_step_s_dp2": median(2),
        "median_step_s_dp4": median(4), "wall_s": wall,
        "ranks": [{"rank": k["rank"], "state_bytes": k["state_bytes"],
                   "peak_device_bytes": k["peak_device_bytes"]}
                  for k in r.ranks],
        "full_state_bytes": r.full_state_bytes, "comm": r.comm,
        "fork": fork, "checkpoint": r.checkpoint, "checks": r.checks}
    print("[smoke] distributed: " + json.dumps(line))
    return line


# ---------------------------------------------------------------------------
# phase 10: tensor parallelism over model
# ---------------------------------------------------------------------------


def tensor_parallel_phase(torch, dev, smoke=False):
    """Phase 10: ``launch/tensor_parallel.run`` on ``dev`` (4 ranks, gloo,
    data=2 x model=2, then 8 as data=1 x model=8; at smoke size the smoke
    configs) and its checks; every rank's kernel counts are added to this
    process's, for ``run_phase``, and must be 0: no kernel is on this
    path.  Prints one line per case and returns the run (its ``cases``
    and every rank's ``ranks`` record)."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import tensor_parallel
    t0 = time.perf_counter()
    r = tensor_parallel.run(["--device", dev.type]
                            + (["--smoke"] if smoke else []))
    wall = time.perf_counter() - t0
    fail = []
    for k in r.kernels:
        dispatch.launches.update(k["launches"])
        dispatch.pages_moved.update(k["pages"])
        dispatch.routes.update(k["routes"])
    if any(dispatch.launches.values()):
        fail.append(f"kernels launched on the ranks: "
                    f"{dict(dispatch.launches)}")
    for c in r.cases:
        kind = c["case"].split(":")[0]
        if kind == "a":
            c["tol"] = {"loss_rel_err": STEP_TOL["loss"],
                        "gnorm_rel_err": STEP_TOL["gnorm"],
                        "params_max_abs_diff": "2 lr + 1e-6",
                        "params_far_share": STEP_TOL["far_share"],
                        "m_err_over_grad_tol": 1.0}
            for s, a in enumerate(c["steps"]):
                if (a["loss_rel_err"] > STEP_TOL["loss"]
                        or a["gnorm_rel_err"] > STEP_TOL["gnorm"]
                        or a["lr"] != a["single_lr"]):
                    fail.append(f"{c['case']} step {s}: {a}")
            a = c["steps"][1]               # the state, after step 1 only
            if (a["params_max_abs_diff"] > 2 * a["lr"] + 1e-6
                    or a["params_far_share"] > STEP_TOL["far_share"]
                    or a["m_err_over_grad_tol"] > 1.0):
                fail.append(f"{c['case']} state after step 1: {a}")
            if not a["lr"] > 0:
                fail.append(f"{c['case']}: lr 0 at step 1")
        elif kind == "b":
            c["tol"] = LOGIT_TOL
            if (c["logits_max_abs_err"] > LOGIT_TOL
                    or not c["tokens_equal"]):
                fail.append(f"{c['case']}: {c}")
        elif kind == "g":
            # the entries the steps wrote come from hidden states reduced
            # over ``model`` in another order: held to TP_TOL, the rest of
            # every rank's part bit for bit
            c["tol"] = {"logits": LOGIT_TOL,
                        "cache_written": TP_TOL * c["cache_written_scale"]}
            if (c["logits_max_abs_err"] > LOGIT_TOL or not c["tokens_equal"]
                    or not c["cache_unwritten_bits_equal"]
                    or c["cache_written_max_abs_err"]
                    > TP_TOL * c["cache_written_scale"]):
                fail.append(f"{c['case']}: {c}")
        else:
            for key, (err, scale, _) in c["errors"].items():
                c["errors"][key].append(TP_TOL * scale)
                if not err <= TP_TOL * scale:
                    fail.append(f"{c['case']} {key}: {err} > {TP_TOL} x "
                                f"{scale}")
            if kind == "c" and c["factor"] == 1.0 and not c["dropped"] > 0:
                fail.append(f"{c['case']}: no token dropped at factor 1.0")
    print("[smoke] tensor_parallel collectives gloo takes, by group: "
          + json.dumps({"device": dev.type, **r.collectives}))
    for c in r.cases:
        ranks = [k[c["case"]] for k in r.ranks if c["case"] in k]
        print("[smoke] tensor_parallel: " + json.dumps({
            **c, "state_bytes": [k["state_bytes"] for k in ranks],
            "flops": [k["flops"] for k in ranks],
            "peak_device_bytes": [k["peak_device_bytes"] for k in ranks],
            "peak_reserved_bytes": [k["peak_reserved_bytes"] for k in ranks],
            "comm": ranks[0]["comm"]}))
    if fail:
        raise AssertionError("tensor_parallel: " + "; ".join(fail))
    print(f"[smoke] tensor_parallel: {len(r.cases)} cases in {wall:.1f} s")
    return r


# ---------------------------------------------------------------------------
# phase 11: the dry-run tools
# ---------------------------------------------------------------------------

DRY_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRY_WORKERS = 6
DRY_PEAK_TOL = 0.02     # 11(b): dry-run peak against rank 1's measured
DRY_INSPECT = ("gemma3-1b", "decode_32k")


def dry_sweep(smoke=False) -> list:
    """(a): every arch x ``DRY_SHAPES`` on both production meshes (at smoke
    size, two decode cells), ``DRY_WORKERS`` cells at a time; prints one
    line per cell and fails unless every applicable cell is ok."""
    from repro_torch.configs.base import SHAPES, get_arch, shape_applicable
    from repro_torch.launch import dryrun
    cells = ([("gemma3-1b", "decode_32k", False),
              ("musicgen-large", "decode_32k", True)] if smoke else
             [(a, s, mp) for mp in (False, True) for a in dryrun.ARCHS
              for s in DRY_SHAPES
              if shape_applicable(get_arch(a), SHAPES[s])[0]])
    t0 = time.perf_counter()
    out, bad = [], []
    for res in dryrun.sweep(cells, workers=DRY_WORKERS):
        line = {k: res.get(k) for k in (
            "arch", "shape", "mesh", "status", "trace_s", "step_time_lb",
            "fits_hbm", "bytes_per_device_total", "roofline_fraction",
            "useful_flops_ratio", "collective_bytes_per_device")}
        line["dominant"] = res.get("roofline", {}).get("dominant")
        line["flops_per_device"] = res.get("cost_analysis", {}).get(
            "flops_per_device")
        line["traffic_bytes_per_device"] = res.get("cost_analysis", {}).get(
            "bytes_per_device")
        if res["status"] != "ok":
            line["error"] = res.get("error", res.get("reason"))
            bad.append(line)
        print("[smoke] dryrun cell (model values, H100 constants): "
              + json.dumps(line))
        out.append(res)
    print(f"[smoke] dryrun sweep: {len(out)} cells in "
          f"{time.perf_counter() - t0:.1f} s on {DRY_WORKERS} processes")
    if bad:
        raise AssertionError(f"dryrun: cells not ok: {bad}")
    return out


def dry_vs_measured(tp) -> list:
    """(b): the dry run of phase 10's gemma3-1b train case under each
    policy, against ``tp`` (phase 10's run): collectives by kind (calls
    and bytes) equal to rank 0's measured step 0, dot FLOPs equal to rank
    1's ``FlopCounterMode`` count of it; peak bytes within
    ``DRY_PEAK_TOL`` of rank 1's (on the card)."""
    from repro_torch.distributed import op_analysis
    from repro_torch.distributed.sharding import make_axis_env
    from repro_torch.launch import dryrun, tensor_parallel
    smoke = "smoke" in tp.cases[0]["case"]
    gemma = tensor_parallel.configs(smoke)[0]
    sz = tensor_parallel.sizes(smoke)
    B, S = sz["train"]
    out, fail = [], []
    for policy in tensor_parallel.POLICIES:
        name = f"a:{gemma.name}:{policy}"
        case = next(c for c in tp.cases if c["case"] == name)
        rank1 = tp.ranks[dryrun.RANK][name]
        t0 = time.perf_counter()
        with dryrun.fake_group(tensor_parallel.WORLD):
            env = make_axis_env(dryrun.mesh_of(
                {"data": tensor_parallel.DATA,
                 "model": tensor_parallel.MODEL}), attn_policy=policy)
            spec = dryrun.step_spec(gemma, "train", env, B, S,
                                    tensor_parallel._tcfg(sz))
            an = op_analysis.analyze(spec["fn"], *spec["args"],
                                     read_bytes=spec["read_bytes"])
        measured = {k: {"calls": v["calls"], "bytes": v["bytes"]}
                    for k, v in case["steps"][0]["step_comm"].items()}
        line = {"case": name, "trace_s": time.perf_counter() - t0,
                "collectives_dry": an["port_collectives"],
                "collectives_equal": an["port_collectives"] == measured,
                "dot_flops_dry": an["dot_flops"],
                "flops_measured_rank1": rank1["flops"],
                "flops_equal": an["dot_flops"] == rank1["flops"],
                "peak_bytes_dry": an["peak_bytes"],
                "peak_device_bytes_rank1": rank1["peak_device_bytes"]}
        if rank1["peak_device_bytes"]:
            line["peak_gap"] = (an["peak_bytes"]
                                / rank1["peak_device_bytes"] - 1.0)
            if abs(line["peak_gap"]) > DRY_PEAK_TOL:
                fail.append(f"{name}: dry peak {an['peak_bytes']} against "
                            f"{rank1['peak_device_bytes']} measured")
        if not (line["collectives_equal"] and line["flops_equal"]):
            fail.append(f"{name}: dry {an['port_collectives']} "
                        f"{an['dot_flops']} measured {measured} "
                        f"{rank1['flops']}")
        print("[smoke] dryrun (b) vs phase 10: " + json.dumps(line))
        out.append(line)
    if fail:
        raise AssertionError("dryrun (b): " + "; ".join(fail))
    return out


def dry_roofline(train_line) -> dict:
    """(c): the roofline, for the H100's constants, of phase 8(a)'s
    one-card gemma3-1b step (mesh 1x1), counted on meta tensors, beside
    the step time phase 8(a) measured."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import op_analysis, roofline
    from repro_torch.models import flops, lm
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import make_train_step
    cfg, tcfg = train_line["config"]
    B, S = train_line["batch"], train_line["seq"]
    params = lm.init_params(cfg, torch.Generator(), "meta")
    tok = torch.empty((B, S), dtype=torch.int32, device="meta")
    an = op_analysis.analyze(make_train_step(cfg, tcfg), params,
                             init_opt_state(params), tok, tok)
    rl = roofline.roofline(an["dot_flops"], an["traffic_bytes"], 0.0, 1)
    mf = flops.model_flops(cfg, ShapeConfig("train", S, B, "train"))
    line = {"note": "model values for H100 constants (bf16 dense peak); "
                    "the step runs float32 with TF32 off",
            "arch": cfg.name, "batch": B, "seq": S,
            "dot_flops": an["dot_flops"], "traffic_bytes": an["traffic_bytes"],
            "peak_bytes": an["peak_bytes"], "roofline": rl.to_dict(),
            "step_time_lb": rl.step_time_lb,
            "roofline_fraction": rl.fraction_of_roofline(mf),
            "compute_s_at_fp32_peak": an["dot_flops"] / FP32_FLOPS_PER_S,
            "measured_step_s": train_line["mean_step_s_2_4"],
            "measured_peak_device_bytes": train_line["peak_device_bytes"]}
    print("[smoke] dryrun (c) one-card train step: " + json.dumps(line))
    return line


def dryrun_phase(torch, dev, tp, train_line, smoke=False) -> dict:
    """Phase 11: (a)-(d) above; ``tp`` phase 10's run, ``train_line``
    phase 8(a)'s."""
    from repro_torch.distributed import inspect_cell, roofline
    total = (torch.cuda.get_device_properties(dev).total_memory
             if dev.type == "cuda" else roofline.HBM_PER_CHIP)
    hbm = {"HBM_PER_CHIP": roofline.HBM_PER_CHIP, "card_total_memory": total,
           "gap": roofline.HBM_PER_CHIP / total - 1.0}
    print("[smoke] dryrun HBM_PER_CHIP: " + json.dumps(hbm))
    if abs(hbm["gap"]) > 0.01:
        raise AssertionError(f"dryrun: HBM_PER_CHIP off the card's: {hbm}")
    out = {"hbm": hbm, "a": dry_sweep(smoke), "b": dry_vs_measured(tp),
           "c": dry_roofline(train_line)}
    print("[smoke] dryrun (d) inspect_cell, per device, model values:")
    inspect_cell.inspect(*DRY_INSPECT, top=8)
    return out


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
    print("[smoke] cow_scatter_runs host stages, the replay's 16-page run "
          "(us): " + json.dumps(host_stages_runs(torch)))
    print("[smoke] page_gather host stages, the replay's one page of 16 "
          "(us): " + json.dumps(host_stages_gather(torch)))
    print("[smoke] page_gather_runs host stages, the replay's 16-page run "
          "(us): " + json.dumps(host_stages_gather_runs(torch)))
    print("[smoke] replay shapes, host us of one call, wrappers and library "
          "calls in turns: " + json.dumps(replay_host_us(torch)))
    for case in attention_cases():
        for dtype in (torch.float32, torch.bfloat16):
            r = run_attention_case(torch, case, dtype)
            print("[smoke] kernel " + json.dumps(r))
            rows.append(r)
    for case in latent_attention_cases():
        r = run_latent_case(torch, case)
        print("[smoke] kernel " + json.dumps(r))
        rows.append(r)
    for case in moe_experts_cases():
        r = run_moe_case(torch, case)
        print("[smoke] kernel " + json.dumps(r))
        rows.append(r)
    print("[smoke] paged_attention device us per call, by kernel, one "
          "fp32 sequence of 8,192 tokens (torch.profiler): "
          + json.dumps(attention_kernel_split(torch)))
    torch.cuda.synchronize()

    launches, pages, routes = main_path(torch)

    dev = torch.device("cuda", torch.cuda.current_device())
    run_phase(torch, "decode_graph", lambda: decode_graph_phase(torch, dev),
              required=("paged_attention",))
    run_phase(torch, "platform", lambda: platform_phase(torch, dev),
              required=KERNELS, bulk=BULK_KERNELS)
    examples = {}
    _, examples["quickstart"] = run_phase(
        torch, "examples", lambda: quickstart_example(dev),
        required=KERNELS, bulk=BULK_KERNELS)
    _, examples["finra"] = run_phase(
        torch, "examples", lambda: finra_example(dev),
        required=COPY_KERNELS, bulk=BULK_KERNELS)
    pinned_staging(torch, dev)
    _, replay_launches = run_phase(torch, "replay",
                                   lambda: replay_phase(torch, dev),
                                   required=(), bulk=BULK_KERNELS)
    if not sum(replay_launches[k] for k in COPY_KERNELS):
        raise AssertionError(f"replay launched no copy kernel: "
                             f"{replay_launches}")
    models = {}
    _, models[MOE_ARCH] = run_phase(torch, "models",
                                    lambda: moe_model(torch, dev),
                                    required=KERNELS, bulk=BULK_KERNELS)
    for arch in RECURRENT_ARCHS:
        _, models[arch] = run_phase(
            torch, "models", lambda a=arch: recurrent_model(torch, dev, a),
            required=COPY_KERNELS, bulk=BULK_KERNELS)
    train, train_launches = run_phase(torch, "train",
                                      lambda: train_phase(torch, dev),
                                      required=COPY_KERNELS,
                                      bulk=BULK_KERNELS)
    _, dist_launches = run_phase(
        torch, "distributed", lambda: distributed_phase(
            torch, dev, fork_pages=train["d"]["fork"]["pages_rdma"]),
        required=COPY_KERNELS, bulk=BULK_KERNELS)
    tp, tp_launches = run_phase(
        torch, "tensor_parallel", lambda: tensor_parallel_phase(torch, dev),
        required=())
    _, dry_launches = run_phase(
        torch, "dryrun", lambda: dryrun_phase(torch, dev, tp, train["a"]),
        required=())
    if any(dry_launches.values()):
        raise AssertionError(f"dryrun launched kernels: {dry_launches}")

    kernels = []
    for name in KERNELS:
        main_row = next(r for r in rows if r["name"] == name)  # main shape
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "design": DESIGN[name],
            "launches": launches[name], "pages": pages[name],
            "examples_launches": {e: n[name] for e, n in examples.items()},
            "models_launches": {a: n[name] for a, n in models.items()},
            "train_launches": train_launches[name],
            "distributed_launches": dist_launches[name],
            "tensor_parallel_launches": tp_launches[name],
            "dryrun_launches": dry_launches[name],
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
