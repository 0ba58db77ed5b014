"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the metrics, all found by name from
``BENCHMARK.json``.

- The cell names a configuration (``configs[].file``: the model's sizes,
  the port's arch, the pool's page size and the check's limits) and a
  traffic mix (``forkbench/traffic/<traffic>.json``).  The configuration's
  architecture (``model.arch``, ``gqa_moe`` where absent) is
  ``forkbench/archs/<arch>.py``: its checks, the program's config, the
  weights' layout, the reference and the roofline's counts.
- Every metric of the cell is read by ``forkbench/metrics/<name>.py``'s
  ``read(run)`` from the run's record (``Run``); a reader that finds
  nothing returns None and the metric is left out.  ``--trace 0`` reads
  the cell's end-to-end metrics, ``--trace 1`` its per-layer ones.  A
  metric with a ``workloads`` list is the cell's where the list names
  it; a per-layer metric without one is every cell's whose end-to-end
  metrics hold the one it ``moves`` (``cell_metrics``).
- A ``--trace 1`` window runs a sub-window of its invocations (the
  mix's ``profile``) under the profiler and with the program's tracer
  (``repro_torch.tracing``) on: reset and enabled as the sub-window
  opens, disabled as it closes, so set-up, warm-up and the rest of the
  window record nothing.  ``--trace 0`` never turns the tracer on.

The window drives ``Coordinator.invoke`` on ``NodeRuntime``s whose pools
live on the card.  The function's behaviour (``Behaviour``) materializes
the instance's tree and answers one request through ``ServingEngine``,
greedily; a warm container (policy ``cache``) keeps the tree it
materialized at its first invocation, a forked child always
materializes.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from forkbench import archs, check, profiling, roofline, traffic
from forkbench import weights as W

HERE = Path(__file__).resolve().parent
FUNC = "model"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
COPY_ENTRIES = ("page_gather", "page_gather_runs", "cow_scatter",
                "cow_scatter_runs")
LATE_S = 90.0       # an open-loop request not started this long after the
                    # window closes never comes: it counts as failed


# ---------------------------------------------------------------------------
# the cell, found by name
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    metrics_e2e: List[dict]
    metrics_layer: List[dict]
    root: Path
    arch: ModuleType                   # forkbench/archs/<arch>.py


def load_cell(root: Path, name: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    arch = archs.load(config["model"], root)
    arch.check_config(config)
    mix = json.loads((root / HERE.name / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return Cell(name, int(cell["chips"]), config, mix,
                *cell_metrics(bench, name), root, arch)


def cell_metrics(bench: dict, name: str) -> Tuple[List[dict], List[dict]]:
    """The end-to-end and the per-layer metrics of cell ``name``: a
    metric's ``workloads`` list where it has one; else an end-to-end
    metric is every cell's, and a per-layer one every cell's whose
    end-to-end metrics hold the one it ``moves``, those added later
    too."""
    listed = lambda m: "workloads" in m
    e2e = [m for m in bench["end_to_end"]
           if not listed(m) or name in m["workloads"]]
    ends = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if listed(m)
                 else m["moves"] in ends)]
    return e2e, layer


def port_config(conf: dict):
    """The program's ArchConfig of ``conf``, by its architecture's
    module."""
    return archs.load(conf["model"]).port_config(conf)


def reader(root: Path, metric: str) -> Callable:
    path = Path(root) / HERE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "forkbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# the record the metrics read
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Invocation:
    index: int
    prompt_len: int
    forked: bool
    due: Optional[float] = None        # perf_counter when it was due
    start: float = 0.0                 # the call to invoke
    tree_at: float = 0.0               # the tree materialized, synced
    submit: float = 0.0                # the engine made, the request sent
    answer: float = 0.0                # the answer, synced
    end: float = 0.0                   # the instance released, synced
    pages_fork: int = 0                # pages the copy kernels moved until
                                       # the tree was ready
    tokens: List[int] = dataclasses.field(default_factory=list)
    logits: List[torch.Tensor] = dataclasses.field(default_factory=list)
    failed: bool = False
    request: Optional[int] = None      # the tracer's request id of its
                                       # ``invoke`` span, where it traced it

    @property
    def latency(self) -> float:
        return self.end - (self.due if self.due is not None else self.start)


@dataclasses.dataclass
class Run:
    cell: str
    model: dict
    mix: dict
    page_elems: int
    seconds: float
    setup_s: float
    window_s: float
    peak_bytes: int
    invocations: List[Invocation]
    # a traced run's: profiling.summarize, the profiled sub-window's spans
    # and counters (repro_torch.tracing.snapshot), its device
    # events (profiling.raw_events) and bounds (ns), and the forks whose
    # ``invoke`` span the tracer recorded
    trace: dict = dataclasses.field(default_factory=dict)
    spans: list = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    device_events: list = dataclasses.field(default_factory=list)
    profiled: Optional[Tuple[int, int]] = None
    forks_traced: int = 0

    @property
    def ok(self) -> List[Invocation]:
        return [v for v in self.invocations if not v.failed]


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------


class _Label:
    """A ``record_function`` range opened and closed by different calls."""

    def __init__(self, name: str):
        self.rf = record_function(name)
        self.rf.__enter__()

    def close(self) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


class Behaviour:
    """The function the coordinator runs: materialize the instance's tree
    (a warm container's once), then answer one request greedily.  The
    engine keeps each served token's logits (on the host) for the
    check."""

    def __init__(self, cfg, device, page_tokens: int, sync):
        self.cfg, self.device, self.page_tokens = cfg, device, page_tokens
        self.sync = sync
        self.trees: Dict = {}          # warm containers' trees

    def __call__(self, inst, inputs: dict) -> dict:
        from repro_torch.serving.engine import ServingEngine
        tree = self.trees.get(inst)
        if tree is None:
            tree = inst.materialize_pytree()
            if inputs["hold"]:
                self.trees[inst] = tree
        self.sync()
        inputs["on_tree"](tree)
        with record_function(f"{profiling.LABEL}serve.{inputs['index']}"):
            submit = time.perf_counter()
            eng = ServingEngine(self.cfg, tree, page_tokens=self.page_tokens,
                                device=self.device, keep_logits=True)
            rid = eng.submit(inputs["prompt"], max_tokens=inputs["max_tokens"])
            tokens = eng.run_to_completion()[rid]
            self.sync()
            answer = time.perf_counter()
        return {"tokens": list(tokens), "logits": eng.requests[rid].logits,
                "submit": submit, "answer": answer}


class Program:
    """The cluster: the seed on node0, children's nodes after it, every
    pool reserved at the state's page count so no pool grows."""

    def __init__(self, cell: Cell, cfg, w: dict, device, sync):
        from repro_torch.core.instance import ModelInstance
        from repro_torch.memory.paging import num_pages
        from repro_torch.net import Network
        from repro_torch.platform.coordinator import Coordinator, FunctionDef
        from repro_torch.platform.node import NodeRuntime
        pool = cell.config["pool"]
        self.page_elems = pool["page_elems"]
        frames = sum(num_pages(t.numel(), self.page_elems)
                     for _, t in W.flat(w))
        self.net = Network()
        self.nodes = [NodeRuntime(f"node{i}", self.net,
                                  page_elems=self.page_elems,
                                  device_pool=True, device=device,
                                  pool_frames=frames)
                      for i in range(1 + cell.mix["child_nodes"])]
        self.coord = Coordinator(self.net, self.nodes, seed_replicas=1)
        self.behaviour = Behaviour(cfg, device, pool["kv_page_tokens"], sync)
        self.coord.register_function(FunctionDef(FUNC, cfg.name, lambda: w,
                                                 self.behaviour))
        seed = ModelInstance.create(self.nodes[0], cfg.name, w)
        self.coord.deploy_seed(FUNC, self.nodes[0], instance=seed, replicas=1)
        self.mix, self.sync = cell.mix, sync
        self.warm = None               # the cached child (policy cache)
        self.tree = None               # the last invocation's tree
        self.label = None

    def node_for(self, i: int):
        return self.nodes[1 + i % self.mix["child_nodes"]]

    def invoke(self, req: traffic.Request, i: int, policy: str,
               due: Optional[float] = None) -> Invocation:
        from repro_torch.kernels import dispatch
        inv = Invocation(i, len(req.prompt), forked=policy == "fork", due=due)
        node = self.node_for(i)
        self.tree = None
        pages0 = sum(dispatch.pages_moved[e] for e in COPY_ENTRIES)
        inputs = {"index": i, "prompt": req.prompt,
                  "max_tokens": req.max_tokens,
                  "hold": self.warm is None and self.mix["policy"] == "cache",
                  "on_tree": lambda tree: self._tree_ready(inv, tree, pages0)}
        self.label = _Label(f"{profiling.LABEL}fork.{i}")
        inv.start = time.perf_counter()
        try:
            out, inst = self.coord.invoke(FUNC, inputs, node=node,
                                          policy=policy,
                                          **self.mix.get("fork", {}))
            inv.tokens, inv.logits = out["tokens"], out["logits"]
            inv.submit, inv.answer = out["submit"], out["answer"]
            if policy == "cache" and inst is not self.warm:
                raise RuntimeError("the warm container was not reused")
            if self.mix["policy"] == "cache":
                self.warm = inst
            self.coord.release(FUNC, inst, self.mix["policy"])
            self.sync()
            inv.end = time.perf_counter()
        except Exception as e:          # a failed invocation is counted
            print(f"[forkbench] invocation {i} failed: {e!r}",
                  file=sys.stderr)
            inv.failed = True
            self.tree = None
        finally:
            self.label.close()
        return inv

    def _tree_ready(self, inv: Invocation, tree, pages0: int) -> None:
        from repro_torch.kernels import dispatch
        inv.tree_at = time.perf_counter()
        inv.pages_fork = sum(dispatch.pages_moved[e]
                             for e in COPY_ENTRIES) - pages0
        self.tree = tree
        self.label.close()


# ---------------------------------------------------------------------------
# set-up, window, check
# ---------------------------------------------------------------------------


def make_sync(device) -> Callable[[], None]:
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def setup(cell: Cell, seed: int, device):
    """Weights from the seed, the cluster with its seed deployed, and the
    warm-up invocations (a cached cell's first one forks its container)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = make_sync(device)
    cfg = cell.arch.port_config(cell.config)
    m = cell.config["model"]
    t = [time.perf_counter()]
    w = W.make(m, seed, device)
    sync()
    t.append(time.perf_counter())
    prog = Program(cell, cfg, w, device, sync)
    sync()
    t.append(time.perf_counter())
    for k, req in enumerate(traffic.warmup(cell.mix, m["vocab_size"], seed)):
        policy = "fork" if prog.warm is None or cell.mix["policy"] == "fork" \
            else "cache"
        if prog.invoke(req, -1 - k, policy).failed:
            raise RuntimeError("a warm-up invocation failed")
    prog.tree = None
    sync()
    t.append(time.perf_counter())
    prog.setup_parts = dict(zip(("weights_s", "cluster_and_seed_s",
                                 "warmup_s"), (b - a for a, b in zip(t, t[1:]))))
    return prog, w


def window(prog: Program, reqs: List[traffic.Request], mix: dict,
           seconds: float, trace: bool, device, tracer: bool = True):
    """Drive the window; returns (invocations, its seconds, what a traced
    window recorded: ``Run``'s fields from ``trace`` on, or {}).  A closed
    loop starts requests until ``seconds`` have passed; an open loop sends
    each at its due time and serves every one due.  A traced window runs
    the profiled sub-window with the program's tracer on, or with it off
    where ``tracer`` is false (to measure its cost)."""
    closed = mix["loop"] == "closed"
    prof = label = tracing = None
    first = mix["profile"]["first"]
    last = first + mix["profile"]["count"] - 1
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    invs: List[Invocation] = []
    if trace:
        from repro_torch import tracing
        tracing.reset()
    gc.collect()
    t_open = time.perf_counter()
    for i, req in enumerate(reqs):
        now = time.perf_counter()
        due = None
        if closed:
            if now - t_open >= seconds:
                break
        else:
            due = t_open + req.due
            if now < due:
                time.sleep(due - now)
            elif now - t_open > seconds + LATE_S:
                invs.append(Invocation(i, len(req.prompt), forked=False,
                                       due=due, failed=True))
                continue
        if trace and i == first:
            if tracer:
                tracing.enable()
            prof = profile(activities=acts)
            prof.start()
            label = _Label(profiling.LABEL + "profiled")
        invs.append(prog.invoke(req, i, mix["policy"], due))
        if label is not None and i == last:
            label.close()
            prof.stop()
            tracing.disable()
            label = None
    if label is not None:
        label.close()
        prof.stop()
        tracing.disable()
    prog.sync()
    t_close = time.perf_counter()
    if tracing is None:
        return invs, t_close - t_open, {}
    snap = tracing.snapshot()
    # the tracer starts a request at each ``invoke`` span, in call order
    roots = [s.request for s in snap["spans"]
             if s.name == "invoke" and s.parent == -1]
    traced = [v for v in invs if first <= v.index <= last
              and v.start > 0.0]
    if len(roots) == len(traced):
        for inv, r in zip(traced, roots):
            inv.request = r
    out = {"spans": snap["spans"], "counters": snap["counters"],
           "forks_traced": sum(1 for v in invs
                               if v.forked and v.request is not None)}
    if prof is not None:
        raw = profiling.raw_events(prof)
        out["trace"] = profiling.summarize(raw, range(first, last + 1))
        out["device_events"] = raw[1]
        out["profiled"] = raw[0].get(profiling.LABEL + "profiled")
    return invs, t_close - t_open, out


def check_sample(invs: List[Invocation], reqs, mix: dict, seed: int):
    """The answers the reference checks (``check.Answer``): every one, or a
    sample drawn from the seed with the longest among them."""
    done = [(reqs[v.index].prompt, v.tokens, torch.stack(v.logits))
            for v in invs if not v.failed]
    n = mix["check"]["sample"]
    if n == "all" or len(done) <= n:
        return done
    longest = max(range(len(done)), key=lambda j: len(done[j][0])
                  + len(done[j][1]))
    rest = [j for j in range(len(done)) if j != longest]
    pick = random.Random(int(seed)).sample(rest, n - 1)
    return [done[j] for j in sorted([longest] + pick)]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, control: bool = False) -> dict:
    """One run of ``cell``; returns the result line's object.  ``t0``: the
    process's start (``perf_counter``).  ``control`` also judges the
    control, the reference in TF32 in the program's place, by the same
    comparison (``forkbench/control.py``); the benchmark's runs leave it
    off."""
    return run_record(cell, seed, seconds, trace, device, t0, control)[0]


def run_record(cell: Cell, seed: int, seconds: float, trace: bool, device,
               t0: float, control: bool = False, tracer: bool = True):
    """``run``, returning (the result line's object, the run's record
    ``Run``); ``tracer`` as ``window`` takes it."""
    dev = torch.device(device)
    m, mix = cell.config["model"], cell.mix
    prog, w = setup(cell, seed, dev)
    reqs = traffic.window(mix, m["vocab_size"], seed, seconds)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0
    invs, window_s, traced = window(prog, reqs, mix, seconds, trace, dev,
                                    tracer)
    setup_parts = prog.setup_parts
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    record = Run(cell.name, m, mix, prog.page_elems, seconds, setup_s,
                 window_s, peak, invs, **traced)
    summary = record.trace

    # the program's state goes before the reference runs: the tree checked
    # is the last invocation's (a cached cell's: the one every invocation
    # served from)
    tree = prog.tree if prog.tree is not None else next(
        iter(prog.behaviour.trees.values()), None)
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = {"fork_mismatch": check.fork_mismatch(tree, w)
              if tree is not None else -1}
    del tree
    answers = check_sample(invs, reqs, mix, seed)
    want = check.reference_rows(cell.arch.Reference(m, w), answers)
    served = check.measure(want, answers)
    limits = cell.config["limits"]
    ok, checks = check.judge(dict(values, **served), limits)
    failed = sum(v.failed for v in invs)
    correct = failed == 0 and len(answers) > 0 and ok

    metrics = {}
    for entry in (cell.metrics_layer if trace else cell.metrics_e2e):
        value = reader(cell.root, entry["name"])(record)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else dev.type,
                   "count": 1, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": len(invs), "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = summary.get("busy_s", 0.0)
        device_info["window_s"] = summary.get("window_s", window_s)
        out["breakdown"] = {"device_ops": summary.get("device_ops", []),
                            "idle_gaps": summary.get("idle_gaps", [])}
    out["check_s"] = time.perf_counter() - t_check
    out["card"] = roofline.card() if dev.type == "cuda" else {}
    out["setup_parts"] = setup_parts
    out["invocations"] = [[v.prompt_len, len(v.tokens), v.latency,
                           v.tree_at - v.start, v.answer - v.submit]
                          for v in invs if not v.failed]
    out["served"] = served
    if control:
        lower = check.control_answers(
            cell.arch.Reference(m, w, precision="tf32"), answers)
        c_served = check.measure(want, lower)
        c_ok, c_checks = check.judge(dict(values, **c_served), limits)
        out["control"] = {"correct": c_ok, "served": c_served,
                          "checks": c_checks}
        # the fault "a token altered where it is produced", read on the
        # same rows: each served token one past the program's
        V = m["vocab_size"]
        out["token_altered"] = check.measure(
            want, [(p, [(t + 1) % V for t in s], r) for p, s, r in answers])
    out["checks"] = checks
    return out, record


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load:
    JAX, Flax, or the JAX package (``repro``; ``repro_torch`` is another
    name)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def emit(result: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"[forkbench] check {name}: {c['value']!r} (limit "
              f"{c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
