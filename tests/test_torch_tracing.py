"""The port's tracer (``repro_torch.tracing``) on the CPU, with the
``micro-hello`` config on device pools held on the CPU: off it records
nothing and costs one shared object; on, a fork and a serve give nested
spans under one request, counters of the bytes staged through the host
and of the MoE dispatch's rows, the same meters and digests as with it
off, and spans that line up with their ``repro.*`` profiler events."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import _dtypes, tracing  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core.instance import ModelInstance  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.net import Network  # noqa: E402
from repro_torch.platform.coordinator import Coordinator, FunctionDef  # noqa: E402
from repro_torch.platform.node import NodeRuntime  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

CFG = dataclasses.replace(get_arch("micro-hello"), compute_dtype="float32",
                          param_dtype="float32")
PAGE_ELEMS = 1024
PROMPT = [5, 17, 3, 99, 42, 7, 250, 11, 64]
FORK_PATH = ("fork.resume", "instance.fault", "net.read_pages",
             "instance.adopt", "pool.assemble")
SERVE_PATH = ("serve.prefill", "serve.decode")


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def behaviour(inst, inputs):
    tree = inst.materialize_pytree()
    eng = ServingEngine(CFG, tree, page_tokens=4, device="cpu")
    rid = eng.submit(inputs["prompt"], max_tokens=inputs["max_tokens"])
    return {"tokens": eng.run_to_completion()[rid], "tree": tree}


def fork_and_serve():
    """A seed on node0, one lazy fork of it onto node1 that materializes
    its whole tree and serves one request, then the child's release."""
    dispatch.reset_meters()
    w = lm.init_params(CFG, torch.Generator().manual_seed(3), device="cpu")
    net = Network()
    nodes = [NodeRuntime(f"node{i}", net, page_elems=PAGE_ELEMS,
                         device_pool=True, device="cpu") for i in range(2)]
    coord = Coordinator(net, nodes, seed_replicas=1)
    coord.register_function(FunctionDef("f", CFG.name, lambda: w, behaviour))
    seed = ModelInstance.create(nodes[0], CFG.name, w)
    coord.deploy_seed("f", nodes[0], instance=seed, replicas=1)
    state = sum(v.npages * PAGE_ELEMS * _dtypes.itemsize(v.dtype)
                for v in seed.aspace.values())
    out, child = coord.invoke("f", {"prompt": PROMPT, "max_tokens": 5},
                              node=nodes[1], policy="fork", lazy=True,
                              prefetch=1)
    stats = dict(child.stats)
    coord.release("f", child, "fork")
    digest = [_dtypes.to_numpy(t).tobytes() for t in _leaves(out["tree"])]
    return {"meter": dict(net.meter), "sim_time": net.sim_time,
            "stats": stats, "tokens": list(out["tokens"]),
            "digest": digest, "state_bytes": state}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def test_off_records_nothing_and_spans_are_one_shared_object():
    a = tracing.span("invoke", request=True)
    b = tracing.span("pool.assemble", pages=3)
    assert a is b is tracing.NOTHING
    with a:
        tracing.count("stage.htod_bytes", 10)
    fork_and_serve()
    snap = tracing.snapshot()
    assert snap == {"spans": [], "counters": {}}


def test_on_a_fork_and_a_serve_nest_under_one_request():
    tracing.enable()
    fork_and_serve()
    tracing.disable()
    spans = tracing.snapshot()["spans"]
    names = {s.name for s in spans}
    assert set(FORK_PATH + SERVE_PATH) | {"invoke", "release"} == names
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["invoke", "release"]
    assert {s.request for s in spans} == {0}
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert spans.index(p) < spans.index(s)

    def chain(s):
        out = []
        while s.parent >= 0:
            s = spans[s.parent]
            out.append(s.name)
        return out
    by = lambda name: [s for s in spans if s.name == name]
    assert all(chain(s) == ["invoke"] for s in by("fork.resume"))
    assert all(chain(s)[0] == "instance.fault" and chain(s)[-1] == "invoke"
               for s in by("net.read_pages") + by("instance.adopt"))
    assert all(chain(s) == ["invoke"] for s in by("serve.decode"))
    # every leaf of the lazy child faults once, reads once, adopts once
    faults = by("instance.fault")
    assert len(faults) == len(by("net.read_pages")) == len(by("instance.adopt"))
    assert sum(s.attrs["pages"] for s in faults) == \
        sum(s.attrs["pages"] for s in by("instance.adopt"))
    assert len(by("serve.prefill")) == 1
    assert len(by("serve.decode")) == 4        # 5 tokens: the prefill's + 4
    assert by("serve.prefill")[0].attrs == {"tokens": len(PROMPT)}


def test_a_second_request_gets_its_own_id():
    tracing.enable()
    with tracing.span("invoke", request=True):
        with tracing.span("serve.decode"):
            pass
    with tracing.span("release"):
        pass
    with tracing.span("invoke", request=True):
        pass
    spans = tracing.snapshot()["spans"]
    assert [(s.name, s.request, s.parent) for s in spans] == [
        ("invoke", 0, -1), ("serve.decode", 0, 0), ("release", 0, -1),
        ("invoke", 1, -1)]


def test_staged_bytes_equal_the_states_page_bytes():
    tracing.enable()
    got = fork_and_serve()
    counters = tracing.snapshot()["counters"]
    assert counters["stage.dtoh_bytes.wire"] == got["state_bytes"]
    assert counters["stage.htod_bytes"] == got["state_bytes"]
    assert "stage.dtoh_bytes.cache" not in counters
    assert got["state_bytes"] > 0


@pytest.mark.parametrize("path", ["dense", "routed"])
@pytest.mark.parametrize("T", [1, 64])
def test_moe_rows_useful_share_is_a_quarter_at_capacity_factor_4(
        T, path):
    """The dense dispatch (here, as in training, with gradients tracked)
    computes E cap = 4 T K rows for the T K routed ones; the routed path,
    where no gradient is tracked (run here on the CPU through the kernel's
    plain version), only those."""
    cfg = dataclasses.replace(CFG, moe_experts=8, moe_topk=2, moe_d_ff=32,
                              moe_capacity_factor=4.0)
    gen = torch.Generator().manual_seed(T)
    params = MOE.init_moe(gen, cfg, device="cpu")
    if path == "dense":
        params = {k: v.requires_grad_() for k, v in params.items()}
    x = torch.randn(1, T, cfg.d_model, generator=gen)
    tracing.enable()
    with MOE.routed_on("cpu"):
        MOE.moe_mlp(params, x, cfg)
    c = tracing.snapshot()["counters"]
    assert c["moe.routed_rows"] == 2 * T
    assert c["moe.routed_rows"] / c["moe.expert_rows"] == \
        (0.25 if path == "dense" else 1.0)
    assert c.get("moe.routed_calls", 0) == (path == "routed")


def test_meters_stats_and_digests_are_the_same_on_and_off():
    off = fork_and_serve()
    tracing.enable()
    on = fork_and_serve()
    assert tracing.snapshot()["spans"]
    assert on == off


def test_spans_match_their_profiler_events_within_50_us():
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fork_and_serve()
    tracing.disable()
    spans = tracing.snapshot()["spans"]
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX):
            start = e.start_ns()
            events.setdefault(e.name()[len(tracing.PREFIX):], []).append(
                (start, start + e.duration_ns()))
    assert sum(map(len, events.values())) == len(spans)
    worst = 0
    for name, evs in events.items():
        mine = [(s.start_ns, s.end_ns) for s in spans if s.name == name]
        assert len(mine) == len(evs), name
        for (s0, s1), (e0, e1) in zip(mine, sorted(evs)):
            worst = max(worst, abs(s0 - e0), abs(s1 - e1))
    assert worst <= 50_000, f"{worst} ns"
