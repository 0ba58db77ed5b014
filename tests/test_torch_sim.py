"""Trace replay in both packages: the event loop, traces, metrics, the fault
plane, and whole replays through the coordinator.

A replay's ``summary()`` carries no meter, so it and its digest must be
equal across the two packages whatever pools the nodes hold: the
reference's host pools, the port's host pools (``device=None``) and the
port's torch pools on the CPU (``device="cpu"``, the plain versions of the
copy kernels)."""
import functools
import json
import random
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.sim as jsim  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro.net import Network as JNetwork  # noqa: E402
from repro_torch.net import Network as TNetwork  # noqa: E402

from torch_parity import load_chip_smoke  # noqa: E402

SIDES = {"jax": (jsim, JNetwork), "torch": (tsim, TNetwork)}
PORT_POOLS = {"host": None, "cpu": "cpu"}


# ---------------------------------------------------------------------------
# event loop, traces, metrics: same inputs, same outputs
# ---------------------------------------------------------------------------


def _loop_run(S, Net, tiebreak_seed):
    net = Net()
    loop = S.EventLoop(net, seed=5, tiebreak_seed=tiebreak_seed)
    clock = S.SimClock(net)
    out = []
    for i in range(6):
        loop.at(1.0, lambda i=i: out.append((f"a{i}", clock())),
                label=f"a{i}", priority=i % 2)
    loop.at(0.5, lambda: out.append(("b", clock())), label="b")
    loop.every(0.7, lambda: out.append(("tick", loop.now)), until=3.0,
               label="tick", priority=3)
    loop.after(2.5, lambda: out.append(("late", loop.rng.random())))
    ran = loop.run(until=2.0)
    ran2 = loop.run()
    with pytest.raises(ValueError):
        loop.at(-1.0, print)
    with pytest.raises(ValueError):
        loop.every(0.0, print, until=1.0)
    return out, ran, ran2, loop.log, loop.log_digest(), loop.now


@pytest.mark.parametrize("tiebreak_seed", [None, 1, 2])
def test_event_loop_matches_reference(tiebreak_seed):
    ref = _loop_run(*SIDES["jax"], tiebreak_seed)
    port = _loop_run(*SIDES["torch"], tiebreak_seed)
    assert port == ref


def _traces(S, tmp_path):
    csv = tmp_path / "trace.csv"
    csv.write_text("HashOwner,HashFunction,1,2,3\n"
                   "o,aaaaaaaaaaaa1,1,0,2\no,aaaaaaaaaaaa2,0,5,1\n"
                   "o,bbbbbbbb,3,3,3\n")
    traces = [S.spike_660323(), S.spike_660323(scale=3, func="f"),
              S.correlated_spikes(3, scale=2, stagger_minutes=1),
              S.diurnal(minutes=30, phase=0.25),
              S.multi_function([S.spike_660323(func="x"),
                                S.diurnal(minutes=5, func="y")]),
              S.load_azure_csv(str(csv), top=2),
              S.load_azure_csv(str(csv), minutes=2).scaled(4)]
    out = []
    for tr in traces:
        rng = random.Random(11)
        arr = tr.arrivals(rng)
        out.append((tr.name, dict(tr.per_minute), tr.functions, tr.minutes,
                    tr.total_invocations(), tr.peak_per_minute(),
                    [(a.t, a.func, a.idx) for a in arr]))
    return out


def test_traces_and_arrivals_match_reference(tmp_path):
    assert _traces(tsim, tmp_path) == _traces(jsim, tmp_path)
    assert tsim.SPIKE_660323 == jsim.SPIKE_660323


@pytest.mark.parametrize("n", [0, 1, 7, 250])
def test_metrics_match_reference(n):
    def run(S):
        rng = np.random.default_rng(n)
        samples = list(rng.exponential(0.03, n))
        tl = S.Timeline("m", keep_nodes=True)
        tele = S.TelemetryStream()
        for i in range(3):
            tl.record(i * 30.0, {f"n{j}": float(rng.integers(0, 9))
                                 for j in range(4)})
            tele.emit(i * 30.0 + 1e-10, "gc", seeds=i)
        return (S.percentile(samples, 99), S.latency_row(samples),
                S.cdf_points(samples), tl.series(), tl.rows, tl.peak_node(),
                tl.peak_total(), tl.peak_mean(), tl.final_total(),
                tele.to_json(), tele.last("gc"),
                S.canonical_digest({"s": samples, "k": [1, "a"]}))
    assert run(tsim) == run(jsim)


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_fault_plans_and_injector_match_reference(seed):
    def run(S, Net):
        ids = [f"n{i}" for i in range(7)]
        plan = S.FaultPlan.random(seed, ids, 200.0, crash_rate=0.3,
                                  flap_rate=0.3, degrade_rate=0.3,
                                  op_fail_rate=0.2)
        net = Net()
        inj = S.FaultInjector(net, plan)
        seen = []
        for t in np.linspace(0.0, 200.0, 41):
            net.sim_time = float(t)
            for a in ids[:4]:
                seen.append((inj.flapped(a), inj.dark(a),
                             inj.op_fault("dct", "read", a, ids[-1]),
                             inj.penalty(a, ids[-1])))
        with pytest.raises(ValueError):
            S.FaultPlan(op_fail_rate=1.5)
        with pytest.raises(ValueError):
            S.FaultPlan(flaps=(S.Flap(2.0, 1.0, "n0"),))
        return plan.describe(), plan.empty(), S.FaultPlan().empty(), seen
    assert run(*SIDES["torch"]) == run(*SIDES["jax"])


# ---------------------------------------------------------------------------
# whole replays
# ---------------------------------------------------------------------------


def _fn(S, name="spike"):
    return S.SimFunction(name, state_bytes=16 * 1024 * 4, touch_frac=0.25,
                         exec_s=0.030, coldstart_s=0.167, hold_s=60.0)


POLICIES = {
    "fork": lambda S: S.ForkOnDemand(replicas=2, prefetch=0),
    "keepwarm": lambda S: S.KeepWarm(ttl=60.0, prewarm=2),
    "hybrid": lambda S: S.Hybrid(pool=2, ttl=60.0, prefetch=0),
    "coldstart": lambda S: S.ColdStart(),
}


def _spike_replay(S, policy, **kw):
    eng = S.ReplayEngine(S.spike_660323(scale=2), POLICIES[policy](S),
                         [_fn(S)], n_nodes=8, seed=20260809,
                         page_elems=1024, **kw)
    res = eng.run()
    return eng, res


@functools.lru_cache(maxsize=None)
def _ref_spike(policy):
    _, res = _spike_replay(jsim, policy)
    return res.summary(), res.digest()


@pytest.mark.parametrize("pool", sorted(PORT_POOLS))
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_spike_replay_matches_reference(policy, pool):
    ref_summary, ref_digest = _ref_spike(policy)
    eng, res = _spike_replay(tsim, policy, device=PORT_POOLS[pool])
    assert res.summary() == ref_summary
    assert res.digest() == ref_digest
    assert res.invocations == 402
    if pool == "cpu":
        # the torch pools really moved the pages
        assert eng.net.meter["kernel.cow_scatter.torch"] > 0
        assert all(n.pool.device == torch.device("cpu") for n in eng.nodes)
    else:
        assert all(n.pool.device is None for n in eng.nodes)


def test_port_device_pools_replay_equals_host_pools():
    """The port against itself: the fig20 MITOSIS row's configuration
    (4 replicas, no prefetch, 4 KiB pages) at scale 2, with torch pools on
    the CPU and with host pools, gives the same digests, sim time and
    meters.  Left out of the meters, and only these: the device pools'
    ``kernel.*`` impl choices, and the host pools' ``pool.*_runs`` counts
    of slice copies (a device pool moves runs in one kernel call)."""
    fn = tsim.SimFunction("spike", state_bytes=16 * 1024 * 4,
                          touch_frac=0.05, exec_s=0.030, coldstart_s=0.167,
                          hold_s=60.0)
    runs = {}
    for label, device in PORT_POOLS.items():
        eng = tsim.ReplayEngine(tsim.spike_660323(scale=2),
                                tsim.ForkOnDemand(replicas=4, prefetch=0),
                                [fn], n_nodes=8, seed=20260809,
                                page_elems=1024, device=device)
        res = eng.run()
        meter = {k: v for k, v in eng.net.meter.items()
                 if not k.startswith("kernel.")
                 and k not in ("pool.gather_runs", "pool.scatter_runs")}
        runs[label] = (res.digest(), res.event_log_digest, meter,
                       eng.net.sim_time)
        kernels = [k for k in eng.net.meter if k.startswith("kernel.")]
        assert bool(kernels) == (device is not None)
    assert runs["cpu"] == runs["host"]


def _chaos(S, plan_fn, device):
    trace = S.Trace("chaos", {"f": (4, 3, 4)})
    fn = S.SimFunction("f", state_bytes=8 * 1024 * 4, touch_frac=0.5,
                       hold_s=30.0)
    kw = {} if S is jsim else {"device": device}
    net, nodes = S.build_cluster(6, page_elems=1024, **kw)
    eng = S.ReplayEngine(trace, S.ForkOnDemand(replicas=2, prefetch=0),
                         [fn], network=net, nodes=nodes, seed=7,
                         faults=plan_fn(S))
    return eng.run().summary()


FAULT_PLANS = {
    "crash": lambda S: S.FaultPlan(crashes=(S.Crash(20.0, "n0"),
                                            S.Crash(25.0, "n1"))),
    "flap": lambda S: S.FaultPlan(flaps=(S.Flap(10.0, 70.0, "n0"),
                                         S.Flap(65.0, 90.0, "n2"))),
    "degrade": lambda S: S.FaultPlan(degrades=(
        S.Degrade(0.0, 120.0, "n0", 0.25),
        S.Degrade(30.0, 60.0, "n1", 0.5))),
    "random": lambda S: S.FaultPlan.random(
        4, [f"n{i}" for i in range(6)], 110.0, crash_rate=0.2,
        flap_rate=0.3, flap_len_s=20.0, op_fail_rate=0.05),
}


@pytest.mark.parametrize("pool", sorted(PORT_POOLS))
@pytest.mark.parametrize("plan", sorted(FAULT_PLANS))
def test_fault_replay_matches_reference(plan, pool):
    ref = _chaos(jsim, FAULT_PLANS[plan], None)
    port = _chaos(tsim, FAULT_PLANS[plan], PORT_POOLS[pool])
    assert port == ref
    assert "faults" in port
    assert jsim.canonical_digest(port) == tsim.canonical_digest(ref)


CHIP_SMOKE = load_chip_smoke()
FIG22_PLANS = {
    # a seed parent crashes inside the burst minute: the card run's plan
    "crash": None,
    # crashes, flaps and degrades across the cluster
    "storm": lambda ids, dur: tsim.FaultPlan.random(
        CHIP_SMOKE.FIG22["seed"] + 2, ids, dur, crash_rate=0.1,
        flap_rate=0.2, degrade_rate=0.1, op_fail_rate=0.05),
}


@pytest.mark.parametrize("plan,pool", [("crash", "cpu"), ("storm", "host")])
def test_fig22_fault_replay_reproduces_committed_digest(plan, pool):
    """Figure 22's configuration (spike x8 = 1,608 invocations, 32 nodes
    with 8 links each, 2 replicas, 64 pages over 2 VMAs, re-routing at
    0.05 s of backlog), replayed by the port through the card script's
    own ``fig22_replay``, reproduces the event-log digest the reference
    committed in ``BENCH_faults.json``."""
    bench = json.loads((Path(__file__).resolve().parents[1]
                        / "BENCH_faults.json").read_text())["fig22"]
    s = CHIP_SMOKE.fig22_replay(PORT_POOLS[pool],
                                faults=FIG22_PLANS[plan]).summary()
    assert s["nodes"] == 32
    assert s["event_log_digest"] == bench["event_log_digest"][plan]
    assert s["invocations"] == bench["invocations"]
    assert s["faults"]["completion_rate"] == bench["completion"][plan]


def test_build_cluster_defaults_to_the_card():
    """Replays hold their pools on ``cuda`` unless told otherwise: on a
    machine without a card, building the default cluster fails instead of
    falling back to host pools."""
    import inspect
    for fn in (tsim.build_cluster, tsim.ReplayEngine.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            net, nodes = tsim.build_cluster(1, page_elems=64, pool_frames=4)
            nodes[0].pool.alloc("float32", 1)
