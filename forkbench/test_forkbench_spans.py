"""The program's spans read in tiny traced runs on the CPU
(``forkbench/spans.py``): a traced run's record holds them and the
metrics that read them print a value, the fork's readings and the MoE
counter read a value with the tracer on, nothing is recorded with it off
or in an untraced run, and the device's idle time goes to the innermost
span; on the card, the tracer's ranges put nothing on the device's
timeline."""
import json
import time

import pytest
import torch

from forkbench import harness, profiling, spans
from forkbench.conftest import CELLS

SEED = 2 ** 31 + 29
FORK_READINGS = {"resume_s", "wire_read_s", "adopt_s", "staged_gb"}
PROFILED = [1, 2]            # the tiny mixes' profiled invocations


def traced(root, cell, tracer):
    # a window long enough to reach the profiled invocations (the second
    # and third, the tiny mixes' ``profile``) on a loaded CPU
    return spans.run(harness.load_cell(root, cell), SEED, 3.0,
                     torch.device("cpu"), time.perf_counter(), tracer)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tracer_on_the_readings_read_a_value(tiny_root, cell):
    out = traced(tiny_root, cell, "on")
    assert out["result"]["correct"] is True
    got = out["spans"]
    r = got["readings"]
    if "coldstart" in cell:
        assert FORK_READINGS <= set(r)
        assert all(r[k] > 0 for k in FORK_READINGS)
        assert got["fork_cover_min"] > 0
        # each fork stages every page down and up once
        down = got["counters"]["stage.dtoh_bytes.wire"]
        assert got["counters"]["stage.htod_bytes"] == down
    else:
        assert "moe_useful_pct" in r and 0 < r["moe_useful_pct"] <= 100
        assert not FORK_READINGS & set(r)
        assert not [k for k in got["counters"] if k.startswith("stage.")]
    assert got["n_spans"] > 0 and got["serve_cover_min"] > 0
    assert "decode_gap_ms" not in r        # the CPU profiler sees no device
    # only the profiled sub-window is traced: those of its invocations the
    # window reached on this CPU
    reached = [i for i in PROFILED if i < out["result"]["attempted"]]
    assert reached and [r["index"] for r in got["invocations"]] == reached


def test_tracer_off_records_nothing(tiny_root):
    out = traced(tiny_root, "tiny-stablelm-3b.coldstart", "off")
    assert out["result"]["correct"] is True
    got = out["spans"]
    assert got["n_spans"] == 0 and got["counters"] == {}
    assert got["readings"] == {} and got["invocations"] == []


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_traced_runs_record_holds_the_programs_spans(tiny_root, cell):
    """The record keeps the profiled sub-window's spans and counters, and
    nothing of the invocations around it, and every per-layer metric that
    reads them prints a value in its cells (but ``decode_gap_ms``, which
    needs the device's events)."""
    out, rec = harness.run_record(harness.load_cell(tiny_root, cell), SEED,
                                  3.0, True, torch.device("cpu"),
                                  time.perf_counter())
    assert out["correct"] is True
    assert rec.spans and rec.counters and rec.profiled is not None
    assert {s.name for s in rec.spans} >= {"invoke", "release",
                                            "serve.prefill", "serve.decode"}
    reached = [i for i in PROFILED if i < out["attempted"]]
    assert reached
    assert [v.request for v in rec.invocations] == [
        reached.index(v.index) if v.index in reached else None
        for v in rec.invocations]
    assert rec.forks_traced == (len(reached) if "coldstart" in cell
                                else 0)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in harness.cell_metrics(bench, cell)[1]
            if m["source"] in ("program_span", "program_counter")
            and not m["name"].startswith("decode_gap_ms.")}
    assert want and want <= set(out["metrics"])
    assert all(out["metrics"][k]["value"] > 0 for k in want)


def test_an_untraced_run_never_turns_the_tracer_on(tiny_root, monkeypatch):
    from repro_torch import tracing

    def enable():
        raise AssertionError("the tracer was turned on")
    monkeypatch.setattr(tracing, "enable", enable)
    out, rec = harness.run_record(
        harness.load_cell(tiny_root, "tiny-mixtral-8x7b-2L.coldstart"), SEED,
        0.6, False, torch.device("cpu"), time.perf_counter())
    assert out["correct"] is True and not tracing.enabled()
    assert rec.spans == [] and rec.counters == {} and rec.forks_traced == 0
    assert all(v.request is None for v in rec.invocations)


def test_decode_gap_is_the_idle_time_inside_decode_spans():
    from repro_torch.tracing import Span
    decode = [Span("serve.decode", a, -1, 0, {}) for a in
              (10_000, 70_000, 95_000)]
    for s, end in zip(decode, (60_000, 80_000, 120_000)):
        s.end_ns = end
    rec = harness.Run("c", {}, {}, 1, 1.0, 0.0, 1.0, 0, [], spans=decode,
                      device_events=[(20_000, 30_000, "gemv"),
                                     (40_000, 50_000, "paged_attention"),
                                     (75_000, 90_000, "gemv")],
                      profiled=(0, 100_000))
    # 10-20, 30-40, 50-60 and 70-75 idle; the third span leaves the window
    assert spans.readings(rec) == {"decode_gap_ms": pytest.approx(0.0175)}


def test_idle_gaps_go_to_the_innermost_program_span():
    from repro_torch.tracing import Span
    spans_ = [Span("invoke", 0, -1, 0, {}), Span("serve.decode", 10_000, 0,
                                                  0, {})]
    spans_[0].end_ns, spans_[1].end_ns = 90_000, 60_000
    dev = [(20_000, 30_000, "gemv"), (40_000, 50_000, "paged_attention")]
    got = dict(spans.idle_by_span(dev, (0, 100_000), spans_))
    assert got["serve.decode"] == pytest.approx(30e-6)   # 10-20 30-40 50-60
    assert got["invoke"] == pytest.approx(40e-6)         # 0-10, 60-90
    assert got["outside"] == pytest.approx(10e-6)        # 90-100


@pytest.mark.card
def test_the_tracers_ranges_leave_the_device_timeline_alone(cuda):
    """Under CUDA activity a ``record_function`` range also lands on the
    device's timeline, spanning the work it queued, where the harness
    would count it as busy; the tracer's ranges must not."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tracing
    x = torch.randn(1024, 1024, device=cuda)
    tracing.reset()
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                with tracing.span("mm"):
                    (x @ x).sum().item()
    finally:
        tracing.disable()
        tracing.reset()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "repro.mm"]
    assert len(events) == 5
    assert not [e for e in events if profiling._is_device(e)]
