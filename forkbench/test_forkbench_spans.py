"""The program's spans read in tiny traced runs on the CPU
(``forkbench/spans.py``): the fork's readings and the MoE counter read a
value with the tracer on, nothing is recorded with it off, and the
device's idle time goes to the innermost span; on the card, the tracer's
ranges put nothing on the device's timeline."""
import time

import pytest
import torch

from forkbench import harness, profiling, spans
from forkbench.conftest import CELLS

SEED = 2 ** 31 + 29
FORK_READINGS = {"resume_s", "wire_read_s", "adopt_s", "staged_gb"}


def traced(root, cell, tracer):
    return spans.run(harness.load_cell(root, cell), SEED, 0.6,
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
    assert len(got["invocations"]) == out["result"]["attempted"]


def test_tracer_off_records_nothing(tiny_root):
    out = traced(tiny_root, "tiny-dense.coldstart", "off")
    assert out["result"]["correct"] is True
    got = out["spans"]
    assert got["n_spans"] == 0 and got["counters"] == {}
    assert got["readings"] == {} and got["invocations"] == []


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
