"""BENCHMARK.json against the benchmark's contract, every file a cell or
metric names, each configuration against its source's published keys
(``forkbench/sources/<config>.json``), the traffic generator's seeds, and
the frozen arithmetic against the program's own counts."""
import json
import re

import pytest

from forkbench import harness, roofline, traffic
from forkbench import weights as W
from forkbench.conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHJ = json.loads((ROOT / "BENCHMARK.json").read_text())
WIDTHS = re.compile(r"(_dim|_rank)$|hidden_size|intermediate_size|"
                    r"num_experts_per_tok|head")


def test_benchmark_json_keeps_the_contract():
    b = BENCHJ
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["forkbench"] and 1 <= b["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    names = [c["name"] for c in b["configs"]] + [
        w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        ends, layer = harness.cell_metrics(b, w["name"])
        assert layer and len(ends) >= 2
        for m in layer:
            assert m["moves"] in {e["name"] for e in ends}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    # a per-layer metric named for a traffic mix, with no list of its own,
    # is the metric of every cell of that mix and of no other
    mixes = {w["traffic"] for w in b["workloads"]}
    for m in b["per_layer"]:
        kind = m["name"].rsplit(".", 1)[-1]
        if "workloads" not in m and kind in mixes:
            assert {w["name"] for w in b["workloads"]
                    if m in harness.cell_metrics(b, w["name"])[1]} == {
                w["name"] for w in b["workloads"] if w["traffic"] == kind}


def config_contract(root, bench: dict, conf: dict) -> None:
    """A configuration entry of ``bench`` (the root ``root``'s) against
    the contract: its file lies in the configs and holds its source and
    its cuts, a cell uses it, ``reduced`` names no width, and the keys it
    changed from its source's published config
    (``forkbench/sources/<config>.json``, found by name) are exactly
    ``reduced``."""
    bench_dir = root / BENCH.name
    path = root / conf["file"]
    assert path.parent == bench_dir / "configs" and path.stem == conf["name"]
    f = json.loads(path.read_text())
    assert f["source"] == conf["source"] and f["reduced"] == conf["reduced"]
    assert any(w["config"] == conf["name"] for w in bench["workloads"])
    assert not [k for k in conf["reduced"] if WIDTHS.search(k)]
    published = json.loads((bench_dir / "sources"
                            / f"{conf['name']}.json").read_text())
    assert published["source"] == conf["source"]
    source = published["config"]
    changed = {k for k, v in source.items() if f.get(k, "absent") != v}
    assert changed == set(conf["reduced"])


@pytest.mark.parametrize("conf", BENCHJ["configs"], ids=lambda c: c["name"])
def test_each_config_file_names_its_source_and_cuts(conf):
    config_contract(ROOT, BENCHJ, conf)


def test_a_seed_orders_the_same_work():
    mix = json.loads((BENCH / "traffic" / "warm.json").read_text())
    one = traffic.window(mix, 1000, 2 ** 31 + 1, 40)
    again = traffic.window(mix, 1000, 2 ** 31 + 1, 40)
    other = traffic.window(mix, 1000, 7, 40)
    assert [r.prompt for r in one] == [r.prompt for r in again]
    shape = lambda reqs: sorted((len(r.prompt), r.max_tokens) for r in reqs)
    assert shape(one) == shape(other)
    assert len(one) == len(other) and one[-1].due < 40
    assert [r.due for r in one] == [r.due for r in other]
    assert one[1].due - one[0].due == pytest.approx(1 / mix["rate"])
    assert max(len(r.prompt) for r in one) <= mix["prompt"]["max"]
    cold = json.loads((BENCH / "traffic" / "coldstart.json").read_text())
    a, b = traffic.window(cold, 1000, 1, 40), traffic.window(cold, 1000, 2, 40)
    n = cold["cycle"]
    assert shape([a[i] for i in range(n)]) == shape([b[i] for i in range(n)])


@pytest.mark.parametrize("conf", BENCHJ["configs"], ids=lambda c: c["name"])
def test_frozen_counts_equal_the_programs(conf):
    from repro_torch.models import flops
    f = json.loads((ROOT / conf["file"]).read_text())
    total, active, embed = flops.param_counts(harness.port_config(f))
    m = f["model"]
    assert W.param_count(m) == total
    assert roofline.state_bytes(m) == 4 * total
    assert roofline.block_params(m) + embed == active
