"""BENCHMARK.json against the benchmark's contract, every file a cell or
metric names, the traffic generator's seeds, and the frozen arithmetic
against the program's own counts."""
import json
import re

import pytest

from forkbench import roofline, traffic
from forkbench import weights as W
from forkbench.conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHJ = json.loads((ROOT / "BENCHMARK.json").read_text())
# the published config.json of each source, its keys that give a shape
PUBLISHED = {
    "https://huggingface.co/stabilityai/stablelm-3b-4e1t/blob/main/"
    "config.json": {
        "hidden_act": "silu", "hidden_size": 2560, "intermediate_size": 6912,
        "max_position_embeddings": 4096, "norm_eps": 1e-05,
        "num_attention_heads": 32, "num_hidden_layers": 32,
        "num_key_value_heads": 32, "rope_pct": 0.25, "rope_theta": 10000,
        "tie_word_embeddings": False, "use_qkv_bias": False,
        "vocab_size": 50304},
    "https://huggingface.co/mistralai/Mixtral-8x7B-v0.1/blob/main/"
    "config.json": {
        "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 14336,
        "max_position_embeddings": 32768, "model_type": "mixtral",
        "num_attention_heads": 32, "num_experts_per_tok": 2,
        "num_hidden_layers": 32, "num_key_value_heads": 8,
        "num_local_experts": 8, "rms_norm_eps": 1e-05,
        "rope_theta": 1000000.0, "sliding_window": None,
        "tie_word_embeddings": False, "vocab_size": 32000}}
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
        layer = [m for m in b["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        ends = [m for m in b["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert layer and len(ends) >= 2
        for m in layer:
            assert m["moves"] in {e["name"] for e in ends}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


@pytest.mark.parametrize("conf", BENCHJ["configs"], ids=lambda c: c["name"])
def test_each_config_file_names_its_source_and_cuts(conf):
    path = ROOT / conf["file"]
    assert path.parent == BENCH / "configs" and path.stem == conf["name"]
    f = json.loads(path.read_text())
    assert f["source"] == conf["source"] and f["reduced"] == conf["reduced"]
    assert any(w["config"] == conf["name"] for w in BENCHJ["workloads"])
    assert not [k for k in conf["reduced"] if WIDTHS.search(k)]
    source = PUBLISHED[conf["source"]]
    changed = {k for k, v in source.items() if f.get(k, "absent") != v}
    assert changed == set(conf["reduced"])


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
    from forkbench import harness
    from repro_torch.models import flops
    f = json.loads((ROOT / conf["file"]).read_text())
    total, active, embed = flops.param_counts(harness.port_config(f))
    m = f["model"]
    assert W.param_count(m) == total
    assert roofline.state_bytes(m) == 4 * total
    assert roofline.block_params(m) + embed == active
