"""The harness on the CPU, at tiny sizes: a run of each traffic mix prints
a well-formed last line; new configuration, traffic and metric files are
found by name; and with the timed path broken underneath, ``correct``
comes out false."""
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from forkbench import harness
from forkbench.conftest import BENCH, CELLS, ROOT, make_root, twins

SEED = 2 ** 31 + 11          # past 32 signed bits, as the driver's are


def run_cell(root, cell, trace=False, seconds=0.6, seed=SEED, **kw):
    t0 = time.perf_counter()
    return harness.run(harness.load_cell(root, cell), seed, seconds, trace,
                       torch.device("cpu"), t0, **kw)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_run_prints_a_well_formed_last_line(tiny_root, cell, trace, capsys):
    out = run_cell(tiny_root, cell, bool(trace))
    harness.emit(out)
    stdout, stderr = capsys.readouterr()
    line = json.loads(stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    tail = stderr.strip().splitlines()[-len(line["checks"]):]
    for (name, c), said in zip(line["checks"].items(), tail):
        assert f"check {name}: {c['value']!r} (limit {c['limit']!r})" in said
        assert c["value"] <= c["limit"]
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in harness.cell_metrics(bench, cell)[trace]}
    got = set(line["metrics"])
    assert got <= want
    host = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
            if m["source"] == "host_clock"} - {"peak_device_gb"}
    assert want & host <= got          # the CPU reads every host metric
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


TWO_GROUPS = '''"""A test architecture: gqa_moe's block in two groups, one block
repeated once, then a unit of two blocks repeated twice."""
import dataclasses
import importlib.util
from pathlib import Path

from forkbench.archs import gqa_moe
from forkbench.archs.gqa_moe import block_leaves
# the checks and the counts are gqa_moe's: every layer is its block
from forkbench.archs.gqa_moe import (  # noqa: F401
    attention_bytes, block_params, check_config, decode_work, prefill_work,
    state_bytes)

_path = Path(__file__).parents[1] / "reference" / "two_groups.py"
_spec = importlib.util.spec_from_file_location("two_groups_reference", _path)
_ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ref)
Reference = _ref.Reference


def port_config(conf):
    from repro_torch.configs.base import AttnSpec, GroupSpec
    return dataclasses.replace(gqa_moe.port_config(conf), groups=(
        GroupSpec(unit=(AttnSpec(),), repeat=1),
        GroupSpec(unit=(AttnSpec(), AttnSpec()), repeat=2)))


def leaves(m):
    assert m["num_layers"] == 5
    D, V = m["d_model"], m["vocab_size"]
    return ([(("embed", "tok"), (V, D), 0.02),
             (("embed", "out"), (D, V), D ** -0.5)]
            + block_leaves(m, ("groups", "0", "blocks", "0"), 1)
            + block_leaves(m, ("groups", "1", "blocks", "0"), 2)
            + block_leaves(m, ("groups", "1", "blocks", "1"), 2)
            + [(("final_norm", "scale"), (D,), 0.1)])
'''


def test_new_files_are_found_by_name(tiny_root, monkeypatch):
    """A configuration of a new architecture (its module and its own copy
    of the reference) from a new source (its published keys), a traffic
    mix and a metric added as files, and named in BENCHMARK.json, keep the
    contract and run with no other edit; the per-layer metrics of the
    mix they share come with them."""
    import sys
    from forkbench import archs, roofline
    from forkbench import weights as W
    from forkbench.test_forkbench_files import config_contract
    b = tiny_root / "forkbench"
    (b / "archs").mkdir()
    (b / "archs" / "two_groups.py").write_text(TWO_GROUPS)
    (b / "reference").mkdir()
    shutil.copy(Path(archs.__file__).parents[1] / "reference" / "model.py",
                b / "reference" / "two_groups.py")
    monkeypatch.delitem(sys.modules, "forkbench.archs.two_groups",
                        raising=False)
    source = "https://example.org/tiny-deep/config.json"
    published = {"hidden_size": 64, "num_attention_heads": 4,
                 "num_hidden_layers": 10, "vocab_size": 256}
    (b / "sources").mkdir()
    (b / "sources" / "tiny-deep.json").write_text(json.dumps(
        {"source": source, "config": published}))
    conf = json.loads((b / "configs" / "tiny-stablelm-3b.json").read_text())
    conf["name"] = conf["port"]["name"] = "tiny-deep"
    conf["model"].update(num_layers=5, arch="two_groups")
    conf.update(published, num_hidden_layers=5, source=source,
                reduced=["num_hidden_layers"])
    (b / "configs" / "tiny-deep.json").write_text(json.dumps(conf))
    mix = json.loads((b / "traffic" / "coldstart.json").read_text())
    mix["output"].update(min=1, max=1)
    (b / "traffic" / "one-token.json").write_text(json.dumps(mix))
    (b / "metrics" / "tokens_served.py").write_text(
        "def read(run):\n"
        "    return float(sum(len(v.tokens) for v in run.ok))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-deep", "source": source,
                             "file": "forkbench/configs/tiny-deep.json",
                             "reduced": ["num_hidden_layers"],
                             "why": "a CPU test"})
    bench["workloads"] += [
        {"name": "tiny-deep.one-token", "config": "tiny-deep",
         "traffic": "one-token", "chips": 1, "why": "a CPU test"},
        {"name": "tiny-deep.coldstart", "config": "tiny-deep",
         "traffic": "coldstart", "chips": 1, "why": "a CPU test"}]
    bench["end_to_end"].append({"name": "tokens_served", "unit": "tokens",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny-deep.one-token"]})
    invoke_s = next(m for m in bench["end_to_end"] if m["name"] == "invoke_s")
    invoke_s["workloads"].append("tiny-deep.coldstart")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    config_contract(tiny_root, bench, bench["configs"][-1])
    e2e, layer = harness.cell_metrics(bench, "tiny-deep.coldstart")
    assert {m["name"] for m in layer} == {
        m["name"] for m in harness.cell_metrics(
            bench, "tiny-stablelm-3b.coldstart")[1]}
    cell = harness.load_cell(tiny_root, "tiny-deep.one-token")
    assert Path(cell.arch.__file__) == b / "archs" / "two_groups.py"
    assert Path(cell.arch._ref.__file__) == b / "reference" / "two_groups.py"
    cfg = harness.port_config(conf)
    assert [(len(g.unit), g.repeat) for g in cfg.groups] == [(1, 1), (2, 2)]
    w = W.make(conf["model"], SEED, "cpu")
    assert [len(g["blocks"]) for g in w["groups"]] == [1, 2]
    assert W.param_count(conf["model"]) == roofline.state_bytes(
        conf["model"]) // 4
    out = run_cell(tiny_root, "tiny-deep.one-token")
    assert out["correct"]
    assert out["checks"]["fork_mismatch"]["value"] == 0
    # max_tokens 1: the prefill's token, and one decode step past it
    assert out["metrics"]["tokens_served"]["value"] == 2 * out["attempted"]
    assert "setup_s" in out["metrics"] and "invoke_s" not in out["metrics"]


NEW_CELL = "mixtral-8x7b-4L.warm"


def _with_a_new_cell(src: Path) -> None:
    """The benchmark's files under ``src``, with a second configuration of
    an existing architecture and a cell of it added as new files, the
    cell named in ``invoke_p50_s``'s list and in that of a new per-layer
    metric, ``served_tokens``, whose reader is a new file too."""
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / d, src / BENCH.name / d)
    conf = json.loads((BENCH / "configs" / "mixtral-8x7b-2L.json").read_text())
    conf.update(name="mixtral-8x7b-4L", num_hidden_layers=4)
    conf["port"]["name"] = conf["name"]
    conf["model"]["num_layers"] = 4
    (src / BENCH.name / "configs" / "mixtral-8x7b-4L.json").write_text(
        json.dumps(conf))
    (src / BENCH.name / "metrics" / "served_tokens.py").write_text(
        "def read(run):\n"
        "    return float(sum(len(v.tokens) for v in run.ok))\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": conf["name"], "source": conf["source"],
                             "file": "forkbench/configs/mixtral-8x7b-4L.json",
                             "reduced": ["num_hidden_layers"],
                             "why": "a CPU test"})
    bench["workloads"].append({"name": NEW_CELL, "config": conf["name"],
                               "traffic": "warm", "chips": 1,
                               "why": "a CPU test"})
    p50 = next(m for m in bench["end_to_end"] if m["name"] == "invoke_p50_s")
    p50["workloads"].append(NEW_CELL)
    bench["per_layer"].append({"name": "served_tokens", "unit": "tokens",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving", "moves": "invoke_p50_s",
                               "workloads": [NEW_CELL]})
    (src / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("trace", [0, 1])
def test_a_new_cell_is_taken_from_new_files_only(tmp_path, trace):
    """A cell added to the benchmark as new files and named in metrics'
    lists gets a tiny twin of its own from ``make_root``, with no edit to
    the CPU tests' fixtures; the twin reports the metrics listed for it,
    and every real cell's twin keeps its metrics."""
    src = tmp_path / "real"
    _with_a_new_cell(src)
    twin = twins(src)[2][NEW_CELL]
    assert twin == "tiny-mixtral-8x7b-4L.warm" and twin not in CELLS
    root = make_root(tmp_path / "tiny", src)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    e2e, layer = harness.cell_metrics(bench, twin)
    assert {"invoke_p50_s", "peak_device_gb", "setup_s"} == {
        m["name"] for m in e2e}
    assert {"served_tokens", "kv_cache_gb"} == {m["name"] for m in layer}
    usual = json.loads((make_root(tmp_path / "usual") / "BENCHMARK.json")
                       .read_text())
    names = lambda b, cell: [[m["name"] for m in ms]
                             for ms in harness.cell_metrics(b, cell)]
    for cell in CELLS:
        assert names(bench, cell) == names(usual, cell)
    out = run_cell(root, twin, bool(trace))
    assert out["correct"] is True and out["failed"] == 0
    want = {m["name"] for m in (e2e, layer)[trace]} - {"peak_device_gb"}
    assert want <= set(out["metrics"]) <= want | {"peak_device_gb"}
    if trace:
        # one prefill token and the decode steps past it, each request
        assert out["metrics"]["served_tokens"]["value"] >= 2 * out[
            "attempted"]


def _alter_token(monkeypatch):
    from repro_torch.serving import engine
    real = engine.sample
    monkeypatch.setattr(engine, "sample",
                        lambda logits: (real(logits) + 1) % logits.shape[-1])


def _skip_kv_write(monkeypatch):
    """A decode step that leaves the cache as it was."""
    from repro_torch.serving.engine import ServingEngine
    monkeypatch.setattr(ServingEngine, "_write_token",
                        lambda self, sids, layer, k, v: None)


def _corrupt_page(monkeypatch):
    """A fork whose assembled leaves carry one wrong element."""
    from repro_torch.memory.pool import PagePool
    real = PagePool.assemble

    def assemble(self, dtype, frames, shape):
        out = real(self, dtype, frames, shape)
        if out.numel() > 1000:
            out.view(-1)[1000] += 1.0
        return out
    monkeypatch.setattr(PagePool, "assemble", assemble)


@pytest.mark.parametrize("fault", [_alter_token, _skip_kv_write,
                                   _corrupt_page])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault,
                                            monkeypatch):
    fault(monkeypatch)
    out = run_cell(tiny_root, cell)
    assert out["correct"] is False
    checks = out["checks"]
    assert any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_the_limit(tiny_root, cell):
    """The reference computed in TF32 in the program's place, judged by
    the same comparison at the same served positions, is not correct,
    where the program is: its logits read past the limit."""
    out = run_cell(tiny_root, cell, seconds=1.5, control=True)
    assert out["correct"] is True and out["control"]["correct"] is False
    limit = out["checks"]["logit_err_p90"]["limit"]
    assert out["served"]["logit_err_p90"] <= limit
    assert out["control"]["checks"]["logit_err_p90"]["value"] > limit
    assert out["control"]["checks"]["fork_mismatch"] == \
        out["checks"]["fork_mismatch"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_a_cell_is_correct_on_the_card(cuda, cell):
    out = harness.run(harness.load_cell(ROOT, cell), SEED, 10.0, False, cuda,
                      time.perf_counter())
    assert out["correct"], out["checks"]
