"""Fixtures of the benchmark's CPU tests: a benchmark root in a temporary
directory with tiny configurations of the two block kinds (dense and
MoE), each real cell's tiny twin under the real traffic mixes cut to tiny
lengths, and the real metric readers, run on the CPU's pools and the
kernels' plain versions.

Tests that need the card carry the ``card`` marker and decide whether
there is one in the ``cuda`` fixture, never at import."""
import json
import shutil
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CELLS = {"tiny-dense.coldstart": ("tiny-dense", "coldstart"),
         "tiny-moe.warm": ("tiny-moe", "warm"),
         "tiny-moe.coldstart": ("tiny-moe", "coldstart")}
# the real cells' names, for the per-metric workload lists
REAL = {"stablelm-3b.coldstart": "tiny-dense.coldstart",
        "mixtral-8x7b-2L.warm": "tiny-moe.warm",
        "mixtral-8x7b-2L.coldstart": "tiny-moe.coldstart"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips where there is none)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_model(moe: bool) -> dict:
    return {"d_model": 64, "num_heads": 4, "num_kv_heads": 4 if moe else 2,
            "head_dim": 16, "d_ff": 0 if moe else 128, "vocab_size": 256,
            "num_layers": 2, "mlp_gated": True, "tie_embeddings": False,
            "rope_theta": 10000.0, "norm_eps": 1e-5,
            "moe_experts": 8 if moe else 0, "moe_topk": 2 if moe else 0,
            "moe_d_ff": 32 if moe else 0, "moe_capacity_factor": 1.25}


def tiny_config(name: str, moe: bool) -> dict:
    """A tiny configuration of the real one's arch, with the dense cell's
    limits."""
    real = json.loads((BENCH / "configs" / ("mixtral-8x7b-2L.json" if moe
                                            else "stablelm-3b.json")).read_text())
    dense = json.loads((BENCH / "configs" / "stablelm-3b.json").read_text())
    return {"name": name, "port": {"arch": real["port"]["arch"], "name": name},
            "model": tiny_model(moe),
            "pool": {"page_elems": 1024, "kv_page_tokens": 4},
            "limits": dense["limits"]}


def tiny_mix(mix: str) -> dict:
    t = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    t["prompt"].update(median=24, min=4, max=48)
    t["output"].update(min=2, max=6)
    t["warmup"] = [[48, 6]]
    t["profile"] = {"first": 1, "count": 2}
    if t["loop"] == "open":
        t["rate"] = 20.0
        t["check"]["sample"] = 5
    return t


def make_root(tmp: Path) -> Path:
    """A benchmark root holding the tiny cells, with BENCHMARK.json's
    metrics renamed onto them."""
    (tmp / BENCH.name / "configs").mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", tmp / BENCH.name / "metrics")
    (tmp / BENCH.name / "traffic").mkdir()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for cell, (conf, mix) in CELLS.items():
        path = f"{BENCH.name}/configs/{conf}.json"
        (tmp / BENCH.name / "traffic" / f"{mix}.json").write_text(
            json.dumps(tiny_mix(mix)))
        if not (tmp / path).exists():
            (tmp / path).write_text(json.dumps(tiny_config(conf,
                                                           "moe" in conf)))
            bench["configs"].append({"name": conf, "source": "tiny",
                                     "file": path, "reduced": [],
                                     "why": "a CPU test"})
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": mix, "chips": 1,
                                   "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [REAL[w] for w in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)
