"""Fixtures of the benchmark's CPU tests: a benchmark root in a temporary
directory with a tiny twin of every cell of ``BENCHMARK.json``, run on the
CPU's pools and the kernels' plain versions.

Each real configuration gets a tiny one from its architecture's
``tiny(m)`` (``forkbench/archs/<arch>.py``), each real cell a twin of that
tiny configuration under the cell's own traffic mix cut to tiny lengths,
and every metric's ``workloads`` list names the twins of the cells it
names; the real metric readers read them.  A cell added to
``BENCHMARK.json`` with its files gets its twin with no edit here.

Tests that need the card carry the ``card`` marker and decide whether
there is one in the ``cuda`` fixture, never at import."""
import json
import shutil
from pathlib import Path
from typing import Dict, Tuple

import pytest
import torch

from forkbench import archs

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips where there is none)")


@pytest.fixture(autouse=True)
def one_thread():
    """Each test here runs with one intra-op thread: the tiny models gain
    nothing from more, and a test run's workers share the host's cores,
    where threads that outnumber them slow an open-loop window past its
    cutoff (``harness.LATE_S``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# Every twin's limits: the tightest any configuration stated when the
# twins were first built (StableLM's).  A tiny model's sound runs read
# ~1e-6 and its TF32 control 1.3e-3 or more, so these separate the two for
# every twin; fixed here, a later configuration's limits move no twin.
TINY_LIMITS = {"fork_mismatch": 0, "logit_err_p90": 2e-4, "served_gap": 0.5}


def tiny_config(name: str, real: dict, src: Path = ROOT) -> dict:
    """The tiny twin of configuration ``real`` (of the benchmark at
    ``src``): its architecture's tiny model, run as the same registered
    arch, held to ``TINY_LIMITS``."""
    model = archs.load(real["model"], src).tiny(real["model"])
    return {"name": name, "port": {"arch": real["port"]["arch"], "name": name},
            "model": model, "pool": {"page_elems": 1024, "kv_page_tokens": 4},
            "limits": dict(TINY_LIMITS)}


def tiny_mix(mix: str, src: Path = ROOT) -> dict:
    t = json.loads((src / BENCH.name / "traffic" / f"{mix}.json").read_text())
    t["prompt"].update(median=24, min=4, max=48)
    t["output"].update(min=2, max=6)
    t["warmup"] = [[48, 6]]
    t["profile"] = {"first": 1, "count": 2}
    if t["loop"] == "open":
        t["rate"] = 20.0
        t["check"]["sample"] = 5
    return t


def twins(src: Path = ROOT) -> Tuple[Dict[str, dict],
                                     Dict[str, Tuple[str, str]],
                                     Dict[str, str]]:
    """The tiny twins of the benchmark at ``src``: {tiny configuration's
    name: its file}, {twin cell: (tiny configuration, traffic mix)} and
    {real cell: its twin}.  The twin of configuration or cell ``<name>``
    is ``tiny-<name>``."""
    bench = json.loads((src / "BENCHMARK.json").read_text())
    confs: Dict[str, dict] = {}
    for c in bench["configs"]:
        real = json.loads((src / c["file"]).read_text())
        confs["tiny-" + c["name"]] = tiny_config("tiny-" + c["name"], real,
                                                 src)
    cells = {f"tiny-{w['name']}": (f"tiny-{w['config']}", w["traffic"])
             for w in bench["workloads"]}
    real_to_twin = {w["name"]: f"tiny-{w['name']}" for w in bench["workloads"]}
    return confs, cells, real_to_twin


CONFS, CELLS, REAL = twins()


def make_root(tmp: Path, src: Path = ROOT) -> Path:
    """A benchmark root holding the twins of the benchmark at ``src``, with
    its metrics' readers and its ``BENCHMARK.json``'s metrics renamed onto
    the twins."""
    confs, cells, real_to_twin = twins(src)
    (tmp / BENCH.name / "configs").mkdir(parents=True)
    shutil.copytree(src / BENCH.name / "metrics", tmp / BENCH.name / "metrics")
    (tmp / BENCH.name / "traffic").mkdir()
    bench = json.loads((src / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for name, conf in confs.items():
        path = f"{BENCH.name}/configs/{name}.json"
        (tmp / path).write_text(json.dumps(conf))
        bench["configs"].append({"name": name, "source": "tiny",
                                 "file": path, "reduced": [],
                                 "why": "a CPU test"})
    for cell, (conf, mix) in cells.items():
        (tmp / BENCH.name / "traffic" / f"{mix}.json").write_text(
            json.dumps(tiny_mix(mix, src)))
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": mix, "chips": 1,
                                   "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real_to_twin[w] for w in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)
