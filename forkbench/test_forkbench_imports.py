"""What the benchmark loads: no module whose top-level name (the part
before the first dot, compared whole) is ``jax``, ``jaxlib``, ``flax``
or ``repro`` (``repro_torch`` is another name), and a reference that
loads nothing of the program."""
import ast
import json
import os
import subprocess
import sys

from forkbench import harness
from forkbench.conftest import BENCH, ROOT

DRIVE = """
import json, sys, time
from pathlib import Path
import torch
from forkbench import harness
from forkbench.conftest import make_root
root = make_root(Path(sys.argv[1]))
for cell in ("tiny-stablelm-3b.coldstart", "tiny-mixtral-8x7b-2L.warm"):
    out = harness.run(harness.load_cell(root, cell), 2 ** 31 + 3, 0.3, True,
                      torch.device("cpu"), time.perf_counter())
    assert out["correct"], out
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_modules(code: str, *args) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                       str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    top = _top_modules(DRIVE, str(tmp_path))
    assert "repro_torch" in top and "forkbench" in top
    assert not top & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = _top_modules("import json, sys\n"
                       "import forkbench.reference.model\n"
                       "print(json.dumps(sorted({m.split('.')[0] "
                       "for m in sys.modules})))")
    assert not top & (set(harness.FORBIDDEN) | {"repro_torch"})


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    bad = set(harness.FORBIDDEN)
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert not names & bad, (path, names & bad)
        if path.parent.name == "reference":
            assert "repro_torch" not in names, path


def test_without_a_card_run_py_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "stablelm-3b.coldstart", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
