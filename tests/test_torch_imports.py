"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax, jaxlib, ml_dtypes, msgpack or the reference
package ``repro``, and importing the serve, train, quickstart and FINRA
entry points loads none of them."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
FILES.append("chip_smoke.py")
BANNED = ("jax", "jaxlib", "ml_dtypes", "msgpack", "repro")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_has_files():
    assert len(FILES) > 30


@pytest.mark.parametrize("path", FILES)
def test_no_banned_imports(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [(line, mod) for line, mod in _imported(tree)
           if mod.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


def test_serve_import_loads_no_reference_or_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.launch.train,"
            " repro_torch.launch.quickstart, repro_torch.launch.finra,"
            " repro_torch.models.convert;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{BANNED!r});"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
