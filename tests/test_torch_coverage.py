"""The port covers the reference: every module of ``src/repro`` has a
counterpart in ``src/repro_torch`` that defines its public top-level names,
every example has a port launcher, and every launcher takes at least the
reference's flags.  AST only: nothing is imported.

A name may be missing from its counterpart only if ``JAX_ONLY`` lists it
with the reason it has no meaning outside JAX; the table is held to the
tree, so an entry whose name the port defines (or the reference lost)
fails too."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))

# a reference module whose counterpart has another name
RENAMED = {"distributed/hlo_analysis.py": "distributed/op_analysis.py"}

JAX_ONLY = {
    ("distributed/hlo_analysis.py", "Computation"):
        "a parsed XLA HLO computation; the port counts ops as they run",
    ("distributed/hlo_analysis.py", "OpInfo"):
        "an XLA HLO instruction of a parsed computation",
    ("distributed/hlo_analysis.py", "parse_computations"):
        "parses XLA's HLO text, which only a jax compile writes",
    ("distributed/hlo_analysis.py", "collective_stats"):
        "reads collectives from HLO text; op_analysis.analyze counts them",
    ("distributed/sharding.py", "token_sharding"):
        "builds a jax NamedSharding; the port's rule is batch_pspec",
    ("kernels/cow_scatter/kernel.py", "LANE"):
        "the TPU vector lane width that Pallas block shapes align to",
    ("kernels/page_gather/kernel.py", "LANE"):
        "the TPU vector lane width that Pallas block shapes align to",
    ("kernels/dispatch.py", "IMPL_KERNEL"):
        "names the compiled Pallas impl; the port's is IMPL_CUDA",
    ("kernels/dispatch.py", "IMPL_INTERPRET"):
        "names Pallas interpret mode, which CUDA kernels do not have",
    ("kernels/dispatch.py", "IMPL_JNP"):
        "names the fused-XLA fallback; the port has no fallback",
    ("kernels/dispatch.py", "IMPL_REF"):
        "names the jnp oracle; the port's plain version is IMPL_TORCH",
    ("kernels/dispatch.py", "kernel_available"):
        "asks jax whether Pallas compiles for the TPU; the port decides by "
        "each tensor's device",
}

# each example of the reference -> the port launcher that stands for it
EXAMPLES = {"quickstart.py": "launch/quickstart.py",
            "serve_workflow_finra.py": "launch/finra.py",
            "train_elastic.py": "launch/elastic.py"}
LAUNCHERS = sorted(
    [(f"src/repro/launch/{p.name}", f"launch/{p.name}")
     for p in (REF / "launch").glob("*.py")]
    + [(f"examples/{k}", v) for k, v in EXAMPLES.items()])


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _targets(node):
    for t in ast.walk(node):
        if isinstance(t, ast.Name):
            yield t.id


def _defined(body):
    """Names a module body defines: defs, classes and assignments."""
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            yield node.name
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                yield from _targets(t)
        elif isinstance(node, ast.AnnAssign):
            yield from _targets(node.target)


def _bound(body):
    """Every name a module body binds: what ``_defined`` yields, imports,
    and bindings inside top-level ``if`` and ``try`` blocks."""
    for node in body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                yield (a.asname or a.name).split(".")[0]
        elif isinstance(node, (ast.If, ast.Try)):
            for part in (node.body, node.orelse,
                         getattr(node, "finalbody", []),
                         *[h.body for h in getattr(node, "handlers", [])]):
                yield from _bound(part)
        else:
            yield from _defined([node])


def _public(path: Path) -> set:
    return {n for n in _defined(_tree(path).body) if not n.startswith("_")}


def _flags(path: Path) -> set:
    """The option strings of every ``add_argument`` call in ``path``."""
    return {a.value for node in ast.walk(_tree(path))
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument"
            for a in node.args
            if isinstance(a, ast.Constant) and isinstance(a.value, str)}


def _counterpart(module: str) -> Path:
    return PORT / RENAMED.get(module, module)


@pytest.mark.parametrize("module", MODULES)
def test_module_has_a_counterpart_defining_its_names(module):
    port = _counterpart(module)
    assert port.is_file(), f"src/repro/{module} has no port counterpart"
    missing = _public(REF / module) - set(_bound(_tree(port).body))
    excused = {n for m, n in JAX_ONLY if m == module}
    assert missing == excused, (
        f"{module}: missing from {port.relative_to(ROOT)}: "
        f"{sorted(missing - excused)}; listed as JAX-only but present: "
        f"{sorted(excused - missing)}")


def test_jax_only_table_names_reference_modules():
    assert {m for m, _ in JAX_ONLY} <= set(MODULES)
    assert all(reason for reason in JAX_ONLY.values())
    assert set(RENAMED) <= set(MODULES)


def test_every_example_is_mapped():
    assert sorted(p.name for p in (ROOT / "examples").glob("*.py")) == \
        sorted(EXAMPLES)


@pytest.mark.parametrize("example", sorted(EXAMPLES))
def test_example_has_a_port_launcher(example):
    launcher = PORT / EXAMPLES[example]
    assert launcher.is_file()
    assert {"main", "run"} <= set(_defined(_tree(launcher).body))


@pytest.mark.parametrize("ref,port", LAUNCHERS)
def test_launcher_takes_the_references_flags(ref, port):
    missing = _flags(ROOT / ref) - _flags(PORT / port)
    assert not missing, f"{port} lacks {ref}'s flags {sorted(missing)}"
