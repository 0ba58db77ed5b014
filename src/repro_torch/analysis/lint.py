"""Determinism linter — a stdlib-``ast`` pass over the sim-critical tree.

Every replay digest this repo pins assumes the simulation's inputs are
exactly (trace, seed): no wall clock, no process entropy, no
hash-randomized iteration order feeding event scheduling or digest
input.  This linter makes those assumptions checkable::

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis.lint --json src/repro_torch

Rules (see ``docs/analysis.md`` for the full catalog):

``wall-clock``
    References to host clocks — ``time.time`` / ``time.monotonic`` /
    ``time.perf_counter`` / ``time.process_time`` (called *or* stored,
    e.g. as a ``clock=`` default) and argless ``datetime.now()`` /
    ``utcnow()`` / ``today()``.
``unseeded-random``
    Module-level ``random.*`` / ``np.random.*`` draws (a seeded
    ``random.Random(seed)`` / ``np.random.default_rng(seed)`` instance
    is fine — the *argless* constructors are not) and any ``secrets.*``
    call (process entropy by definition).
``set-iter``
    Iterating a ``set`` (literal, ``set(...)``/``frozenset(...)``,
    set-typed locals, or set-annotated attributes like ``conn.users``)
    without an explicit ``sorted(...)``: string-set order is
    hash-randomized per process, so any order-sensitive consumer
    diverges across runs.
``float-sum``
    ``sum(...)`` over a set (directly or via a generator): float
    addition is non-associative, so an unordered reduction can differ
    in the last ulp between processes.
``dict-iter`` (``--strict`` only)
    Iterating ``.keys()`` / ``.values()`` / ``.items()`` without
    ``sorted(...)``.  Dict views are insertion-ordered (deterministic
    within a run), so this is an advisory audit rule, not a default
    failure.

Any finding is suppressible in place with a ``# sim-ok: <rule>`` comment
on the same line or the line above, optionally with a reason after
``--``::

    clock=time.monotonic,   # sim-ok: wall-clock -- host default; replays pass SimClock

Only files under the sim-critical packages (``sim/``, ``net/``,
``placement/``, ``fork/``, ``platform/``, ``memory/``) are checked;
everything else (benchmarks, launch scripts, training loops) measures
wall time on purpose.  ``--all`` lints every given file regardless.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

SIM_CRITICAL = ("sim", "net", "placement", "fork", "platform", "memory")

RULES = ("wall-clock", "unseeded-random", "set-iter", "float-sum",
         "dict-iter")

_WALL_CLOCK_ATTRS = {"time", "monotonic", "perf_counter", "process_time",
                     "clock", "monotonic_ns", "perf_counter_ns", "time_ns"}
_DATETIME_NOW = {"now", "utcnow", "today"}
_SEEDABLE_RNG_CTORS = {"Random", "default_rng", "Generator", "RandomState",
                       "PCG64", "Philox", "SeedSequence", "seed", "SystemRandom"}
_DICT_VIEWS = {"keys", "values", "items"}

_SIM_OK_RE = re.compile(r"#\s*sim-ok:\s*([a-z\-,\s]+?)(?:--|$)")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str
    suppressed: bool = False

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}: {self.message}{tag}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _suppressions(source: str) -> Dict[int, Set[str]]:
    """line number -> rules waived there by a ``# sim-ok:`` comment.  A
    waiver covers its own line plus the statement the comment block sits
    directly above, so multi-line reason comments work: the marker
    propagates down through contiguous comment-only lines."""
    lines = source.splitlines()
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _SIM_OK_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(i, set()).update(rules)
        if not text.lstrip().startswith("#"):
            continue        # trailing comment: covers its own line only
        # comment-only line: extend through the comment block below
        # (continuation lines) to the first code line, which inherits it
        j = i + 1
        while j <= len(lines) and lines[j - 1].lstrip().startswith("#"):
            out.setdefault(j, set()).update(rules)
            j += 1
        if j <= len(lines):
            out.setdefault(j, set()).update(rules)
    return out


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_set_annotation(node: Optional[ast.AST]) -> bool:
    if node is None:
        return False
    if isinstance(node, ast.Subscript):       # Set[str] / set[str] / frozenset[...]
        node = node.value
    name = _dotted(node)
    return name is not None and name.split(".")[-1] in (
        "Set", "set", "FrozenSet", "frozenset", "MutableSet", "AbstractSet")


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str, strict: bool = False,
                 extra_set_attrs: Optional[Set[str]] = None):
        self.path = path
        self.strict = strict
        self.findings: List[Finding] = []
        self.suppress = _suppressions(source)
        tree = ast.parse(source, filename=path)
        self.tree = tree
        # names `from time import ...` pulled into this module
        self.time_imports: Set[str] = set()
        # attribute names annotated/assigned as sets anywhere in the module
        # (e.g. ``self.users: Set[str] = set()``) — lets ``for u in conn.users``
        # resolve as set iteration without type inference.  ``extra_set_attrs``
        # carries the same knowledge collected across the whole lint run, so
        # an attribute annotated in types.py is recognized in pool.py.
        self.set_attrs: Set[str] = set(extra_set_attrs or ())
        self._prepass(tree)
        # per-scope set-typed local/global names (stack of scopes)
        self._set_names: List[Set[str]] = [set()]

    # -- prepass -------------------------------------------------------------

    def _prepass(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name in _WALL_CLOCK_ATTRS:
                        self.time_imports.add(alias.asname or alias.name)
            elif isinstance(node, ast.AnnAssign) and \
                    _is_set_annotation(node.annotation):
                if isinstance(node.target, ast.Attribute):
                    self.set_attrs.add(node.target.attr)
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and \
                            self._is_set_expr_shallow(node.value):
                        self.set_attrs.add(tgt.attr)

    # -- helpers -------------------------------------------------------------

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        # _suppressions already propagated comment-block waivers down to
        # their statement line; a trailing comment covers only its own line
        waived = self.suppress.get(line, set())
        self.findings.append(Finding(
            path=self.path, line=line, col=getattr(node, "col_offset", 0),
            rule=rule, message=message, suppressed=rule in waived))

    def _is_set_expr_shallow(self, node: ast.AST) -> bool:
        """Syntactically-a-set without scope lookups (used by the prepass)."""
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("set", "frozenset"):
            return True
        return False

    def _is_set_expr(self, node: ast.AST) -> bool:
        if self._is_set_expr_shallow(node):
            return True
        if isinstance(node, ast.Name):
            return any(node.id in scope for scope in self._set_names)
        if isinstance(node, ast.Attribute):
            return node.attr in self.set_attrs
        if isinstance(node, ast.BinOp) and \
                isinstance(node.op, (ast.BitOr, ast.BitAnd, ast.Sub,
                                     ast.BitXor)):
            return self._is_set_expr(node.left) or \
                self._is_set_expr(node.right)
        return False

    def _is_dict_view(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _DICT_VIEWS
                and not node.args and not node.keywords)

    # -- scopes --------------------------------------------------------------

    def _visit_scope(self, node) -> None:
        self._set_names.append(set())
        self.generic_visit(node)
        self._set_names.pop()

    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope
    visit_Lambda = _visit_scope

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                if self._is_set_expr(node.value):
                    self._set_names[-1].add(tgt.id)
                else:
                    self._set_names[-1].discard(tgt.id)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if isinstance(node.target, ast.Name) and \
                _is_set_annotation(node.annotation):
            self._set_names[-1].add(node.target.id)
        self.generic_visit(node)

    # -- wall-clock ----------------------------------------------------------

    def visit_Attribute(self, node: ast.Attribute) -> None:
        dotted = _dotted(node)
        if dotted is not None:
            head, _, _ = dotted.partition(".")
            leaf = dotted.rsplit(".", 1)[-1]
            if head == "time" and leaf in _WALL_CLOCK_ATTRS and \
                    dotted == f"time.{leaf}":
                self._emit(node, "wall-clock",
                           f"host clock `{dotted}` in sim-critical code "
                           "(use the network's sim clock / SimClock)")
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load) and node.id in self.time_imports:
            self._emit(node, "wall-clock",
                       f"host clock `{node.id}` (from time import ...) "
                       "in sim-critical code")
        self.generic_visit(node)

    # -- calls: datetime / random / secrets / sum ----------------------------

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func) or ""
        parts = dotted.split(".")
        # argless datetime.now()/utcnow()/today()
        if parts[-1] in _DATETIME_NOW and not node.args and not node.keywords \
                and any(p in ("datetime", "date") for p in parts[:-1]):
            self._emit(node, "wall-clock",
                       f"argless `{dotted}()` reads the host clock "
                       "(pass an explicit sim timestamp)")
        # module-level random draws
        if len(parts) == 2 and parts[0] == "random":
            if parts[1] not in _SEEDABLE_RNG_CTORS:
                self._emit(node, "unseeded-random",
                           f"module-level `{dotted}()` draws from the "
                           "process-global RNG (use a seeded "
                           "random.Random(seed))")
            elif not node.args and not node.keywords and \
                    parts[1] != "SystemRandom":
                self._emit(node, "unseeded-random",
                           f"argless `{dotted}()` is entropy-seeded "
                           "(pass an explicit seed)")
            if parts[1] == "SystemRandom":
                self._emit(node, "unseeded-random",
                           "`random.SystemRandom` is OS entropy by design")
        if len(parts) >= 2 and parts[-2] == "random" and \
                parts[0] in ("np", "numpy"):
            if parts[-1] not in _SEEDABLE_RNG_CTORS:
                self._emit(node, "unseeded-random",
                           f"module-level `{dotted}()` draws from numpy's "
                           "global RNG (use np.random.default_rng(seed))")
            elif not node.args and not node.keywords:
                self._emit(node, "unseeded-random",
                           f"argless `{dotted}()` is entropy-seeded "
                           "(pass an explicit seed)")
        if len(parts) == 2 and parts[0] == "secrets":
            self._emit(node, "unseeded-random",
                       f"`{dotted}()` is process entropy — nondeterministic "
                       "across runs by definition")
        # float accumulation over unordered collections
        if isinstance(node.func, ast.Name) and node.func.id == "sum" \
                and node.args:
            arg = node.args[0]
            unordered = self._is_set_expr(arg) or (
                self.strict and self._is_dict_view(arg))
            if isinstance(arg, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
                for gen in arg.generators:
                    if self._is_set_expr(gen.iter) or (
                            self.strict and self._is_dict_view(gen.iter)):
                        unordered = True
            if unordered:
                self._emit(node, "float-sum",
                           "sum() over an unordered collection — float "
                           "addition is order-sensitive; sort first")
        self.generic_visit(node)

    # -- iteration order -----------------------------------------------------

    def _check_iter(self, iter_node: ast.AST, where: ast.AST) -> None:
        # sorted(...) / min / max / len consume order-insensitively
        if self._is_set_expr(iter_node):
            self._emit(where, "set-iter",
                       "iterating a set — hash-randomized order; wrap in "
                       "sorted(...) or annotate why order cannot matter")
        elif self.strict and self._is_dict_view(iter_node):
            self._emit(where, "dict-iter",
                       "iterating a dict view — insertion-ordered but "
                       "audit-worthy when it feeds scheduling or digests")

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter, node)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_iter(gen.iter, node)
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp


def is_sim_critical(path: Path) -> bool:
    parts = path.resolve().parts
    for i, p in enumerate(parts[:-1]):
        if p == "repro_torch" and parts[i + 1] in SIM_CRITICAL:
            return True
    return False


def lint_source(source: str, path: str = "<string>", strict: bool = False,
                extra_set_attrs: Optional[Set[str]] = None) -> List[Finding]:
    """Lint one source string; returns every finding (suppressed included)."""
    linter = _Linter(path, source, strict=strict,
                     extra_set_attrs=extra_set_attrs)
    linter.visit(linter.tree)
    return sorted(linter.findings, key=lambda f: (f.line, f.col, f.rule))


def collect_set_attrs(sources: Iterable[Tuple[str, str]]) -> Set[str]:
    """Union of set-annotated/assigned attribute names across (path, source)
    pairs — the cross-module prepass that lets ``for u in conn.users`` in
    one file resolve against the ``users: Set[str]`` annotation in another."""
    attrs: Set[str] = set()
    for path, source in sources:
        try:
            linter = _Linter(path, source)
        except SyntaxError:
            continue
        attrs |= linter.set_attrs
    return attrs


def iter_py_files(paths: Iterable[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        else:
            out.append(path)
    return out


def lint_paths(paths: Iterable[str], strict: bool = False,
               everything: bool = False) -> Tuple[List[Finding], int]:
    """Lint ``paths`` (files or trees).  Returns (findings, files_checked);
    non-sim-critical files are skipped unless ``everything``."""
    findings: List[Finding] = []
    files = [(f, f.read_text()) for f in iter_py_files(paths)
             if everything or is_sim_critical(f)]
    set_attrs = collect_set_attrs((str(f), src) for f, src in files)
    for f, src in files:
        findings.extend(lint_source(src, path=str(f), strict=strict,
                                    extra_set_attrs=set_attrs))
    return findings, len(files)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Determinism linter for the sim-critical tree.")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint "
                         "(default: src/repro_torch)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (one JSON document)")
    ap.add_argument("--strict", action="store_true",
                    help="enable the advisory dict-iter audit rule")
    ap.add_argument("--all", action="store_true", dest="everything",
                    help="lint every given file, not just sim-critical ones")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print findings waived by # sim-ok comments")
    args = ap.parse_args(argv)
    findings, checked = lint_paths(args.paths or ["src/repro_torch"],
                                   strict=args.strict,
                                   everything=args.everything)
    active = [f for f in findings if not f.suppressed]
    shown = findings if args.show_suppressed else active
    if args.json:
        print(json.dumps({
            "files_checked": checked,
            "findings": [f.to_dict() for f in shown],
            "active": len(active),
            "suppressed": len(findings) - len(active),
        }, indent=1, sort_keys=True))
    else:
        for f in shown:
            print(f.format())
        print(f"{checked} file(s) checked: {len(active)} finding(s), "
              f"{len(findings) - len(active)} suppressed")
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
