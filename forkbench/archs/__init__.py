"""The benchmark's architectures, one module each, found by name.

A configuration's ``model`` dict names its architecture under ``"arch"``
(``gqa_moe`` where it has no such key); ``forkbench/archs/<arch>.py``
holds everything of the harness that depends on it:

- ``check_config(conf)``: the published keys the file holds agree with
  its ``model`` dict;
- ``port_config(conf)``: the program's ``ArchConfig`` of the file;
- ``leaves(m)``: (path, shape, scale) of every weight, in the program's
  layout; a numeric part of a path is a list index
  (``forkbench/weights.py``);
- ``Reference(m, w, precision)``: the plain reference, from a module of
  ``forkbench/reference/``, with the ``logits(prompt, served)`` that
  ``check.reference_rows`` calls;
- the counts ``forkbench/roofline.py`` needs: ``block_params(m,
  active)``, ``state_bytes(m)``, ``prefill_work(m, P)`` and
  ``decode_work(m, ctx)`` as (FLOPs, bytes), and ``attention_bytes(m, P,
  n_out)``;
- ``tiny(m)``: a tiny ``model`` dict of ``m``'s kind, from which the CPU
  tests build each real cell's twin (``forkbench/conftest.py``).
"""
from __future__ import annotations

import importlib
import importlib.util
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent
DEFAULT = "gqa_moe"
NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def load(m: dict, root: Optional[Path] = None) -> ModuleType:
    """The module of ``m``'s architecture: ``forkbench/archs/<arch>.py``
    of the benchmark checkout ``root`` where it holds that file, else of
    this package.  A module loaded from ``root`` is kept under its import
    name, so that a later ``load(m)`` (the roofline's) finds it."""
    name = m.get("arch", DEFAULT)
    if not NAME.match(name):
        raise ValueError(f"arch {name!r} is not a module name")
    key = f"{__name__}.{name}"
    path = (Path(root) / HERE.parent.name / HERE.name / f"{name}.py"
            if root is not None else None)
    if path is None or not path.exists() or path.resolve() == HERE / path.name:
        return importlib.import_module(key)
    mod = sys.modules.get(key)
    if mod is not None and Path(mod.__file__).resolve() == path.resolve():
        return mod
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
