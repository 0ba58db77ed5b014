"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` source compiles, on its own and all at once, into a
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The output name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.  The build runs at the
first kernel launch (never at import: machines without nvcc import this
package) and a failed build raises.  ``REPRO_TORCH_BUILD_DIR`` overrides
the output directory, which defaults to ``build/kernels`` at the root of
the checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("paging", "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "cannot be built on this machine")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{h}.so"


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every stale source in parallel (one nvcc per source).
    Returns name -> library path; raises with nvcc's output on failure."""
    out = {n: _lib_path(n) for n in SOURCES}
    todo = [n for n, p in out.items() if not p.exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            continue
        if verbose and log.strip():
            print(f"[build] {n}.cu:\n{log.strip()}")
        os.replace(tmp, out[n])        # atomic: concurrent builders agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for n, p in paths.items():
                if n not in _libs:
                    _libs[n] = ctypes.CDLL(str(p))
            lib = _libs[name]
        return lib


_fns: Dict[tuple, object] = {}


def function(lib_name: str, entry: str, argtypes):
    """A C entry point of ``csrc/<lib_name>.cu`` with its ctypes signature
    (``c_void_p`` for every pointer and the stream) and an int return."""
    key = (lib_name, entry)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(lib_name), entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def copy_unit(row_bytes: int, limit_bytes: int, *tensors) -> int:
    """Widest copy unit (16, 8, 4, 2 or 1 bytes) that divides a page row,
    the destination limit and every tensor's base address."""
    u = 16
    while u > 1 and (row_bytes % u or limit_bytes % u
                     or any(t.data_ptr() % u for t in tensors)):
        u //= 2
    return u
