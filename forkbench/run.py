"""Run one cell of the benchmark once, from the root of a checkout:

  python3 forkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``; ``checks`` last, each compared number beside its
limit, as the last lines of standard error too).  Exits non-zero and
prints no result without a CUDA device (or fewer than the cell asks for),
outside a checkout that holds the program (``src/repro_torch``), or if
JAX, Flax or the JAX package (``repro``) was loaded.  The kernels build
into ``build/kernels`` inside the checkout, and every cache of the
program stays under ``build/``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for p in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    if not torch.cuda.is_available():
        print("forkbench: no CUDA device", file=sys.stderr)
        return 2
    from forkbench import harness
    cell = harness.load_cell(ROOT, args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"forkbench: {args.workload} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"forkbench: loaded {found}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
