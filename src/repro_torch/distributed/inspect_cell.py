"""Dry-run profiler: attributes the collective bytes, HBM traffic and dot
FLOPs of one cell's step (per device, loops counted for their trips) to
the model code that ran them: the counterpart of the reference's
``distributed/inspect_cell.py``.

The reference attributes each HLO op to its jax ``op_name``.  Here each
op of the port's step on one rank (``launch/dryrun``, ``op_analysis``) is
attributed to the innermost frame in ``src/repro_torch/models``
(``file:line function``) that ran it; an op of the backward pass to the
frame that created its autograd node, marked "(backward)" (anomaly mode
records those frames, at some cost in trace time); an op outside the
models (the step's param gathers, the optimizer) has no frame.

  PYTHONPATH=src python -m repro_torch.distributed.inspect_cell \\
      granite-34b prefill_32k [--multi-pod] [--opt k=v] [--top 18]
"""
from __future__ import annotations

import argparse

# the label of an op run outside the models (the step's own gathers,
# reductions and optimizer)
STEP = "(step)"


def inspect(arch, shape, multi_pod=False, opts=None, top=18):
    """Prints the three top-``top`` tables; returns the analysis's rows."""
    from repro_torch.distributed import op_analysis
    from repro_torch.launch import dryrun
    with dryrun.fake_group(512 if multi_pod else 256):
        spec = dryrun.input_specs(arch, shape, multi_pod, opts)
        an = op_analysis.analyze(spec["fn"], *spec["args"],
                                 read_bytes=spec["read_bytes"], rows=True)
        del an["output"]
    print(f"=== {arch} x {shape} x {'pod512' if multi_pod else 'pod256'} "
          f"opts={opts} ===")
    for title, rows in an["rows"].items():
        print(f"-- top {title} (per device, loop-aware) --")
        tot = sum(r[0] for r in rows.values())
        for (kind, where), (amount, n) in sorted(
                rows.items(), key=lambda kv: -kv[1][0])[:top]:
            if title == "dot flops":
                print(f"  {amount:12.3e} x{n:6.0f} {kind:22s} {where or STEP}")
            else:
                print(f"  {amount / 2**30:9.2f}GiB x{n:6.0f} {kind:22s} "
                      f"{where or STEP}")
        print(f"  TOTAL {title}: "
              + (f"{tot:.3e} flops" if title == "dot flops"
                 else f"{tot / 2**30:.1f} GiB"))
    return an["rows"]


def main(argv=None):
    from repro_torch.launch.dryrun import parse_opts
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt", action="append", default=[])
    ap.add_argument("--top", type=int, default=18)
    args = ap.parse_args(argv)
    return inspect(args.arch, args.shape, args.multi_pod,
                   parse_opts(args.opt), args.top)


if __name__ == "__main__":
    main()
