"""The control of ``correct``: runs a cell at its own size, as the
benchmark does, and after the window judges twice, by the same
comparison (``check.measure`` and ``check.judge``) at the same served
positions: the program's answers, and the control's, the reference
computed in TF32 in the program's place (its logits, and the tokens it
puts first).  The control has to come out not correct.  One JSON line
per seed: each side's ``correct`` and numbers beside their limits.

  python3 forkbench/control.py --workload stablelm-3b.coldstart \\
      --seconds 51 --seeds 11 12 13
"""
import argparse
import json
import sys
import time

from run import ROOT, _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _environment()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from forkbench import harness
    cell = harness.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        out = harness.run(cell, seed, args.seconds, False,
                          torch.device("cuda", 0), time.perf_counter(),
                          control=True)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "checks": out["checks"], "served": out["served"],
                          "control": out["control"],
                          "token_altered": out["token_altered"],
                          "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
