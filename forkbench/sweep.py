"""The knee sweep of an open-loop cell: one set-up, then a window at each
of a list of fixed rates, each printed as a JSON line with its latencies
and its backlog.  The knee is the highest rate whose queue does not grow
through its window; the cell's traffic file then fixes a rate at four
fifths of it.

  python3 forkbench/sweep.py --workload mixtral-8x7b-2L.warm \\
      --seed 7 --seconds 30 --rates 2 2.5 3 3.5 4

``late_s`` is how long after it was due the window's last request
started (a queue that grows leaves it late by a growing amount),
``backlog`` the requests due but not started when the last one was due.
Each line also gives the device memory as the window closed
(``allocated_gb``, of it ``graph_pools_gb`` in CUDA graphs' private
pools), the serving engines still alive, and both again once the
window's records are dropped and a full collection has run
(``*_after_gc``): memory that grows from line to line after the
collection is held by the program, not by the sweep's records.
"""
import argparse
import gc
import json
import statistics
import sys

from run import ROOT, _environment


def _memory(torch) -> dict:
    """Device memory allocated now, of it in graphs' private pools (GB),
    and the serving engines alive."""
    pools = sum(seg["allocated_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))
    engines = sum(1 for o in gc.get_objects()
                  if type(o).__name__ == "ServingEngine")
    return {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "graph_pools_gb": pools / 1e9, "engines_alive": engines}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    _environment()
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    from forkbench import harness, traffic
    cell = harness.load_cell(ROOT, args.workload)
    dev = torch.device("cuda", 0)
    prog, _ = harness.setup(cell, args.seed, dev)
    vocab = cell.config["model"]["vocab_size"]
    for rate in args.rates:
        mix = dict(cell.mix, rate=rate)
        reqs = traffic.window(mix, vocab, args.seed, args.seconds)
        invs, window_s, _ = harness.window(prog, reqs, mix, args.seconds,
                                           False, dev)
        ok = [v for v in invs if not v.failed]
        lat = [v.latency for v in ok]
        line = {"rate": rate, "requests": len(invs),
                "failed": len(invs) - len(ok), "window_s": window_s}
        if ok:
            last = max(ok, key=lambda v: v.due)
            line.update(
                p50_s=statistics.median(lat),
                p90_s=statistics.quantiles(lat, n=10)[-1] if len(lat) > 1
                else lat[0],
                mean_service_s=statistics.mean(v.end - v.start for v in ok),
                late_s=last.start - last.due,
                backlog=sum(1 for v in ok if v.due <= last.due < v.start))
        line.update(_memory(torch))
        del invs, ok, lat
        gc.collect()
        line.update({f"{k}_after_gc": v for k, v in _memory(torch).items()})
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
