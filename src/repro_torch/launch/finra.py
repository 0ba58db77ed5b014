"""FINRA workflow (paper Figure 2/19), the port of the reference's
``examples/serve_workflow_finra.py``: an upstream function pre-materializes
market data; N runAuditRule children remote-fork it and validate trades
with zero serialization, against the Fn/Redis-style message baseline.

Every node's page pool lives on ``--device`` (default ``cuda``), where the
fetch function uploads the market, so the fork path's adopt and assembly
run through the copy kernels.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.finra --rules 8
  PYTHONPATH=src python -m repro_torch.launch.finra --device cpu
"""
from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.models import lm
from repro_torch.net import Network
from repro_torch.platform.coordinator import Coordinator, FunctionDef
from repro_torch.platform.node import NodeRuntime
from repro_torch.platform.workflow import build_finra, run_workflow

TRANSFERS = ("fork", "message")
THRESHOLD = 3.5           # a trade value past it violates the audit rule


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rules", type=int, default=8)
    ap.add_argument("--market-mb", type=float, default=6.0)
    ap.add_argument("--arch", default="micro-hello")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_market(market_mb: float) -> np.ndarray:
    """The market data, as the reference draws it: float32 normals from
    numpy seed 0."""
    return np.random.default_rng(0).standard_normal(
        int(market_mb * 2**20 / 4)).astype(np.float32)


def violations(data) -> int:
    """The audit rule: trades whose value lies past ``THRESHOLD``."""
    return int((torch.as_tensor(data).abs() > THRESHOLD).sum())


def register_finra(coord, cfg, params, market: np.ndarray, transfer: str,
                   device):
    """Register FINRA's fetch and audit functions at ``coord`` for
    ``transfer`` and return the workflow.  The fetch uploads ``market`` to
    ``device`` and, for a fork, adds it to its instance; each audit counts
    the violations and reports the pages its instance faulted over RDMA."""

    def fetch(inst, ctx):
        # fused fetchPortfolioData+fetchMarketData (paper §7.6)
        data = torch.from_numpy(market).to(device)
        if transfer == "message":
            return {"market": data}
        inst.add_tensor("globals/market", data)
        return {"rows": market.size}

    def audit(inst, ctx):
        if "msg:fetchData" in ctx:
            data = ctx["msg:fetchData"]["market"]        # deserialized copy
        else:
            data = inst.ensure_tensor("globals/market")
        return {"violations": violations(data),
                "pages_rdma": inst.stats["pages_rdma"]}

    coord.register_function(FunctionDef("finra-fetch", cfg.name,
                                        lambda: params, fetch))
    coord.register_function(FunctionDef("finra-audit", cfg.name,
                                        lambda: params, audit))
    return build_finra(coord)


def run_transfer(coord, wf, transfer: str, rules: int, device) -> dict:
    """Run the workflow once by ``transfer`` with ``rules`` audit children;
    returns its wall and modelled times and bytes (what this run added to
    the coordinator's network), each rule's violations and faulted
    pages.  Raises if the rules disagree."""
    net, dev = coord.network, torch.device(device)
    sim0 = net.sim_time
    rdma0, msg0 = net.meter["rdma_bytes"], net.meter["msg_bytes"]
    t0 = time.perf_counter()
    res = run_workflow(coord, wf, {}, transfer=transfer,
                       fan_out={"runAuditRule": rules})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = {"wall_s": time.perf_counter() - t0,
           "sim_time_s": net.sim_time - sim0,
           "rdma_bytes": net.meter["rdma_bytes"] - rdma0,
           "msg_bytes": net.meter["msg_bytes"] - msg0,
           "violations": [r["violations"] for r in res["runAuditRule"]],
           "audit_pages_rdma": [r["pages_rdma"]
                                for r in res["runAuditRule"]]}
    if len(set(out["violations"])) != 1:
        raise AssertionError(f"[{transfer}] the audit rules saw different "
                             f"data: {out['violations']}")
    return out


def main(argv=None):
    """Run the workflow by fork and by message; returns each transfer's
    record."""
    return run(argv).transfers


def run(argv=None, params=None) -> SimpleNamespace:
    """Run FINRA by fork, then by message, each on a fresh 4-node cluster;
    returns what it printed as a record.  ``params`` (on ``--device``)
    replaces the functions' torch-seeded initialization."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    cfg = get_arch(args.arch)
    if params is None:
        params = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    market = make_market(args.market_mb)
    transfers = {}
    for transfer in TRANSFERS:
        net = Network()
        nodes = [NodeRuntime(f"inv{i}", net, device_pool=True, device=dev)
                 for i in range(4)]
        coord = Coordinator(net, nodes)
        wf = register_finra(coord, cfg, params, market, transfer, dev)
        r = transfers[transfer] = run_transfer(coord, wf, transfer,
                                               args.rules, dev)
        print(f"[{transfer:7s}] {args.rules} audit rules in "
              f"{r['wall_s']*1e3:7.1f} ms wall | sim "
              f"{r['sim_time_s']*1e3:6.2f} ms | rdma "
              f"{r['rdma_bytes']/2**20:7.1f} MiB | msg "
              f"{r['msg_bytes']/2**20:7.1f} MiB | "
              f"violations={r['violations'][0]}")
    return SimpleNamespace(arch=cfg.name, rules=args.rules,
                           market_elems=market.size, transfers=transfers)


if __name__ == "__main__":
    main()
