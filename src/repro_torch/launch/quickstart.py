"""Quickstart: the remote fork in one script (the port of the reference's
``examples/quickstart.py``).

Builds a 2-node cluster whose page pools live on ``--device`` (default
``cuda``), deploys one seed LM replica, remote-forks it to the second node
(descriptor-only transfer + on-demand paging) and generates text on the
child, which must match the parent exactly.  On the card, packing, page
faults, assembly and decode attention run through the hand-written kernels
(kernels/dispatch.py).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.quickstart
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from types import SimpleNamespace

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.instance import ModelInstance
from repro_torch.fork import ForkPolicy
from repro_torch.models import lm
from repro_torch.net import Network
from repro_torch.platform.node import NodeRuntime
from repro_torch.serving.engine import ServingEngine

PROMPT = [11, 42, 7, 300]
MAX_TOKENS = 8


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="micro-small")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _synced_clock(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def main(argv=None):
    """Run the quickstart; returns the parent's and the child's tokens."""
    rec = run(argv)
    return rec.parent_tokens, rec.child_tokens


def run(argv=None, params=None) -> SimpleNamespace:
    """Fork the seed and serve from both; returns what it printed as a
    record.  ``params`` (on ``--device``, of the arch's float32 config)
    replaces the seed's torch-seeded initialization."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    cfg = dataclasses.replace(get_arch(args.arch), compute_dtype="float32")
    net = Network()
    parent_node = NodeRuntime("parent", net, device_pool=True, device=dev)
    child_node = NodeRuntime("child", net, device_pool=True, device=dev)

    # 1. one seed replica: the only provisioned instance in the cluster
    if params is None:
        params = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    seed = ModelInstance.create(parent_node, cfg.name, params)
    handle = parent_node.prepare_fork(seed)
    descriptor_bytes = len(parent_node.seeds[handle.handler_id].blob)
    print(f"seed: {seed.total_bytes()/2**20:.1f} MiB state, descriptor = "
          f"{descriptor_bytes} bytes")

    # 2. remote fork: the child maps the parent's pages, fetches on demand
    t0 = _synced_clock(dev)
    child = handle.resume_on(child_node, ForkPolicy(lazy=True, prefetch=1))
    t1 = _synced_clock(dev)
    resident = child.resident_fraction()
    print(f"resume_on: {(t1 - t0)*1e3:.1f} ms (resident: {resident:.0%})")
    child_params = child.materialize_pytree()
    t2 = _synced_clock(dev)
    print(f"materialized on demand: {child.stats['pages_rdma']} pages over "
          f"RDMA, {net.meter['rdma_bytes']/2**20:.1f} MiB")

    # 3. serve from the child; parent and child agree bit for bit
    out = {}
    for tag, p in (("parent", params), ("child", child_params)):
        eng = ServingEngine(cfg, p, backend="auto", device=dev)
        rid = eng.submit(PROMPT, max_tokens=MAX_TOKENS)
        out[tag] = list(eng.run_to_completion()[rid])
        print(f"{tag} generated: {out[tag]}")
    if out["parent"] != out["child"]:
        raise AssertionError(f"child {out['child']} != parent "
                             f"{out['parent']}")
    print("child == parent: OK")
    return SimpleNamespace(
        arch=cfg.name, descriptor_bytes=descriptor_bytes,
        total_bytes=seed.total_bytes(),
        seed_pages=sum(v.npages for v in seed.aspace.values()),
        resident_fraction=resident, pages_rdma=child.stats["pages_rdma"],
        rdma_bytes=net.meter["rdma_bytes"], sim_time=net.sim_time,
        resume_s=t1 - t0, materialize_s=t2 - t1,
        parent_tokens=out["parent"], child_tokens=out["child"])


if __name__ == "__main__":
    main()
