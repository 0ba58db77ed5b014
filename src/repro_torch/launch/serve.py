"""Serving driver: spin up a mini cluster, deploy a seed, serve requests via
remote fork, demo KV-prefix forking.

Every node's page pool lives on ``--device`` (default ``cuda``), so
packing, page faults, assembly, prefill KV writes, copy-on-write and decode
attention all run through the hand-written kernels (kernels/dispatch.py).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch micro-small --requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch micro-hello --device cpu
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


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="micro-small")
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--fork-demo", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keep-logits", action="store_true",
                    help="keep every generated token's logits on its "
                         "request (for checking against the model)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the driver; returns its state (network, nodes, seed, children,
    engines, request results) for callers that check it."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    cfg = dataclasses.replace(get_arch(args.arch), compute_dtype="float32")
    net = Network()
    nodes = [NodeRuntime(f"node{i}", net, cache_enabled=True,
                         device_pool=True, device=dev)
             for i in range(args.nodes)]

    # Seed replica on node0 — the single provisioned instance (O(1))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen, dev)
    seed_inst = ModelInstance.create(nodes[0], cfg.name, params)
    handle = nodes[0].prepare_fork(seed_inst)
    blob = nodes[0].seeds[handle.handler_id].blob
    print(f"[serve] seed on node0: {seed_inst.total_bytes()/2**20:.1f} MiB, "
          f"descriptor {len(blob)/1024:.1f} KiB")

    # Scale out: each remaining node forks the seed and serves
    policy = ForkPolicy(lazy=True, prefetch=1)
    engines, children, child_params, fork_s = [], [], [], []
    for node in nodes[1:]:
        t0 = time.perf_counter()
        child = handle.resume_on(node, policy)
        cp = child.materialize_pytree()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        fork_s.append(dt)
        print(f"[serve] {node.node_id}: forked replica in {dt*1e3:.1f} ms "
              f"({child.stats['pages_rdma']} pages via RDMA)")
        children.append(child)
        child_params.append(cp)
        engines.append(ServingEngine(cfg, cp, backend="auto", device=dev,
                                     keep_logits=args.keep_logits))

    prompt_gen = torch.Generator().manual_seed(1)
    results, prompts = [], []
    for i in range(args.requests):
        eng = engines[i % len(engines)]
        prompt = torch.randint(0, cfg.vocab_size, (6,),
                               generator=prompt_gen).tolist()
        rid = eng.submit(prompt, max_tokens=args.max_tokens)
        out = eng.run_to_completion()[rid]
        print(f"[serve] req{i} -> {out}")
        prompts.append(prompt)
        results.append((eng, rid))

    fork_demo = None
    if args.fork_demo:
        eng = engines[0]
        r0 = eng.submit([1, 2, 3, 4], max_tokens=6)
        eng.step()
        eng.step()      # prefill + two decode steps, request still live
        kids = [eng.fork_request(r0, max_tokens=4) for _ in range(3)]
        res = eng.run_to_completion()
        print(f"[serve] fork-demo parent={res[r0]} children="
              f"{[res[k] for k in kids]} (shared prefix pages, COW)")
        fork_demo = SimpleNamespace(engine=eng, parent=r0, children=kids)
    print("[serve] network:", net.snapshot())
    return SimpleNamespace(cfg=cfg, net=net, nodes=nodes, params=params,
                           seed=seed_inst, handle=handle, children=children,
                           child_params=child_params, engines=engines,
                           fork_seconds=fork_s, prompts=prompts,
                           results=results, fork_demo=fork_demo)


if __name__ == "__main__":
    main()
