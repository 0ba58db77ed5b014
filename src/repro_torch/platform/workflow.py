"""Serverless workflows (§2.3, §6.1): DAGs of functions with fork-based
state transfer, plus the message-passing baseline (Fn/Redis-style).

Upstream functions pre-materialize state into their instance
(`instance.add_tensor`); downstream functions fork the upstream seed and
read it with zero serialization — the FINRA pattern of Figure 3(b).
"""
from __future__ import annotations

import dataclasses
import io
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import _dtypes
from repro_torch.fork import ForkHandle, ForkPolicy
from repro_torch.platform.coordinator import Coordinator, ForkTreeNode


@dataclasses.dataclass
class WorkflowFunc:
    name: str
    func: str                      # FunctionDef name at the coordinator
    fork_from: Optional[str] = None  # annotated upstream to fork (§6.1)


class Workflow:
    def __init__(self, wf_id: str):
        self.wf_id = wf_id
        self.nodes: Dict[str, WorkflowFunc] = {}
        self.edges: List[tuple] = []

    def add(self, wfunc: WorkflowFunc) -> "Workflow":
        self.nodes[wfunc.name] = wfunc
        return self

    def edge(self, up: str, down: str) -> "Workflow":
        self.edges.append((up, down))
        return self

    def topo_order(self) -> List[str]:
        indeg = {n: 0 for n in self.nodes}
        for u, v in self.edges:
            indeg[v] += 1
        order, frontier = [], [n for n, d in indeg.items() if d == 0]
        while frontier:
            n = frontier.pop(0)
            order.append(n)
            for u, v in self.edges:
                if u == n:
                    indeg[v] -= 1
                    if indeg[v] == 0:
                        frontier.append(v)
        assert len(order) == len(self.nodes), "cycle in workflow"
        return order

    def upstreams(self, name: str) -> List[str]:
        return [u for u, v in self.edges if v == name]


def run_workflow(coord: Coordinator, wf: Workflow, inputs: dict, *,
                 transfer: str = "fork", fan_out: Dict[str, int] = None,
                 prefetch: int = 1) -> dict:
    """Execute a workflow. transfer: "fork" (MITOSIS) or "message"
    (serialize->copy->deserialize, the Fn/Redis baseline).

    fan_out: optional {func_name: n} to run n parallel children of one node
    (FINRA's ~200 runAuditRule instances)."""
    fan_out = fan_out or {}
    results: Dict[str, Any] = {}
    instances: Dict[str, Any] = {}
    seeds: Dict[str, ForkHandle] = {}      # wf node -> short-lived seed handle
    root = ForkTreeNode(func="<root>", node_id="", handle=None)
    tree_nodes = {None: root}
    coord.tree_open(wf.wf_id, root)
    mailbox: Dict[str, bytes] = {}

    for name in wf.topo_order():
        wfunc = wf.nodes[name]
        fdef = coord.functions[wfunc.func]
        ups = wf.upstreams(name)
        n_copies = fan_out.get(name, 1)
        outs = []
        for ci in range(n_copies):
            # route-aware: the scheduler sees the function's seed demand
            node = coord.pick_node(func=wfunc.func)
            ctx = dict(inputs)
            inst = None
            if transfer == "fork" and ups:
                src = wfunc.fork_from or ups[0]
                inst = seeds[src].resume_on(node, ForkPolicy(lazy=True,
                                                             prefetch=prefetch))
                ctx["__fork_parent"] = src
            elif transfer == "message" and ups:
                # Fn-style: deserialize upstream state from the mailbox
                for u in ups:
                    ctx[f"msg:{u}"] = pickle.loads(mailbox[u])
            if inst is None:
                inst = coord.acquire_instance(wfunc.func, node=node,
                                              policy="fork")
            out = fdef.behavior(inst, ctx)
            outs.append(out)
            tn = ForkTreeNode(func=name, node_id=node.node_id, handle=None)
            tree_nodes.setdefault(name, tn)
            parent_tn = tree_nodes.get(
                wfunc.fork_from or (ups[0] if ups else None), root)
            parent_tn.children.append(tn)
            instances.setdefault(name, []).append(inst)
        results[name] = outs if n_copies > 1 else outs[0]

        # prepare this node as a short-lived seed for downstreams (§6.1)
        has_down = any(u == name for u, _ in wf.edges)
        if has_down:
            if transfer == "fork":
                inst0 = instances[name][0]
                handle = inst0.node.prepare_fork(inst0)
                seeds[name] = handle
                tree_nodes[name].handle = handle
            else:
                # message baseline: serialize outputs (the cost MITOSIS skips)
                payload = {k: _host(v) for k, v in
                           (results[name] or {}).items()}
                mailbox[name] = pickle.dumps(payload)
                nbytes = wire_bytes(results[name] or {},
                                    len(mailbox[name]))
                coord.network.meter["msg_bytes"] += nbytes
                # modeled store round trip: producer PUT + consumer GET
                # (Redis-style; paper: ~27 ms store latency for FINRA)
                nm = coord.network.model
                coord.network.sim_time += 2 * nbytes / nm.rdma_bw + 27e-3

    coord.tree_close(wf.wf_id)
    for insts in instances.values():
        for inst in insts:
            inst.free()
    return results


def _host(v):
    """An output value as the mailbox carries it: tensors become host
    numpy arrays, except bfloat16 ones, which numpy cannot hold without
    ``ml_dtypes``: they stay tensors, moved to the host, so the consumer
    reads values and never bare bits."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.detach().cpu()
        return v.detach().cpu().numpy()
    return np.asarray(v) if hasattr(v, "shape") else v


class _Global:
    """A global that a pickle names and this process need not have."""

    def __init__(self, module: str, name: str):
        self.module, self.name = module, name


_BF16_TYPE = _Global("ml_dtypes", "bfloat16")


class _BF16Bits:
    """A bfloat16 array held as its uint16 bits, pickled as numpy pickles
    an ``ml_dtypes.bfloat16`` array."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits


_BF16_DTYPE = object()          # stands for np.dtype(ml_dtypes.bfloat16)
_RECONSTRUCT = np.zeros(1).__reduce__()[0]


class _WirePickler(pickle._Pickler):
    """The pure-Python pickler, writing a bfloat16 array as numpy's own
    ``__reduce__`` does with the ``ml_dtypes`` dtype: the stream the
    reference's message baseline puts on the wire for the same payload."""

    def reducer_override(self, obj):
        if isinstance(obj, _BF16Bits):
            a = obj.bits
            fortran = a.flags.f_contiguous and not a.flags.c_contiguous
            # a fresh (0,) each time, as numpy's reduce builds one per array
            return (_RECONSTRUCT, (np.ndarray, tuple([0]), b"b"),
                    (1, a.shape, _BF16_DTYPE, fortran,
                     a.tobytes(order="F" if fortran else "C")))
        if obj is _BF16_DTYPE:
            return (np.dtype, (_BF16_TYPE, False, True),
                    (3, "<", None, None, None, 2, 2, 64))
        return NotImplemented

    def save(self, obj, save_persistent_id=True):
        if isinstance(obj, _Global):
            memo = self.memo.get(id(obj))
            if memo is not None:
                self.write(self.get(memo[0]))
                return
            self.save(obj.module)
            self.save(obj.name)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save(obj, save_persistent_id)


def wire_bytes(outputs: dict, blob_len: int) -> int:
    """Bytes the message baseline meters for ``outputs``: the length of
    the pickle the reference writes for the same payload.  That is the
    mailbox blob's own length unless a value is a bfloat16 tensor, whose
    reference pickle names ``ml_dtypes.bfloat16`` where the blob holds a
    torch tensor.  The stream mirrors numpy's array and dtype
    ``__reduce__``, which the port's workflow tests pin."""
    if not any(isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
               for v in outputs.values()):
        return blob_len
    payload = {k: (_BF16Bits(_dtypes.to_numpy(v))
                   if isinstance(v, torch.Tensor)
                   and v.dtype == torch.bfloat16 else _host(v))
               for k, v in outputs.items()}
    buf = io.BytesIO()
    _WirePickler(buf, protocol=pickle.DEFAULT_PROTOCOL).dump(payload)
    return len(buf.getvalue())


# ---------------------------------------------------------------------------
# FINRA (Figure 2): fetchPortfolioData + fetchMarketData -> runAuditRule x N
# ---------------------------------------------------------------------------


def build_finra(coord: Coordinator, market_mb: float = 6.0,
                n_rules: int = 8) -> Workflow:
    """The paper's FINRA app: upstream functions fetch market/portfolio data
    (fused, per §7.6), N audit-rule children consume it."""
    wf = Workflow("finra")
    wf.add(WorkflowFunc(name="fetchData", func="finra-fetch"))
    wf.add(WorkflowFunc(name="runAuditRule", func="finra-audit",
                        fork_from="fetchData"))
    wf.edge("fetchData", "runAuditRule")
    return wf
