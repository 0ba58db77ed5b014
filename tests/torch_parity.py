"""Scaffolding shared by the port's platform-level parity tests: the two
packages' classes side by side, pool kinds, and the observations a
scenario returns (meters, sim time, leaf digests) in a form that compares
with ``==``.

A scenario is a function ``scenario(P, params, pool)``: ``P`` is ``REF``
(the JAX package) or ``PORT`` (the torch port), ``params`` that side's
micro-hello fp32 parameters (the reference's own, carried across with
``models/convert.py``), ``pool`` a key of ``POOLS``.  It returns a dict of
plain values; ``run_both`` runs it once per package and returns both."""
import dataclasses
import hashlib
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.prefetch as jprefetch  # noqa: E402
from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.configs.base import reduce_for_smoke as jreduce  # noqa: E402
import repro.placement as jplacement  # noqa: E402
import repro.platform.coordinator as jcoord  # noqa: E402
import repro.platform.straggler as jstraggler  # noqa: E402
import repro.platform.workflow as jworkflow  # noqa: E402
from repro.core.instance import ModelInstance as JInstance  # noqa: E402
from repro.fork import ForkPolicy as JPolicy  # noqa: E402
from repro.fork.tree import ForkTree as JForkTree  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro import net as jnet  # noqa: E402
from repro.platform.node import NodeRuntime as JNode  # noqa: E402

import repro_torch.core.prefetch as tprefetch  # noqa: E402
import repro_torch.placement as tplacement  # noqa: E402
import repro_torch.platform.coordinator as tcoord  # noqa: E402
import repro_torch.platform.straggler as tstraggler  # noqa: E402
import repro_torch.platform.workflow as tworkflow  # noqa: E402
from repro_torch import _dtypes  # noqa: E402
from repro_torch.configs.base import get_arch as tget_arch  # noqa: E402
from repro_torch.configs.base import reduce_for_smoke as treduce  # noqa: E402
from repro_torch import net as tnet  # noqa: E402
from repro_torch.core.descriptor import flatten_with_names  # noqa: E402
from repro_torch.core.instance import ModelInstance as TInstance  # noqa: E402
from repro_torch.fork import ForkPolicy as TPolicy  # noqa: E402
from repro_torch.fork.tree import ForkTree as TForkTree  # noqa: E402
from repro_torch.kernels import dispatch as tdispatch  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.platform.node import NodeRuntime as TNode  # noqa: E402

from conftest import FakeClock  # noqa: E402


def _side(name, net, Node, Instance, Policy, ForkTree, placement, coord,
          straggler, workflow, prefetch, dispatch):
    return SimpleNamespace(
        name=name, net=net, Network=net.Network, NetModel=net.NetModel,
        Node=Node, Instance=Instance, ForkPolicy=Policy,
        ForkTree=ForkTree, placement=placement, Coordinator=coord.Coordinator,
        FunctionDef=coord.FunctionDef, straggler=straggler,
        workflow=workflow, issue_fan_in=prefetch.issue_fan_in,
        dispatch=dispatch)


REF = _side("jax", jnet, JNode, JInstance, JPolicy, JForkTree, jplacement,
            jcoord, jstraggler, jworkflow, jprefetch, jdispatch)
PORT = _side("torch", tnet, TNode, TInstance, TPolicy, TForkTree, tplacement,
             tcoord, tstraggler, tworkflow, tprefetch, tdispatch)

# node keyword arguments per pool kind: host numpy pools on both sides, or
# device pools (the reference's jnp path on the CPU, the port's plain torch
# versions of its kernels on a CPU tensor)
POOLS = {"host": ({}, {}),
         "device": ({"device_pool": True},
                    {"device_pool": True, "device": "cpu"})}
IMPL = {"jnp": "torch"}       # the reference's fused-XLA path <-> plain torch


def node_kw(P, pool):
    return dict(POOLS[pool][0 if P is REF else 1])


def every_kind(cfg):
    """``cfg`` with each group's unit cut to one block of each kind, in
    order (zamba2: a Mamba block and the shared attention; xlstm: an mLSTM
    and the sLSTM): the smoke cut keeps a unit's first three blocks, which
    for those two are all of one kind."""
    return dataclasses.replace(cfg, groups=tuple(
        dataclasses.replace(g, unit=tuple(dict.fromkeys(g.unit)))
        for g in cfg.groups))


def smoke_cfgs(name, kinds=False, **kw):
    """(reference config, port config) of arch ``name`` at smoke size in
    fp32 unless ``kw`` gives another ``compute_dtype``, with the fields
    ``kw`` replaced; the two must be equal.  With ``kinds`` the unit is
    first cut to one block of each kind (``every_kind``)."""
    cut = every_kind if kinds else (lambda cfg: cfg)
    kw = {"compute_dtype": "float32", **kw}
    jc = dataclasses.replace(jreduce(cut(jget_arch(name))), **kw)
    tc = dataclasses.replace(treduce(cut(tget_arch(name))), **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def side_params(P, hello_params):
    """micro-hello fp32 parameters for side ``P``: the reference's own, or
    the same numbers carried across as CPU tensors."""
    if P is REF:
        return hello_params
    return params_from_numpy(jax.tree.map(np.asarray, hello_params), "cpu")


def meter(m):
    """A network meter with the impl part of ``kernel.*`` keys mapped
    jnp -> torch, so that both packages' device-pool meters compare."""
    out = {}
    for k, v in m.items():
        parts = k.split(".")
        if parts[0] == "kernel" and len(parts) == 3:
            parts[2] = IMPL.get(parts[2], parts[2])
        out[".".join(parts)] = v
    return out


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return _dtypes.to_numpy(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def tree_digest(tree) -> dict:
    """leaf name -> (shape, sha256 of the leaf's bytes)."""
    names, _, leaves = flatten_with_names(tree)
    out = {}
    for name, leaf in zip(names, leaves):
        b = np.ascontiguousarray(bits(leaf))
        out[name] = (tuple(b.shape), hashlib.sha256(b.tobytes()).hexdigest())
    return out


def net_obs(net) -> dict:
    return {"meter": meter(net.meter), "sim_time": net.sim_time}


def coord_obs(coord) -> dict:
    return {"seed_store": sorted(coord.seed_store),
            "lease": {f: dict(c) for f, c in coord.lease_telemetry.items()},
            **net_obs(coord.network)}


def mk_platform(P, params, pool, n=3, behavior=None, **coord_kw):
    """An ``n``-node coordinator cluster on a FakeClock with one function
    "f" whose behaviour assembles the first leaf."""
    net = P.Network()
    clock = FakeClock()
    nodes = [P.Node(f"node{i}", net, page_elems=1024, clock=clock,
                    **node_kw(P, pool)) for i in range(n)]
    coord = P.Coordinator(net, nodes, clock=clock, **coord_kw)

    def assemble_first(inst, ctx):
        inst.ensure_tensor(inst.leaf_names[0])
        return {"ok": True}

    coord.register_function(P.FunctionDef(
        name="f", arch="micro-hello", make_params=lambda: params,
        behavior=behavior or assemble_first))
    return net, nodes, coord, clock


def run_both(scenario, hello_params, pool, **kw):
    """(reference observation, port observation) of one scenario, each
    package's module meter of kernel choices started clean."""
    out = []
    for P in (REF, PORT):
        P.dispatch.reset_meters()
        out.append(scenario(P, side_params(P, hello_params), pool, **kw))
    return out


def load_chip_smoke():
    """``chip_smoke.py`` from the checkout root, as a module (it imports
    numpy alone at import; its phases import the port when called)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
