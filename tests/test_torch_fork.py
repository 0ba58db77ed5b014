"""The fork path (part 1 of the slice) in both packages: a seed packed on
node0, two children resumed lazily with prefetch and materialized.  The
network meters (with the impl part of ``kernel.*`` keys mapped jnp <->
torch), sim time, child stats and the children's parameters must all be
equal to the reference's, bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.instance import ModelInstance as JInstance  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.fork import ForkPolicy as JPolicy  # noqa: E402
from repro.net import Network as JNetwork  # noqa: E402
from repro.platform.node import NodeRuntime as JNode  # noqa: E402

from repro_torch import _dtypes  # noqa: E402
from repro_torch.core.descriptor import flatten_with_names  # noqa: E402
from repro_torch.core.instance import ModelInstance  # noqa: E402
from repro_torch.fork import ForkPolicy  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.net import Network  # noqa: E402
from repro_torch.platform.node import NodeRuntime  # noqa: E402

IMPL = {"jnp": "torch"}       # the reference's fused-XLA path <-> plain torch


def _scenario(Net, Node, Inst, Policy, params, device_pool, **node_kw):
    # both packages keep kernel choices in a module meter until a pool
    # drains them: start clean, whatever ran before in this process
    jdispatch.reset_meters()
    dispatch.reset_meters()
    net = Net()
    nodes = [Node(f"node{i}", net, page_elems=1024, cache_enabled=True,
                  device_pool=device_pool, **node_kw) for i in range(3)]
    seed = Inst.create(nodes[0], "micro-hello", params)
    handle = nodes[0].prepare_fork(seed)
    children, trees = [], []
    for node in nodes[1:]:
        child = handle.resume_on(node, Policy(lazy=True, prefetch=1))
        # a partial fault first, so the lazy path and prefetch both run
        first = child.leaf_names[0]
        child.touch_pages(first, [0])
        trees.append(child.materialize_pytree())
        children.append(child)
    return net, nodes, children, trees


def _meter(meter):
    out = {}
    for k, v in meter.items():
        parts = k.split(".")
        if parts[0] == "kernel" and len(parts) == 3:
            parts[2] = IMPL.get(parts[2], parts[2])
        out[".".join(parts)] = v
    return out


def _bits(x):
    if isinstance(x, torch.Tensor):
        return _dtypes.to_numpy(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("device_pool", [True, False])
def test_fork_path_matches_reference(hello_params, device_pool):
    np_params = jax.tree.map(np.asarray, hello_params)
    jnet, jnodes, jkids, jtrees = _scenario(
        JNetwork, JNode, JInstance, JPolicy, hello_params, device_pool)
    net, nodes, kids, trees = _scenario(
        Network, NodeRuntime, ModelInstance, ForkPolicy,
        params_from_numpy(np_params, "cpu"), device_pool, device="cpu")

    assert _meter(net.meter) == _meter(jnet.meter)
    assert net.sim_time == jnet.sim_time
    assert _meter(net.snapshot()) == _meter(jnet.snapshot())
    if device_pool:
        assert net.meter["kernel.page_gather.torch"] > 0
        assert net.meter["kernel.cow_scatter.torch"] > 0
    names, _, seed_leaves = flatten_with_names(np_params)
    for kid, jkid, tree, jtree in zip(kids, jkids, trees, jtrees):
        assert kid.stats == jkid.stats
        assert kid.stats["pages_rdma"] > 0
        tnames, _, leaves = flatten_with_names(tree)
        jnames, _, jleaves = flatten_with_names(jtree)
        assert tnames == jnames == names
        for name, a, b, s in zip(names, leaves, jleaves, seed_leaves):
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
            np.testing.assert_array_equal(_bits(a), _bits(s), err_msg=name)
    for node, jnode in zip(nodes, jnodes):
        assert node.pool.num_allocated() == jnode.pool.num_allocated()
        for dt in jnode.pool._frames:
            np.testing.assert_array_equal(_bits(node.pool._frames[dt]),
                                          _bits(jnode.pool._frames[dt]))


@pytest.mark.parametrize("device_pool", [True, False])
def test_cow_write_then_incremental_reassembly_matches_reference(
        hello_params, device_pool):
    """A child COW-writes one page of a multi-page leaf after assembly:
    ensure_tensor patches that page in (scatter_patch) in both packages."""
    np_params = jax.tree.map(np.asarray, hello_params)
    runs = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            _, _, kids, _ = _scenario(JNetwork, JNode, JInstance, JPolicy,
                                      hello_params, device_pool)
        else:
            _, _, kids, _ = _scenario(Network, NodeRuntime, ModelInstance,
                                      ForkPolicy,
                                      params_from_numpy(np_params, "cpu"),
                                      device_pool, device="cpu")
        child = kids[0]
        name = max(child.leaf_names, key=lambda n: child.aspace[n].npages)
        vma = child.aspace[name]
        assert vma.npages >= 3
        page = np.full((1, 1024), 7.0, np.float32)
        child.write_pages(name, [1], page if pkg == "jax"
                          else torch.from_numpy(page))
        out = child.ensure_tensor(name)
        runs.append((_bits(out), dict(child.stats)))
    (jout, jstats), (tout, tstats) = runs
    np.testing.assert_array_equal(tout, jout)
    assert tstats == jstats
    assert tstats["assemble_patch_pages"] == 1
