"""The placement plane in both packages: schedulers, placement policies and
route plans, sharded seeds, per-VMA transport routes, the Router's hot-spot
re-routing and the link clock.

Pure parts (scheduler picks, plans) are fed the same inputs and must give
equal answers.  Platform scenarios follow the reference's own tests
(``tests/test_placement.py``, ``test_link_contention.py``) and run once per
package on the same micro-hello fp32 parameters, with host pools on both
sides and with device pools on both sides: network meters (impl part of
``kernel.*`` keys mapped jnp -> torch), sim time, lease telemetry, ``gc()``
dicts, routes and children's parameters must be equal."""
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from conftest import FakeClock  # noqa: E402
from torch_parity import (PORT, REF, coord_obs, mk_platform,  # noqa: E402
                          net_obs, node_kw, run_both, side_params,
                          tree_digest)

POOL_KINDS = ["host", "device"]


# ---------------------------------------------------------------------------
# schedulers: the same pick sequences
# ---------------------------------------------------------------------------


def _fake_nodes(*ids):
    return {i: types.SimpleNamespace(node_id=i, alive=True) for i in ids}


def _rr_picks(P):
    sched = P.placement.RoundRobinScheduler()
    nodes = _fake_nodes("a", "b", "c", "d")
    picks = [sched.pick(nodes).node_id for _ in range(5)]
    picks += [sched.pick(nodes, exclude={"b"}).node_id for _ in range(5)]
    nodes["c"].alive = False
    picks += [sched.pick(nodes).node_id for _ in range(5)]
    nodes["c"].alive = True
    nodes["e"] = types.SimpleNamespace(node_id="e", alive=True)
    picks += [sched.pick(nodes, exclude={"a"}).node_id for _ in range(6)]
    with pytest.raises(P.net.NoNodesAvailable, match="no live nodes"):
        sched.pick(_fake_nodes())
    return picks


def _transport_aware_picks(P):
    net = P.Network()
    for i in range(6):
        P.Node(f"node{i}", net, page_elems=64)
    sched = P.placement.TransportAwareScheduler(net)
    nodes = {i: net.nodes[i] for i in net.nodes}
    out = [sched.pick(nodes).node_id for _ in range(3)]      # no demand: RR
    net.note_connection("rc", "node2", "node0")
    out.append(sched.pick(nodes, exclude={"node0"},
                          demand=P.placement.route_demand(["node0"], ["rc"])
                          ).node_id)
    net.set_channel_busy("node1", "node0", 5.0)
    demand = P.placement.route_demand(["node0", "node3"], [None, "dct"])
    out.append(sched.pick(nodes, exclude={"node0"}, demand=demand).node_id)
    out.append([sched.score(n, demand) for n in sorted(nodes)])
    out.append(sched.score("node1",
                           P.placement.route_demand(["node0"], ["rc"]) * 40))
    return out


@pytest.mark.parametrize("which", ["round_robin", "transport_aware"])
def test_scheduler_picks_match_reference(which):
    fn = _rr_picks if which == "round_robin" else _transport_aware_picks
    assert fn(PORT) == fn(REF)


# ---------------------------------------------------------------------------
# placement policies and route plans: the same plans
# ---------------------------------------------------------------------------


def _vmas(P, seed, n):
    rng = np.random.default_rng(seed)
    names = [f"layers/{i}/{k}" for i in range(n // 3 + 1)
             for k in ("w", "opt/m", "ema")][:n]
    sizes = rng.integers(1, 1 << 20, n)
    sizes[rng.integers(0, n, 2)] = sizes[0]          # ties break by name
    return [P.placement.VMAInfo(nm, int(s)) for nm, s in zip(names, sizes)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_plans_match_reference(seed):
    out = []
    for P in (REF, PORT):
        pl = P.placement
        vmas = _vmas(P, seed, 17)
        reps = [f"p{i}" for i in range(1 + seed)]
        plans = [pl.PlacementPolicy().plan(vmas, reps).to_dict()]
        for off in range(3):
            plans.append(pl.SpreadPolicy().plan(vmas, reps, off).to_dict())
            plans.append(pl.SpreadPolicy("rc").plan(vmas, reps,
                                                    off).to_dict())
            plans.append(pl.HotColdPolicy().plan(vmas, reps, off).to_dict())
        hc = pl.HotColdPolicy(hot="tpu_ici", cold=None)
        plans.append(hc.plan(vmas, reps, 1).to_dict())
        plans.append([hc.transport_hints(),
                      pl.SpreadPolicy().transport_hints()])
        plan = pl.SpreadPolicy().plan(vmas, reps)
        fallback = pl.HotColdPolicy().plan(vmas, list(reversed(reps)))
        plans.append([plan.owners(), plan.transports(), plan.by_owner(),
                      plan.reroute(reps[0], fallback), plan.to_dict(),
                      pl.RoutePlan.from_dict(plan.to_dict()).to_dict()])
        with pytest.raises(ValueError, match="unknown transport"):
            pl.SpreadPolicy(transport="bogus")
        with pytest.raises(ValueError, match="empty replica set"):
            pl.SpreadPolicy().plan(vmas, [])
        out.append(plans)
    assert out[1] == out[0]


def test_vma_sizes_match_reference_for_bf16(hello_params):
    """A descriptor's VMA sizes and a sharded child's Router sources,
    bfloat16 leaves included: the port takes the item size from its dtype
    table, since numpy has no bfloat16 where the port runs."""
    np_params = jax.tree.map(np.asarray, hello_params)
    mixed = {"w": np_params, "b16": np.asarray(
        jax.numpy.arange(3000, dtype=jax.numpy.bfloat16))}
    from repro_torch.models.convert import params_from_numpy
    out = []
    for P in (REF, PORT):
        net = P.Network()
        nodes = [P.Node(f"n{i}", net, page_elems=1024) for i in range(3)]
        params = mixed if P is REF else params_from_numpy(mixed, "cpu")
        inst = P.Instance.create(nodes[0], "micro-hello", params)
        handle = nodes[0].prepare_fork(inst)
        desc = handle.fetch_descriptor(nodes[2], P.ForkPolicy())
        infos = P.placement.descriptor_vma_infos(desc)
        replica = handle.resume_on(nodes[1], P.ForkPolicy(lazy=False))
        seed = P.placement.ShardedSeed([handle,
                                        nodes[1].prepare_fork(replica)])
        child = seed.resume_on(nodes[2], P.ForkPolicy(reroute_backlog=1.0))
        sources = {n: {o: s.nbytes for o, s in by.items()}
                   for n, by in child.router.sources.items()}
        out.append(([(v.name, v.nbytes) for v in infos], sources,
                    tree_digest(child.materialize_pytree())))
    assert out[1] == out[0]
    assert ("b16", 6000) in out[1][0]
    assert out[1][1]["b16"] == {"n0": 6000, "n1": 6000}


def test_vma_sizes_need_no_ml_dtypes():
    """Where the port runs, numpy knows no ``bfloat16``: with
    ``ml_dtypes`` unimportable, a bf16 VMA's size still comes out."""
    import os
    import subprocess
    import sys
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import numpy as np\n"
        "from types import SimpleNamespace as NS\n"
        "from repro_torch.placement import ShardedSeed\n"
        "from repro_torch.placement.route import descriptor_vma_infos\n"
        "vd = {'name': 'b', 'shape': [3000], 'dtype': 'bfloat16',\n"
        "      'frames': np.arange(6, dtype=np.int32).tobytes()}\n"
        "d = NS(vmas=[vd], extra={'prepared_keys': {'b': 7}})\n"
        "src = ShardedSeed._route_sources([(NS(parent_node='p'), d)])\n"
        "print(descriptor_vma_infos(d)[0].nbytes, src['b']['p'].nbytes)\n")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve()
                                          .parents[1] / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["6000", "6000"]


# ---------------------------------------------------------------------------
# sharded seeds and the coordinator's shard lifecycle
# ---------------------------------------------------------------------------


def _deploy_sharded(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool, n=8)
    seed = coord.deploy_seed("f", nodes[0], replicas=3)
    net.reset_meter()
    child = seed.resume_on(nodes[5])
    tree = tree_digest(child.materialize_pytree())
    busy = {p: net.node_busy(p) for p in seed.parent_nodes}
    return {"parents": seed.parent_nodes, "repr": repr(seed),
            "owners": {n: v.ancestry[0] for n, v in child.aspace.items()},
            "resident": [coord.nodes[h.parent_node].seeds[h.handler_id]
                         .instance.resident_fraction()
                         for h in seed.handles],
            "busy": busy, "child": tree, **coord_obs(coord)}


def _fan_out_rotates(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool, n=8)
    seed = coord.deploy_seed("f", nodes[0], replicas=2)
    kids = seed.fan_out([nodes[4], nodes[5], nodes[6], nodes[7]])
    return {"serve_counts": dict(seed.serve_counts),
            "owners": [{n: v.ancestry[0] for n, v in k.aspace.items()}
                       for k in kids],
            "children": [tree_digest(k.materialize_pytree()) for k in kids],
            **coord_obs(coord)}


def _lease_surface(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool, n=8)
    seed = coord.deploy_seed("f", nodes[0], replicas=2)
    surface = [seed.alive, seed.expired, seed.lease_deadline,
               seed.remaining(10.0)]
    clock.t = 100.0
    seed.renew()
    seed.revoke()
    surface += [[h.generation for h in seed.handles], seed.lease_deadline]
    child = seed.resume_on(nodes[5])
    seed.reclaim(free_instance=False)
    surface += [seed.alive, bool(child.ancestry)]
    return {"surface": surface, "child": tree_digest(
        child.materialize_pytree()), **coord_obs(coord)}


def _degradation(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool, n=8)
    seed = coord.deploy_seed("f", nodes[0], replicas=3)
    parents = list(seed.parent_nodes)
    out1, c1 = coord.invoke("f", node=nodes[5], policy="fork")
    coord.nodes[parents[1]].crash()
    out2, c2 = coord.invoke("f", node=nodes[6], policy="fork")
    owners2 = {n: v.ancestry[0] for n, v in c2.aspace.items()}
    freed = coord.gc()
    out3, c3 = coord.invoke("f", node=nodes[7], policy="fork")
    return {"outs": [out1, out2, out3], "owners2": owners2, "gc": freed,
            "parents": seed.parent_nodes,
            "children": [tree_digest(c.materialize_pytree())
                         for c in (c1, c2, c3)], **coord_obs(coord)}


def _fully_lost(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool, n=8)
    seed = coord.deploy_seed("f", nodes[0], replicas=2)
    for p in list(seed.parent_nodes):
        coord.nodes[p].crash()
    live = next(n for n in nodes if n.alive)
    out, inst = coord.invoke("f", node=live, policy="fork")
    return {"out": out, "reseeded_on": coord.seed_store["f"].parent_node,
            **coord_obs(coord)}


def _plain_parent_loss(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool)
    coord.invoke("f")
    parent = coord.seed_store["f"].parent_node
    coord.nodes[parent].crash()
    fresh = coord._fresh_seed("f")
    live = next(n for n in nodes if n.alive)
    out, inst = coord.invoke("f", node=live, policy="fork")
    return {"fresh": fresh, "out": out,
            "reseeded_on": coord.seed_store["f"].parent_node,
            **coord_obs(coord)}


# ---------------------------------------------------------------------------
# per-VMA transport routes
# ---------------------------------------------------------------------------


def _hot_cold_parent(P, params, pool, n=4):
    net = P.Network()
    nodes = [P.Node(f"node{i}", net, page_elems=1024, **node_kw(P, pool))
             for i in range(n)]
    parent = P.Instance.create(nodes[0], "micro-hello", params)
    parent.add_tensor("opt/m", np.zeros(4096, np.float32) if P is REF
                      else torch.zeros(4096))
    return net, nodes, parent


def _hot_cold_routes(P, params, pool):
    net, nodes, parent = _hot_cold_parent(P, params, pool)
    handle = nodes[0].prepare_fork(parent)
    child = handle.resume_on(nodes[1], P.ForkPolicy(),
                             placement=P.placement.HotColdPolicy())
    net.reset_meter()
    child.ensure_tensor("opt/m")
    after_cold = net_obs(net)
    child.ensure_tensor(child.leaf_names[0])
    reseed = nodes[1].prepare_fork(child)
    grand = reseed.resume_on(nodes[2])
    grand.ensure_tensor("opt/m")
    return {"transports": {n: v.transport for n, v in child.aspace.items()},
            "grand": {n: v.transport for n, v in grand.aspace.items()},
            "after_cold": after_cold,
            "grand_tree": tree_digest(grand.materialize_pytree()),
            **net_obs(net)}


def _async_prefetch_route(P, params, pool):
    net, nodes, parent = _hot_cold_parent(P, params, pool)
    handle = nodes[0].prepare_fork(parent)
    child = handle.resume_on(nodes[1], P.ForkPolicy(async_prefetch=4),
                             placement=P.placement.HotColdPolicy(
                                 cold="shared_fs"))
    net.reset_meter()
    child.prefetch_engine.issue("opt/m", np.arange(4))
    issued = net_obs(net)
    child.prefetch_engine.drain("opt/m")
    return {"issued": issued, "stats": child.stats, **net_obs(net)}


def _node_busy_ledger(P, params, pool):
    net, nodes, parent = _hot_cold_parent(P, params, pool)
    handle = nodes[0].prepare_fork(parent)
    child = handle.resume_on(nodes[1])
    net.reset_meter()
    child.ensure_all()
    return {"busy": [net.node_busy(f"node{i}") for i in range(4)],
            **net_obs(net)}


# ---------------------------------------------------------------------------
# link contention, Router re-routing, sharded fork trees
# ---------------------------------------------------------------------------


def _mk_coord(P, params, pool, n_nodes=6, node_links=1, **coord_kw):
    net = P.Network(model=P.NetModel(node_links=node_links))
    clock = FakeClock()
    nodes = [P.Node(f"node{i}", net, page_elems=1024, clock=clock,
                    **node_kw(P, pool)) for i in range(n_nodes)]
    coord = P.Coordinator(net, nodes, clock=clock, **coord_kw)
    coord.register_function(P.FunctionDef(
        name="f", arch="micro-hello", make_params=lambda: params,
        behavior=lambda inst, ctx: {"ok": True}))
    return net, nodes, coord


def _heat_link(net, node, pages=4096):
    frames = node.pool.alloc("float32", pages)
    key = net.create_dc_target(node.node_id)
    net.read_pages("bystander", node.node_id, "float32", frames, key,
                   async_read=True)
    return net.link_backlog(node.node_id)


def _touch_all(child):
    for name in child.leaf_names:
        child.touch_pages(name, np.arange(child.aspace[name].npages))


def _routed_run(P, params, pool, reroute_backlog):
    net, nodes, coord = _mk_coord(P, params, pool)
    seed = coord.deploy_seed("f", nodes[0], replicas=2)
    hot = seed.parent_nodes[0]
    child = seed.resume_on(nodes[4], P.ForkPolicy(
        descriptor_fetch="rpc", reroute_backlog=reroute_backlog))
    backlog = _heat_link(net, coord.nodes[hot])
    _touch_all(child)
    return {"backlog": backlog,
            "reroutes": None if child.router is None
            else child.router.reroutes,
            "owners": {n: v.ancestry[0] for n, v in child.aspace.items()},
            "child": tree_digest(child.materialize_pytree()),
            **net_obs(net)}


def _reroute_static(P, params, pool):
    return _routed_run(P, params, pool, None)


def _reroute_hot(P, params, pool):
    return _routed_run(P, params, pool, 1e-5)


def _router_crashed_owner(P, params, pool):
    net, nodes, coord = _mk_coord(P, params, pool)
    seed = coord.deploy_seed("f", nodes[0], replicas=2)
    child = seed.resume_on(nodes[4], P.ForkPolicy(
        descriptor_fetch="rpc", reroute_backlog=1e-3))
    victim = next(vma.ancestry[0] for vma in child.aspace.values())
    coord.nodes[victim].crash()
    tree = tree_digest(child.materialize_pytree())
    return {"reroutes": child.router.reroutes, "child": tree,
            "plan": child.router.plan.to_dict(), **net_obs(net)}


def _lazy_restamp(P, params, pool):
    net, nodes, coord = _mk_coord(P, params, pool)
    seed = coord.deploy_seed("f", nodes[0], replicas=2)
    child = seed.resume_on(nodes[4], P.ForkPolicy(
        descriptor_fetch="rpc", reroute_backlog=1e-5))
    plan = child.router.plan
    by_owner = {}
    for name, r in plan.routes.items():
        by_owner.setdefault(r.owner, []).append(name)
    hot, names = max(by_owner.items(), key=lambda e: len(e[1]))
    other = next(o for o in by_owner if o != hot)
    _heat_link(net, coord.nodes[hot])
    child.touch_pages(names[0], [0])
    stamps = [child.aspace[names[1]].ancestry[0]]
    coord.nodes[other].crash()
    child.touch_pages(names[1], [0])
    stamps.append(child.aspace[names[1]].ancestry[0])
    return {"stamps": stamps, "child": tree_digest(
        child.materialize_pytree()), **net_obs(net)}


def _coord_reroute_backlog(P, params, pool):
    net, nodes, coord = _mk_coord(P, params, pool, reroute_backlog=2e-4)
    coord.deploy_seed("f", nodes[0], replicas=2)
    out, inst = coord.invoke("f", node=nodes[4])
    return {"out": out, "threshold": inst.router.threshold,
            "child": tree_digest(inst.materialize_pytree()),
            **coord_obs(coord)}


def _sharded_tree(P, params, pool):
    net, nodes, coord = _mk_coord(P, params, pool, n_nodes=10)
    seed = coord.deploy_seed("f", nodes[0], replicas=2)
    tree = seed.fan_out([nodes[3 + i] for i in range(6)],
                        P.ForkPolicy(descriptor_fetch="rpc"), tree_degree=1)
    served = sorted(tree.served_by().values())
    kids = [tree_digest(c.materialize_pytree()) for c in tree.children]
    depth = tree.depth()
    tree.close()
    return {"is_tree": isinstance(tree, P.ForkTree), "served": served,
            "depth": depth, "children": kids, "seed_alive": seed.alive,
            "reseeds_alive": [h.alive for h in tree.seeds],
            **coord_obs(coord)}


def _async_fan_in(P, params, pool):
    net, nodes, coord = _mk_coord(P, params, pool, n_nodes=5)
    seed = coord.deploy_seed("f", nodes[0])
    kids = [seed.resume_on(n, P.ForkPolicy(async_prefetch=64))
            for n in nodes[1:]]
    P.issue_fan_in(kids)
    backlog = net.link_backlog("node0")
    for k in kids:
        k.ensure_all()
    return {"backlog": backlog, "children": [
        tree_digest(k.materialize_pytree()) for k in kids], **net_obs(net)}


PLATFORM = {
    "deploy_sharded_seed_and_resume": _deploy_sharded,
    "sharded_fan_out_rotates": _fan_out_rotates,
    "sharded_lease_surface": _lease_surface,
    "shard_degradation_reroute_rereplicate": _degradation,
    "fully_lost_sharded_seed": _fully_lost,
    "plain_seed_parent_loss": _plain_parent_loss,
    "hot_cold_routes_across_generations": _hot_cold_routes,
    "async_prefetch_honors_route": _async_prefetch_route,
    "node_busy_ledger": _node_busy_ledger,
    "static_routes_behind_hot_parent": _reroute_static,
    "router_diverts_hot_parent": _reroute_hot,
    "router_around_crashed_owner": _router_crashed_owner,
    "lazy_restamp_never_targets_crashed": _lazy_restamp,
    "coordinator_reroute_backlog": _coord_reroute_backlog,
    "sharded_fan_out_tree": _sharded_tree,
    "async_fan_in_on_parent_link": _async_fan_in,
}


@pytest.mark.parametrize("pool", POOL_KINDS)
@pytest.mark.parametrize("name", sorted(PLATFORM))
def test_placement_scenario_matches_reference(hello_params, name, pool):
    ref, port = run_both(PLATFORM[name], hello_params, pool)
    assert port == ref
    seed = tree_digest(jax.tree.map(np.asarray, hello_params))
    for tree in [port.get("child")] + port.get("children", []):
        if tree is not None:
            assert tree == seed


def test_reroute_moves_no_extra_bytes(hello_params):
    """The port's Router: a re-routed sweep moves the same bytes as the
    static plan, off the hot parent, and sooner."""
    params = side_params(PORT, hello_params)
    static = _reroute_static(PORT, params, "host")
    routed = _reroute_hot(PORT, params, "host")
    assert static["reroutes"] is None and routed["reroutes"] > 0
    assert routed["meter"]["reroutes"] == routed["reroutes"]
    assert static["meter"]["channel_wait_s"] > 0
    assert routed["meter"]["dct.bytes"] == static["meter"]["dct.bytes"]
    assert routed["sim_time"] < static["sim_time"]

