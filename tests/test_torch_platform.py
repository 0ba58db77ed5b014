"""The coordinator, straggler mitigation and workflows in both packages.

Each scenario follows one of the reference's own tests
(``tests/test_platform.py``, ``test_faults.py``, ``test_straggler.py``)
and runs once per package on the same micro-hello fp32 parameters, with
host pools on both sides and with device pools on both sides (the
reference's jnp path, the port's plain torch versions of its kernels).
Seed stores, ``gc()`` dicts, lease telemetry, network meters (with the
impl part of ``kernel.*`` keys mapped jnp -> torch) and sim time must be
equal, and every child's parameters bit-equal to the reference child's and
to the seed's."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from torch_parity import (PORT, REF, coord_obs, load_chip_smoke,  # noqa: E402
                          mk_platform, net_obs, node_kw, run_both,
                          tree_digest)

POOL_KINDS = ["host", "device"]


def _invoke_twice(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool)
    out, inst = coord.invoke("f", policy="fork")
    out2, inst2 = coord.invoke("f", policy="fork")
    return {"outs": [out, out2], "second_is_child": bool(inst2.ancestry),
            "child": tree_digest(inst2.materialize_pytree()),
            **coord_obs(coord)}


def _seed_timeout_gc(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool)
    coord.invoke("f")
    clock.t = coord.seed_store["f"].lease_deadline + 1
    return {"gc": coord.gc(), **coord_obs(coord)}


def _seed_renew(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool)
    coord.invoke("f")
    clock.t = 500.0
    coord.renew_seed("f")
    clock.t = 700.0
    return {"gc": coord.gc(), **coord_obs(coord)}


def _cache_per_node(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool)
    out, inst = coord.invoke("f", policy="cache", node=nodes[0])
    coord.release("f", inst, policy="cache")
    out2, inst2 = coord.invoke("f", policy="cache", node=nodes[0])
    coord.release("f", inst2, policy="cache")
    out3, inst3 = coord.invoke("f", policy="cache", node=nodes[1])
    clock.t = 100.0
    return {"reused": inst2 is inst, "other_node_new": inst3 is not inst,
            "gc": coord.gc(), **coord_obs(coord)}


def _crash_to_coldstart(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool)
    coord.invoke("f")
    parent = coord.seed_store["f"].parent_node
    coord.nodes[parent].crash()
    out, inst = coord.invoke("f", node=next(
        n for n in nodes if n.alive and n.node_id != parent))
    return {"out": out, "forked": bool(inst.ancestry), "gc": coord.gc(),
            **coord_obs(coord)}


def _dangling_gc(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool)
    out, inst = coord.invoke("f")
    inst.node.prepare_fork(inst)
    clock.t = 901.0
    return {"gc": coord.gc(), **coord_obs(coord)}


def _sibling_reroute_off_lost_parent(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool, n=4,
                                           seed_replicas=2,
                                           reroute_backlog=0.05)
    seed = coord.deploy_seed("f", replicas=2)
    spare = next(n for n in nodes if n.node_id not in seed.parent_nodes)
    inst = coord.acquire_instance("f", node=spare, policy="fork")
    victim = inst.aspace[inst.leaf_names[0]].ancestry[0]
    coord.nodes[victim].crash()
    inst.ensure_all()
    return {"victim": victim,
            "ancestry": {n: v.ancestry for n, v in inst.aspace.items()},
            "child": tree_digest(inst.materialize_pytree()),
            **coord_obs(coord)}


def _reseed_from_coordinator(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool, n=3,
                                           seed_replicas=2)
    seed = coord.deploy_seed("f", replicas=2)
    spare = next(n for n in nodes if n.node_id not in seed.parent_nodes)
    inst = coord.acquire_instance("f", node=spare, policy="fork")
    for nid in list(seed.parent_nodes):
        coord.nodes[nid].crash()
    inst.ensure_all()
    return {"child": tree_digest(inst.materialize_pytree()),
            **coord_obs(coord)}


def _recovery_exhausts(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool, auto_seed=False)
    coord.deploy_seed("f", node=nodes[0])
    inst = coord.acquire_instance("f", node=nodes[1], policy="fork")
    nodes[0].crash()
    with pytest.raises(P.net.RecoveryFailed):
        inst.ensure_all()
    return coord_obs(coord)


def _parent_lost_once_sharded(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool, n=4,
                                           seed_replicas=2)
    seed = coord.deploy_seed("f", replicas=2)
    first, second = seed.parent_nodes
    spare = next(n for n in nodes if n.node_id not in seed.parent_nodes)
    coord.nodes[first].crash()
    inst = coord.acquire_instance("f", node=spare, policy="fork")
    gcs = [coord.gc()]
    coord.nodes[second].crash()
    gcs.append(coord.gc())
    return {"forked": bool(inst.ancestry), "gc": gcs,
            "child": tree_digest(inst.materialize_pytree()),
            **coord_obs(coord)}


def _parent_lost_once_plain(P, params, pool):
    net, nodes, coord, clock = mk_platform(P, params, pool)
    coord.deploy_seed("f", node=nodes[0])
    nodes[0].crash()
    coord.renew_seed("f")
    inst = coord.acquire_instance("f", node=nodes[1], policy="fork")
    gc = coord.gc()
    coord.acquire_instance("f", node=nodes[1], policy="fork")
    return {"forked": bool(inst.ancestry), "gc": gc, **coord_obs(coord)}


COORDINATOR = {
    "first_coldstart_becomes_seed": _invoke_twice,
    "seed_timeout_gc": _seed_timeout_gc,
    "seed_renew": _seed_renew,
    "cache_policy_per_node": _cache_per_node,
    "node_crash_to_coldstart": _crash_to_coldstart,
    "dangling_seed_gc": _dangling_gc,
    "sibling_reroute_off_lost_parent": _sibling_reroute_off_lost_parent,
    "recovery_reseed_from_coordinator": _reseed_from_coordinator,
    "recovery_exhausts_to_typed_failure": _recovery_exhausts,
    "parent_lost_once_sharded": _parent_lost_once_sharded,
    "parent_lost_once_plain": _parent_lost_once_plain,
}


@pytest.mark.parametrize("pool", POOL_KINDS)
@pytest.mark.parametrize("name", sorted(COORDINATOR))
def test_coordinator_scenario_matches_reference(hello_params, name, pool):
    ref, port = run_both(COORDINATOR[name], hello_params, pool)
    assert port == ref
    seed = tree_digest(jax.tree.map(np.asarray, hello_params))
    if "child" in port:
        assert port["child"] == seed


# ---------------------------------------------------------------------------
# straggler mitigation
# ---------------------------------------------------------------------------


def _straggler(P, params, pool):
    net = P.Network()
    nodes = [P.Node(f"node{i}", net, page_elems=1024, **node_kw(P, pool))
             for i in range(4)]
    mon = P.straggler.StragglerMonitor(net, threshold=2.0)
    for _ in range(5):
        mon.report("node0", 0.1)
        mon.report("node1", 0.1)
        mon.report("node2", 0.4)
    found = mon.stragglers()
    worker = P.Instance.create(nodes[2], "micro-hello", params,
                               registers={"step": 17})
    handle = nodes[2].prepare_fork(worker)
    backup = mon.mitigate("node2", handle, nodes[3])
    after = mon.stragglers()
    mon.resolve("node2", winner="node3")
    return {"found": found, "after": after, "backups": dict(mon.backups),
            "stats": {k: (s.ewma_s, s.steps) for k, s in mon.stats.items()},
            "registers": backup.registers, "stats_child": backup.stats,
            "child": tree_digest(backup.materialize_pytree()),
            **net_obs(net)}


@pytest.mark.parametrize("pool", POOL_KINDS)
def test_straggler_backup_fork_matches_reference(hello_params, pool):
    ref, port = run_both(_straggler, hello_params, pool)
    assert port == ref
    assert port["found"] == ["node2"] and port["registers"]["step"] == 17
    assert port["child"] == tree_digest(jax.tree.map(np.asarray,
                                                     hello_params))


def test_straggler_balanced_workers_match_reference():
    out = []
    for P in (REF, PORT):
        mon = P.straggler.StragglerMonitor(None, threshold=2.0)
        seen = []
        for step in range(5):
            for n in ("a", "b", "c", "d"):
                mon.report(n, 0.1 + 0.01 * step + (0.5 if n == "d" and
                                                   step > 2 else 0.0))
            seen.append(mon.stragglers())
        out.append(seen)
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# workflows: fork state transfer and the message baseline
# ---------------------------------------------------------------------------


def _tensor(P, a):
    return jax.numpy.asarray(a) if P is REF else torch.from_numpy(a.copy())


def _host(P, x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _workflow(P, params, pool, transfer, n_down=3):
    net, nodes, coord, clock = mk_platform(P, params, pool)
    payload = np.arange(4096, dtype=np.float32)

    def up(inst, ctx):
        inst.add_tensor("globals/market", _tensor(P, payload))
        return {"rows": 1, "data": payload[:128]}

    def down(inst, ctx):
        if "msg:U" in ctx:
            got = ctx["msg:U"]["data"]
        else:
            got = _host(P, inst.ensure_tensor("globals/market"))
        return {"sum": float(got.sum()), "n": int(got.size)}

    coord.register_function(P.FunctionDef("up", "micro-hello",
                                          lambda: params, up))
    coord.register_function(P.FunctionDef("down", "micro-hello",
                                          lambda: params, down))
    W = P.workflow
    wf = W.Workflow("t")
    wf.add(W.WorkflowFunc("U", "up"))
    wf.add(W.WorkflowFunc("D", "down",
                          fork_from="U" if transfer == "fork" else None))
    wf.edge("U", "D")
    res = W.run_workflow(coord, wf, {}, transfer=transfer,
                         fan_out={"D": n_down})
    res["U"] = {k: v for k, v in res["U"].items() if k != "data"}
    return {"results": res, "trees": sorted(coord.fork_trees),
            **coord_obs(coord)}


@pytest.mark.parametrize("pool", POOL_KINDS)
@pytest.mark.parametrize("transfer", ["fork", "message"])
def test_workflow_matches_reference(hello_params, transfer, pool):
    ref, port = run_both(_workflow, hello_params, pool, transfer=transfer)
    assert port == ref
    assert port["trees"] == []
    if transfer == "message":
        assert port["meter"]["msg_bytes"] > 0
        assert [r["sum"] for r in port["results"]["D"]] == \
            [float(np.arange(128).sum())] * 3
    else:
        assert [r["n"] for r in port["results"]["D"]] == [4096] * 3


def _finra(P, params, pool, transfer, n_rules=3, market_mb=0.25):
    """The FINRA app (``build_finra``) as ``examples/serve_workflow_finra``
    registers it, at a small market."""
    net, nodes, coord, clock = mk_platform(P, params, pool, n=4)
    market = np.random.default_rng(0).standard_normal(
        int(market_mb * 2**20 / 4)).astype(np.float32)

    def fetch(inst, ctx):
        if transfer == "message":
            return {"market": _tensor(P, market)}
        inst.add_tensor("globals/market", _tensor(P, market))
        return {"rows": market.size}

    def audit(inst, ctx):
        if "msg:fetchData" in ctx:
            data = ctx["msg:fetchData"]["market"]
        else:
            data = _host(P, inst.ensure_tensor("globals/market"))
        return {"violations": int((np.abs(data) > 3.5).sum()),
                "faults": inst.stats["pages_rdma"]}

    coord.register_function(P.FunctionDef("finra-fetch", "micro-hello",
                                          lambda: params, fetch))
    coord.register_function(P.FunctionDef("finra-audit", "micro-hello",
                                          lambda: params, audit))
    wf = P.workflow.build_finra(coord, market_mb=market_mb, n_rules=n_rules)
    res = P.workflow.run_workflow(coord, wf, {}, transfer=transfer,
                                  fan_out={"runAuditRule": n_rules})
    if "market" in res["fetchData"]:
        res["fetchData"]["market"] = tree_digest(
            {"m": res["fetchData"]["market"]})
    return {"results": res, **coord_obs(coord)}


@pytest.mark.parametrize("pool", POOL_KINDS)
@pytest.mark.parametrize("transfer", ["fork", "message"])
def test_finra_matches_reference(hello_params, transfer, pool):
    ref, port = run_both(_finra, hello_params, pool, transfer=transfer)
    assert port == ref
    v = {r["violations"] for r in port["results"]["runAuditRule"]}
    assert len(v) == 1
    if transfer == "message":
        assert port["meter"]["msg_bytes"] > 0.25 * 2**20
    else:
        # each audit child faulted in the market's pages only (and their
        # prefetch), never the model's
        for r in port["results"]["runAuditRule"]:
            assert 0 < r["faults"] <= 0.25 * 2**20 / 4 / 1024 + 1


@pytest.mark.parametrize("shape", [(128,), (3, 5), (0,), (40, 33)])
def test_message_bytes_of_bf16_outputs_match_reference(shape):
    """A bfloat16 output crosses the mailbox as a host tensor; the metered
    bytes are those of the reference's pickle of the same values (which
    names ``ml_dtypes.bfloat16``), and the consumer gets the bfloat16
    values back, not their bits."""
    import pickle
    from repro_torch.platform.workflow import _host as mailbox_value
    from repro_torch.platform.workflow import wire_bytes
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ref_b16 = np.asarray(jax.numpy.asarray(x, jax.numpy.bfloat16))
    port_b16 = torch.from_numpy(x).to(torch.bfloat16)
    ref = {"a": ref_b16, "b": ref_b16.T, "f": x, "n": 3, "s": "k"}
    port = {"a": port_b16,
            "b": port_b16.permute(*reversed(range(port_b16.ndim))),
            "f": torch.from_numpy(x),
            "n": 3, "s": "k"}
    blob = pickle.dumps({k: mailbox_value(v) for k, v in port.items()})
    assert wire_bytes(port, len(blob)) == len(pickle.dumps(ref))
    back = pickle.loads(blob)
    for k, want in (("a", ref_b16), ("b", ref_b16.T)):
        assert back[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(back[k].float().numpy(),
                                      want.astype(np.float32))
    np.testing.assert_array_equal(back["f"], x)


def test_wire_pickler_mirrors_numpys_array_reduce():
    """``wire_bytes`` writes a bfloat16 array the way numpy reduces an
    array and its dtype (dtype state version 3, a fresh ``(0,)`` shape,
    the raw bytes last).  This pins that layout on the numpy installed,
    independently of ``ml_dtypes``: it fails when numpy changes it."""
    from repro_torch.platform import workflow
    a = np.arange(6, dtype=np.uint16).reshape(2, 3)
    fn, args, state = a.__reduce__()
    assert fn is workflow._RECONSTRUCT
    assert args == (np.ndarray, (0,), b"b")
    assert state == (1, (2, 3), np.dtype(np.uint16), False, a.tobytes())
    assert np.asfortranarray(a).__reduce__()[2][3] is True
    assert np.dtype(np.uint16).__reduce__() == (
        np.dtype, ("u2", False, True), (3, "<", None, None, None, -1, -1, 0))


def test_chip_smoke_platform_phase_rehearses_on_the_cpu():
    """The card script's platform phase, assertions and all, on the CPU
    at micro-hello size: three fork invocations over a 2-replica sharded
    seed served through the ServingEngine, a straggler backup fork and
    FINRA by fork and by message (its size knobs serve this rehearsal;
    the card run keeps gemma3-1b, 6 MB and 8 rules)."""
    smoke = load_chip_smoke()
    out = smoke.platform_phase(torch, torch.device("cpu"), arch="micro-hello",
                               market_mb=0.25, n_rules=3)
    assert [r["kind"] for r in out["invocations"]] == ["coldstart", "fork",
                                                       "fork"]
    assert all(len(r["owners"]) == 2 for r in out["invocations"][1:])
    assert out["straggler"]["pages_rdma"] > 0
    assert len(out["finra"]["fork"]["violations"]) == 3
    assert out["finra"]["message"]["msg_bytes"] > 0.25 * 2**20
