"""The MoE, Mamba2 and xLSTM families on the fork path and in the paged
engine, in both packages, with the reference's weights carried across.

Fork path: descriptor blobs, leaf names and order, page tables, wire
meters, sim time and child stats equal; children bit-equal to the seed.
Engine: the port's ``ServingEngine`` (CPU) gives the reference engine's
tokens on smoke moonshot, requests and fork demo, with and without
dropped tokens; recurrent archs raise the reference's ``ValueError``.
Last, ``chip_smoke.py``'s models phase rehearsed at smoke size."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.core.descriptor import flatten_with_names  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

from torch_parity import (PORT, REF, bits, load_chip_smoke,  # noqa: E402
                          meter, smoke_cfgs)

ARCHS = ["moonshot-v1-16b-a3b", "zamba2-2.7b", "xlstm-1.3b"]
# zamba2 and xlstm also cut to one block of each kind (the shared
# attention's one parameter set, the sLSTM's leaves)
KINDS = ["zamba2-2.7b:kinds", "xlstm-1.3b:kinds"]


def _fork(P, arch, params):
    """Seed on node0 (device pools), one lazy child with prefetch on
    node1, materialized: (network, descriptor blob, child, its tree)."""
    P.dispatch.reset_meters()
    net = P.Network()
    kw = {"device": "cpu"} if P is PORT else {}
    nodes = [P.Node(f"node{i}", net, page_elems=1024, cache_enabled=True,
                    device_pool=True, **kw) for i in range(2)]
    seed = P.Instance.create(nodes[0], arch, params)
    handle = nodes[0].prepare_fork(seed)
    child = handle.resume_on(nodes[1], P.ForkPolicy(lazy=True, prefetch=1))
    tree = child.materialize_pytree()
    return net, nodes[0].seeds[handle.handler_id].blob, child, tree


@pytest.mark.parametrize("arch", ARCHS + KINDS)
def test_fork_path_matches_reference(arch):
    name, _, kinds = arch.partition(":")
    jc, tc = smoke_cfgs(name, kinds=bool(kinds))
    jparams = jlm.init_params(jax.random.PRNGKey(0), jc)
    np_params = jax.tree.map(np.asarray, jparams)
    jnet, jblob, jkid, jtree = _fork(REF, jc.name, jparams)
    net, blob, kid, tree = _fork(PORT, tc.name,
                                 params_from_numpy(np_params, "cpu"))
    assert blob == jblob
    assert meter(net.meter) == meter(jnet.meter)
    assert net.sim_time == jnet.sim_time
    assert kid.stats == jkid.stats and kid.stats["pages_rdma"] > 0
    assert kid.leaf_names == jkid.leaf_names
    for name in jkid.leaf_names:
        assert kid.aspace[name].table_dict() == jkid.aspace[name].table_dict()
    names, _, seed_leaves = flatten_with_names(np_params)
    tnames, _, leaves = flatten_with_names(tree)
    jnames, _, jleaves = flatten_with_names(jtree)
    assert tnames == jnames == names
    for name, a, b, s in zip(names, leaves, jleaves, seed_leaves):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=name)
        np.testing.assert_array_equal(bits(a), bits(s), err_msg=name)


def _moe_model(**kw):
    jc, tc = smoke_cfgs("moonshot-v1-16b-a3b", **kw)
    jparams = jlm.init_params(jax.random.PRNGKey(2), jc)
    return jc, tc, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _serve(eng, prompts):
    """The serve driver's traffic: requests one at a time, then the fork
    demo (a request, two steps, three forked children)."""
    outs = []
    for p in prompts:
        rid = eng.submit(p, max_tokens=8)
        outs.append(eng.run_to_completion()[rid])
    r0 = eng.submit([1, 2, 3, 4], max_tokens=6)
    eng.step()
    eng.step()
    kids = [eng.fork_request(r0, max_tokens=4) for _ in range(3)]
    res = eng.run_to_completion()
    return (outs, res[r0], [res[k] for k in kids],
            [eng.requests[k] for k in kids])


# smoke moonshot (4 experts, top-2, factor 8: no token dropped), and 8
# experts at factor 1.25: the demo's batch of 4 equal rows then keeps
# each expert for its first row only
@pytest.mark.parametrize("moe_kw", [
    {}, {"moe_experts": 8, "moe_capacity_factor": 1.25}],
    ids=["no-drops", "drops"])
def test_engine_matches_reference_engine(moe_kw):
    jc, tc, jparams, tparams = _moe_model(**moe_kw)
    prompts = [list(np.random.default_rng(i).integers(0, 256, 6))
               for i in range(2)]
    want = _serve(JEngine(jc, jparams, page_tokens=4, backend="ref"),
                  prompts)
    got = _serve(ServingEngine(tc, tparams, page_tokens=4, device="cpu",
                               keep_logits=True), prompts)
    assert got[:3] == want[:3]
    # the children's first step equals a roomy engine's unless tokens of
    # that batch were dropped
    roomy = _serve(ServingEngine(
        dataclasses.replace(tc, moe_capacity_factor=8.0), tparams,
        page_tokens=4, device="cpu", keep_logits=True), prompts)
    firsts = [[r.logits[0] for r in run[3]] for run in (got, roomy)]
    dropped = any(not torch.equal(a, b) for a, b in zip(*firsts))
    assert dropped == bool(moe_kw)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_engine_refuses_recurrent_archs_as_the_reference(arch):
    jc, tc = smoke_cfgs(arch)
    with pytest.raises(ValueError) as want:
        JEngine(jc, {}, backend="ref")
    with pytest.raises(ValueError) as got:
        ServingEngine(tc, {}, device="cpu")
    assert str(got.value) == str(want.value)


def test_chip_smoke_models_phase_rehearses_on_the_cpu():
    """The card script's models phase, checks and all, at smoke size on
    the CPU: moonshot through the serve driver (the fork demo's batches
    held against lm.decode_step), zamba2 and xlstm packed, forked and
    decoded on seed and child."""
    smoke = load_chip_smoke()
    dev = torch.device("cpu")
    line = smoke.moe_model(torch, dev, smoke=True)
    assert line["requests_checked"] == 8 and line["pages_rdma"] > 0
    assert line["logits_max_abs_err"] < smoke.LOGIT_TOL
    for arch in smoke.RECURRENT_ARCHS:
        line = smoke.recurrent_model(torch, dev, arch, smoke=True)
        assert line["child_equal"] and len(line["tokens"]) == 9
        assert line["engine_refused"].startswith("paged engine supports")
