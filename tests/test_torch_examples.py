"""The port's last two entry points against the reference's examples:
``launch/quickstart.py`` against ``examples/quickstart.py`` and
``launch/finra.py`` against ``examples/serve_workflow_finra.py``.

Each reference example's ``main()`` runs in this process with ``sys.argv``
patched and its standard output captured; the printed facts are parsed and
held against the port's ``run(...)`` record, at the example's rounding.
The exact meters come from a reference run built from the same modules as
the example, with pools of the kind the port uses (device pools: the
reference's jnp path, the port's torch CPU pools).  Descriptor bytes, page
counts and RDMA bytes do not depend on the pool kind on the reference side
either: the printed run uses host pools."""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.core.instance import ModelInstance as JInstance  # noqa: E402
from repro.fork import ForkPolicy as JPolicy  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.net import Network as JNetwork  # noqa: E402
from repro.platform.coordinator import Coordinator as JCoord  # noqa: E402
from repro.platform.coordinator import FunctionDef as JFunctionDef  # noqa: E402
from repro.platform.node import NodeRuntime as JNode  # noqa: E402
from repro.platform.workflow import build_finra as jbuild_finra  # noqa: E402
from repro.platform.workflow import run_workflow as jrun_workflow  # noqa: E402

from repro_torch.launch import finra, quickstart  # noqa: E402
from repro_torch.memory.pool import PAGE_ELEMS  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
RULES, MARKET_MB = 3, 0.25


def _example_output(name, argv=()):
    """What ``examples/<name>.py``'s ``main()`` prints with ``argv``."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with mock.patch.object(sys, "argv", [f"{name}.py", *argv]), \
            contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def _mib(x):
    """A byte count as the examples print it."""
    return f"{x / 2**20:.1f}"


# -- quickstart ----------------------------------------------------------------


@pytest.fixture(scope="module")
def quick():
    """(printed reference facts, exact reference meters, port record) of
    the quickstart on micro-small fp32 with the reference's PRNGKey(0)
    parameters."""
    text = _example_output("quickstart")

    def found(pattern):
        return re.search(pattern, text).group(1)

    printed = {"descriptor_bytes": int(found(r"descriptor = (\d+) bytes")),
               "pages_rdma": int(found(r"(\d+) pages over RDMA")),
               "rdma_mib": found(r"RDMA, ([\d.]+) MiB"),
               **{f"{tag}_tokens": json.loads(found(rf"{tag} generated: "
                                                    r"(\[.*\])"))
                  for tag in ("parent", "child")}}

    cfg = dataclasses.replace(jget_arch("micro-small"),
                              compute_dtype="float32")
    jparams = jlm.init_params(jax.random.PRNGKey(0), cfg)
    net = JNetwork()
    parent = JNode("parent", net, device_pool=True)
    child_node = JNode("child", net, device_pool=True)
    seed = JInstance.create(parent, cfg.name, jparams)
    handle = parent.prepare_fork(seed)
    child = handle.resume_on(child_node, JPolicy(lazy=True, prefetch=1))
    resident = child.resident_fraction()
    child.materialize_pytree()
    exact = {"descriptor_bytes": len(parent.seeds[handle.handler_id].blob),
             "total_bytes": seed.total_bytes(),
             "resident_fraction": resident,
             "pages_rdma": child.stats["pages_rdma"],
             "rdma_bytes": net.meter["rdma_bytes"], "sim_time": net.sim_time}

    port = quickstart.run(["--device", "cpu"], params=params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"))
    return printed, exact, port


def test_quickstart_prints_the_reference_facts(quick):
    printed, _, port = quick
    assert port.descriptor_bytes == printed["descriptor_bytes"]
    assert port.pages_rdma == printed["pages_rdma"]
    assert _mib(port.rdma_bytes) == printed["rdma_mib"]
    assert port.parent_tokens == printed["parent_tokens"]
    assert port.child_tokens == printed["child_tokens"]
    assert len(port.child_tokens) == quickstart.MAX_TOKENS


def test_quickstart_meters_equal_the_references(quick):
    _, exact, port = quick
    assert {k: getattr(port, k) for k in exact} == exact
    assert port.pages_rdma == port.seed_pages


# -- FINRA ---------------------------------------------------------------------

_FINRA_LINE = re.compile(
    r"\[(\w+)\s*\] (\d+) audit rules in .*\| sim\s+([\d.]+) ms \| "
    r"rdma\s+([\d.]+) MiB \| msg\s+([\d.]+) MiB \| violations=(\d+)")


def _ref_finra(transfer):
    """``examples/serve_workflow_finra.py``'s run of one transfer, built
    from the same reference modules with device pools; returns its
    meters and each audit rule's violations and faulted pages."""
    cfg = jget_arch("micro-hello")
    params = jlm.init_params(jax.random.PRNGKey(0), cfg)
    market = np.random.default_rng(0).standard_normal(
        int(MARKET_MB * 2**20 / 4)).astype(np.float32)

    def fetch(inst, ctx):
        if transfer == "message":
            return {"market": market}
        inst.add_tensor("globals/market", jnp.asarray(market))
        return {"rows": market.size}

    def audit(inst, ctx):
        if "msg:fetchData" in ctx:
            data = ctx["msg:fetchData"]["market"]
        else:
            data = np.asarray(inst.ensure_tensor("globals/market"))
        return {"violations": int((np.abs(data) > 3.5).sum()),
                "pages_rdma": inst.stats["pages_rdma"]}

    net = JNetwork()
    coord = JCoord(net, [JNode(f"inv{i}", net, device_pool=True)
                         for i in range(4)])
    coord.register_function(JFunctionDef("finra-fetch", cfg.name,
                                         lambda: params, fetch))
    coord.register_function(JFunctionDef("finra-audit", cfg.name,
                                         lambda: params, audit))
    res = jrun_workflow(coord, jbuild_finra(coord), {}, transfer=transfer,
                        fan_out={"runAuditRule": RULES})
    return {"sim_time_s": net.sim_time,
            "rdma_bytes": net.meter.get("rdma_bytes", 0),
            "msg_bytes": net.meter.get("msg_bytes", 0),
            "violations": [r["violations"] for r in res["runAuditRule"]],
            "audit_pages_rdma": [r["pages_rdma"]
                                 for r in res["runAuditRule"]]}


@pytest.fixture(scope="module")
def finra_runs():
    """(printed reference lines by transfer, exact reference runs, port
    record) at 3 rules and a 0.25 MiB market."""
    argv = ["--rules", str(RULES), "--market-mb", str(MARKET_MB)]
    printed = {m.group(1): m.groups()[1:]
               for m in _FINRA_LINE.finditer(
                   _example_output("serve_workflow_finra", argv))}
    assert sorted(printed) == sorted(finra.TRANSFERS)
    exact = {t: _ref_finra(t) for t in finra.TRANSFERS}
    port = finra.run([*argv, "--device", "cpu"])
    return printed, exact, port


@pytest.mark.parametrize("transfer", finra.TRANSFERS)
def test_finra_prints_the_reference_facts(finra_runs, transfer):
    printed, _, port = finra_runs
    rules, sim_ms, rdma_mib, msg_mib, v = printed[transfer]
    got = port.transfers[transfer]
    assert len(got["violations"]) == int(rules) == RULES
    assert got["violations"] == [int(v)] * RULES
    assert f"{got['sim_time_s'] * 1e3:.2f}" == sim_ms
    assert _mib(got["rdma_bytes"]) == rdma_mib
    assert _mib(got["msg_bytes"]) == msg_mib


@pytest.mark.parametrize("transfer", finra.TRANSFERS)
def test_finra_meters_equal_the_references(finra_runs, transfer):
    _, exact, port = finra_runs
    want, got = exact[transfer], port.transfers[transfer]
    assert abs(got["sim_time_s"] - want["sim_time_s"]) <= 1e-9
    for k in ("rdma_bytes", "msg_bytes", "violations", "audit_pages_rdma"):
        assert got[k] == want[k], k


def test_finra_violations_agree_across_transfers(finra_runs):
    _, _, port = finra_runs
    fork, msg = port.transfers["fork"], port.transfers["message"]
    assert fork["violations"] == msg["violations"]
    market = finra.make_market(MARKET_MB)
    assert fork["violations"][0] == int((np.abs(market) > 3.5).sum()) > 0
    assert fork["msg_bytes"] == 0 and msg["msg_bytes"] > market.nbytes
    # each audit child faulted the market's pages (plus one of prefetch),
    # never the model's
    pages = -(-market.size // PAGE_ELEMS)
    assert all(pages <= p <= pages + 1 for p in fork["audit_pages_rdma"])


def test_chip_smoke_examples_phase_rehearses_on_the_cpu():
    """The card script's examples phase, checks and all, on the CPU at
    the reference examples' sizes (the card run takes gemma3-1b, 8 rules
    and a 6 MB market)."""
    from torch_parity import load_chip_smoke
    smoke = load_chip_smoke()
    cpu = torch.device("cpu")
    q = smoke.quickstart_example(cpu, arch="micro-small")
    assert q["child_tokens"] == q["parent_tokens"]
    assert q["pages_rdma"] == q["seed_pages"] > 0
    f = smoke.finra_example(cpu, arch="micro-hello", market_mb=MARKET_MB,
                            n_rules=RULES)
    assert f["fork"]["violations"] == f["message"]["violations"]
    assert f["market_pages"] == -(-f["market_elems"] // PAGE_ELEMS)
