import dataclasses

import jax
import pytest

from repro.configs.base import get_arch, reduce_for_smoke
from repro.net import Network
from repro.models import lm
from repro.platform.coordinator import Coordinator, FunctionDef
from repro.platform.node import NodeRuntime


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips where there is none)")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture()
def cluster():
    net = Network()
    nodes = [NodeRuntime(f"node{i}", net, page_elems=1024) for i in range(4)]
    return net, nodes


@pytest.fixture()
def platform(hello_cfg, hello_params):
    """A 3-node coordinator cluster on a FakeClock with one function "f"."""
    net = Network()
    clock = FakeClock()
    nodes = [NodeRuntime(f"node{i}", net, page_elems=1024, clock=clock)
             for i in range(3)]
    coord = Coordinator(net, nodes, clock=clock)

    def behavior(inst, ctx):
        inst.ensure_tensor(inst.leaf_names[0])
        return {"ok": True}

    coord.register_function(FunctionDef(
        name="f", arch=hello_cfg.name,
        make_params=lambda: hello_params, behavior=behavior))
    return net, nodes, coord, clock


@pytest.fixture(scope="session")
def smoke_cfg():
    return reduce_for_smoke(get_arch("stablelm-3b"))


@pytest.fixture(scope="session")
def smoke_params(smoke_cfg):
    return lm.init_params(jax.random.PRNGKey(0), smoke_cfg)


@pytest.fixture(scope="session")
def hello_cfg():
    return dataclasses.replace(get_arch("micro-hello"), compute_dtype="float32")


@pytest.fixture(scope="session")
def hello_params(hello_cfg):
    return lm.init_params(jax.random.PRNGKey(0), hello_cfg)
