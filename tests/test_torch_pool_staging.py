"""A device pool's wire payload, staged through host memory by
``PagePool.read_pages_host`` and uploaded again by ``write_pages``.

On the CPU (host pools and pools on the CPU device, fp32 and bf16): the
payload holds the frames' bytes in the storage dtype, ``out`` is
honoured, two reads hand out arrays that do not alias, nothing is staged
through page-locked memory (``pinned.*`` reads 0) and ``stage.*`` counts
what it counted before; a two-node fork keeps its wire meters and the
sanitizer's payload tag.  On a CUDA card (the ``card`` case, skipped
without one): the payload is page-locked host memory, bit-equal to the
frames and not changed by a later read, and a fork stages every byte
through it."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._pytree import tree_map  # noqa: E402

from repro_torch import _dtypes, tracing  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core.instance import ModelInstance  # noqa: E402
from repro_torch.fork import ForkPolicy  # noqa: E402
from repro_torch.memory.pool import PagePool  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.net import Network  # noqa: E402
from repro_torch.platform.node import NodeRuntime  # noqa: E402

PAGE_ELEMS = 64
FRAMES = 16
FORK_PAGE_ELEMS = 1024
FORK_PAGE_BYTES = FORK_PAGE_ELEMS * 4          # micro-hello is fp32
CFG = dataclasses.replace(get_arch("micro-hello"), compute_dtype="float32",
                          param_dtype="float32")
POOLS = pytest.mark.parametrize("device", [None, "cpu"],
                                ids=["host", "cpu-device"])
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])


def load_chip_smoke():
    """``chip_smoke.py`` from the checkout root, as a module.  This file
    imports no JAX (``torch_parity`` does), so that its card cases run on
    the card's machine: ``pytest --noconftest -m card`` on this file."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def tracer():
    tracing.reset()
    tracing.enable()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def filled_pool(device, dtype, seed=0):
    """A pool of ``FRAMES`` frames of ``dtype`` and the pages written into
    them, as a host tensor (frame i holds row i)."""
    pool = PagePool(page_elems=PAGE_ELEMS, initial_frames=FRAMES,
                    device=device)
    frames = pool.alloc(dtype, FRAMES)
    assert frames.tolist() == sorted(frames.tolist())
    rows = torch.randn(FRAMES, PAGE_ELEMS, generator=torch.Generator()
                       .manual_seed(seed)).to(_dtypes.torch_dtype(dtype))
    pool.write_pages(dtype, frames, rows if device is None
                     else rows.to(device))
    return pool, frames, rows


def want(rows, idx):
    return _dtypes.to_numpy(rows[torch.as_tensor(idx, dtype=torch.long)])


def counters(prefix):
    return {k: v for k, v in tracing.snapshot()["counters"].items()
            if k.startswith(prefix)}


# the gathers' two shapes: scattered ids, and runs long enough to coalesce
READS = [[3, 1, 2, 7], list(range(4, 12)) + [0]]


@POOLS
@DTYPES
@pytest.mark.parametrize("order", READS, ids=["scattered", "runs"])
def test_read_pages_host_gives_the_frames_bytes(device, dtype, order):
    pool, frames, rows = filled_pool(device, dtype)
    idx = frames[order]
    got = pool.read_pages_host(dtype, idx)
    assert isinstance(got, np.ndarray)
    assert got.dtype == _dtypes.numpy_dtype(dtype)
    assert got.shape == (len(order), PAGE_ELEMS)
    assert got.tobytes() == want(rows, order).tobytes()


@POOLS
@DTYPES
def test_read_pages_host_fills_out_in_place(device, dtype):
    pool, frames, rows = filled_pool(device, dtype)
    out = np.full((3, PAGE_ELEMS), 7, _dtypes.numpy_dtype(dtype))
    got = pool.read_pages_host(dtype, frames[[5, 0, 9]], out=out)
    assert got is out
    assert out.tobytes() == want(rows, [5, 0, 9]).tobytes()


@POOLS
@DTYPES
def test_back_to_back_reads_do_not_alias(device, dtype):
    """Each read is its own array: a caller may keep or change one (the
    swap-out path keeps its rows) and no later read or write of the pool
    reaches it."""
    pool, frames, rows = filled_pool(device, dtype)
    a = pool.read_pages_host(dtype, frames[:4])
    b = pool.read_pages_host(dtype, frames[:4])
    assert not np.shares_memory(a, b)
    first = a.tobytes()
    b[...] = 0
    assert a.tobytes() == first
    fresh = torch.zeros(4, PAGE_ELEMS, dtype=_dtypes.torch_dtype(dtype))
    pool.write_pages(dtype, frames[:4], fresh if device is None
                     else fresh.to(device))
    c = pool.read_pages_host(dtype, frames[:4])
    assert a.tobytes() == first and not c.any()


@POOLS
@DTYPES
def test_staging_counters_off_the_card(device, dtype):
    """``stage.*`` counts a device pool's bytes through the host as before
    (a host pool stages nothing); ``pinned.*`` reads 0 off the card."""
    pool, frames, rows = filled_pool(device, dtype)
    tracing.reset()
    payload = pool.read_pages_host(dtype, frames[:5])
    pool.read_pages_host(dtype, frames[5:7], site="cache")
    pool.read_pages_host(dtype, frames[7:8],
                         out=np.empty((1, PAGE_ELEMS),
                                      _dtypes.numpy_dtype(dtype)))
    pool.write_pages(dtype, frames[8:13], payload)
    page = PAGE_ELEMS * _dtypes.itemsize(dtype)
    staged = {"stage.dtoh_bytes.wire": 6 * page,
              "stage.dtoh_bytes.cache": 2 * page,
              "stage.htod_bytes": 5 * page} if device else {}
    assert counters("stage.") == staged
    assert counters("pinned.") == {}


def fork(device, sanitize=False):
    """A micro-hello seed on node0 forked lazily onto node1 and
    materialized; returns the network, the child and its tree."""
    w = lm.init_params(CFG, torch.Generator().manual_seed(5), device="cpu")
    if device is not None:
        w = tree_map(lambda t: t.to(device), w)
    net = Network(sanitize=sanitize)
    nodes = [NodeRuntime(f"node{i}", net, page_elems=FORK_PAGE_ELEMS,
                         device_pool=device is not None, device=device)
             for i in range(2)]
    handle = nodes[0].prepare_fork(ModelInstance.create(nodes[0], CFG.name,
                                                        w))
    child = handle.resume_on(nodes[1], ForkPolicy(lazy=True, prefetch=1))
    return net, child, child.materialize_pytree(), w


def wire(meter):
    """The network's meters but the pools' own (data-plane route counts,
    which differ between a host pool and a device pool by design)."""
    return {k: v for k, v in meter.items()
            if not k.startswith(("pool.", "kernel."))}


def test_fork_keeps_wire_meters_and_payload_tags():
    """A fork from a CPU-device pool charges the wire exactly as one from
    a host pool, and every payload the wire tagged reaches the adopter's
    ``write_pages`` whole (the sanitizer's conservation check)."""
    runs = {}
    for device in (None, "cpu"):
        tracing.reset()
        net, child, _, _ = fork(device, sanitize=True)
        stats = net.sanitizer.stats()
        runs[device] = (dict(net.meter), net.sim_time, stats["checks"],
                        dict(child.stats), counters(""))
        assert stats["pending_payloads"] == 0
    (m_host, t_host, checks_host, st_host, c_host), \
        (m_dev, t_dev, checks_dev, st_dev, c_dev) = runs[None], runs["cpu"]
    assert wire(m_dev) == wire(m_host) and t_dev == t_host
    assert st_dev == st_host
    assert checks_dev == checks_host > 0
    assert c_dev["stage.htod_bytes"] == c_dev["stage.dtoh_bytes.wire"] \
        == st_dev["pages_rdma"] * FORK_PAGE_BYTES > 0
    assert not [k for k in c_host if k.startswith("stage.")]
    assert not [k for k in c_dev if k.startswith("pinned.")]


def test_chip_smoke_pinned_staging_rehearses_on_the_cpu():
    """The card script's pinned-staging check, assertions and all, on the
    CPU at micro-hello size: two bit-equal forks, every byte staged
    through the host once each way, none of it page-locked (0% off the
    card, where the check asks 100%)."""
    line = load_chip_smoke().pinned_staging(torch, torch.device("cpu"),
                                            arch="micro-hello")
    assert [f["node"] for f in line["forks"]] == ["node1", "node2"]
    for f in line["forks"]:
        assert f["pinned_pct"] == 0.0
        assert f["dtoh_bytes"] == f["htod_bytes"] >= line["seed_bytes"] > 0


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_payload_is_page_locked_and_its_own(cuda, dtype):
    pool, frames, rows = filled_pool(cuda, dtype)
    tracing.reset()
    a = pool.read_pages_host(dtype, frames[:6])
    assert torch.from_numpy(a).is_pinned()
    assert a.dtype == _dtypes.numpy_dtype(dtype)
    assert a.tobytes() == want(rows, range(6)).tobytes()
    first = a.tobytes()
    pool.write_pages(dtype, frames[:6], torch.zeros(
        6, PAGE_ELEMS, dtype=_dtypes.torch_dtype(dtype), device=cuda))
    b = pool.read_pages_host(dtype, frames[:6])
    assert not np.shares_memory(a, b) and not b.any()
    assert a.tobytes() == first
    pool.write_pages(dtype, frames[6:12], a)
    assert pool.read_pages_host(dtype, frames[6:12]).tobytes() == first
    out = np.empty((2, PAGE_ELEMS), _dtypes.numpy_dtype(dtype))
    pool.read_pages_host(dtype, frames[6:8], out=out)   # the caller's buffer
    page = PAGE_ELEMS * _dtypes.itemsize(dtype)
    assert counters("pinned.") == {"pinned.dtoh_bytes": 18 * page,
                                   "pinned.htod_bytes": 6 * page}
    assert counters("stage.") == {"stage.dtoh_bytes.wire": 20 * page,
                                  "stage.htod_bytes": 6 * page}


@pytest.mark.card
def test_cuda_fork_stages_every_byte_page_locked(cuda):
    net, child, tree, w = fork(cuda)
    c = counters("")
    assert c["pinned.dtoh_bytes"] == c["stage.dtoh_bytes.wire"] \
        == c["pinned.htod_bytes"] == c["stage.htod_bytes"] \
        == child.stats["pages_rdma"] * FORK_PAGE_BYTES > 0
    load_chip_smoke().same_leaves(torch, tree, w, "the child")
