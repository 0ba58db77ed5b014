"""The port's page pool, descriptor encoding and pytree flattening against
the reference package: same frames byte for byte, same allocation, same
descriptor blob, same leaf names and paths."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import descriptor as jdesc  # noqa: E402
from repro.core.instance import ModelInstance as JInstance  # noqa: E402
from repro.memory import pool as jpool  # noqa: E402
from repro.memory.paging import to_pages as jto_pages  # noqa: E402
from repro.net import Network as JNetwork  # noqa: E402
from repro.platform.node import NodeRuntime as JNode  # noqa: E402

from repro_torch import _dtypes  # noqa: E402
from repro_torch.core import descriptor as desc  # noqa: E402
from repro_torch.core.instance import ModelInstance  # noqa: E402
from repro_torch.memory import pool as tpool  # noqa: E402
from repro_torch.memory.paging import to_pages  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.net import Network  # noqa: E402
from repro_torch.platform.node import NodeRuntime  # noqa: E402


def _np_params(params):
    return jax.tree.map(np.asarray, params)


def _leaves(rng):
    """A pytree of mixed sizes and dtypes (multi-page, single-page, bf16,
    int) in the reference's leaf order."""
    return {
        "a": rng.standard_normal((5, 300)).astype(np.float32),
        "b": {"w": rng.standard_normal((2100,)).astype(np.float32),
              "i": rng.integers(0, 9, (7, 3)).astype(np.int32)},
        "c": [rng.standard_normal((1,)).astype(np.float32),
              rng.standard_normal((40, 64)).astype(np.float32)],
        "h": rng.standard_normal((3, 500)).astype(np.float32),
    }


def _frames_bits(pool, dt):
    a = pool._frames[dt]
    if isinstance(a, torch.Tensor):
        return _dtypes.to_numpy(a)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("device_pool", [False, True])
def test_pool_pack_matches_reference(device_pool):
    rng = np.random.default_rng(0)
    tree = _leaves(rng)
    bf = rng.standard_normal((2, 700)).astype(np.float32)
    jp = jpool.PagePool(page_elems=1024, device=device_pool)
    tp = tpool.PagePool(page_elems=1024,
                        device="cpu" if device_pool else None)
    jnames, _, jl = jdesc.flatten_with_names(tree)
    names, _, tl = desc.flatten_with_names(tree)
    assert names == jnames
    items = [(n, a, a.dtype.name) for n, a in zip(names, tl)]
    items.append(("bf", bf, "bfloat16"))
    for name, a, dt in items:
        jleaf = jnp.asarray(a).astype(dt)
        tleaf = torch.from_numpy(a).to(_dtypes.torch_dtype(dt))
        jpages = jto_pages(jleaf, 1024)
        tpages = to_pages(tleaf, 1024)
        jf = jp.alloc(dt, jpages.shape[0])
        tf = tp.alloc(dt, tpages.shape[0])
        np.testing.assert_array_equal(tf, jf, err_msg=name)
        jp.write_pages(dt, jf, jpages)
        tp.write_pages(dt, tf, tpages)
    for dt in ("float32", "int32", "bfloat16"):
        np.testing.assert_array_equal(_frames_bits(tp, dt),
                                      _frames_bits(jp, dt))
        assert tp.num_allocated(dt) == jp.num_allocated(dt)
        assert tp.free_extents(dt) == jp.free_extents(dt)
        # reads: local gather, host wire payload, fused assembly
        ids = np.array([3, 0, 1, 2], np.int32)[:jp.num_allocated(dt)]
        np.testing.assert_array_equal(
            _dtypes.to_numpy(tp.read_pages(dt, ids)),
            _frames_bits(jp, dt)[ids])
        host = tp.read_pages_host(dt, ids)
        assert isinstance(host, np.ndarray)
        assert host.dtype.itemsize == _dtypes.itemsize(dt)
    assert tp.bytes_allocated() == jp.bytes_allocated()
    assert tp.bytes_reserved() == jp.bytes_reserved()
    shape = tree["b"]["w"].shape
    frames = np.arange(3) + 5                      # where "b/w" was packed
    np.testing.assert_array_equal(
        tp.assemble("float32", frames, shape).numpy(),
        np.asarray(jp.assemble("float32", frames, shape)))


def test_pool_free_and_fragmented_alloc_match_reference():
    jp = jpool.PagePool(page_elems=128, grow_frames=8)
    tp = tpool.PagePool(page_elems=128, grow_frames=8)
    for pool in (jp, tp):
        a = pool.alloc("float32", 6)
        pool.alloc("float32", 1)
        pool.free("float32", a[[1, 3, 4]])
    np.testing.assert_array_equal(tp.alloc("float32", 4),
                                  jp.alloc("float32", 4))
    assert tp.free_extents("float32") == jp.free_extents("float32")


def test_frame_runs_matches_reference():
    rng = np.random.default_rng(5)
    for _ in range(30):
        ids = rng.integers(0, 40, int(rng.integers(0, 20)))
        if rng.random() < 0.5:
            ids = np.sort(ids)
        for a, b in zip(tpool.frame_runs(ids), jpool.frame_runs(ids)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_write_rows_matches_reference():
    for device_pool in (False, True):
        jp = jpool.PagePool(page_elems=64, device=device_pool)
        tp = tpool.PagePool(page_elems=64,
                            device="cpu" if device_pool else None)
        jf, tf = jp.alloc("float32", 3), tp.alloc("float32", 3)
        rows = np.arange(32, dtype=np.float32).reshape(2, 16)
        jp.write_rows("float32", jf[[2, 0]], [1, 3], jnp.asarray(rows), 16)
        tp.write_rows("float32", tf[[2, 0]], [1, 3], torch.from_numpy(rows),
                      16)
        np.testing.assert_array_equal(_frames_bits(tp, "float32"),
                                      _frames_bits(jp, "float32"))


# -- descriptor ------------------------------------------------------------------


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**63 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.0, 1.5, -2.25e300, float("inf"), "", "a" * 31,
    "b" * 32, "c" * 255, "d" * 256, "é" * 40000, b"", b"x" * 255,
    b"y" * 256, b"z" * 70000, [], list(range(15)), list(range(16)),
    list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {1: "int key", "n": [None, {"x": b"y"}]},
    (1, 2), np.arange(6, dtype=np.int32).reshape(2, 3), np.int64(7),
    np.float64(0.1), np.float32(0.5), {"arr": np.zeros(3, np.uint8)},
])
def test_msgpack_subset_is_byte_identical(obj):
    want = msgpack.packb(obj, default=jdesc._pack_default, use_bin_type=True)
    assert desc.packb(obj) == want
    back = desc.unpackb(want)
    ref = msgpack.unpackb(want, object_hook=jdesc._unpack_hook, raw=False,
                          strict_map_key=False)
    if isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(back, ref)
    elif isinstance(ref, dict) and "arr" in ref:
        np.testing.assert_array_equal(back["arr"], ref["arr"])
    else:
        assert back == ref


def test_flatten_with_names_matches_reference(hello_params):
    tree = {"z": [1.0, None, {"b": 2.0, "a": [3.0, 4.0]}], "a": 5.0,
            "m": {"q": (6.0, 7.0)}}
    for t in (tree, _np_params(hello_params)):
        jn, jp, jl = jdesc.flatten_with_names(t)
        n, p, l = desc.flatten_with_names(t)
        assert n == jn and p == jp
        assert all(a is b for a, b in zip(l, jl))
        rebuilt = desc.unflatten_from_paths(p, l)
        assert desc.flatten_with_names(rebuilt)[0] == n


def test_descriptor_blob_matches_reference(hello_cfg, hello_params):
    jnet, net = JNetwork(), Network()
    jnode = JNode("node0", jnet, page_elems=1024)
    node = NodeRuntime("node0", net, page_elems=1024)
    jinst = JInstance.create(jnode, hello_cfg.name, hello_params)
    inst = ModelInstance.create(
        node, hello_cfg.name,
        params_from_numpy(_np_params(hello_params), "cpu"))
    jh = jnode.prepare_fork(jinst)
    h = node.prepare_fork(inst)
    jblob = jnode.seeds[jh.handler_id].blob
    blob = node.seeds[h.handler_id].blob
    assert blob == jblob
    d = desc.Descriptor.from_bytes(blob)
    jd = jdesc.Descriptor.from_bytes(jblob)
    assert dataclasses.asdict(d) == dataclasses.asdict(jd)
    assert d.to_bytes() == blob
    assert [v["dtype"] for v in d.vmas] == [v["dtype"] for v in jd.vmas]
    assert {v["dtype"] for v in d.vmas} == {"float32"}
