"""Container descriptor (§5.1): metadata-only capture of an instance.

The descriptor holds the page tables (not the pages!), "registers" (step
counter, RNG key, tiny recurrent states), the pytree layout, DC keys and
the ancestry chain.  Serialized as msgpack; KB-sized for GB-sized
instances — the paper's orders-of-magnitude win over checkpoint files.

The encoder below is a stdlib-only writer/reader for the msgpack subset
the descriptor uses (maps, arrays, str, bin, ints, floats, bool, nil, and
ndarrays as ``{b"__nd": True, b"d": ..., b"t": ..., b"s": ...}`` maps).
It produces the bytes ``msgpack.packb(..., use_bin_type=True)`` does:
the blob's length is what a child is charged for the descriptor read.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.core.pagetable import VMA

# ---------------------------------------------------------------------------
# msgpack subset
# ---------------------------------------------------------------------------


def _pack_default(o):
    if isinstance(o, np.ndarray):
        return {b"__nd": True, b"d": o.tobytes(), b"t": o.dtype.str,
                b"s": list(o.shape)}
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    raise TypeError(f"unserializable {type(o)}")


def _pack_int(n: int, out: bytearray) -> None:
    if n < -(1 << 5):
        if n < -(1 << 15):
            if n < -(1 << 31):
                out += b"\xd3" + struct.pack(">q", n)
            else:
                out += b"\xd2" + struct.pack(">i", n)
        elif n < -(1 << 7):
            out += b"\xd1" + struct.pack(">h", n)
        else:
            out += b"\xd0" + struct.pack(">b", n)
    elif n < (1 << 7):
        out += struct.pack(">b", n)          # fixint, positive or negative
    elif n < (1 << 8):
        out += b"\xcc" + struct.pack(">B", n)
    elif n < (1 << 16):
        out += b"\xcd" + struct.pack(">H", n)
    elif n < (1 << 32):
        out += b"\xce" + struct.pack(">I", n)
    else:
        out += b"\xcf" + struct.pack(">Q", n)


def _pack_len(n: int, fix: int, fixmax: int, codes: Tuple[bytes, ...],
              out: bytearray) -> None:
    """Header of a sized container: fix form, then 8/16/32-bit lengths
    (``codes`` lists the 8-bit code first; b"" where a width is absent)."""
    if fix is not None and n <= fixmax:
        out.append(fix | n)
    elif codes[0] and n < (1 << 8):
        out += codes[0] + struct.pack(">B", n)
    elif n < (1 << 16):
        out += codes[1] + struct.pack(">H", n)
    else:
        out += codes[2] + struct.pack(">I", n)


def _pack(o, out: bytearray) -> None:
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif isinstance(o, int):
        _pack_int(int(o), out)
    elif isinstance(o, float):
        out += b"\xcb" + struct.pack(">d", o)
    elif isinstance(o, str):
        b = o.encode("utf-8")
        _pack_len(len(b), 0xA0, 31, (b"\xd9", b"\xda", b"\xdb"), out)
        out += b
    elif isinstance(o, (bytes, bytearray, memoryview)):
        b = bytes(o)
        _pack_len(len(b), None, -1, (b"\xc4", b"\xc5", b"\xc6"), out)
        out += b
    elif isinstance(o, (list, tuple)):
        _pack_len(len(o), 0x90, 15, (b"", b"\xdc", b"\xdd"), out)
        for x in o:
            _pack(x, out)
    elif isinstance(o, dict):
        _pack_len(len(o), 0x80, 15, (b"", b"\xde", b"\xdf"), out)
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    else:
        _pack(_pack_default(o), out)


def packb(o) -> bytes:
    out = bytearray()
    _pack(o, out)
    return bytes(out)


def _unpack_hook(o):
    if b"__nd" in o or "__nd" in o:
        d = o.get(b"d", o.get("d"))
        t = o.get(b"t", o.get("t"))
        s = o.get(b"s", o.get("s"))
        return np.frombuffer(d, np.dtype(t)).reshape(s).copy()
    return o


class _Reader:
    _FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
              0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.i = 0

    def _take(self, n: int) -> bytes:
        b = self.data[self.i:self.i + n]
        if len(b) != n:
            raise ValueError("truncated msgpack blob")
        self.i += n
        return bytes(b)

    def _unpack_fmt(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        c = self._take(1)[0]
        if c <= 0x7F or c >= 0xE0:
            return struct.unpack(">b", bytes([c]))[0] if c >= 0xE0 else c
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self._take(c & 0x1F).decode("utf-8")
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in self._FIXED:
            return self._unpack_fmt(self._FIXED[c])
        if c in (0xC4, 0xC5, 0xC6):
            n = self._unpack_fmt({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[c])
            return self._take(n)
        if c in (0xD9, 0xDA, 0xDB):
            n = self._unpack_fmt({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[c])
            return self._take(n).decode("utf-8")
        if c in (0xDC, 0xDD):
            n = self._unpack_fmt(">H" if c == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self._map(self._unpack_fmt(">H" if c == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def _map(self, n: int):
        d = {}
        for _ in range(n):
            k = self.read()
            d[k] = self.read()
        return _unpack_hook(d)


def unpackb(data: bytes):
    r = _Reader(data)
    o = r.read()
    if r.i != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return o


@dataclasses.dataclass
class Descriptor:
    arch: str                           # config name
    kind: str                           # "weights" | "kv" | "full"
    parent_node: str                    # RDMA address of the parent machine
    handler_id: int
    ancestry: List[str]                 # hop h reads from ancestry[h-1]
    leaf_paths: List[List[Any]]         # pytree paths, in leaf order
    vmas: List[dict]                    # VMA.table_dict() per leaf
    registers: Dict[str, Any]           # step, rng, inline small state
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # per-VMA route plan: vma name -> {"owner", "transport"}.  Children
    # fetch each VMA from its routed owner over its routed fabric; absent
    # = every VMA at parent_node over the default.
    routes: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)

    def to_bytes(self) -> bytes:
        return packb(dataclasses.asdict(self))

    @classmethod
    def from_bytes(cls, data: bytes) -> "Descriptor":
        return cls(**unpackb(data))

    def vma_objects(self) -> List[VMA]:
        return [VMA.from_table_dict(d) for d in self.vmas]

    def route_for(self, name: str) -> Dict[str, Any]:
        """The route of VMA ``name``: explicit entry, else the implicit
        single-parent default (owner = parent_node, default transport)."""
        return self.routes.get(name) or {"owner": self.parent_node,
                                         "transport": None}

    @property
    def nbytes(self) -> int:
        return len(self.to_bytes())


# ---------------------------------------------------------------------------
# pytree <-> (paths, leaves)
# ---------------------------------------------------------------------------


def _flatten(tree, path, paths, leaves) -> None:
    if tree is None:                  # an empty subtree, as in jax
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], path + [k], paths, leaves)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            _flatten(x, path + [i], paths, leaves)
    else:
        paths.append(path)
        leaves.append(tree)


def flatten_with_names(tree) -> Tuple[List[str], List[List[Any]], List[Any]]:
    """Returns (names, paths, leaves). Paths are [key_or_index, ...]: dict
    keys in sorted order, list/tuple indices in order — the leaf order and
    names ``jax.tree_util.tree_flatten_with_path`` gives for nested
    dicts and lists."""
    paths: List[List[Any]] = []
    leaves: List[Any] = []
    _flatten(tree, [], paths, leaves)
    names = ["/".join(str(p) for p in path) for path in paths]
    return names, paths, leaves


def unflatten_from_paths(paths: List[List[Any]], leaves: List[Any]):
    """Rebuild nested dict/list pytrees from paths."""
    root: Any = None

    def ensure_container(container, key, next_key):
        want_list = isinstance(next_key, int)
        if isinstance(container, dict):
            if key not in container:
                container[key] = [] if want_list else {}
            return container[key]
        assert isinstance(container, list)
        while len(container) <= key:
            container.append(None)
        if container[key] is None:
            container[key] = [] if want_list else {}
        return container[key]

    for path, leaf in zip(paths, leaves):
        if not path:                 # the whole tree is a single leaf
            return leaf
        if root is None:
            root = [] if isinstance(path[0], int) else {}
        node = root
        for i, key in enumerate(path[:-1]):
            node = ensure_container(node, key, path[i + 1])
        last = path[-1]
        if isinstance(node, list):
            while len(node) <= last:
                node.append(None)
            node[last] = leaf
        else:
            node[last] = leaf
    return root
