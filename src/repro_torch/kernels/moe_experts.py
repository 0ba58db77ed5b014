"""The routed experts of a mixture-of-experts layer: the wrapper, its plain
PyTorch version and the launcher of ``csrc/moe_experts.cu``.

It replaces no TPU kernel (the JAX package's MoE is jnp code over an (E,
C, D) dispatch buffer).  ``models/moe.py`` calls it where no token can
drop: the routed rows, sorted by expert, each computed once against its
expert's weights only.  The launch shape is planned from host ints alone
(:func:`plan`), so a call never reads the device and a CUDA graph captures
it as it is.  One call is one count in ``dispatch``, under the route
``gemv`` (up to ~128 rows an expert: at decode bound by the chosen
experts' weight bytes) or ``tiled`` (longer prefills: bound by the routed
flops).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.paged_attention.kernel import sm_count

_P, _I = ctypes.c_void_p, ctypes.c_int
GEMV_ROWS = 8        # csrc: kGemvRows, rows of a gemv tile
GEMV_COLS = 512      # csrc: kGemvCols, columns of a gemv block
GEMV_TILES = 16      # gemv up to this many of its tiles an expert, on average
UNROLL = 8           # csrc: kUnroll, a split's reduction rounds up to it
MIN_CHUNK = 64       # fewest reduction rows a gemv split takes
MAX_CHUNK = 1536     # most: its rows staged in 48 KB of shared memory
BLOCKS_PER_SM = 8    # the gemv grid's aim
TILE_ROWS = 64       # csrc: kTileRows, rows of a tiled tile
TILED_COLS = 128     # csrc: kBN, columns of a tiled block
SLAB = 8             # csrc: kBK, a tiled split's reduction rounds up to it
TILED_SLOTS = 32     # the tiled grid's aim an SM: 8 waves of 4 blocks
MAX_SPLITS = 4       # most splits of a tiled pass


@dataclasses.dataclass(frozen=True)
class Plan:
    """A call's launch shape: the route, the rows of a tile ``bm``, the
    grid's bound on tiles, each pass's reduction rows a split and splits
    (the up pass reduces over D, the down pass over Fd), and the workspace
    in floats."""

    route: str
    bm: int
    tiles: int
    up_chunk: int
    up_splits: int
    dn_chunk: int
    dn_splits: int
    ws_floats: int


def _split(K: int, N: int, experts: int, sms: int) -> tuple:
    """(rows a split, splits) of a gemv pass reducing over ``K`` into ``N``
    columns for ``experts`` busy experts: enough splits that the grid holds
    about BLOCKS_PER_SM blocks an SM, none shorter than MIN_CHUNK rows or
    longer than MAX_CHUNK, and none empty."""
    blocks = experts * -(-N // GEMV_COLS)
    want = max(1, min(-(-BLOCKS_PER_SM * sms // blocks), -(-K // MIN_CHUNK)))
    chunk = -(-K // want)
    chunk = min(MAX_CHUNK, -(-chunk // UNROLL) * UNROLL)
    return chunk, -(-K // chunk)


def _tiled_split(TK: int, K: int, N: int, sms: int) -> tuple:
    """(rows a split, splits) of a tiled pass reducing over ``K`` into ``N``
    columns for ``TK`` rows: split (up to MAX_SPLITS) where the grid's
    tiles would fill fewer than TILED_SLOTS blocks an SM."""
    blocks = -(-TK // TILE_ROWS) * -(-N // TILED_COLS)
    want = max(1, min(MAX_SPLITS, TILED_SLOTS * sms // blocks))
    chunk = -(-K // want)
    chunk = -(-chunk // SLAB) * SLAB
    return chunk, -(-K // chunk)


def plan(TK: int, E: int, D: int, Fd: int, gated: bool, sms: int) -> Plan:
    """The launch shape of ``TK`` routed rows over ``E`` experts of widths
    ``D`` and ``Fd``: ``gemv`` where the rows average at most GEMV_TILES
    gemv tiles an expert (``TK <= 128 E``; the tiles of one expert read its
    weights through L2 together), else ``tiled``."""
    n_up = 2 * Fd if gated else Fd
    busy = min(E, TK)
    if TK <= GEMV_ROWS * GEMV_TILES * E:
        route, bm = "gemv", GEMV_ROWS
        up = _split(D, n_up, busy, sms)
        dn = _split(Fd, D, busy, sms)
    else:
        route, bm = "tiled", TILE_ROWS
        up = _tiled_split(TK, D, n_up, sms)
        dn = _tiled_split(TK, Fd, D, sms)
    tiles = -(-TK // bm) + busy
    ws = (4 * tiles + up[1] * TK * n_up + TK * Fd
          + (dn[1] * TK * D if dn[1] > 1 else 0))
    return Plan(route, bm, tiles, *up, *dn, ws)


def moe_experts_ref(h, counts, starts, wi, wg, wd):
    """h (TK, D), rows sorted by expert; counts, starts (E,) the rows of
    each expert; wi, wg (E, D, F) (``wg`` None: not gated), wd (E, F, D)
    -> (TK, D) in h's order: each expert's rows through its gated SiLU MLP
    (GELU, tanh form, where not gated).  Reads ``counts`` on the host."""
    y = h.new_zeros(h.shape)
    for e, (s, n) in enumerate(zip(starts.tolist(), counts.tolist())):
        if n == 0:
            continue
        r = h[s:s + n]
        a = r @ wi[e]
        if wg is not None:
            a = F.silu(r @ wg[e]) * a
        else:
            a = F.gelu(a, approximate="tanh")   # jax.nn.gelu's default
        y[s:s + n] = a @ wd[e]
    return y


def expert_bytes(counts, D: int, Fd: int, gated: bool) -> int:
    """Bytes one call needs from and to device memory, from host
    ``counts``: each chosen expert's weights read once, the rows read and
    the outputs written, fp32."""
    counts = [int(n) for n in counts]
    experts = sum(n > 0 for n in counts)
    return 4 * (experts * (3 if gated else 2) * D * Fd
                + 2 * sum(counts) * D)


def expert_flops(TK: int, D: int, Fd: int, gated: bool) -> int:
    """The routed rows' flops: the up and down products."""
    return 2 * TK * D * Fd * (3 if gated else 2)


def _launch(h, counts, starts, wi, wg, wd):
    TK, D = h.shape
    E, _, Fd = wi.shape
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"moe_experts kernel needs CUDA tensors, got {dev}")
    weights = (wi, wd) if wg is None else (wi, wg, wd)
    for t in (h,) + weights:
        if (t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("moe_experts kernel takes contiguous, 16-byte "
                             "aligned float32 tensors on one device")
    if (tuple(wi.shape) != (E, D, Fd) or tuple(wd.shape) != (E, Fd, D)
            or (wg is not None and wg.shape != wi.shape)):
        raise ValueError(f"weights must be (E, D, F) and (E, F, D), got "
                         f"{[tuple(w.shape) for w in weights]} for D={D}")
    if D % 4 or Fd % 4 or TK < 1:
        raise ValueError(f"kernel supports widths of a multiple of 4 and at "
                         f"least one row, got D={D} F={Fd} rows={TK}")
    for t in (counts, starts):
        if (t.dtype != torch.int64 or t.device != dev
                or tuple(t.shape) != (E,) or not t.is_contiguous()):
            raise ValueError(f"counts and starts must be contiguous int64 "
                             f"({E},) on {dev}")
    p = plan(TK, E, D, Fd, wg is not None, sm_count(dev))
    y = torch.empty((TK, D), dtype=torch.float32, device=dev)
    ws = torch.empty(p.ws_floats, dtype=torch.float32, device=dev)
    fn = build.function("moe_experts", "moe_experts", [_P] * 8 + [_I] * 11
                        + [_P])
    dispatch.count_launch("moe_experts", route=p.route)
    err = fn(h.data_ptr(), counts.data_ptr(), starts.data_ptr(),
             wi.data_ptr(), None if wg is None else wg.data_ptr(),
             wd.data_ptr(), y.data_ptr(), ws.data_ptr(), TK, E, D, Fd,
             int(p.route == "tiled"), p.bm, p.tiles, p.up_chunk,
             p.up_splits, p.dn_chunk, p.dn_splits, build.stream(dev))
    build.check(err, "moe_experts")
    return y


def moe_experts(h, counts, starts, wi, wg, wd, *, backend: str = "auto"):
    """The routed rows ``h`` (TK, D), sorted by expert with ``counts`` and
    ``starts`` (E,) int64, through their experts' MLPs ``wi``, ``wg`` (E,
    D, F; ``wg`` None where not gated) and ``wd`` (E, F, D): (TK, D) in
    h's order; the kernel on CUDA tensors, the plain version on CPU ones
    (``backend`` as ``dispatch.resolve_backend`` takes it)."""
    impl = dispatch.resolve_backend(backend, kernel_name="moe_experts",
                                    device=h.device)
    if impl == dispatch.IMPL_TORCH:
        return moe_experts_ref(h, counts, starts, wi, wg, wd)
    return _launch(h.contiguous(), counts.contiguous(), starts.contiguous(),
                   wi.contiguous(), None if wg is None else wg.contiguous(),
                   wd.contiguous())
