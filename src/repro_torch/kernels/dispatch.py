"""Backend resolution, choice meters and launch counts for the kernel layer.

Every ``ops.py`` wrapper routes its ``backend=`` argument through
:func:`resolve_backend`, so the rules live in ONE place:

``auto``    a CUDA tensor launches the hand-written kernel; a CPU tensor
            takes the plain PyTorch version.
``kernel``  the hand-written kernel; a CPU tensor raises.
``torch``   the plain PyTorch version on any device (tests, and the
            kernel-against-plain comparison on the card).

There is no fallback: a CUDA tensor either launches its kernel or raises.

The chosen implementation is counted as ``kernel.{name}.{cuda|torch}`` in
a module meter that pools drain into ``Network.meter``
(:func:`drain_meters_into`), as in the reference package.  Separately,
each kernel wrapper adds one to :data:`launches` where it launches its
kernel, the pages that launch moved to :data:`pages_moved`, and one to
:data:`routes` under ``{entry}.{route}``: which of the kernel layer's paths
took the call (copies: ``bulk-value``, ``bulk-device`` or ``copy_rows``;
paged_attention: ``tma`` or ``loads``; moe_experts: ``gemv`` or
``tiled``).  These counts are never drained,
so a run can show which kernels and paths the main path went through.
"""
from __future__ import annotations

from collections import Counter

import torch

IMPL_CUDA = "cuda"      # the hand-written kernel (kernels/csrc)
IMPL_TORCH = "torch"    # the plain PyTorch version (ref.py)

BACKENDS = ("auto", "kernel", "torch")

_meter: Counter = Counter()
# since the last reset_launches(): kernel entry point -> launches, -> pages
# moved by them, and "{entry}.{route}" -> launches
launches: Counter = Counter()
pages_moved: Counter = Counter()
routes: Counter = Counter()


def resolve_backend(backend: str, *, kernel_name: str,
                    device: torch.device) -> str:
    """Map a requested ``backend`` on tensors living on ``device`` to an
    impl (``cuda`` | ``torch``), recording the choice in the meter."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} for {kernel_name}; "
                         f"expected one of {BACKENDS}")
    device = torch.device(device)
    if backend == "torch":
        impl = IMPL_TORCH
    elif device.type == "cuda":
        impl = IMPL_CUDA
    elif backend == "kernel" or device.type != "cpu":
        raise RuntimeError(f"{kernel_name}: backend={backend!r} has no kernel "
                           f"for tensors on {device}; the kernels need CUDA")
    else:
        impl = IMPL_TORCH
    _meter[f"kernel.{kernel_name}.{impl}"] += 1
    return impl


def count_launch(entry: str, pages: int = 0, route: str = None) -> None:
    """Called by a kernel wrapper exactly where it launches ``entry``."""
    launches[entry] += 1
    pages_moved[entry] += pages
    if route is not None:
        routes[f"{entry}.{route}"] += 1


def counters() -> tuple:
    """Every count kept here, each a ``Counter``: the choice meter, and
    the launches, pages moved and routes."""
    return _meter, launches, pages_moved, routes


def reset_launches() -> None:
    launches.clear()
    pages_moved.clear()
    routes.clear()


def record(kernel_name: str, event: str, n: int = 1) -> None:
    """Count a kernel-layer event in the meter (e.g. pages moved by an
    impl), as ``kernel.{name}.{event}``."""
    _meter[f"kernel.{kernel_name}.{event}"] += n


def kernel_meters() -> dict:
    """Snapshot of the kernel meter."""
    return dict(_meter)


def drain_meters_into(meter) -> None:
    """Fold (and clear) the kernel meter into a Counter-like ``meter``."""
    for k, v in _meter.items():
        meter[k] += v
    _meter.clear()


def reset_meters() -> None:
    _meter.clear()
