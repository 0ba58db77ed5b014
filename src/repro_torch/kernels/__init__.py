# Kernel layer: the fault handler's data plane (page_gather / cow_scatter,
# per-page and run-table forms) plus serving decode's paged_attention and
# the MoE layer's routed experts (moe_experts.py).
# Each kernel ships <name>/kernel.py (ctypes launcher of the CUDA source in
# csrc/), ref.py (the plain PyTorch version) and ops.py (public wrapper);
# backend selection, choice meters and launch counts live in dispatch.py,
# the nvcc build in build.py.
from repro_torch.kernels import dispatch  # noqa: F401
