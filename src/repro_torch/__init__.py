"""PyTorch/CUDA port of the MITOSIS reproduction in ``repro``.

Same layout and names as the reference package; imports torch, numpy and
the standard library only.  Kernels are hand-written CUDA for Hopper
(``kernels/csrc``), built with nvcc at first use.
"""
