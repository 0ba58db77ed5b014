"""Three-term roofline model for one NVIDIA H100 SXM5 80 GB per chip, the
port's counterpart of the reference's v5e roofline
(``src/repro/distributed/roofline.py``): the same terms and formulas,
the H100's constants.

  compute    = FLOPs      / (chips * PEAK_FLOPS)
  memory     = bytes      / (chips * HBM_BW)
  collective = coll_bytes / (chips * LINK_BW)

FLOPs and bytes are normalized to GLOBAL (all-chip) quantities before the
formulas apply; the dry run (``launch/dryrun.py``) records the per-device
counts it multiplied.

Constants, from NVIDIA's H100 Tensor Core GPU datasheet (SXM5 part):

- ``PEAK_FLOPS``: 989 TFLOP/s, dense BF16 on the tensor cores (no
  sparsity), at the card's 700 W power limit;
- ``HBM_BW``: 3.35 TB/s of HBM3;
- ``HBM_PER_CHIP``: the 80 GB of HBM3 as CUDA reports them on the H100
  80GB HBM3 (``torch.cuda.get_device_properties(0).total_memory``):
  81,079 MiB, 1.0% less than the datasheet's 80 GiB, which the driver
  does not hand out.  ``chip_smoke.py`` checks it against the card's,
  within 1%;
- ``LINK_BW``: 50 GB/s per GPU, one InfiniBand NDR port (400 Gb/s) per
  GPU.  On the 16x16 and 2x16x16 production meshes, with 8 GPUs to a
  node, a ``model`` group (the fastest axis) is 16 consecutive GPUs on
  two nodes, and a ``data`` or ``pod`` group strides over nodes, one GPU
  on each: every group spans nodes, so every collective crosses the
  inter-node links.  NVLink's 450 GB/s per direction within a node
  bounds no group of these meshes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12          # dense bf16 / chip
HBM_BW = 3.35e12             # bytes/s / chip
LINK_BW = 50e9               # bytes/s / GPU, one NDR port
HBM_PER_CHIP = 81079 * 1024**2  # H100 80GB HBM3, as CUDA reports it


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_global: float
    bytes_global: float
    coll_bytes_global: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_lb(self) -> float:
        """Lower bound on step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def fraction_of_roofline(self, model_flops: float) -> float:
        """Useful-FLOPs throughput achievable at the bound, as a fraction of
        peak: (model_flops / step_time_lb) / (chips * peak)."""
        if self.step_time_lb == 0:
            return 0.0
        return (model_flops / self.step_time_lb) / (self.chips * PEAK_FLOPS)

    def to_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_global": self.flops_global, "bytes_global": self.bytes_global,
            "coll_bytes_global": self.coll_bytes_global, "chips": self.chips,
        }


def roofline(flops_global: float, bytes_global: float,
             coll_bytes_global: float, chips: int) -> Roofline:
    return Roofline(
        compute_s=flops_global / (chips * PEAK_FLOPS),
        memory_s=bytes_global / (chips * HBM_BW),
        collective_s=coll_bytes_global / (chips * LINK_BW),
        flops_global=flops_global,
        bytes_global=bytes_global,
        coll_bytes_global=coll_bytes_global,
        chips=chips,
    )
