"""Target GPU constants for roofline analysis and plan estimates.

The counterpart of the JAX package's ``repro/hw/tpu_spec.py`` for an
NVIDIA H100.  These constants feed the three-term roofline of the
dry-run's per-device counts (:mod:`repro_torch.launch.dryrun`) and the
Conduit scheduler's estimates (:mod:`repro_torch.distributed.scheduler`):

  compute term    = flops            / (chips * peak_bf16_flops)
  memory term     = bytes            / (chips * hbm_bw)
  collective term = collective_bytes / (chips * collective_bw)

The collective term uses the network, not NVLink: the production mesh
keeps the JAX package's 16-wide axes, and a 16-wide axis spans two
8-GPU NVLink nodes, so its collectives cross each GPU's NIC.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    name: str = "h100_sxm5"
    # NVIDIA H100 80GB HBM3 (SXM5, 700 W): dense bf16 tensor-core peak
    peak_bf16_flops: float = 989e12      # FLOP/s per GPU
    # NVIDIA H100 80GB HBM3 (SXM5, 700 W): HBM3 bandwidth
    hbm_bw: float = 3.35e12              # bytes/s per GPU
    # NVIDIA H100 80GB HBM3 (SXM5, 700 W): HBM3 capacity
    hbm_bytes: float = 80e9              # bytes per GPU
    # NVIDIA H100 80GB HBM3 (SXM5, 700 W): NVLink 4, each direction
    nvlink_bw: float = 450e9             # bytes/s per GPU, within a node
    # NVIDIA H100 80GB HBM3 (SXM5, 700 W): one 400 Gb/s NDR NIC per GPU
    nic_bw: float = 50e9                 # bytes/s per GPU, between nodes

    @property
    def collective_bw(self) -> float:
        """Per-GPU bandwidth of a collective over a 16-wide mesh axis,
        which leaves the 8-GPU NVLink node: the NIC's."""
        return self.nic_bw

    def roofline_terms(self, flops: float, hbm_bytes: float,
                       collective_bytes: float, chips: int) -> dict:
        """Return the three roofline terms in seconds (per-step)."""
        ct = flops / (chips * self.peak_bf16_flops)
        mt = hbm_bytes / (chips * self.hbm_bw)
        xt = collective_bytes / (chips * self.collective_bw)
        dominant = max((ct, "compute"), (mt, "memory"), (xt, "collective"))[1]
        return {
            "compute_s": ct,
            "memory_s": mt,
            "collective_s": xt,
            "dominant": dominant,
            "bound_s": max(ct, mt, xt),
        }


H100 = GPUSpec()
