"""Hardware models: the simulated SSD (paper Table 2) and the H100 that
the distributed planner targets."""
from repro_torch.hw.gpu_spec import H100, GPUSpec
from repro_torch.hw.ssd_spec import DEFAULT_SSD, SSDSpec

__all__ = ["SSDSpec", "DEFAULT_SSD", "GPUSpec", "H100"]
