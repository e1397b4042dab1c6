"""Hardware model: the simulated SSD (paper Table 2)."""
from repro_torch.hw.ssd_spec import DEFAULT_SSD, SSDSpec

__all__ = ["SSDSpec", "DEFAULT_SSD"]
