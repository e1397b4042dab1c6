"""Simulated SSD hardware parameters.

Faithful transcription of the paper's Table 2 ("Evaluated Configurations")
plus the latency/energy constants quoted in §4.5 and §5.2.  All latencies in
nanoseconds, all energies in nanojoules, all sizes in bytes unless noted.

The SSD modeled is a 2 TB 48-WL-layer 3D TLC NAND SSD (Samsung 980 Pro
class) with computation capability retrofitted per Flash-Cosmos [10],
Ares-Flash [201], MIMDRAM [26] and ARM Cortex-R8 ISP cores [216].
"""
from __future__ import annotations

import dataclasses

KiB = 1024
MiB = 1024 * KiB
GiB = 1024 * MiB

US = 1_000.0  # ns per microsecond
MS = 1_000_000.0


@dataclasses.dataclass(frozen=True)
class FlashSpec:
    """NAND geometry + timing (Table 2) and IFP compute primitives."""

    channels: int = 8
    dies_per_channel: int = 8
    planes_per_die: int = 2
    blocks_per_plane: int = 2048
    wls_per_block: int = 196          # 4 x 48 WL layers
    page_size: int = 16 * KiB         # NDP page == vector width (§4.3.1)
    # §4.3.1: -force-vector-width=4096 with 32-bit operands = 16 KiB, sized
    # to the NAND page so one vector operand == one logical page.  After the
    # INT8 quantization (§5.4) a page holds 16384 lanes; the SSD offloader
    # splits pages into smaller sub-operations for narrower resources
    # (handled inside each resource's latency model).
    channel_bw_GBps: float = 1.2      # flash channel bandwidth
    # SLC-mode latencies (Flash-Cosmos-calibrated)
    t_read_ns: float = 22.5 * US      # tR, SLC-mode sense of one page
    t_prog_ns: float = 400 * US       # SLC-mode program
    t_erase_ns: float = 3500 * US
    e_erase_nj_per_block: float = 150_000.0  # block erase energy (GC wear)
    # In-flash compute primitives
    t_and_or_ns: float = 20.0         # MWS AND/OR (per multi-WL sense, on top of tR)
    t_xor_ns: float = 30.0            # XOR via latch ops
    t_latch_transfer_ns: float = 20.0 # S-latch <-> D-latch move
    t_dma_ns: float = 3.3 * US        # page buffer -> flash controller DMA
    # Ares-Flash shift-and-add multiply: bit-serial over operand width.
    # One partial product = 1 latch AND + 1 shift + 1 add (latch transfers).
    shift_add_cycle_ns: float = 2 * 20.0 + 30.0  # latch xfer + xfer + xor-class add
    # Energy (Flash-Cosmos / ParaBit measured values)
    e_read_nj_per_channel: float = 20_500.0   # 20.5 uJ / channel page read
    e_and_or_nj_per_kb: float = 10.0
    e_latch_transfer_nj_per_kb: float = 10.0
    e_xor_nj_per_kb: float = 20.0
    e_dma_nj_per_channel: float = 7_656.0     # 7.656 uJ / channel DMA
    e_prog_nj_per_channel: float = 65_000.0   # SLC program energy (calibrated)

    @property
    def total_dies(self) -> int:
        return self.channels * self.dies_per_channel

    @property
    def total_planes(self) -> int:
        return self.total_dies * self.planes_per_die

    @property
    def channel_ns_per_byte(self) -> float:
        return 1.0 / (self.channel_bw_GBps)  # GB/s == bytes/ns

    @property
    def capacity_bytes(self) -> int:
        return (self.channels * self.dies_per_channel * self.planes_per_die
                * self.blocks_per_plane * self.wls_per_block * self.page_size)


@dataclasses.dataclass(frozen=True)
class SSDDRAMSpec:
    """SSD-internal LPDDR4 DRAM (Table 2) with PuD (MIMDRAM-class) compute."""

    capacity: int = 2 * GiB
    channels: int = 1
    ranks: int = 1
    banks: int = 8
    row_size: int = 8 * KiB           # one DRAM row / PuD vector fragment
    # LPDDR4-1866 core timings (ns)
    t_rcd_ns: float = 18.0
    t_rp_ns: float = 18.0
    t_ras_ns: float = 42.0
    t_ccd_ns: float = 4.3             # column-to-column
    bus_bw_GBps: float = 14.9         # 1866 MT/s x 8B
    # PuD compute: one bulk bitwise op (bbop) over a full row
    t_bbop_ns: float = 49.0           # MIMDRAM-calibrated triple-row-activation op
    e_bbop_nj: float = 0.864          # per row-op
    # bit-serial arithmetic: N-bit add = ~5N bbops, N-bit mul = ~2N^2+6N bbops
    # (SIMDRAM majority-based circuits); relational = ~2N bbops.
    e_act_pre_nj: float = 2.0         # activation+precharge energy per row
    e_bus_nj_per_kb: float = 4.0      # DRAM bus transfer energy

    @property
    def bus_ns_per_byte(self) -> float:
        return 1.0 / self.bus_bw_GBps


@dataclasses.dataclass(frozen=True)
class ISPSpec:
    """SSD controller embedded cores (ARM Cortex-R8, Table 2)."""

    cores: int = 5                     # 1 used for offloaded compute (§4.3.2 fn3)
    compute_cores: int = 1
    freq_ghz: float = 1.5
    simd_bytes: int = 16               # MVE/Helium: 128-bit vector datapath
    ipc: float = 1.0                   # sustained vector IPC (QEMU-calibrated)
    # energy: ARM R8-class core power ~ 0.25 W @1.5GHz
    power_w: float = 0.25
    # SRAM/DRAM access from core
    dram_access_ns: float = 100.0      # controller <-> SSD DRAM latency
    mem_bw_GBps: float = 4.0           # sustained core<->SSD-DRAM streaming bw

    @property
    def cycle_ns(self) -> float:
        return 1.0 / self.freq_ghz

    def vector_op_ns(self, num_bytes: int, cycles_per_vec: float = 1.0) -> float:
        """Latency for an elementwise SIMD op over num_bytes.

        The core is usually *memory-bound* streaming 2 loads + 1 store per
        element through its narrow DRAM port — the paper's "limited SIMD
        parallelism" of ISP (§2.2)."""
        vecs = max(1, (num_bytes + self.simd_bytes - 1) // self.simd_bytes)
        compute = vecs * cycles_per_vec * self.cycle_ns / self.ipc
        mem = 3.0 * num_bytes / self.mem_bw_GBps
        return max(compute, mem)

    def energy_nj(self, latency_ns: float) -> float:
        return self.power_w * latency_ns  # W * ns = nJ


@dataclasses.dataclass(frozen=True)
class FTLSpec:
    """Flash-translation-layer firmware parameters (page-mapping FTL).

    Real drives reserve physical capacity beyond the advertised logical
    space (over-provisioning) so the garbage collector always has somewhere
    to consolidate valid pages; the watermarks bound when the GC background
    process runs.  Fractions are of a die's physical page count — GC is a
    per-die activity in :mod:`repro_torch.sim.ftl`.

    The policy knobs parameterize the GC policy suite of
    :mod:`repro_torch.sim.ftl` (victim selection, hot/cold data separation,
    GC suspend/throttle); :class:`~repro_torch.sim.ftl.FTLConfig` fields default
    to these firmware values and override them per run."""

    op_ratio: float = 0.28            # physical/logical - 1 (28% OP)
    gc_low_watermark: float = 0.10    # free-page fraction that wakes GC
    gc_high_watermark: float = 0.20   # free-page fraction where GC sleeps
    # hot/cold data separation: an LBA whose lifetime write count reaches
    # the threshold is routed to the hot host append point (hot pages die
    # together, so victims are either nearly-empty or nearly-full)
    hot_threshold: int = 3
    # wear-aware victim selection: valid-page-count penalty per erase the
    # candidate block sits above the die's least-worn block
    wear_alpha: float = 4.0
    # GC suspend/throttle: pause the collector between page copies while
    # the host has >= gc_suspend_qd requests outstanding, re-checking
    # every gc_backoff_ns
    gc_suspend_qd: int = 2
    gc_backoff_ns: float = 30_000.0

    def __post_init__(self) -> None:
        if not 0.0 < self.op_ratio:
            raise ValueError(f"op_ratio must be > 0, got {self.op_ratio}")
        if not 0.0 <= self.gc_low_watermark < self.gc_high_watermark <= 1.0:
            raise ValueError(
                "need 0 <= gc_low_watermark < gc_high_watermark <= 1, got "
                f"low={self.gc_low_watermark} high={self.gc_high_watermark}")
        if self.hot_threshold < 2:
            raise ValueError(
                f"hot_threshold must be >= 2, got {self.hot_threshold}")
        if self.wear_alpha < 0.0:
            raise ValueError(
                f"wear_alpha must be >= 0, got {self.wear_alpha}")
        # gc_suspend_qd / gc_backoff_ns are deliberately NOT validated
        # here: the suspend machinery checks them at model-build time
        # (see FTLModel) so a spec with suspend disabled may carry any
        # placeholder values, and tests pin that contract.


@dataclasses.dataclass(frozen=True)
class ReliabilitySpec:
    """ECC / read-recovery hardware constants (the *cost* side of the
    reliability model; the *error-rate* side is the seeded
    :class:`~repro_torch.sim.faults.FaultConfig`).

    The hard-decode BCH/LDPC engine corrects up to an RBER of
    ``ecc_hard_rber`` essentially for free (decode latency is hidden in
    the channel transfer, as on real controllers).  Past it, recovery
    escalates through the classic ladder — read-retry re-senses at
    shifted reference voltages (each retry a real re-read of the die plus
    a channel transfer), then LDPC soft-decode on longer soft-sense data,
    then superpage-parity reconstruction across the stripe's sibling
    dies.  Every stage books real time on the contended pools."""

    ecc_hard_rber: float = 1e-3       # hard-decode correction limit (RBER)
    ecc_steepness: float = 4.0        # decode-failure curve sharpness
    read_retry_ns: float = 8_000.0    # extra sense time per retry step
    max_read_retries: int = 4         # voltage-shift retry steps
    retry_rber_factor: float = 0.5    # effective RBER shrink per retry step
    soft_decode_ns: float = 60_000.0  # LDPC soft-decode on the ECC engine
    soft_rber_factor: float = 0.05    # soft decode corrects ~20x harder reads
    ecc_engines: int = 2              # controller soft-decode/XOR engines
    rebuild_xor_ns_per_page: float = 2_000.0  # parity XOR per stripe page

    def __post_init__(self) -> None:
        if not 0.0 < self.ecc_hard_rber < 1.0:
            raise ValueError(
                f"ecc_hard_rber must be in (0, 1), got {self.ecc_hard_rber}")
        if self.ecc_steepness <= 0.0:
            raise ValueError(
                f"ecc_steepness must be > 0, got {self.ecc_steepness}")
        if self.read_retry_ns < 0.0 or self.soft_decode_ns < 0.0 \
                or self.rebuild_xor_ns_per_page < 0.0:
            raise ValueError("reliability latencies must be >= 0")
        if self.max_read_retries < 0:
            raise ValueError(
                f"max_read_retries must be >= 0, got {self.max_read_retries}")
        if not 0.0 < self.retry_rber_factor <= 1.0:
            raise ValueError("retry_rber_factor must be in (0, 1], got "
                             f"{self.retry_rber_factor}")
        if not 0.0 < self.soft_rber_factor <= 1.0:
            raise ValueError("soft_rber_factor must be in (0, 1], got "
                             f"{self.soft_rber_factor}")
        if self.ecc_engines < 1:
            raise ValueError(
                f"ecc_engines must be >= 1, got {self.ecc_engines}")


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """Host CPU/GPU + interconnect (Table 2).

    CPU: Xeon Gold 5118 (6 cores OoO 3.2 GHz, AVX-512-class 64B SIMD).
    GPU: NVIDIA A100 (108 SMs @ 1.4 GHz).
    PCIe 4.0 x4-class external bandwidth: 8 GB/s.
    Host DRAM: DDR4-2400 4ch, 19.2 GB/s.
    """

    pcie_bw_GBps: float = 8.0
    pcie_latency_ns: float = 1_000.0
    host_dram_bw_GBps: float = 19.2
    cpu_cores: int = 6
    cpu_freq_ghz: float = 3.2
    cpu_simd_bytes: int = 64
    cpu_ipc: float = 2.0               # dual-issue vector pipelines
    cpu_power_w: float = 105.0
    gpu_sms: int = 108
    gpu_freq_ghz: float = 1.4
    gpu_lanes_per_sm: int = 64         # FP32/INT cores per SM
    gpu_power_w: float = 300.0
    gpu_hbm_bw_GBps: float = 1555.0
    e_pcie_nj_per_kb: float = 150.0    # link + controller energy
    e_host_dram_nj_per_kb: float = 30.0

    @property
    def pcie_ns_per_byte(self) -> float:
        return 1.0 / self.pcie_bw_GBps

    def cpu_vector_op_ns(self, num_bytes: int, cycles_per_vec: float = 1.0) -> float:
        per_core = 1.0 / (self.cpu_freq_ghz * self.cpu_ipc)
        vecs = max(1, (num_bytes + self.cpu_simd_bytes - 1) // self.cpu_simd_bytes)
        return vecs * cycles_per_vec * per_core / self.cpu_cores

    def gpu_vector_op_ns(self, num_bytes: int, cycles_per_vec: float = 1.0) -> float:
        lanes = self.gpu_sms * self.gpu_lanes_per_sm  # 4-byte lanes
        elems = max(1, num_bytes // 4)
        waves = max(1, (elems + lanes - 1) // lanes)
        return waves * cycles_per_vec / self.gpu_freq_ghz


@dataclasses.dataclass(frozen=True)
class SSDSpec:
    flash: FlashSpec = dataclasses.field(default_factory=FlashSpec)
    dram: SSDDRAMSpec = dataclasses.field(default_factory=SSDDRAMSpec)
    isp: ISPSpec = dataclasses.field(default_factory=ISPSpec)
    host: HostSpec = dataclasses.field(default_factory=HostSpec)
    ftl: FTLSpec = dataclasses.field(default_factory=FTLSpec)
    reliability: ReliabilitySpec = dataclasses.field(
        default_factory=ReliabilitySpec)
    # Conduit runtime overheads (§4.5)
    l2p_lookup_dram_ns: float = 100.0
    l2p_lookup_flash_ns: float = 30.0 * US
    dep_delay_track_ns: float = 1.0 * US     # per queue
    queue_delay_track_ns: float = 1.0 * US   # per resource
    dm_latency_lookup_ns: float = 100.0
    comp_latency_lookup_ns: float = 150.0
    translation_lookup_ns: float = 300.0
    translation_table_bytes: int = int(1.5 * KiB)

    @property
    def page_size(self) -> int:
        return self.flash.page_size


DEFAULT_SSD = SSDSpec()
