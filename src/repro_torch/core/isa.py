"""Conduit vector-instruction IR and per-resource capability model.

The compile-time pass (see :mod:`repro_torch.core.vectorize`) emits a stream of
:class:`VectorInstr` — wide SIMD operations whose vector width matches the
NAND flash page (4096 x 32-bit = 16 KiB, §4.3.1), each carrying the metadata
Table 1 requires (operation type, operand logical pages, element size,
vector length, SSA dependencies).

Each SSD computation resource supports a different subset of operations
(§4.3.2 "Operation Type"):

* ISP  — ~300 ISA ops (ARM + MVE): everything, incl. control/gather.
* PuD  — 16 ops (SIMDRAM/MIMDRAM/Proteus): bitwise, add/sub, mul,
         relational, predication — bit-serial over bit-planes.
* IFP  — 9 ops (Flash-Cosmos MWS + Ares-Flash): AND/OR/XOR/NOT/NAND/NOR +
         add/sub(shift-add)/mul(shift-and-add).

The latency/energy models below implement §5.2 using the Table 2 constants
in :mod:`repro_torch.hw.ssd_spec`; they are the `latency_comp` feature of the cost
function and also drive the event-driven simulator's execution timing.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence, Tuple

from repro_torch.hw.ssd_spec import SSDSpec


class Resource(enum.Enum):
    """A compute-capable resource (paper §2.2) plus host baselines (§5.3)."""

    ISP = "isp"          # SSD controller embedded cores
    PUD = "pud"          # processing-using-DRAM in the SSD
    IFP = "ifp"          # in-flash processing
    HOST_CPU = "cpu"     # outside-storage processing baselines
    HOST_GPU = "gpu"

    @property
    def in_ssd(self) -> bool:
        return self in (Resource.ISP, Resource.PUD, Resource.IFP)


# Dense integer index per resource: hot paths (feature caches, pool tables)
# key flat tuples by ``resource.index`` instead of hashing enum members.
for _i, _r in enumerate(Resource):
    _r.index = _i
N_RESOURCES = len(Resource)

NDP_RESOURCES: Tuple[Resource, ...] = (Resource.ISP, Resource.PUD, Resource.IFP)


class Location(enum.Enum):
    """Where a logical page currently lives (4-bit encoded in the paper)."""

    FLASH = 0
    DRAM = 1
    CTRL = 2     # controller-core registers / SRAM (transient)
    HOST = 3


# Same dense-index trick as Resource: ``loc.index`` is a plain attribute
# read (``loc.value`` pays the DynamicClassAttribute descriptor on every
# access).  Values equal definition order, so index == value.
for _i, _l in enumerate(Location):
    _l.index = _i
N_LOCATIONS = len(Location)


class OpClass(enum.Enum):
    """Operation type feature (Table 1): latency class of the computation."""

    BITWISE = "bitwise"          # and/or/xor/not/shift   (low latency)
    ARITH_ADD = "arith_add"      # add/sub                (medium latency)
    PREDICATION = "predication"  # cmp/select/min/max     (medium latency)
    ARITH_MUL = "arith_mul"      # mul/mac/div-approx     (high latency)
    REDUCTION = "reduction"      # horizontal sum/max     (medium latency)
    COPY = "copy"                # bulk copy / init       (low latency)
    GATHER = "gather"            # indexed access         (control-ish)
    CONTROL = "control"          # non-vectorizable scalar/branchy region


LOW_LATENCY_CLASSES = frozenset({OpClass.BITWISE, OpClass.COPY})
MEDIUM_LATENCY_CLASSES = frozenset(
    {OpClass.ARITH_ADD, OpClass.PREDICATION, OpClass.REDUCTION})
HIGH_LATENCY_CLASSES = frozenset({OpClass.ARITH_MUL})

# Map concrete op mnemonics to their class.  The vectorizer lowers ATen
# primitives onto these mnemonics (the "native instruction" namespace).
OP_TO_CLASS = {
    "and": OpClass.BITWISE, "or": OpClass.BITWISE, "xor": OpClass.BITWISE,
    "not": OpClass.BITWISE, "nand": OpClass.BITWISE, "nor": OpClass.BITWISE,
    "shl": OpClass.BITWISE, "shr": OpClass.BITWISE,
    "add": OpClass.ARITH_ADD, "sub": OpClass.ARITH_ADD,
    "mul": OpClass.ARITH_MUL, "mac": OpClass.ARITH_MUL,
    "div": OpClass.ARITH_MUL, "rsqrt": OpClass.ARITH_MUL,
    "exp": OpClass.ARITH_MUL, "tanh": OpClass.ARITH_MUL,
    "logistic": OpClass.ARITH_MUL,
    "cmp": OpClass.PREDICATION, "select": OpClass.PREDICATION,
    "min": OpClass.PREDICATION, "max": OpClass.PREDICATION,
    "ge": OpClass.PREDICATION, "lt": OpClass.PREDICATION,
    "reduce_sum": OpClass.REDUCTION, "reduce_max": OpClass.REDUCTION,
    "copy": OpClass.COPY, "broadcast": OpClass.COPY, "iota": OpClass.COPY,
    "search": OpClass.PREDICATION,   # §7 extensibility: in-flash match
    "gather": OpClass.GATHER, "scatter": OpClass.GATHER,
    "scalar": OpClass.CONTROL, "branch": OpClass.CONTROL,
    "shuffle": OpClass.GATHER,
}

# Per-resource supported op classes (§4.3.2 "Operation Type").
SUPPORTED: dict = {
    Resource.ISP: frozenset(OpClass),  # general purpose: everything
    Resource.PUD: frozenset({
        OpClass.BITWISE, OpClass.ARITH_ADD, OpClass.ARITH_MUL,
        OpClass.PREDICATION, OpClass.REDUCTION, OpClass.COPY,
    }),
    Resource.IFP: frozenset({
        OpClass.BITWISE, OpClass.ARITH_ADD, OpClass.ARITH_MUL,
        OpClass.COPY, OpClass.PREDICATION,   # predication == search/cmp via
        # match lines (§7 extensibility); cost model prices non-search
        # predication high via the bit-serial latch path
    }),
    Resource.HOST_CPU: frozenset(OpClass),
    Resource.HOST_GPU: frozenset(OpClass) - {OpClass.CONTROL},
}

# Native ISA mnemonic prefix per resource — the instruction transformation
# unit (§4.3.2) rewrites `add` -> `mve.vadd` / `bbop_add` / `ares.shift_add`.
NATIVE_PREFIX = {
    Resource.ISP: "mve.v",        # ARM M-Profile Vector Extension
    Resource.PUD: "bbop_",        # SIMDRAM/MIMDRAM/Proteus bulk-bitwise ops
    Resource.IFP: "ifp.",         # Flash-Cosmos MWS / Ares-Flash primitives
    Resource.HOST_CPU: "avx512.",
    Resource.HOST_GPU: "ptx.",
}

IFP_NATIVE = {
    "search": "ifp.mws_match",           # XNOR + wired-AND match lines
    "and": "ifp.mws_and", "or": "ifp.mws_or", "nand": "ifp.mws_nand",
    "nor": "ifp.mws_nor", "xor": "ifp.latch_xor", "not": "ifp.latch_not",
    "add": "ifp.shift_add", "sub": "ifp.shift_sub", "mul": "ifp.shift_and_add_mul",
    "copy": "ifp.page_copy",
}


@dataclasses.dataclass
class VectorInstr:
    """One page-aligned SIMD instruction with compile-time metadata.

    ``srcs``/``dst`` are logical page ids (the FTL's L2P granularity); the
    runtime resolves their physical location via the mapping table.  ``deps``
    are producer instruction ids (SSA edges) — the data-dependence feature.
    """

    iid: int
    op: str                                   # mnemonic, key of OP_TO_CLASS
    vlen: int                                 # number of elements
    elem_bytes: int                           # element size (1=INT8 default)
    srcs: Tuple[int, ...]                     # logical source pages
    dst: int                                  # logical destination page
    deps: Tuple[int, ...] = ()                # producer iids
    tag: str = ""                             # provenance (jaxpr eqn / loop)
    vectorizable: bool = True                 # False -> CONTROL (ISP-only)

    @property
    def op_class(self) -> OpClass:
        # memoized: read on every supports()/cost lookup in the dispatch
        # loop, and (op, vectorizable) never change after construction
        oc = self.__dict__.get("_op_class")
        if oc is None:
            oc = (OpClass.CONTROL if not self.vectorizable
                  else OP_TO_CLASS[self.op])
            self._op_class = oc
        return oc

    @property
    def nbytes(self) -> int:
        return self.vlen * self.elem_bytes

    @property
    def bit_width(self) -> int:
        return self.elem_bytes * 8

    def native(self, resource: Resource) -> str:
        """Instruction transformation (§4.3.2): translate to native ISA."""
        if resource is Resource.IFP and self.op in IFP_NATIVE:
            return IFP_NATIVE[self.op]
        return NATIVE_PREFIX[resource] + self.op


# ---------------------------------------------------------------------------
# Expected computation latency model (latency_comp feature + simulator timing)
# ---------------------------------------------------------------------------

# SIMDRAM-class bit-serial bbop counts per W-bit elementwise op.
_PUD_BBOPS = {
    OpClass.BITWISE: lambda w: 3,                 # AAP sequences for and/or/xor
    OpClass.COPY: lambda w: 1,                    # RowClone
    OpClass.ARITH_ADD: lambda w: 5 * w + 2,       # MAJ-based ripple adder
    OpClass.PREDICATION: lambda w: 2 * w + 4,     # bit-serial compare+select
    OpClass.REDUCTION: lambda w: 6 * w + 8,       # tree of adds (log lanes folded)
    OpClass.ARITH_MUL: lambda w: 2 * w * w + 6 * w,  # shift-add partial products
}

# ISP cycles per SIMD vector (load/compute/store micro-schedule on R8+MVE).
_ISP_CYCLES = {
    OpClass.BITWISE: 5.0, OpClass.COPY: 4.0, OpClass.ARITH_ADD: 5.0,
    OpClass.PREDICATION: 6.0, OpClass.REDUCTION: 6.0, OpClass.ARITH_MUL: 8.0,
    OpClass.GATHER: 8.0, OpClass.CONTROL: 8.0,
}

_HOST_CYCLES = {
    OpClass.BITWISE: 1.0, OpClass.COPY: 1.0, OpClass.ARITH_ADD: 1.0,
    OpClass.PREDICATION: 1.5, OpClass.REDUCTION: 2.0, OpClass.ARITH_MUL: 2.0,
    OpClass.GATHER: 6.0, OpClass.CONTROL: 8.0,
}

_GPU_LAUNCH_NS = 4_000.0   # kernel-launch overhead amortized per fused op


def supports(resource: Resource, instr: VectorInstr) -> bool:
    return instr.op_class in SUPPORTED[resource]


def compute_latency_ns(instr: VectorInstr, resource: Resource,
                       spec: SSDSpec, operands_latched: bool = False) -> float:
    """Expected execution latency of ``instr`` on ``resource`` (ns).

    ``operands_latched``: for IFP, whether source pages are already in the
    plane's page buffer (skips the sensing step — Flash-Cosmos computes
    during the sense, consecutive latch ops reuse it).
    """
    oc = instr.op_class
    nbytes = instr.nbytes
    w = instr.bit_width

    if resource is Resource.IFP:
        f = spec.flash
        # Sensing: one multi-WL sense reads *all* same-block operands at once
        # for MWS AND/OR; other ops sense each operand page.
        if operands_latched:
            sense = 0.0
        elif oc is OpClass.BITWISE and instr.op in ("and", "or", "nand", "nor"):
            sense = f.t_read_ns + f.t_and_or_ns          # MWS: single sense
        else:
            sense = len(instr.srcs) * f.t_read_ns        # per-operand sense
        if instr.op == "search":
            # XNOR sense + match-line AND: one multi-WL sense
            return sense if sense else f.t_read_ns + 2 * f.t_and_or_ns
        if oc is OpClass.BITWISE:
            if instr.op in ("and", "or", "nand", "nor"):
                body = f.t_and_or_ns
            else:
                body = f.t_xor_ns + f.t_latch_transfer_ns
        elif oc is OpClass.COPY:
            body = f.t_latch_transfer_ns
        elif oc is OpClass.ARITH_ADD:
            body = w * f.shift_add_cycle_ns              # bit-serial latch adder
        elif oc is OpClass.ARITH_MUL:
            # Ares-Flash shift-and-add: w partial products, each needs a
            # latch AND + shift + add, PLUS operand staging through the
            # flash controller (the §6.4 "frequent operand transfers").
            body = w * (w * f.shift_add_cycle_ns) + 2 * f.t_dma_ns
        elif oc is OpClass.PREDICATION:
            # non-search predication: bit-serial compare via latches
            body = 2 * w * f.shift_add_cycle_ns
        else:  # unsupported classes are filtered by supports()
            body = float("inf")
        return sense + body

    if resource is Resource.PUD:
        d = spec.dram
        rows = max(1, math.ceil(nbytes / d.row_size))
        # MIMDRAM executes a bbop over a full row in t_bbop; rows spread
        # across banks run concurrently, command bus serializes issue.
        bank_par = min(rows, d.banks)
        serial_rows = math.ceil(rows / bank_par)
        bbops = _PUD_BBOPS[oc](w)
        issue = rows * 6.0                                # command issue per row
        return serial_rows * bbops * d.t_bbop_ns + issue

    if resource is Resource.ISP:
        i = spec.isp
        cyc = _ISP_CYCLES.get(oc, 8.0)
        if oc is OpClass.CONTROL:
            # scalar region: per-element, not per-vector
            return instr.vlen * cyc * i.cycle_ns / i.ipc
        return i.vector_op_ns(nbytes, cyc)

    if resource is Resource.HOST_CPU:
        h = spec.host
        cyc = _HOST_CYCLES.get(oc, 2.0)
        if oc is OpClass.CONTROL:
            # branchy scalar region: per-element on one core
            return instr.vlen * cyc / h.cpu_freq_ghz
        comp = h.cpu_vector_op_ns(nbytes, cyc)
        mem = 3 * nbytes / h.host_dram_bw_GBps            # 2 loads + 1 store
        return max(comp, mem)

    if resource is Resource.HOST_GPU:
        h = spec.host
        cyc = _HOST_CYCLES.get(oc, 2.0)
        comp = h.gpu_vector_op_ns(nbytes, cyc)
        mem = 3 * nbytes / h.gpu_hbm_bw_GBps
        return max(comp, mem) + _GPU_LAUNCH_NS / 16.0     # fused/streamed launches
    raise ValueError(f"unknown resource {resource}")


def compute_energy_nj(instr: VectorInstr, resource: Resource,
                      spec: SSDSpec, latency_ns: Optional[float] = None) -> float:
    """Energy of executing ``instr`` on ``resource`` (nJ), §5.2 model."""
    oc = instr.op_class
    kb = instr.nbytes / 1024.0
    if latency_ns is None:
        latency_ns = compute_latency_ns(instr, resource, spec)

    if resource is Resource.IFP:
        f = spec.flash
        sense_e = f.e_read_nj_per_channel * max(1, len(instr.srcs)) * 0.25
        if oc is OpClass.BITWISE:
            if instr.op in ("and", "or", "nand", "nor"):
                sense_e = f.e_read_nj_per_channel * 0.3   # single MWS sense
                return sense_e + f.e_and_or_nj_per_kb * kb
            return sense_e + f.e_xor_nj_per_kb * kb
        if oc is OpClass.COPY:
            return sense_e * 0.5 + f.e_latch_transfer_nj_per_kb * kb
        if oc is OpClass.ARITH_ADD:
            return sense_e + instr.bit_width * f.e_latch_transfer_nj_per_kb * kb
        if oc is OpClass.ARITH_MUL:
            w = instr.bit_width
            return (sense_e + w * w * f.e_latch_transfer_nj_per_kb * kb * 0.5
                    + 2 * f.e_dma_nj_per_channel)
        return sense_e

    if resource is Resource.PUD:
        d = spec.dram
        rows = max(1, math.ceil(instr.nbytes / d.row_size))
        bbops = _PUD_BBOPS[oc](instr.bit_width)
        return rows * bbops * (d.e_bbop_nj + d.e_act_pre_nj)

    if resource is Resource.ISP:
        return spec.isp.energy_nj(latency_ns) + spec.dram.e_bus_nj_per_kb * 3 * kb

    if resource is Resource.HOST_CPU:
        return spec.host.cpu_power_w * latency_ns + spec.host.e_host_dram_nj_per_kb * 3 * kb

    if resource is Resource.HOST_GPU:
        h = spec.host
        cyc = _HOST_CYCLES.get(oc, 2.0)
        active = max(h.gpu_vector_op_ns(instr.nbytes, cyc),
                     3 * instr.nbytes / h.gpu_hbm_bw_GBps)
        return h.gpu_power_w * active + 2_000.0   # + launch/idle overhead nJ
    raise ValueError(f"unknown resource {resource}")


def class_of(op: str) -> OpClass:
    return OP_TO_CLASS[op]


def latency_band(op_class: OpClass) -> str:
    """Table 3 latency bands used by workload characterization."""
    if op_class in LOW_LATENCY_CLASSES:
        return "low"
    if op_class in HIGH_LATENCY_CLASSES:
        return "high"
    return "medium"
