"""Conduit core: the paper's contribution as a composable library.

Compile-time:  :func:`repro_torch.core.vectorize.vectorize` — programmer-
transparent tracing of a PyTorch function into page-aligned vector
instructions.  It is not imported here, so the runtime below (and the
simulator built on it) loads no tracer.

Runtime:       :mod:`repro_torch.core.cost` (six-feature cost function,
Eqns 1-2), :mod:`repro_torch.core.policies` (Conduit + all baseline
offloading policies), :mod:`repro_torch.core.mapping` (L2P + lazy
coherence), :mod:`repro_torch.core.trace` (the traced binary).
"""
from repro_torch.core.isa import (NDP_RESOURCES, Location, OpClass, Resource,
                                  VectorInstr, compute_energy_nj,
                                  compute_latency_ns, supports)
from repro_torch.core.cost import (HOME, Features, SystemView,
                                   decision_overhead_ns, dm_energy_nj,
                                   dm_latency_ns, exec_energy_nj,
                                   exec_latency_ns, features_for,
                                   static_features)
from repro_torch.core.mapping import PageEntry, PageTable
from repro_torch.core.policies import (ALL_POLICIES, ConduitPolicy,
                                       DMOffloading, BWOffloading,
                                       IdealPolicy, Policy, make_policy)
from repro_torch.core.trace import (Trace, TraceStats, trace_from_dict,
                                    trace_to_dict)

__all__ = [
    "NDP_RESOURCES", "Location", "OpClass", "Resource", "VectorInstr",
    "compute_energy_nj", "compute_latency_ns", "supports", "HOME",
    "Features", "SystemView", "decision_overhead_ns", "dm_energy_nj",
    "dm_latency_ns", "exec_energy_nj", "exec_latency_ns", "features_for",
    "static_features", "PageEntry", "PageTable",
    "ALL_POLICIES", "ConduitPolicy", "DMOffloading", "BWOffloading",
    "IdealPolicy", "Policy", "make_policy", "Trace", "TraceStats",
    "trace_to_dict", "trace_from_dict",
]
