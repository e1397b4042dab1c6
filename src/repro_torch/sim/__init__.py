"""Discrete-event SSD NDP simulator (the paper's §5 evaluation vehicle).

Single-tenant entry point: :func:`simulate` (one trace, one policy), on
the time-ordered event heap in :mod:`repro_torch.sim.events`.  The
simulator is host Python, as in the JAX package: it prices every op
analytically and calls no kernel.  Multi-tenant entry point:
:func:`simulate_mix` (several traces plus an optional synthetic host I/O
stream, and an optional FTL with garbage collection, sharing one fabric).
Serving, fleets and trace analysis come with later slices of the port.
"""
from repro_torch.sim.events import EventEngine, EventKind
from repro_torch.sim.faults import FaultConfig, FaultModel, FaultStats
from repro_torch.sim.ftl import (VICTIM_POLICIES, CostBenefitVictim,
                                 FTLConfig, FTLModel, GreedyVictim,
                                 OutOfPhysicalBlocks, VictimPolicy,
                                 WearAwareVictim, drive_zipf_overwrites,
                                 make_victim_policy)
from repro_torch.sim.machine import SimConfig, Simulation, simulate
from repro_torch.sim.servers import Fabric, ServerPool
from repro_torch.sim.stats import (DecisionRecord, FTLStats, HostIOStats,
                                   MixResult, SimResult, jain_fairness,
                                   merged_percentile, percentile)
from repro_torch.sim.telemetry import (CandidateCost, FlightRecorder,
                                       IntervalSample, OffloadAudit,
                                       TelemetryConfig, summarize as
                                       summarize_trace, validate_trace)
from repro_torch.sim.tenancy import HostIOStream, clone_trace, simulate_mix

__all__ = ["SimConfig", "Simulation", "simulate", "ServerPool", "Fabric",
           "EventEngine", "EventKind",
           "HostIOStream", "simulate_mix", "clone_trace",
           "FTLConfig", "FTLModel", "FTLStats",
           "VictimPolicy", "GreedyVictim", "CostBenefitVictim",
           "WearAwareVictim", "VICTIM_POLICIES", "make_victim_policy",
           "drive_zipf_overwrites", "OutOfPhysicalBlocks",
           "HostIOStats", "MixResult",
           "FaultConfig", "FaultModel", "FaultStats",
           "DecisionRecord", "SimResult", "jain_fairness",
           "merged_percentile", "percentile",
           "TelemetryConfig", "FlightRecorder", "OffloadAudit",
           "CandidateCost", "IntervalSample", "validate_trace",
           "summarize_trace"]
