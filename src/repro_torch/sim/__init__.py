"""Discrete-event SSD NDP simulator (the paper's §5 evaluation vehicle).

Single-tenant entry point: :func:`simulate` (one trace, one policy).
Multi-tenant entry point: :func:`simulate_mix` (several traces plus an
optional synthetic host I/O stream sharing one fabric).
Open-loop serving entry point: :func:`simulate_serving` (sessions drawn
from a weighted catalog keep arriving mid-run; steady-state throughput /
tail latency, plus :func:`find_saturation` for the max sustainable rate).
Batched sweeps: :func:`batched_find_saturation` runs many saturation
searches in lockstep (policy grids, seed fans) on a vectorized driver.
Fleet entry point: :func:`simulate_fleet` (N :class:`DriveActor` drives
behind a placement layer — replication, read steering, hedging, fleet
admission — plus :func:`find_fleet_saturation` for fleet sessions/sec
at a fleet p99 SLO).
All run on the time-ordered event heap in :mod:`repro_torch.sim.events`.
The simulator is host Python, as in the JAX package: it prices every op
analytically and calls no kernel.
"""
from repro_torch.sim.analysis import (blame_story, build_report, critical_path,
                                      diff_reports, fleet_blame, pool_rankings,
                                      session_blame, split_fleet_trace)
from repro_torch.sim.drive import DriveActor, DriveHealth, DrivePoll
from repro_torch.sim.events import EventEngine, EventKind
from repro_torch.sim.faults import FaultConfig, FaultModel, FaultStats
from repro_torch.sim.ftl import (VICTIM_POLICIES, CostBenefitVictim, FTLConfig,
                                 FTLModel, GreedyVictim, OutOfPhysicalBlocks,
                                 VictimPolicy, WearAwareVictim,
                                 drive_zipf_overwrites, make_victim_policy)
from repro_torch.sim.fleet import (DriveProfile, FleetConfig,
                                   find_fleet_saturation, simulate_fleet)
from repro_torch.sim.machine import SimConfig, Simulation, simulate
from repro_torch.sim.placement import (ConsistentHashPlacement, HashPlacement,
                                       HeatAwarePlacement, PlacementPolicy,
                                       derive_drive_seed, make_placement)
from repro_torch.sim.servers import Fabric, ServerPool
from repro_torch.sim.serving import (SaturationProbe, SaturationResult,
                                     ServingConfig, find_saturation,
                                     simulate_serving)
from repro_torch.sim.sweep import (FleetSweepLane, SweepLane, array_backend,
                                   batched_find_fleet_saturation,
                                   batched_find_saturation,
                                   batched_poisson_arrival_times_ns)
from repro_torch.sim.stats import (DecisionRecord, FleetResult,
                                   FleetSessionRecord, FTLStats, HostIOStats,
                                   MixResult, ServingResult, SessionRecord,
                                   SessionState, SimResult, jain_fairness,
                                   merged_percentile, percentile)
from repro_torch.sim.telemetry import (CandidateCost, FlightRecorder,
                                       IntervalSample, OffloadAudit,
                                       TelemetryConfig, export_fleet_trace,
                                       merge_fleet_trace, summarize as
                                       summarize_trace, validate_trace)
from repro_torch.sim.tenancy import HostIOStream, clone_trace, simulate_mix
from repro_torch.sim.workgen import (ArrivalProcess, CatalogEntry,
                                     DeterministicArrivals, MMPPArrivals,
                                     PoissonArrivals, SessionCatalog,
                                     SuperposedArrivals, TraceReplayArrivals)

__all__ = ["SimConfig", "Simulation", "simulate", "ServerPool", "Fabric",
           "EventEngine", "EventKind",
           "HostIOStream", "simulate_mix", "clone_trace",
           "FTLConfig", "FTLModel", "FTLStats",
           "VictimPolicy", "GreedyVictim", "CostBenefitVictim",
           "WearAwareVictim", "VICTIM_POLICIES", "make_victim_policy",
           "drive_zipf_overwrites",
           "DecisionRecord", "HostIOStats", "MixResult", "SimResult",
           "jain_fairness", "percentile",
           "ArrivalProcess", "PoissonArrivals", "MMPPArrivals",
           "DeterministicArrivals", "TraceReplayArrivals",
           "SuperposedArrivals", "CatalogEntry", "SessionCatalog",
           "ServingConfig", "ServingResult", "SessionRecord",
           "SessionState", "simulate_serving", "find_saturation",
           "FaultConfig", "FaultModel", "FaultStats",
           "OutOfPhysicalBlocks",
           "SaturationProbe", "SaturationResult",
           "SweepLane", "batched_find_saturation",
           "FleetSweepLane", "batched_find_fleet_saturation",
           "batched_poisson_arrival_times_ns", "array_backend",
           "TelemetryConfig", "FlightRecorder", "OffloadAudit",
           "CandidateCost", "IntervalSample", "validate_trace",
           "summarize_trace",
           "build_report", "session_blame", "critical_path",
           "pool_rankings", "diff_reports", "blame_story",
           "DriveActor", "DriveHealth", "DrivePoll",
           "DriveProfile", "FleetConfig", "simulate_fleet",
           "find_fleet_saturation",
           "PlacementPolicy", "HashPlacement", "ConsistentHashPlacement",
           "HeatAwarePlacement", "make_placement", "derive_drive_seed",
           "FleetResult", "FleetSessionRecord", "merged_percentile",
           "merge_fleet_trace", "export_fleet_trace",
           "split_fleet_trace", "fleet_blame"]
