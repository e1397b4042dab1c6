"""Simulation results: makespan, energy breakdown, latency percentiles,
offloading-decision logs (Figs. 7-10 raw data).

Multi-tenant additions: :class:`MixResult` bundles one :class:`SimResult`
per tenant plus the fairness / interference metrics of the shared-SSD
regime — per-tenant slowdown vs. a solo run, Jain's fairness index over
the slowdowns, and host-I/O tail latency (:class:`HostIOStats`)."""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.isa import Resource
# DecisionRecord's definition lives with the rest of the decision-audit
# machinery in repro_torch.sim.telemetry; re-exported here so existing callers
# (`from repro_torch.sim.stats import DecisionRecord`) keep working.
from repro_torch.sim.telemetry import DecisionRecord


def percentile(values: List[float], p: float) -> float:
    """Nearest-rank percentile; ``p`` must lie in [0, 100].

    Out-of-range ``p`` raises instead of silently clamping to the
    min/max sample — ``p(990)`` is a typo for ``p(99)``, not a request
    for the largest value, and clamping would let it masquerade as a
    plausible tail percentile."""
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile p={p!r} out of range [0, 100]")
    if not values:
        return 0.0
    s = sorted(values)
    k = max(0, min(len(s) - 1, math.ceil(p / 100.0 * len(s)) - 1))
    return s[k]


def merged_percentile(sample_groups: List[List[float]], p: float) -> float:
    """Percentile over the *union* of per-group samples.

    This is the only correct way to aggregate latency percentiles across
    drives: the fleet p99 is the 99th percentile of every session the
    fleet served, pooled.  Averaging per-drive p99s is a classic
    aggregation bug — it weights a 10-session straggler drive equally
    with a 10 000-session healthy one and *understates* the fleet tail
    whenever the tail is concentrated on few drives (the straggler
    scenario this repo exists to study).  ``FleetResult`` routes every
    percentile through here; ``tests/test_fleet.py`` pins the
    merged-vs-averaged gap on an asymmetric fixture."""
    merged: List[float] = []
    for g in sample_groups:
        merged.extend(g)
    return percentile(merged, p)


@dataclasses.dataclass
class SimResult:
    policy: str
    workload: str
    makespan_ns: float
    n_instrs: int
    compute_energy_nj: float
    movement_energy_nj: float
    decision_overhead_ns_total: float
    decisions: List[DecisionRecord]
    resource_counts: Dict[Resource, int]
    resource_busy_ns: Dict[str, float]
    coherence_syncs: int
    evictions: int
    replays: int
    colocations: int
    tenant: str = ""                 # tenant id in a simulate_mix run
    start_ns: float = 0.0            # arrival offset in a simulate_mix run
    # per-op dispatch-to-completion latencies (floats, always cheap);
    # richer per-dispatch detail lives in the telemetry audit stream
    op_latencies_ns: Optional[List[float]] = None
    # FlightRecorder when the run was invoked with telemetry=...
    telemetry: Optional[object] = None
    # fault injection: an NDP operand sense came back unrecoverable
    # somewhere in the run (timing stayed honest; data did not)
    failed: bool = False
    # FaultStats snapshot when the run was invoked with faults=...
    faults: Optional[object] = None

    @property
    def total_energy_nj(self) -> float:
        return self.compute_energy_nj + self.movement_energy_nj

    @property
    def elapsed_ns(self) -> float:
        """Wall time from this tenant's arrival to its last completion —
        what slowdown-vs-solo compares when tenants arrive staggered."""
        return self.makespan_ns - self.start_ns

    @property
    def latencies_ns(self) -> List[float]:
        if self.op_latencies_ns is not None:
            return self.op_latencies_ns
        return [d.t_end - d.t_decide for d in self.decisions]

    def p(self, pct: float) -> float:
        return percentile(self.latencies_ns, pct)

    @property
    def avg_decision_overhead_ns(self) -> float:
        return self.decision_overhead_ns_total / max(1, self.n_instrs)

    def decision_mix(self) -> Dict[Resource, float]:
        total = max(1, sum(self.resource_counts.values()))
        return {r: c / total for r, c in self.resource_counts.items()}

    def summary(self) -> Dict[str, object]:
        mix = self.decision_mix()
        return {
            "policy": self.policy,
            "workload": self.workload,
            "makespan_ms": self.makespan_ns / 1e6,
            "energy_mj": self.total_energy_nj / 1e6,
            "movement_energy_pct": round(
                100 * self.movement_energy_nj / max(1e-9, self.total_energy_nj), 1),
            "p99_us": self.p(99) / 1e3,
            "p9999_us": self.p(99.99) / 1e3,
            "mix": {r.value: round(100 * f, 1) for r, f in mix.items()},
            "avg_overhead_us": self.avg_decision_overhead_ns / 1e3,
            "instrs": self.n_instrs,
        }


@dataclasses.dataclass
class HostIOStats:
    """Latency accounting for the synthetic host read/write I/O stream
    competing with NDP traffic for channels, dies and the PCIe link."""

    n_reads: int
    n_writes: int
    latencies_ns: List[float]
    # ops surfaced as failed under fault injection (unrecoverable reads,
    # rejected writes, timeout-retry budgets spent) — excluded from the
    # latency population above, never silently dropped
    n_failed: int = 0

    @property
    def n_requests(self) -> int:
        return self.n_reads + self.n_writes

    @property
    def mean_ns(self) -> float:
        if not self.latencies_ns:
            return 0.0
        return sum(self.latencies_ns) / len(self.latencies_ns)

    def p(self, pct: float) -> float:
        return percentile(self.latencies_ns, pct)

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "io_requests": self.n_requests,
            "io_reads": self.n_reads,
            "io_mean_us": self.mean_ns / 1e3,
            "io_p50_us": self.p(50) / 1e3,
            "io_p99_us": self.p(99) / 1e3,
            "io_p999_us": self.p(99.9) / 1e3,
        }
        if self.n_failed:
            out["io_failed"] = self.n_failed
        return out


@dataclasses.dataclass
class FTLStats:
    """FTL + garbage-collection accounting for one simulate_mix run.

    ``write_amplification`` is (host + GC copy writes) / host writes —
    exactly 1.0 with GC disabled (infinite over-provisioning).
    ``erase_counts`` is the per-block wear histogram (flattened across
    dies); ``host_during_gc_ns`` the latencies of host requests issued
    while any die's collector was active, isolating the tail-latency cost
    attributable to GC traffic.

    The policy fields record which GC policy suite produced the run:
    ``victim_policy`` (greedy / cost_benefit / wear_aware), ``hot_cold``
    (plus the hot/cold write split), and ``gc_suspend`` with
    ``gc_suspensions`` — how often the throttled collector backed off to
    a deep host queue instead of booking a copy."""

    gc_enabled: bool
    n_logical_pages: int
    n_physical_pages: int
    host_pages_written: int
    gc_pages_copied: int
    blocks_erased: int
    gc_invocations: int
    overflow_blocks: int
    gc_energy_nj: float
    erase_counts: List[int]
    host_during_gc_ns: List[float]
    victim_policy: str = "greedy"
    hot_cold: bool = False
    gc_suspend: bool = False
    gc_suspensions: int = 0
    hot_pages_written: int = 0
    cold_pages_written: int = 0
    # overflow grows taken on the GC append point itself (pool exhausted
    # before the block reserve could be honored) — 0 on healthy
    # reserve-enabled runs, a subset of ``overflow_blocks``
    gc_overflow_blocks: int = 0
    # end of the last die/channel booking the collector made — the GC
    # tail that can outlive every tenant and host request, folded into
    # MixResult/ServingResult makespans (0.0 if GC never booked)
    last_booked_ns: float = 0.0
    # bad-block retirement (fault injection; see repro_torch.sim.faults):
    # blocks permanently removed from the pool and the surviving valid
    # pages relocated through the GC machinery on the way out
    blocks_retired: int = 0
    pages_relocated: int = 0

    @property
    def write_amplification(self) -> float:
        if self.host_pages_written == 0:
            return 1.0
        return (self.host_pages_written + self.gc_pages_copied) \
            / self.host_pages_written

    @property
    def max_erase_count(self) -> int:
        return max(self.erase_counts, default=0)

    @property
    def mean_erase_count(self) -> float:
        if not self.erase_counts:
            return 0.0
        return sum(self.erase_counts) / len(self.erase_counts)

    @property
    def wear_flatness(self) -> float:
        """Mean/max erase count: 1.0 = perfectly level wear, -> 0 as a few
        blocks absorb all erases (the metric wear-aware victim selection
        drives toward 1.0).  1.0 on a drive that never erased."""
        m = self.max_erase_count
        if m == 0:
            return 1.0
        return self.mean_erase_count / m

    def wear_histogram(self) -> Dict[int, int]:
        """erase count -> number of blocks (the wear distribution)."""
        out: Dict[int, int] = {}
        for c in self.erase_counts:
            out[c] = out.get(c, 0) + 1
        return out

    def p_during_gc(self, pct: float) -> float:
        """Host-I/O latency percentile over requests issued during GC."""
        return percentile(self.host_during_gc_ns, pct)

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "ftl_gc": self.gc_enabled,
            "victim_policy": self.victim_policy,
            "hot_cold": self.hot_cold,
            "gc_suspend": self.gc_suspend,
            "write_amp": round(self.write_amplification, 3),
            "host_pages_written": self.host_pages_written,
            "gc_pages_copied": self.gc_pages_copied,
            "gc_invocations": self.gc_invocations,
            "gc_suspensions": self.gc_suspensions,
            "blocks_erased": self.blocks_erased,
            "max_erase": self.max_erase_count,
            "wear_flatness": round(self.wear_flatness, 3),
            "io_during_gc": len(self.host_during_gc_ns),
            "io_p99_during_gc_us": self.p_during_gc(99) / 1e3,
        }
        if self.blocks_retired:
            out["blocks_retired"] = self.blocks_retired
            out["pages_relocated"] = self.pages_relocated
        return out


class SessionState(enum.Enum):
    """Terminal state of an open-loop session (:mod:`repro_torch.sim.serving`).

    ``PENDING`` is the only non-terminal state: a session still queued or
    executing when the record is inspected mid-run (a drained run leaves
    none).  The terminal states are mutually exclusive — the explicit
    enum replaces the old ``completed`` bool + NaN-p99 convention, under
    which a window where every session timed out was indistinguishable
    from one that measured nothing at all."""

    PENDING = "pending"
    COMPLETED = "completed"          # ran to completion, counted in goodput
    REJECTED = "rejected"            # bounced off the full admission backlog
    FAILED = "failed"                # an unrecoverable fault inside the run
    TIMED_OUT = "timed_out"          # exceeded the session timeout
    CANCELLED = "cancelled"          # revoked while queued (hedging twin lost)


@dataclasses.dataclass
class SessionRecord:
    """One open-loop session's lifecycle (:mod:`repro_torch.sim.serving`).

    ``latency_ns`` is arrival-to-completion — it includes time spent in
    the admission backlog, which is exactly what an open-loop client
    observes.  It is only defined for completed sessions: reading it on a
    rejected / failed / timed-out record raises instead of returning the
    nonsense negative ``-1.0 - arrival_ns`` (consumers must filter on
    :attr:`completed` first, as :attr:`ServingResult.measured_sessions`
    does).  ``measured`` marks sessions whose *arrival* falls inside the
    steady-state window (after warm-up, before cool-down)."""

    sid: int
    kind: str
    arrival_ns: float
    admit_ns: float = -1.0          # admission time (-1: never admitted)
    done_ns: float = -1.0           # end of the session's last booking
    state: SessionState = SessionState.PENDING
    measured: bool = False

    @property
    def completed(self) -> bool:
        return self.state is SessionState.COMPLETED

    @property
    def rejected(self) -> bool:
        """Back-compat view of the admission-rejection terminal state."""
        return self.state is SessionState.REJECTED

    @property
    def failed(self) -> bool:
        return self.state is SessionState.FAILED

    @property
    def timed_out(self) -> bool:
        return self.state is SessionState.TIMED_OUT

    @property
    def latency_ns(self) -> float:
        """Arrival-to-completion, including admission-queue wait."""
        if self.state is not SessionState.COMPLETED or self.done_ns < 0.0:
            raise ValueError(
                f"session {self.sid} never completed "
                f"(state={self.state.value}): latency_ns is undefined — "
                "filter on .completed before reading latencies")
        return self.done_ns - self.arrival_ns

    @property
    def queue_wait_ns(self) -> float:
        """Time spent queued for admission before a slot freed; raises
        on never-admitted (e.g. rejected) records, like latency_ns."""
        if self.admit_ns < 0.0:
            raise ValueError(
                f"session {self.sid} was never admitted "
                f"(state={self.state.value}): queue_wait_ns is undefined")
        return self.admit_ns - self.arrival_ns


@dataclasses.dataclass
class ServingResult:
    """Result of an open-loop serving run (:func:`repro_torch.sim.serving.simulate_serving`).

    Steady-state metrics are computed over the measurement window
    ``window_ns`` (arrivals after warm-up and before cool-down), so ramp-up
    and drain transients don't pollute the sustained-load numbers.
    ``mean_in_system`` is the time-averaged number of sessions between
    arrival and completion over that window — the L of Little's law;
    :meth:`little_law_ratio` checks L ≈ λ·W as a consistency law."""

    policy: str
    sessions: List[SessionRecord]
    n_offered: int                   # sessions the arrival process generated
    n_admitted: int
    n_rejected: int
    n_completed: int
    window_ns: Tuple[float, float]   # steady-state measurement window
    mean_in_system: float            # time-avg sessions in system (window)
    op_latencies_ns: List[float]     # measured sessions' per-op latencies
    utilization: Dict[str, float]    # pool -> busy fraction within window
    makespan_ns: float
    host_io: Optional[HostIOStats] = None
    session_results: Optional[List[SimResult]] = None  # per-session detail
    ftl: Optional[FTLStats] = None   # present when an FTL was configured
    # FlightRecorder when the run was invoked with telemetry=...
    telemetry: Optional[object] = None
    n_failed: int = 0                # unrecoverable fault inside the session
    n_timed_out: int = 0             # exceeded the session timeout
    # FaultStats when the run was invoked with faults=...
    faults: Optional[object] = None
    # hedged twins revoked while still queued (fleet runs only; always 0
    # for single-drive simulate_serving, which never cancels)
    n_cancelled: int = 0

    # -- conservation ---------------------------------------------------------

    @property
    def n_inflight(self) -> int:
        """Sessions with no terminal state (0 after a drained run);
        offered == completed + rejected + failed + timed-out + cancelled
        + inflight is the conservation law."""
        return (self.n_offered - self.n_completed - self.n_rejected
                - self.n_failed - self.n_timed_out - self.n_cancelled)

    # -- robustness -----------------------------------------------------------

    @property
    def availability(self) -> float:
        """Fraction of *admitted, terminal* sessions that completed
        successfully: ``completed / (completed + failed + timed-out)``.
        Rejections are admission control, not failures, and stay out of
        the denominator (they gate saturation separately).  1.0 on a run
        where nothing was admitted."""
        den = self.n_completed + self.n_failed + self.n_timed_out
        if den == 0:
            return 1.0
        return self.n_completed / den

    @property
    def goodput_per_sec(self) -> float:
        """*Successful* sessions per second inside the measurement
        window — what a degraded drive actually delivers.  Identical to
        :attr:`completed_rate_per_sec` (which only ever counts
        successfully completed sessions), named for the
        availability-aware saturation search."""
        return self.completed_rate_per_sec

    # -- steady-state window --------------------------------------------------

    @property
    def window_span_ns(self) -> float:
        lo, hi = self.window_ns
        return max(0.0, hi - lo)

    @property
    def measured_sessions(self) -> List[SessionRecord]:
        return [s for s in self.sessions if s.measured and s.completed]

    @property
    def session_latencies_ns(self) -> List[float]:
        return [s.latency_ns for s in self.measured_sessions]

    def p(self, pct: float) -> float:
        """Per-session latency percentile over the measured window."""
        return percentile(self.session_latencies_ns, pct)

    def analysis(self, git_sha: Optional[str] = None) -> Dict[str, object]:
        """The ``conduit-analysis/v1`` run report for this run's trace
        (:func:`repro_torch.sim.analysis.build_report`): tail-latency blame,
        critical path, pool bottlenecks.  Requires the run to have been
        invoked with ``telemetry=``."""
        if self.telemetry is None:
            raise ValueError(
                "no flight recorder on this result: rerun with "
                "telemetry=TelemetryConfig(...) to enable analysis")
        from repro_torch.sim.analysis import build_report
        return build_report(self.telemetry, git_sha=git_sha)

    def op_p(self, pct: float) -> float:
        """Per-op latency percentile over the measured window."""
        return percentile(self.op_latencies_ns, pct)

    @property
    def offered_rate_per_sec(self) -> float:
        """Arrival rate observed inside the measurement window."""
        span = self.window_span_ns
        if span <= 0.0:
            return 0.0
        lo, hi = self.window_ns
        n = sum(1 for s in self.sessions if lo <= s.arrival_ns <= hi)
        return n / (span / 1e9)

    @property
    def completed_rate_per_sec(self) -> float:
        """Completion throughput inside the window — the number that
        saturates below the offered rate once the drive is overloaded."""
        span = self.window_span_ns
        if span <= 0.0:
            return 0.0
        lo, hi = self.window_ns
        n = sum(1 for s in self.sessions
                if s.completed and lo <= s.done_ns <= hi)
        return n / (span / 1e9)

    # -- Little's law ---------------------------------------------------------

    def little_law_ratio(self) -> float:
        """L / (λ·W) over the measurement window — ≈1.0 on a stable run.

        λ is the measured completion rate and W the mean session latency;
        deviations come from edge sessions straddling the window and from
        the engine's lazy booking (a session's final bookings can end
        after the event that completes it)."""
        lats = self.session_latencies_ns
        if not lats or self.window_span_ns <= 0.0:
            return 1.0
        lam_per_ns = self.completed_rate_per_sec / 1e9
        w = sum(lats) / len(lats)
        lw = lam_per_ns * w
        if lw <= 0.0:
            return 1.0
        return self.mean_in_system / lw

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "policy": self.policy,
            "offered": self.n_offered,
            "completed": self.n_completed,
            "rejected": self.n_rejected,
            "failed": self.n_failed,
            "timed_out": self.n_timed_out,
            "availability": round(self.availability, 4),
            "offered_per_sec": round(self.offered_rate_per_sec, 1),
            "completed_per_sec": round(self.completed_rate_per_sec, 1),
            "session_p50_us": self.p(50) / 1e3,
            "session_p99_us": self.p(99) / 1e3,
            "op_p99_us": self.op_p(99) / 1e3,
            "mean_in_system": round(self.mean_in_system, 3),
            "little_ratio": round(self.little_law_ratio(), 3),
            "max_util": round(max(self.utilization.values(), default=0.0), 3),
        }
        if self.n_cancelled:
            out["cancelled"] = self.n_cancelled
        if self.host_io is not None:
            out.update(self.host_io.summary())
        if self.ftl is not None:
            out.update(self.ftl.summary())
        return out


@dataclasses.dataclass
class FleetSessionRecord:
    """One session's lifecycle as the *fleet* front-end saw it
    (:func:`repro_torch.sim.fleet.simulate_fleet`).

    ``drives`` is the replica set the session was routed to (one entry
    unless replicated/hedged), ``winner`` the drive whose copy reached a
    terminal state first.  ``latency_ns`` is fleet-arrival to first
    completion — under hedging that is the min over the dispatched
    copies, which is the whole point of hedging."""

    sid: int
    kind: str
    arrival_ns: float
    drives: Tuple[int, ...]
    state: SessionState = SessionState.PENDING
    done_ns: float = -1.0
    winner: int = -1                # drive that finished first (-1: none)
    measured: bool = False
    hedged: bool = False            # a duplicate copy was dispatched
    steered: bool = False           # routed away from a degraded primary

    @property
    def completed(self) -> bool:
        return self.state is SessionState.COMPLETED

    @property
    def rejected(self) -> bool:
        return self.state is SessionState.REJECTED

    @property
    def latency_ns(self) -> float:
        if self.state is not SessionState.COMPLETED or self.done_ns < 0.0:
            raise ValueError(
                f"fleet session {self.sid} never completed "
                f"(state={self.state.value}): latency_ns is undefined")
        return self.done_ns - self.arrival_ns


@dataclasses.dataclass
class FleetResult:
    """Result of a fleet serving run (:func:`repro_torch.sim.fleet.simulate_fleet`).

    ``drives`` holds one full :class:`ServingResult` per drive — the
    per-drive breakdown — while ``sessions`` carries the fleet-level
    view (one record per offered session, deduplicated across hedged
    copies).  Every fleet percentile is *sample-merged* via
    :func:`merged_percentile`: per-drive p99s are never averaged."""

    placement: str                   # placement policy name
    policy: str                      # offloading policy (run-wide)
    n_drives: int
    drives: List[ServingResult]
    sessions: List[FleetSessionRecord]
    n_offered: int
    n_fleet_rejected: int            # bounced at the fleet front door
    window_ns: Tuple[float, float]
    makespan_ns: float
    replication: int = 1
    n_hedged: int = 0                # sessions that dispatched a twin
    n_steered: int = 0               # sessions routed off a degraded primary
    n_cancelled: int = 0             # hedge twins revoked while queued
    # list of per-drive FlightRecorders (index = drive id) when the run
    # was invoked with telemetry=...; merge with
    # repro_torch.sim.telemetry.merge_fleet_trace for one Perfetto timeline
    telemetry: Optional[List[object]] = None

    # -- conservation ---------------------------------------------------------

    @property
    def n_completed(self) -> int:
        return sum(1 for s in self.sessions if s.completed)

    @property
    def n_rejected(self) -> int:
        """Sessions that terminated REJECTED — at the fleet front door
        or bounced by every replica's admission control."""
        return sum(1 for s in self.sessions if s.rejected)

    @property
    def n_failed(self) -> int:
        return sum(1 for s in self.sessions
                   if s.state is SessionState.FAILED)

    @property
    def n_timed_out(self) -> int:
        return sum(1 for s in self.sessions
                   if s.state is SessionState.TIMED_OUT)

    @property
    def n_inflight(self) -> int:
        """0 after a drained run: offered == completed + rejected +
        failed + timed-out at the fleet record level (cancels happen to
        *copies*, never to the fleet record itself)."""
        return (self.n_offered - self.n_completed - self.n_rejected
                - self.n_failed - self.n_timed_out)

    @property
    def availability(self) -> float:
        den = self.n_completed + self.n_failed + self.n_timed_out
        if den == 0:
            return 1.0
        return self.n_completed / den

    # -- sample-merged fleet percentiles --------------------------------------

    @property
    def window_span_ns(self) -> float:
        lo, hi = self.window_ns
        return max(0.0, hi - lo)

    @property
    def measured_sessions(self) -> List[FleetSessionRecord]:
        return [s for s in self.sessions if s.measured and s.completed]

    def latency_groups(self) -> List[List[float]]:
        """Measured fleet latencies grouped by winning drive — the
        per-drive sample groups the merged percentile pools.  Group
        sizes are wildly uneven under heat-aware routing or a straggler,
        which is exactly when averaging per-group p99s goes wrong."""
        groups: List[List[float]] = [[] for _ in range(self.n_drives)]
        for s in self.measured_sessions:
            groups[s.winner].append(s.latency_ns)
        return groups

    @property
    def session_latencies_ns(self) -> List[float]:
        return [s.latency_ns for s in self.measured_sessions]

    def p(self, pct: float) -> float:
        """Fleet session-latency percentile, sample-merged across
        drives (never an average of per-drive percentiles)."""
        return merged_percentile(self.latency_groups(), pct)

    def per_drive_p(self, pct: float) -> List[float]:
        """Per-drive percentile breakdown (by winning drive) — for
        straggler hunting, not for re-aggregation."""
        return [percentile(g, pct) for g in self.latency_groups()]

    @property
    def offered_rate_per_sec(self) -> float:
        span = self.window_span_ns
        if span <= 0.0:
            return 0.0
        lo, hi = self.window_ns
        n = sum(1 for s in self.sessions if lo <= s.arrival_ns <= hi)
        return n / (span / 1e9)

    @property
    def completed_rate_per_sec(self) -> float:
        """Fleet completion throughput inside the window — the fleet
        sessions/sec that the saturation search maximises."""
        span = self.window_span_ns
        if span <= 0.0:
            return 0.0
        lo, hi = self.window_ns
        n = sum(1 for s in self.sessions
                if s.completed and lo <= s.done_ns <= hi)
        return n / (span / 1e9)

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "placement": self.placement,
            "policy": self.policy,
            "drives": self.n_drives,
            "replication": self.replication,
            "offered": self.n_offered,
            "completed": self.n_completed,
            "rejected": self.n_rejected,
            "fleet_rejected": self.n_fleet_rejected,
            "failed": self.n_failed,
            "timed_out": self.n_timed_out,
            "availability": round(self.availability, 4),
            "offered_per_sec": round(self.offered_rate_per_sec, 1),
            "completed_per_sec": round(self.completed_rate_per_sec, 1),
            "fleet_p50_us": self.p(50) / 1e3,
            "fleet_p99_us": self.p(99) / 1e3,
            "per_drive_p99_us": [round(v / 1e3, 3)
                                 for v in self.per_drive_p(99)],
            "per_drive_completed": [d.n_completed for d in self.drives],
        }
        if self.n_hedged:
            out["hedged"] = self.n_hedged
            out["cancelled"] = self.n_cancelled
        if self.n_steered:
            out["steered"] = self.n_steered
        return out


def jain_fairness(values: List[float]) -> float:
    """Jain's fairness index over per-tenant slowdowns: 1.0 = perfectly
    fair, 1/n = one tenant monopolizes the fabric."""
    if not values:
        return 1.0
    num = sum(values) ** 2
    den = len(values) * sum(v * v for v in values)
    return num / den if den > 0 else 1.0


@dataclasses.dataclass
class MixResult:
    """Result of a multi-tenant run (:func:`repro_torch.sim.tenancy.simulate_mix`).

    ``tenants`` holds one :class:`SimResult` per trace (keyed by
    ``SimResult.tenant``); ``solo_makespan_ns`` the corresponding
    uncontended makespans when ``compute_solo`` was requested, enabling
    the per-tenant *slowdown* interference metric.
    """

    tenants: List[SimResult]
    solo_makespan_ns: Dict[str, float]
    host_io: Optional[HostIOStats]
    fabric_busy_ns: Dict[str, float]
    makespan_ns: float               # end of all tenants + host I/O
    ftl: Optional["FTLStats"] = None  # present when an FTL was configured
    # FlightRecorder when the run was invoked with telemetry=...
    telemetry: Optional[object] = None
    # FaultStats snapshot when the run was invoked with faults=...
    faults: Optional[object] = None

    def tenant(self, name: str) -> SimResult:
        for r in self.tenants:
            if r.tenant == name:
                return r
        raise KeyError(name)

    def analysis(self, git_sha: Optional[str] = None) -> Dict[str, object]:
        """The ``conduit-analysis/v1`` run report for this run's trace
        (:func:`repro_torch.sim.analysis.build_report`).  Requires the run to
        have been invoked with ``telemetry=``."""
        if self.telemetry is None:
            raise ValueError(
                "no flight recorder on this result: rerun with "
                "telemetry=TelemetryConfig(...) to enable analysis")
        from repro_torch.sim.analysis import build_report
        return build_report(self.telemetry, git_sha=git_sha)

    @property
    def slowdowns(self) -> Dict[str, float]:
        """Per-tenant elapsed-time inflation vs. running alone on the SSD
        (elapsed = makespan minus the tenant's arrival offset, so staggered
        arrivals compare like-for-like with their solo runs)."""
        out = {}
        for r in self.tenants:
            solo = self.solo_makespan_ns.get(r.tenant)
            if solo:
                out[r.tenant] = r.elapsed_ns / solo
        return out

    @property
    def fairness(self) -> float:
        return jain_fairness(list(self.slowdowns.values()))

    @property
    def total_energy_nj(self) -> float:
        return sum(r.total_energy_nj for r in self.tenants)

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "tenants": len(self.tenants),
            "makespan_ms": self.makespan_ns / 1e6,
            "energy_mj": self.total_energy_nj / 1e6,
            "fairness": round(self.fairness, 4),
            "slowdowns": {k: round(v, 3) for k, v in self.slowdowns.items()},
        }
        if self.host_io is not None:
            out.update(self.host_io.summary())
        if self.ftl is not None:
            out.update(self.ftl.summary())
        return out
