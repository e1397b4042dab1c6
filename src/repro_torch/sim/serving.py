"""Open-loop serving: session churn on a live event engine (§5 scaled out).

:func:`~repro_torch.sim.tenancy.simulate_mix` measures batch makespan of a fixed
tenant set; this module measures what a *serving* SSD is judged on —
sustainable session throughput at bounded tail latency.  Sessions drawn
from a :class:`~repro_torch.sim.workgen.SessionCatalog` arrive according to an
open-loop :class:`~repro_torch.sim.workgen.ArrivalProcess` and are injected into
a live :class:`~repro_torch.sim.events.EventEngine` mid-run: each admitted
session is a fresh :class:`~repro_torch.sim.machine.Simulation` bound to the
shared fabric at its arrival time, so late sessions contend with the
tail of early ones exactly as staggered tenants do in ``simulate_mix``.

Admission control bounds the open loop: at most
``ServingConfig.max_active_sessions`` sessions execute concurrently,
at most ``max_backlog`` wait in the admission queue, and arrivals beyond
both are *rejected* (counted, never silently dropped) — so overload
degrades into rejections and queueing delay instead of unbounded memory
growth.  Completed work frees a slot via the Simulation ``on_done`` hook
and the backlog drains FIFO.

Steady-state measurement trims warm-up and cool-down: only sessions
arriving inside ``[warmup_ns, last_arrival - cooldown_ns]`` count toward
the offered/completed rates, latency percentiles, the time-averaged
in-system occupancy (Little's L) and the interval utilization per
resource pool (busy-time deltas between two snapshot events at the window
edges; note the engine's lazy booking accrues busy time at decision time,
so near saturation a window's utilization can exceed 1.0).

:func:`find_saturation` bisects the arrival rate — deterministically, the
same probe sequence for the same inputs — for the maximum sustainable
sessions/sec under a p99 session-latency SLO with zero rejections: the
knee of the latency-throughput hockey stick, per offloading policy.

The drive under the sessions can be a *real* drive: passing
``ftl=FTLConfig(...)`` (with an ``io_stream`` whose writes feed it) runs
the page-mapping FTL of :mod:`repro_torch.sim.ftl` underneath the session
churn, so garbage collection contends with dispatches on the shared
die/channel pools exactly as in ``simulate_mix`` — and
:func:`find_saturation` then reports the sustainable rate of a drive
that is actively collecting.

Equivalence laws (tested): one session, no churn, no admission pressure
reproduces ``simulate_mix([trace])`` bit-for-bit, and serving without an
``ftl`` is bit-identical to the pre-FTL serving subsystem — serving is a
strict generalization of the batch entry points.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

from repro_torch.core.policies import Policy, shared_policy
from repro_torch.hw.ssd_spec import DEFAULT_SSD, SSDSpec
from repro_torch.sim.events import EventEngine, EventKind
from repro_torch.sim.ftl import FTLConfig, FTLModel
from repro_torch.sim.machine import SimConfig, Simulation
from repro_torch.sim.servers import Fabric
from repro_torch.sim.stats import ServingResult, SessionRecord, SessionState
from repro_torch.sim.telemetry import TelemetryLike
from repro_torch.sim.tenancy import HostIOStream, _HostIOModel, clone_trace
from repro_torch.sim.workgen import ArrivalProcess, PoissonArrivals, SessionCatalog

PolicyLike = Union[str, Policy]


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Admission control + steady-state measurement knobs.

    ``max_active_sessions`` is the concurrency cap (admitted sessions
    executing on the fabric); ``max_backlog`` bounds the admission queue —
    arrivals beyond both are rejected.  ``warmup_ns``/``cooldown_ns`` trim
    the measurement window at both ends of the arrival span.
    ``record_decisions`` defaults to the fast mode (serving runs dispatch
    far too many instructions to keep one DecisionRecord each);
    ``keep_session_results`` retains one :class:`SimResult` per completed
    session (disable for large saturation sweeps).  ``pool_sessions``
    recycles completed :class:`Simulation` objects per catalog entry
    (reset instead of re-cloned — the dominant per-admission allocation);
    the pooled path is bit-identical to fresh construction (tested law),
    the flag exists as an escape hatch / for the equivalence tests.

    ``little_law_warn_tol`` bounds how far the run's Little's-law
    consistency check (:meth:`~repro_torch.sim.stats.ServingResult.little_law_ratio`,
    L / λW ≈ 1.0 on a clean steady-state measurement) may drift before
    :func:`simulate_serving` emits a ``RuntimeWarning``.  Deviations come
    from window edge effects — sessions straddling the warm-up/cool-down
    trim, a window too short relative to session latency — and from the
    engine's lazy booking; the default 0.35 stays quiet on stable,
    properly-trimmed configurations while flagging windows that are
    measuring mostly transients.  Runs that probe overload on purpose
    (the saturation bisection, past-the-knee bench sweeps) suppress or
    opt out of the warning — pass ``float("inf")`` to disable it."""

    max_active_sessions: int = 8
    max_backlog: int = 64
    warmup_ns: float = 0.0
    cooldown_ns: float = 0.0
    record_decisions: bool = False
    keep_session_results: bool = True
    pool_sessions: bool = True
    little_law_warn_tol: float = 0.35
    # host-side session deadline: an admitted session still running this
    # long after admission is marked TIMED_OUT, its slot freed and the
    # backlog drained (the in-flight work is not revoked — the drive
    # finishes it; the *host* stopped waiting).  Catalog entries may
    # override per kind via CatalogEntry.timeout_ns.  None = no deadline.
    session_timeout_ns: Optional[float] = None

    def __post_init__(self) -> None:
        if self.max_active_sessions < 1:
            raise ValueError("max_active_sessions must be >= 1")
        if self.max_backlog < 0:
            raise ValueError("max_backlog must be >= 0")
        if self.warmup_ns < 0.0 or self.cooldown_ns < 0.0:
            raise ValueError("warmup_ns/cooldown_ns must be >= 0")
        if self.little_law_warn_tol <= 0.0:
            raise ValueError("little_law_warn_tol must be > 0")
        if self.session_timeout_ns is not None and self.session_timeout_ns <= 0.0:
            raise ValueError("session_timeout_ns must be > 0 (or None), "
                             f"got {self.session_timeout_ns}")


class _ServingDriver:
    """Binds catalog + arrivals to one engine/fabric and tracks sessions.

    This is the *drive-local* half of the serving loop: admission
    control, the backlog, session records, the occupancy integral and
    the window snapshots.  Who decides which sessions arrive is the
    *driver loop's* business — either the pre-scheduled arrival list of
    :func:`simulate_serving` (``plan=None``) or a fleet front-end
    (:mod:`repro_torch.sim.fleet`) injecting routed sessions one at a time
    through :meth:`submit`.  Both paths share every line below, which is
    what keeps the N=1 fleet equivalence law bit-exact."""

    def __init__(self, catalog: SessionCatalog, arrival_times: List[float],
                 policy: PolicyLike, spec: SSDSpec, cfg: SimConfig,
                 scfg: ServingConfig, fabric: Fabric, engine: EventEngine,
                 window: Optional[Tuple[float, float]] = None,
                 plan: Optional[List[tuple]] = None):
        self.catalog = catalog
        self.spec = spec
        self.cfg = cfg
        self.scfg = scfg
        self.fabric = fabric
        self.engine = engine
        self.default_policy = (shared_policy(policy, spec)
                               if isinstance(policy, str) else policy)

        self.active = 0
        # optional flight recorder (repro_torch.sim.telemetry): session spans
        self.telemetry = None
        self.backlog: Deque[int] = deque()
        self.n_rejected = 0
        self.n_admitted = 0
        self.n_completed = 0
        self.n_failed = 0
        self.n_timed_out = 0
        self.n_cancelled = 0
        # fleet seam: called (local_index, record) whenever a session
        # reaches a terminal state — None (the default) costs one branch
        self.on_terminal = None
        self.results: List = []
        self.op_latencies: List[float] = []

        # steady-state window over the arrival span; a fleet passes the
        # fleet-global window explicitly so every drive measures the same
        # steady-state span regardless of which sessions it was routed
        if window is None:
            lo = scfg.warmup_ns
            hi = max(lo, (arrival_times[-1] - scfg.cooldown_ns)
                     if arrival_times else lo)
        else:
            lo, hi = window
        self.window = (lo, hi)
        # time-averaged in-system occupancy (arrival-accepted .. done):
        # Little's L, integrated over the window only
        self._in_system = 0
        self._last_ns = 0.0
        self._area = 0.0
        # interval utilization: busy-time snapshots at the window edges
        # (scheduled before the arrivals so same-time arrivals book after
        # the opening snapshot)
        self._busy_lo: Dict[str, float] = {}
        self._busy_hi: Dict[str, float] = {}
        engine.schedule(lo, EventKind.TIMER,
                        lambda _: self._busy_lo.update(fabric.busy_ns()))
        engine.schedule(hi, EventKind.TIMER,
                        lambda _: self._busy_hi.update(fabric.busy_ns()))
        # recycled Simulation objects, keyed by catalog entry name: every
        # session of one kind shares the entry's trace/policy, so a
        # completed session's Simulation can be reset and re-admitted
        # instead of re-cloning the page table and re-allocating all the
        # per-run state (the dominant admission cost at high churn)
        self._sim_pool: Dict[str, List[Simulation]] = {}

        if plan is None:
            # one catalog draw per session, shared by the record and the
            # admission path (drawing again at admit time would double the
            # draw count and let the two diverge if a catalog were stateful)
            self.entries = [catalog.draw(i) for i in range(len(arrival_times))]
            self.records = [
                SessionRecord(sid=i, kind=e.name, arrival_ns=t,
                              measured=lo <= t <= hi)
                for i, (t, e) in enumerate(zip(arrival_times, self.entries))]
            for i, t in enumerate(arrival_times):
                engine.schedule(t, EventKind.SESSION_ARRIVAL,
                                self._on_arrival, payload=i)
        else:
            # fleet path: the placement layer drew the catalog fleet-wide
            # and routed this drive a subset — same scheduling order as
            # the default path (window snapshots first, then arrivals)
            self.entries = []
            self.records = []
            for t, entry, sid, measured in plan:
                self.submit(t, entry, sid, measured)

    # -- Little's-law occupancy integral --------------------------------------

    def _mark(self, now: float, delta: int) -> None:
        lo, hi = self.window
        seg_lo = self._last_ns if self._last_ns > lo else lo
        seg_hi = now if now < hi else hi
        if seg_hi > seg_lo:
            self._area += self._in_system * (seg_hi - seg_lo)
        if now > self._last_ns:
            self._last_ns = now
        self._in_system += delta

    # -- session lifecycle ----------------------------------------------------

    def submit(self, t_ns: float, entry, sid: int, measured: bool) -> int:
        """Fleet submit seam: enqueue one routed session arriving at
        ``t_ns``.  ``sid`` is the caller's (fleet-global) session id;
        the returned local index is what :meth:`cancel` takes.  Callable
        both at construction (the ``plan`` path) and mid-run from a
        lockstep fleet loop — the only requirement is ``t_ns >= now``."""
        i = len(self.records)
        self.entries.append(entry)
        self.records.append(SessionRecord(sid=sid, kind=entry.name,
                                          arrival_ns=t_ns,
                                          measured=measured))
        self.engine.schedule(t_ns, EventKind.SESSION_ARRIVAL,
                             self._on_arrival, payload=i)
        return i

    def cancel(self, i: int) -> bool:
        """Fleet hedging seam (cancel-on-first-win): cancel the copy at
        local index ``i`` if it is still *queued*.  Work already
        dispatched cannot be revoked — it drains on the fabric, exactly
        the session-timeout semantics — so an executing copy returns
        False and simply completes (the fleet deduplicates at its own
        record level)."""
        rec = self.records[i]
        if rec.state is not SessionState.PENDING or rec.admit_ns >= 0.0:
            return False
        try:
            self.backlog.remove(i)
        except ValueError:
            return False        # arrival not processed yet / not queued
        rec.state = SessionState.CANCELLED
        self.n_cancelled += 1
        now = self.engine.now
        self._mark(now, -1)     # a queued session was in-system
        if self.telemetry is not None:
            self.telemetry.on_session_cancel(rec.sid, rec.kind, now)
        self._terminal(i, rec)
        return True

    def _terminal(self, i: int, rec: SessionRecord) -> None:
        if self.on_terminal is not None:
            self.on_terminal(i, rec)

    def _on_arrival(self, i: int) -> None:
        now = self.engine.now
        rec = self.records[i]
        tele = self.telemetry
        if tele is not None:
            tele.on_session_arrival(rec.sid, self.entries[i].name, now)
        if self.active < self.scfg.max_active_sessions:
            self._mark(now, +1)
            self._admit(i)
        elif len(self.backlog) < self.scfg.max_backlog:
            self._mark(now, +1)             # queued sessions are in-system
            self.backlog.append(i)
        else:
            rec.state = SessionState.REJECTED
            self.n_rejected += 1
            if tele is not None:
                tele.on_session_reject(rec.sid, self.entries[i].name, now)
            self._terminal(i, rec)

    def _admit(self, i: int) -> None:
        rec = self.records[i]
        entry = self.entries[i]
        pol = (shared_policy(entry.policy, self.spec)
               if entry.policy is not None else self.default_policy)
        now = self.engine.now
        rec.admit_ns = now
        self.active += 1
        self.n_admitted += 1
        if self.telemetry is not None:
            self.telemetry.on_session_admit(rec.sid, now)
        pooled = self._sim_pool.get(entry.name)
        if pooled:
            sim = pooled.pop()
            sim.reset(f"s{rec.sid}:{entry.name}", now)
        else:
            sim = Simulation(clone_trace(entry.trace), pol, self.spec,
                             self.cfg, fabric=self.fabric,
                             tenant=f"s{rec.sid}:{entry.name}", start_ns=now)
        sim.on_done = lambda s, i=i: self._on_done(s, i)
        sim.bind(self.engine)
        timeout = (entry.timeout_ns if entry.timeout_ns is not None
                   else self.scfg.session_timeout_ns)
        if timeout is not None:
            self.engine.schedule(now + timeout, EventKind.TIMER,
                                 self._on_timeout, payload=i)

    def _on_timeout(self, i: int) -> None:
        """Host-side session deadline fired: if the session is still
        running, the host stops waiting — the slot frees and the backlog
        drains, while the in-flight work drains on the fabric (its
        completion is then a bookkeeping no-op)."""
        rec = self.records[i]
        if rec.state is not SessionState.PENDING:
            return                      # already done / failed / rejected
        rec.state = SessionState.TIMED_OUT
        self.n_timed_out += 1
        self.active -= 1
        now = self.engine.now
        self._mark(now, -1)
        if self.telemetry is not None:
            self.telemetry.on_session_timeout(rec.sid, rec.kind, now)
        self._terminal(i, rec)
        if self.backlog:
            self._admit(self.backlog.popleft())

    def _on_done(self, sim: Simulation, i: int) -> None:
        rec = self.records[i]
        rec.done_ns = sim._makespan
        if rec.state is SessionState.TIMED_OUT:
            # the host already gave up on this session: the drained work
            # only gets repooled — slot/occupancy freed at timeout time
            if self.scfg.pool_sessions:
                self._sim_pool.setdefault(
                    self.entries[i].name, []).append(sim)
            return
        if sim.failed:
            # an operand read came back unrecoverable mid-run: the
            # session drained (timing honest) but its result is garbage
            rec.state = SessionState.FAILED
            self.n_failed += 1
        else:
            rec.state = SessionState.COMPLETED
            self.n_completed += 1
        if self.telemetry is not None:
            self.telemetry.on_session_done(rec.sid, rec.kind, rec.done_ns)
        self.active -= 1
        self._mark(self.engine.now, -1)
        if rec.measured and rec.state is SessionState.COMPLETED:
            self.op_latencies.extend(sim.op_latencies)
        if self.scfg.keep_session_results:
            self.results.append(sim.result())
        self._terminal(i, rec)
        # repool AFTER every read above: reset() replaces the mutable
        # lists, so retained SimResults keep their own references
        if self.scfg.pool_sessions:
            self._sim_pool.setdefault(self.entries[i].name, []).append(sim)
        if self.backlog:
            self._admit(self.backlog.popleft())  # FIFO admission

    # -- result assembly ------------------------------------------------------

    def result(self, policy_name: str, io: Optional[_HostIOModel],
               ftl_model: Optional[FTLModel] = None) -> ServingResult:
        lo, hi = self.window
        self._mark(hi, 0)                   # close the occupancy integral
        span = hi - lo
        mean_in_system = self._area / span if span > 0.0 else 0.0
        util: Dict[str, float] = {}
        if span > 0.0 and self._busy_hi:
            units = {p.name: p.units for p in self.fabric.all_pools()}
            for name, busy in self._busy_hi.items():
                delta = busy - self._busy_lo.get(name, 0.0)
                util[name] = delta / (span * units[name])
        # the makespan is when the *drive* goes quiet, not just the last
        # session: background GC booked past the final completion (the
        # FTL tail) counts — same fold as simulate_mix.  Failed and
        # timed-out sessions drained real work, so their done times count.
        makespan = max([r.done_ns for r in self.records
                        if r.done_ns >= 0.0]
                       + ([io.last_complete_ns] if io else [])
                       + ([ftl_model.last_booked_ns]
                          if ftl_model is not None else []) + [0.0])
        fm = self.fabric.faults
        return ServingResult(
            policy=policy_name,
            sessions=self.records,
            n_offered=len(self.records),
            n_admitted=self.n_admitted,
            n_rejected=self.n_rejected,
            n_completed=self.n_completed,
            window_ns=self.window,
            mean_in_system=mean_in_system,
            op_latencies_ns=self.op_latencies,
            utilization=util,
            makespan_ns=makespan,
            host_io=io.stats() if io else None,
            session_results=(self.results
                             if self.scfg.keep_session_results else None),
            ftl=ftl_model.stats() if ftl_model is not None else None,
            n_failed=self.n_failed,
            n_timed_out=self.n_timed_out,
            faults=fm.stats() if fm is not None else None,
            n_cancelled=self.n_cancelled)


def simulate_serving(catalog: SessionCatalog,
                     arrivals: ArrivalProcess,
                     policy: PolicyLike = "conduit",
                     spec: SSDSpec = DEFAULT_SSD,
                     config: Optional[SimConfig] = None,
                     serving: Optional[ServingConfig] = None,
                     io_stream: Optional[HostIOStream] = None,
                     ftl: Optional[FTLConfig] = None,
                     engine: Optional[EventEngine] = None,
                     telemetry: TelemetryLike = None,
                     faults=None) -> ServingResult:
    """Serve an open-loop session stream on one SSD; see module docstring.

    ``policy`` is the run-wide offloading policy (catalog entries may
    override per kind); ``io_stream`` adds the same background host I/O
    as ``simulate_mix``, and ``ftl`` routes that stream's writes through
    the flash translation layer of :mod:`repro_torch.sim.ftl` (preconditioned
    via the prefill snapshot cache) so sessions churn while the drive
    collects garbage — the full production picture.  Pass a
    ``record=True`` engine to capture the event timeline.  The run always
    drains: every admitted session reaches a terminal state, so the
    conservation law ``offered == completed + rejected + failed +
    timed_out`` holds on the result (failed and timed-out sessions exist
    only under fault injection / session timeouts — see ``faults`` and
    ``ServingConfig.session_timeout_ns``).
    ``ServingConfig.record_decisions`` governs the per-session
    DecisionRecord logging even when a ``config`` is passed (serving
    admits far too many sessions to default to full logging).
    ``telemetry`` attaches a :class:`~repro_torch.sim.telemetry.FlightRecorder`
    across the engine, fabric, FTL, host-I/O model and session lifecycle;
    the recorder comes back on ``result.telemetry``.

    When the run's Little's-law consistency ratio deviates from 1.0 by
    more than ``ServingConfig.little_law_warn_tol``, a ``RuntimeWarning``
    is emitted: the steady-state numbers are then dominated by window
    edge effects and should not be trusted as sustained-load metrics."""
    scfg = serving or ServingConfig()
    cfg = dataclasses.replace(config or SimConfig(),
                              record_decisions=scfg.record_decisions)
    arrival_times = arrivals.arrival_times_ns()
    if any(t < 0 for t in arrival_times):
        raise ValueError("arrival times must be >= 0")
    if any(b < a for a, b in zip(arrival_times, arrival_times[1:])):
        raise ValueError("arrival times must be non-decreasing")
    # an over-long warmup/cooldown trim leaves a zero-length measurement
    # window: every steady-state metric (rates, percentiles, occupancy,
    # utilization) silently reads 0.0 — fail loudly at the entry point
    # instead.  Zero trim with a degenerate span (single arrival at 0.0)
    # stays legal: that is the batch-equivalence configuration.
    if arrival_times and (scfg.warmup_ns > 0.0 or scfg.cooldown_ns > 0.0):
        if arrival_times[-1] - scfg.cooldown_ns <= scfg.warmup_ns:
            raise ValueError(
                f"empty measurement window: warmup_ns={scfg.warmup_ns:g} + "
                f"cooldown_ns={scfg.cooldown_ns:g} swallow the arrival span "
                f"(last arrival at {arrival_times[-1]:g} ns) — every "
                "steady-state metric would silently read zero")

    # the whole one-drive wiring (engine, fabric, fault model, telemetry,
    # driver, FTL, host I/O) lives in DriveActor: simulate_serving IS a
    # one-actor run driven to quiescence, which is what makes the N=1
    # fleet equivalence law hold by construction rather than by parallel
    # maintenance of two wiring orders.  Lazy import: drive.py imports
    # this module for the driver/config types.
    from repro_torch.sim.drive import DriveActor
    actor = DriveActor(catalog, policy, spec, cfg, scfg,
                       arrival_times=arrival_times, io_stream=io_stream,
                       ftl=ftl, faults=faults, engine=engine,
                       telemetry=telemetry)
    actor.drain()
    res = actor.result()
    if res.session_latencies_ns:
        ratio = res.little_law_ratio()
        tol = scfg.little_law_warn_tol
        if not (abs(ratio - 1.0) <= tol):
            warnings.warn(
                f"little_law_ratio {ratio:.3f} deviates from 1.0 beyond "
                f"tolerance {tol:g}: the measurement window is dominated "
                "by edge effects (sessions straddling warmup/cooldown, or "
                "a window short relative to session latency) — widen the "
                "window before trusting the steady-state metrics",
                RuntimeWarning, stacklevel=2)
    return res


# -- saturation-point finder ---------------------------------------------------

@dataclasses.dataclass
class SaturationProbe:
    """One bisection probe: the serving run at one offered rate.

    ``completed_rate_per_sec`` is the *goodput* — only sessions that ran
    to completion count, so under fault injection it diverges from the
    admitted rate.  ``p99_ns`` is NaN when no session latency could be
    measured (every in-window arrival bounced, failed or timed out);
    ``availability`` then carries the verdict instead."""

    rate_per_sec: float
    p99_ns: float
    n_rejected: int
    completed_rate_per_sec: float
    sustainable: bool
    availability: float = 1.0        # completed / (completed+failed+timed out)
    n_failed: int = 0
    n_timed_out: int = 0


@dataclasses.dataclass
class SaturationResult:
    """Output of :func:`find_saturation` for one policy.

    ``rate_per_sec`` is the highest probed rate that met the SLO with
    zero rejections (0.0 if even ``rate_lo`` was unsustainable);
    ``bracket`` is the final (sustainable, unsustainable) rate pair the
    bisection narrowed to."""

    policy: str
    slo_p99_ns: float
    rate_per_sec: float
    bracket: Tuple[float, float]
    probes: List[SaturationProbe]

    def summary(self) -> Dict[str, object]:
        return {
            "policy": self.policy,
            "slo_p99_us": self.slo_p99_ns / 1e3,
            "saturation_per_sec": round(self.rate_per_sec, 1),
            "bracket_per_sec": (round(self.bracket[0], 1),
                                round(self.bracket[1], 1)),
            "probes": len(self.probes),
        }


def _saturation_probe(catalog: SessionCatalog, base: ArrivalProcess,
                      policy: PolicyLike, rate: float, slo_p99_ns: float,
                      scfg: ServingConfig, spec: SSDSpec,
                      config: Optional[SimConfig],
                      io_stream: Optional[HostIOStream],
                      ftl: Optional[FTLConfig],
                      probes: List[SaturationProbe],
                      faults=None,
                      min_availability: float = 1.0) -> bool:
    """One bisection probe: serve ``base.at_rate(rate)``, append the
    :class:`SaturationProbe`, return sustainability.  Shared verbatim by
    :func:`find_saturation` and the batched lockstep search in
    :mod:`repro_torch.sim.sweep` so the two can never drift apart."""
    # the bisection probes unsustainable rates on purpose: past the knee
    # the Little's-law ratio always degrades, so the edge-effect warning
    # carries no information here — sustainability is judged on
    # rejections, availability and the p99 directly
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="little_law_ratio",
                                category=RuntimeWarning)
        res = simulate_serving(catalog, base.at_rate(rate), policy,
                               spec=spec, config=config, serving=scfg,
                               io_stream=io_stream, ftl=ftl, faults=faults)
    avail = res.availability
    # a measured-but-uncompleted window (every session failed/timed out/
    # bounced) is a legitimate *unsustainable* verdict — distinguish it
    # via the session terminal states instead of the old NaN-p99-only
    # convention; p99 stays NaN when nothing completed in-window
    p99 = res.p(99) if res.session_latencies_ns else float("nan")
    if res.n_rejected > 0:
        # rejections alone prove the rate unsustainable — even when
        # every in-window arrival bounced and no latency was measured
        # (then there is no p99 to report: record NaN, not the
        # empty-percentile 0.0 that would masquerade as a great tail)
        probes.append(SaturationProbe(
            rate, p99, res.n_rejected, res.completed_rate_per_sec, False,
            availability=avail, n_failed=res.n_failed,
            n_timed_out=res.n_timed_out))
        return False
    if not any(s.measured for s in res.sessions):
        raise ValueError(
            f"no measured sessions at rate {rate:.1f}/s: warmup/cooldown "
            f"trim ({scfg.warmup_ns:.0f}+{scfg.cooldown_ns:.0f} ns) "
            "swallows the arrival span — an empty window would make "
            "every rate look sustainable")
    ok = (avail >= min_availability
          and bool(res.session_latencies_ns) and p99 <= slo_p99_ns)
    probes.append(SaturationProbe(rate, p99, 0,
                                  res.completed_rate_per_sec, ok,
                                  availability=avail, n_failed=res.n_failed,
                                  n_timed_out=res.n_timed_out))
    return ok


def find_saturation(catalog: SessionCatalog,
                    policy: PolicyLike,
                    slo_p99_ns: float,
                    rate_lo: float,
                    rate_hi: float,
                    base_process: Optional[ArrivalProcess] = None,
                    iters: int = 6,
                    n_sessions: int = 64,
                    seed: int = 0xA117,
                    spec: SSDSpec = DEFAULT_SSD,
                    config: Optional[SimConfig] = None,
                    serving: Optional[ServingConfig] = None,
                    io_stream: Optional[HostIOStream] = None,
                    ftl: Optional[FTLConfig] = None,
                    faults=None,
                    min_availability: float = 1.0
                    ) -> SaturationResult:
    """Bisect the offered rate for the max sustainable sessions/sec.

    A rate is *sustainable* iff the serving run rejects nothing and its
    measured p99 session latency meets ``slo_p99_ns``.  The bisection is
    deterministic: probes are a pure function of the inputs (the arrival
    process is rescaled via ``at_rate``, preserving seed and shape), so
    repeated calls — and parallel benchmark workers — produce identical
    results.  ``base_process`` defaults to Poisson arrivals with
    ``n_sessions``/``seed``; pass an MMPP or replay process to find the
    saturation point under bursty traffic instead.  ``ftl`` (with an
    ``io_stream`` whose writes drive the collector) finds the saturation
    point of a drive that is actively collecting garbage — GC steals
    sustainable session throughput, measurably.

    ``faults`` threads a :class:`~repro_torch.sim.faults.FaultConfig` through
    every probe, and sustainability then additionally requires
    ``availability >= min_availability`` — the bisection reports the max
    rate at which the drive still delivers its *goodput* SLO while
    walking recovery ladders and retiring blocks."""
    if rate_lo <= 0.0 or rate_hi <= rate_lo:
        raise ValueError("need 0 < rate_lo < rate_hi")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    if not 0.0 < min_availability <= 1.0:
        raise ValueError(
            f"min_availability must be in (0, 1], got {min_availability}")
    base = base_process or PoissonArrivals(rate_per_sec=rate_lo,
                                           n_sessions=n_sessions, seed=seed)
    scfg = serving or ServingConfig(keep_session_results=False)
    probes: List[SaturationProbe] = []

    def probe(rate: float) -> bool:
        return _saturation_probe(catalog, base, policy, rate, slo_p99_ns,
                                 scfg, spec, config, io_stream, ftl, probes,
                                 faults=faults,
                                 min_availability=min_availability)

    name = policy if isinstance(policy, str) else policy.name
    if not probe(rate_lo):
        return SaturationResult(name, slo_p99_ns, 0.0, (0.0, rate_lo), probes)
    if probe(rate_hi):
        return SaturationResult(name, slo_p99_ns, rate_hi,
                                (rate_hi, rate_hi), probes)
    lo, hi = rate_lo, rate_hi
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if probe(mid):
            lo = mid
        else:
            hi = mid
    return SaturationResult(name, slo_p99_ns, lo, (lo, hi), probes)
