"""Rack-scale fleet serving: N drive actors behind a placement layer.

:func:`simulate_fleet` serves one open-loop session stream on a fleet of
:class:`~repro_torch.sim.drive.DriveActor` drives.  The fleet front-end owns
nothing drive-local: it draws the catalog fleet-wide, routes each
session through a :mod:`repro_torch.sim.placement` policy, and talks to the
drives only through the three actor seams (submit / poll / advance).

Two driver regimes, chosen automatically:

* **static** — placement independent of load (hash / consistent-hash,
  no steering, no hedging, no fleet admission cap, no retirement).  The
  session stream pre-partitions into per-drive plans and every drive
  runs to quiescence independently: embarrassingly parallel, and for
  N=1 *bit-identical* to :func:`~repro_torch.sim.serving.simulate_serving`
  (the tested equivalence law — both are one DriveActor built the same
  way).
* **lockstep** — anything load- or time-dependent.  The fleet walks the
  arrival sequence, advances every drive's engine to just before each
  arrival (:meth:`~repro_torch.sim.drive.DriveActor.advance_before`), reads
  health snapshots, and routes on them.  With hedging on, engines are
  interleaved in global event-time order so a win on one drive can
  cancel the still-queued twin on another before that drive's clock
  passes the cancel instant.

Fleet mechanisms layered on the route order (any placement policy):

* **read steering** (``FleetConfig.steering``) — stable-partition the
  replica preference order so drives that are collecting, recovering,
  degraded (read-only / failed dies) or retired sink to the back.
* **hedging** (``FleetConfig.hedging``) — dispatch the session to the
  two best replicas; first completion wins, the loser's *queued* copy is
  cancelled (cancel-on-first-win), an executing copy drains like a
  timed-out session's in-flight work.
* **fleet admission** (``FleetConfig.max_inflight``) — backpressure at
  the front door: arrivals beyond the fleet-wide in-flight cap are
  rejected before touching any drive.
* **retirement + rebuild** (``FleetConfig.retire``) — at a set instant
  one drive stops accepting sessions; the survivors each pick up a
  rebuild read stream (the reconstruction traffic) as a background
  tenant while placement routes the retiree's sessions to its replicas.

Fleet percentiles are *sample-merged* across drives
(:func:`repro_torch.sim.stats.merged_percentile`) — never averages of
per-drive percentiles.  :func:`find_fleet_saturation` bisects fleet
sessions/sec at a fleet p99 SLO exactly as
:func:`~repro_torch.sim.serving.find_saturation` does for one drive.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.hw.ssd_spec import DEFAULT_SSD, SSDSpec
from repro_torch.sim.drive import DriveActor
from repro_torch.sim.ftl import FTLConfig
from repro_torch.sim.machine import SimConfig
from repro_torch.sim.placement import (PlacementPolicy, derive_drive_seed,
                                 make_placement)
from repro_torch.sim.serving import (PolicyLike, SaturationProbe,
                               SaturationResult, ServingConfig)
from repro_torch.sim.stats import (FleetResult, FleetSessionRecord, SessionState)
from repro_torch.sim.telemetry import FlightRecorder, TelemetryLike
from repro_torch.sim.tenancy import HostIOStream
from repro_torch.sim.workgen import ArrivalProcess, SessionCatalog


@dataclasses.dataclass(frozen=True)
class DriveProfile:
    """Per-drive overrides — the straggler knob.

    A profile's fields replace the fleet-wide template *verbatim* (no
    reseeding), so a straggler scenario can hand drive 0 a write-heavy
    io_stream + tight FTL while the rest of the fleet derives its
    streams from the fleet seed as usual."""

    io_stream: Optional[HostIOStream] = None
    ftl: Optional[FTLConfig] = None
    faults: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet topology + routing mechanisms; see the module docstring.

    ``retire`` is ``(drive, t_ns)``: at ``t_ns`` the drive stops taking
    sessions and each survivor picks up a rebuild read stream of
    ``rebuild_read_iops / (n_drives - 1)`` IOPS (chained declustering
    spreads reconstruction, it does not double one mirror's load)."""

    n_drives: int = 4
    placement: object = "hash"       # registry name or PlacementPolicy
    replication: int = 1
    steering: bool = False
    hedging: bool = False
    max_inflight: Optional[int] = None
    retire: Optional[Tuple[int, float]] = None
    rebuild_read_iops: float = 20_000.0
    rebuild_reads: int = 128
    profiles: Tuple[Tuple[int, DriveProfile], ...] = ()

    def __post_init__(self) -> None:
        if self.n_drives < 1:
            raise ValueError("n_drives must be >= 1")
        if self.replication < 1:
            raise ValueError("replication must be >= 1")
        if self.replication > self.n_drives:
            raise ValueError(
                f"replication {self.replication} exceeds n_drives "
                f"{self.n_drives}")
        if self.hedging and self.replication < 2:
            raise ValueError("hedging needs replication >= 2 "
                             "(a twin requires a second replica)")
        if self.steering and self.replication < 2:
            raise ValueError("read steering needs replication >= 2 "
                             "(nowhere to steer with one copy)")
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1 (or None)")
        if self.retire is not None:
            d, t = self.retire
            if not (0 <= d < self.n_drives) or t < 0.0:
                raise ValueError(
                    f"retire=({d}, {t}) needs a valid drive and t_ns >= 0")
            if self.n_drives < 2:
                raise ValueError("cannot retire the only drive")
        seen = set()
        for d, _p in self.profiles:
            if not 0 <= d < self.n_drives or d in seen:
                raise ValueError(f"profiles names invalid/duplicate drive {d}")
            seen.add(d)

    def profile(self, d: int) -> Optional[DriveProfile]:
        for k, p in self.profiles:
            if k == d:
                return p
        return None


def _available(h) -> bool:
    """Steering predicate: fit to serve a read right now."""
    return not (h.retired or h.gc_busy or h.recovering
                or h.read_only_dies or h.failed_dies)


def _advance_all(actors: List[DriveActor], t: float,
                 interleaved: bool) -> None:
    """Advance every drive's engine to just before ``t``.

    ``interleaved`` (hedging on) processes the engines in global
    event-time order — one timestamp cluster at a time, ties broken by
    drive id — so a completion on one drive schedules its twin's cancel
    *before* the twin's engine runs past the cancel instant.  Without
    cross-drive messages the per-drive order is free and each engine
    just runs ahead independently."""
    if not interleaved:
        for a in actors:
            a.advance_before(t)
        return
    while True:
        tn, best = None, None
        for a in actors:
            nt = a.engine.next_time()
            if nt is not None and nt < t and (tn is None or nt < tn):
                tn, best = nt, a
        if best is None:
            return
        best.engine.run(until=tn)


def simulate_fleet(catalog: SessionCatalog,
                   arrivals: ArrivalProcess,
                   policy: PolicyLike = "conduit",
                   spec: SSDSpec = DEFAULT_SSD,
                   config: Optional[SimConfig] = None,
                   serving: Optional[ServingConfig] = None,
                   fleet: Optional[FleetConfig] = None,
                   io_stream: Optional[HostIOStream] = None,
                   ftl: Optional[FTLConfig] = None,
                   faults=None,
                   telemetry: TelemetryLike = None) -> FleetResult:
    """Serve an open-loop session stream on an N-drive fleet.

    ``io_stream`` / ``faults`` are fleet-wide *templates*: each drive
    derives its own seed via :func:`~repro_torch.sim.placement.derive_drive_seed`
    (distinct draws per drive, drive 0 identical to the template — the
    N=1 law).  ``ftl`` configs are stateless and shared.  Per-drive
    overrides come from ``FleetConfig.profiles``.

    ``telemetry`` may be ``True`` or a ``TelemetryConfig`` — each drive
    gets its *own* FlightRecorder (returned as ``result.telemetry``, a
    list indexed by drive id; merge with
    :func:`repro_torch.sim.telemetry.merge_fleet_trace`).  Passing one
    FlightRecorder instance is rejected: a recorder records one engine.
    """
    fcfg = fleet or FleetConfig()
    scfg = serving or ServingConfig()
    cfg = dataclasses.replace(config or SimConfig(),
                              record_decisions=scfg.record_decisions)
    if isinstance(telemetry, FlightRecorder):
        raise ValueError(
            "simulate_fleet needs one recorder per drive: pass "
            "telemetry=TelemetryConfig(...) (or True) and read the "
            "per-drive recorders off result.telemetry")
    arrival_times = arrivals.arrival_times_ns()
    if any(t < 0 for t in arrival_times):
        raise ValueError("arrival times must be >= 0")
    if any(b < a for a, b in zip(arrival_times, arrival_times[1:])):
        raise ValueError("arrival times must be non-decreasing")
    if arrival_times and (scfg.warmup_ns > 0.0 or scfg.cooldown_ns > 0.0):
        if arrival_times[-1] - scfg.cooldown_ns <= scfg.warmup_ns:
            raise ValueError(
                "empty measurement window: warmup/cooldown swallow the "
                "arrival span — every steady-state metric would read zero")

    placement = make_placement(fcfg.placement, fcfg.n_drives)
    n = fcfg.n_drives
    lo = scfg.warmup_ns
    hi = max(lo, (arrival_times[-1] - scfg.cooldown_ns)
             if arrival_times else lo)
    window = (lo, hi)

    # fleet-wide catalog draw: one entry per offered session, identical
    # to the per-drive draw of simulate_serving when N=1
    entries = [catalog.draw(i) for i in range(len(arrival_times))]
    frecs = [FleetSessionRecord(sid=i, kind=e.name, arrival_ns=t,
                                drives=(), measured=lo <= t <= hi)
             for i, (t, e) in enumerate(zip(arrival_times, entries))]

    static = (not placement.needs_health and not fcfg.steering
              and not fcfg.hedging and fcfg.max_inflight is None
              and fcfg.retire is None)

    # -- per-drive wiring (derived RNG lineages, profile overrides) ----------
    def drive_args(d: int):
        prof = fcfg.profile(d)
        io_d = prof.io_stream if prof is not None and \
            prof.io_stream is not None else (
                dataclasses.replace(
                    io_stream, seed=derive_drive_seed(io_stream.seed, d))
                if io_stream is not None else None)
        ftl_d = prof.ftl if prof is not None and prof.ftl is not None \
            else ftl
        if prof is not None and prof.faults is not None:
            faults_d = prof.faults
        elif faults is None or d == 0:
            # drive 0 keeps the template verbatim — the N=1 identity;
            # salt=1 keeps later drives' fault draws uncorrelated with
            # their io-stream draws even when the template seeds match
            faults_d = faults
        else:
            faults_d = dataclasses.replace(
                faults, seed=derive_drive_seed(faults.seed, d, salt=1))
        return io_d, ftl_d, faults_d

    # -- routing (shared by both regimes) ------------------------------------
    def route_for(sid: int, health) -> Tuple[Tuple[int, ...],
                                             Tuple[int, ...]]:
        replicas = placement.replicas(sid, fcfg.replication)
        order = list(placement.route(
            sid, replicas, health if placement.needs_health else None))
        if fcfg.steering and health is not None:
            # stable partition: available drives first, stragglers last
            order = ([d for d in order if _available(health[d])]
                     + [d for d in order if not _available(health[d])])
        order = [d for d in order if health is None
                 or not health[d].retired]
        return replicas, tuple(order)

    if static:
        # pre-partition the arrival stream into per-drive plans; each
        # drive then runs to quiescence independently (no cross-drive
        # messages exist in this regime)
        plans: List[List[tuple]] = [[] for _ in range(n)]
        for i, t in enumerate(arrival_times):
            replicas, order = route_for(i, None)
            frecs[i].drives = replicas
            plans[order[0]].append((t, entries[i], i, frecs[i].measured))
        actors = []
        for d in range(n):
            io_d, ftl_d, faults_d = drive_args(d)
            actors.append(DriveActor(
                catalog, policy, spec, cfg, scfg, plan=plans[d],
                window=window, io_stream=io_d, ftl=ftl_d, faults=faults_d,
                telemetry=telemetry, drive_id=d,
                entry_name="simulate_fleet"))
        for a in actors:
            a.drain()
        copies: Dict[int, List[Tuple[int, int]]] = {}
        for d, a in enumerate(actors):
            for i, rec in enumerate(a.driver.records):
                copies.setdefault(rec.sid, []).append((d, i))
        n_fleet_rejected = 0
    else:
        actors = []
        for d in range(n):
            io_d, ftl_d, faults_d = drive_args(d)
            actors.append(DriveActor(
                catalog, policy, spec, cfg, scfg, plan=[],
                window=window, io_stream=io_d, ftl=ftl_d, faults=faults_d,
                telemetry=telemetry, drive_id=d,
                entry_name="simulate_fleet"))

        copies = {}
        won: Dict[int, float] = {}
        inflight = {"n": 0}
        terminal_copies: Dict[int, int] = {}

        def on_term(drive: int, rec) -> None:
            sid = rec.sid
            nc = len(copies.get(sid, ()))
            terminal_copies[sid] = terminal_copies.get(sid, 0) + 1
            if rec.state is SessionState.COMPLETED:
                if sid not in won:
                    won[sid] = rec.done_ns
                    inflight["n"] -= 1
                    # cancel-on-first-win: revoke still-queued twins at
                    # the winner's completion instant (drive time)
                    for d2, i2 in copies.get(sid, ()):
                        if d2 != drive:
                            actors[d2].schedule_cancel(i2, rec.done_ns)
            elif sid not in won and terminal_copies[sid] == nc:
                inflight["n"] -= 1        # every copy ended without a win

        for a in actors:
            a.on_session_terminal = on_term

        retire_pending = fcfg.retire

        def maybe_retire(t: float) -> None:
            nonlocal retire_pending
            if retire_pending is None or t < retire_pending[1]:
                return
            rd, rt = retire_pending
            retire_pending = None
            _advance_all(actors, rt, fcfg.hedging)
            actors[rd].retire()
            # rebuild as a fleet-level background tenant: survivors
            # serve the reconstruction reads of the retiree's share
            survivors = [d for d in range(n) if d != rd]
            for d in survivors:
                actors[d].add_io_stream(HostIOStream(
                    rate_iops=fcfg.rebuild_read_iops / len(survivors),
                    read_fraction=1.0,
                    n_requests=max(1, fcfg.rebuild_reads // len(survivors)),
                    seed=derive_drive_seed(catalog.seed, d, salt=2),
                    start_ns=rt))

        for i, t in enumerate(arrival_times):
            maybe_retire(t)
            _advance_all(actors, t, fcfg.hedging)
            need_health = (placement.needs_health or fcfg.steering
                           or fcfg.retire is not None)
            health = ({d: actors[d].health() for d in range(n)}
                      if need_health else None)
            replicas, order = route_for(i, health)
            frecs[i].drives = replicas
            if not order:
                frecs[i].state = SessionState.REJECTED
                continue
            if (fcfg.max_inflight is not None
                    and inflight["n"] >= fcfg.max_inflight):
                # fleet front-door backpressure: never touches a drive
                frecs[i].state = SessionState.REJECTED
                continue
            targets = (order[:2] if fcfg.hedging and len(order) >= 2
                       else order[:1])
            frecs[i].steered = targets[0] != replicas[0]
            frecs[i].hedged = len(targets) > 1
            sid_copies = copies.setdefault(i, [])
            for d in targets:
                sid_copies.append((d, actors[d].submit(
                    t, entries[i], i, frecs[i].measured)))
            inflight["n"] += 1
        maybe_retire(math.inf)
        _advance_all(actors, math.inf, fcfg.hedging)
        for a in actors:
            a.drain()                     # no-op unless stragglers remain
        n_fleet_rejected = sum(1 for r in frecs
                               if r.rejected and r.sid not in copies)

    # -- fleet record resolution (shared) ------------------------------------
    for frec in frecs:
        if frec.state is not SessionState.PENDING:
            continue
        recs = [(d, actors[d].driver.records[i])
                for d, i in copies.get(frec.sid, ())]
        done = [(r.done_ns, d) for d, r in recs
                if r.state is SessionState.COMPLETED]
        if done:
            frec.done_ns, frec.winner = min(done)
            frec.state = SessionState.COMPLETED
        elif any(r.state is SessionState.FAILED for _, r in recs):
            frec.state = SessionState.FAILED
        elif any(r.state is SessionState.TIMED_OUT for _, r in recs):
            frec.state = SessionState.TIMED_OUT
        else:
            frec.state = SessionState.REJECTED

    results = [a.result() for a in actors]
    recorders = [a.telemetry for a in actors]
    if any(r is not None for r in recorders):
        for d, r in enumerate(recorders):
            if r is not None:
                r.run_meta.setdefault("drive", d)
                r.run_meta.setdefault("n_drives", n)
    else:
        recorders = None
    return FleetResult(
        placement=placement.name,
        policy=policy if isinstance(policy, str) else policy.name,
        n_drives=n,
        drives=results,
        sessions=frecs,
        n_offered=len(frecs),
        n_fleet_rejected=n_fleet_rejected,
        window_ns=window,
        makespan_ns=max([r.makespan_ns for r in results] + [0.0]),
        replication=fcfg.replication,
        n_hedged=sum(1 for r in frecs if r.hedged),
        n_steered=sum(1 for r in frecs if r.steered),
        n_cancelled=sum(r.n_cancelled for r in results),
        telemetry=recorders)


# -- fleet saturation ----------------------------------------------------------

def _fleet_saturation_probe(catalog: SessionCatalog, base: ArrivalProcess,
                            policy: PolicyLike, rate: float,
                            slo_p99_ns: float, scfg: ServingConfig,
                            fcfg: FleetConfig, spec: SSDSpec,
                            config: Optional[SimConfig],
                            io_stream: Optional[HostIOStream],
                            ftl: Optional[FTLConfig],
                            probes: List[SaturationProbe],
                            faults=None,
                            min_availability: float = 1.0) -> bool:
    """One fleet bisection probe; shared verbatim by
    :func:`find_fleet_saturation` and the batched lockstep search in
    :mod:`repro_torch.sim.sweep`.  Sustainable iff nothing was rejected —
    neither at the fleet front door nor by any drive's admission
    control — availability holds, and the *sample-merged* fleet p99
    meets the SLO."""
    res = simulate_fleet(catalog, base.at_rate(rate), policy, spec=spec,
                         config=config, serving=scfg, fleet=fcfg,
                         io_stream=io_stream, ftl=ftl, faults=faults)
    n_rej = res.n_rejected + sum(d.n_rejected for d in res.drives)
    avail = res.availability
    lats = res.session_latencies_ns
    if n_rej > 0 and not lats:
        probes.append(SaturationProbe(
            rate_per_sec=rate, p99_ns=float("nan"), n_rejected=n_rej,
            completed_rate_per_sec=res.completed_rate_per_sec,
            sustainable=False, availability=avail,
            n_failed=res.n_failed, n_timed_out=res.n_timed_out))
        return False
    if not res.measured_sessions and res.n_failed == 0 \
            and res.n_timed_out == 0 and n_rej == 0:
        raise ValueError(
            "no measured sessions at probe rate "
            f"{rate:g}/s: widen the warmup/cooldown window")
    p99 = res.p(99) if lats else float("nan")
    ok = (n_rej == 0 and avail >= min_availability
          and bool(lats) and p99 <= slo_p99_ns)
    probes.append(SaturationProbe(
        rate_per_sec=rate, p99_ns=p99, n_rejected=n_rej,
        completed_rate_per_sec=res.completed_rate_per_sec,
        sustainable=ok, availability=avail,
        n_failed=res.n_failed, n_timed_out=res.n_timed_out))
    return ok


def find_fleet_saturation(catalog: SessionCatalog,
                          base_arrivals: ArrivalProcess,
                          policy: PolicyLike = "conduit",
                          slo_p99_ns: float = 2_000_000.0,
                          rate_lo: float = 50.0,
                          rate_hi: float = 5_000.0,
                          iters: int = 6,
                          spec: SSDSpec = DEFAULT_SSD,
                          config: Optional[SimConfig] = None,
                          serving: Optional[ServingConfig] = None,
                          fleet: Optional[FleetConfig] = None,
                          io_stream: Optional[HostIOStream] = None,
                          ftl: Optional[FTLConfig] = None,
                          faults=None,
                          min_availability: float = 1.0
                          ) -> SaturationResult:
    """Max sustainable *fleet* sessions/sec under a fleet-p99 SLO.

    The single-drive bisection of
    :func:`~repro_torch.sim.serving.find_saturation`, generalized: the probe
    judges the sample-merged fleet p99 and rejections anywhere in the
    fleet (front door or any drive).  Deterministic for fixed inputs."""
    if rate_lo <= 0.0 or rate_hi <= rate_lo:
        raise ValueError("need 0 < rate_lo < rate_hi")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    scfg = serving or ServingConfig()
    fcfg = fleet or FleetConfig()
    probes: List[SaturationProbe] = []

    def probe(rate: float) -> bool:
        return _fleet_saturation_probe(
            catalog, base_arrivals, policy, rate, slo_p99_ns, scfg, fcfg,
            spec, config, io_stream, ftl, probes, faults=faults,
            min_availability=min_availability)

    name = "{}[{}x{}]".format(
        policy if isinstance(policy, str) else policy.name,
        make_placement(fcfg.placement, fcfg.n_drives).name, fcfg.n_drives)
    if not probe(rate_lo):
        return SaturationResult(policy=name, slo_p99_ns=slo_p99_ns,
                                rate_per_sec=0.0,
                                bracket=(0.0, rate_lo), probes=probes)
    if probe(rate_hi):
        return SaturationResult(policy=name, slo_p99_ns=slo_p99_ns,
                                rate_per_sec=rate_hi,
                                bracket=(rate_hi, rate_hi), probes=probes)
    lo_r, hi_r = rate_lo, rate_hi
    for _ in range(iters):
        mid = 0.5 * (lo_r + hi_r)
        if probe(mid):
            lo_r = mid
        else:
            hi_r = mid
    return SaturationResult(policy=name, slo_p99_ns=slo_p99_ns,
                            rate_per_sec=lo_r, bracket=(lo_r, hi_r),
                            probes=probes)
