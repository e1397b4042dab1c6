"""Drive-as-actor: one SSD behind three seams (ISSUE 10 tentpole).

A :class:`DriveActor` owns everything that used to be wired inline in
:func:`repro_torch.sim.serving.simulate_serving` — one
:class:`~repro_torch.sim.events.EventEngine`, one
:class:`~repro_torch.sim.servers.Fabric`, optionally an FTL
(:mod:`repro_torch.sim.ftl`), a fault model (:mod:`repro_torch.sim.faults`), a host
I/O stream and the serving loop — and exposes exactly three message
points to whoever drives it:

* **submit** (:meth:`DriveActor.submit`): inject one session arriving at
  a future instant.  Returns a local index usable for
  :meth:`schedule_cancel` (hedging's cancel-on-first-win).
* **poll** (:meth:`DriveActor.poll`): drain completions that terminated
  since the last poll, plus a :class:`DriveHealth` snapshot (GC
  activity, read-only/failed dies, recovery windows, queue depths) — the
  signals a placement layer steers on.
* **advance-to-time** (:meth:`DriveActor.advance_before`): process this
  drive's events strictly before ``t`` and stop.  A fleet loop
  (:mod:`repro_torch.sim.fleet`) alternates advance/submit across N actors in
  arrival order, which is time-accurate: no actor's clock passes an
  arrival that could still be routed to it.

Nothing *inside* the seams changed: the actor's constructor performs the
same wiring, in the same order, as ``simulate_serving`` always did — in
fact ``simulate_serving`` is now implemented as a one-actor run driven
to quiescence, so the N=1 fleet equivalence law
(``tests/test_fleet.py``) holds by construction: a 1-drive fleet under
hash placement and a plain serving run execute literally the same code.

Actors never share state.  Each owns a private engine/fabric/FTL/fault
model and a private RNG lineage
(:func:`repro_torch.sim.placement.derive_drive_seed`), so a fleet is
embarrassingly parallel in the static-placement regime and lockstep-
deterministic in the dynamic one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from repro_torch.hw.ssd_spec import SSDSpec
from repro_torch.sim.events import EventEngine, EventKind
from repro_torch.sim.ftl import FTLConfig
from repro_torch.sim.machine import SimConfig
from repro_torch.sim.servers import Fabric
from repro_torch.sim.serving import PolicyLike, ServingConfig, _ServingDriver
from repro_torch.sim.stats import ServingResult, SessionRecord
from repro_torch.sim.telemetry import TelemetryLike, as_recorder
from repro_torch.sim.tenancy import (HostIOStream, _HostIOModel, build_ftl_model)
from repro_torch.sim.workgen import SessionCatalog


@dataclasses.dataclass(frozen=True)
class DriveHealth:
    """Point-in-time health snapshot — what :meth:`DriveActor.poll`
    reports and what read steering / heat-aware placement consume.

    ``recovering`` means at least one die sits inside a fault-recovery
    window (read-retry ladder / relocation in progress); ``retired``
    drives accept no new sessions (fleet-level rebuild is routing their
    load elsewhere)."""

    drive_id: int
    t_ns: float
    active: int                      # admitted sessions executing now
    backlog: int                     # sessions queued for admission
    gc_busy: bool                    # any die currently collecting
    gc_active_dies: int
    read_only_dies: int
    failed_dies: int
    recovering: bool
    retired: bool

    @property
    def inflight(self) -> int:
        return self.active + self.backlog

    @property
    def healthy(self) -> bool:
        """Fit to take unsteered traffic: not retired, not collecting,
        not recovering, no degraded dies."""
        return not (self.retired or self.gc_busy or self.recovering
                    or self.read_only_dies or self.failed_dies)


@dataclasses.dataclass(frozen=True)
class DrivePoll:
    """One :meth:`DriveActor.poll` result: completions since the last
    poll (terminal :class:`~repro_torch.sim.stats.SessionRecord` objects, in
    termination order) plus the health snapshot at poll time."""

    completions: Tuple[SessionRecord, ...]
    health: DriveHealth


class DriveActor:
    """One SSD as an actor; see the module docstring for the seams.

    The constructor is the former body of ``simulate_serving`` verbatim
    (engine → fabric → fault model → telemetry attach → serving driver →
    FTL → host I/O → telemetry attach) — do not reorder it, the golden
    digest suites pin the resulting event interleavings bit-for-bit.

    Exactly one of ``arrival_times`` (self-scheduled, the single-drive
    entry point) or ``plan``/neither (fleet-routed) is the intended use;
    a fleet passes ``window`` explicitly so every drive measures the
    same fleet-global steady-state span."""

    def __init__(self, catalog: SessionCatalog, policy: PolicyLike,
                 spec: SSDSpec, cfg: SimConfig, scfg: ServingConfig,
                 arrival_times: Optional[List[float]] = None,
                 plan: Optional[List[tuple]] = None,
                 window: Optional[Tuple[float, float]] = None,
                 io_stream: Optional[HostIOStream] = None,
                 ftl: Optional[FTLConfig] = None,
                 faults=None,
                 engine: Optional[EventEngine] = None,
                 telemetry: TelemetryLike = None,
                 drive_id: int = 0,
                 entry_name: str = "simulate_serving"):
        self.drive_id = drive_id
        self.spec = spec
        self.cfg = cfg
        self.scfg = scfg
        self.policy_name = policy if isinstance(policy, str) else policy.name
        engine = engine or EventEngine()
        self.engine = engine
        fabric = Fabric(spec, pud_units=cfg.pud_units)
        self.fabric = fabric
        fm = None
        if faults is not None and faults.active:
            from repro_torch.sim.faults import FaultModel
            fm = FaultModel(faults, spec, fabric, engine)
        self.fault_model = fm
        tele = as_recorder(telemetry)
        self.telemetry = tele
        if tele is not None:
            tele.attach(fabric=fabric, engine=engine)
            if fm is not None:
                tele.attach_faults(fm)
            tele.run_meta.setdefault("entry", entry_name)
            tele.run_meta.setdefault("policy", self.policy_name)
            tele.run_meta.setdefault("seed", catalog.seed)
        self.driver = _ServingDriver(
            catalog, arrival_times if arrival_times is not None else [],
            policy, spec, cfg, scfg, fabric, engine,
            window=window, plan=plan)
        self.ftl_model = (build_ftl_model(ftl, spec, fabric, engine,
                                          io_stream)
                          if ftl is not None else None)
        if self.ftl_model is not None and fm is not None:
            self.ftl_model.attach_faults(fm)
        self.io = (_HostIOModel(io_stream, fabric, spec, engine,
                                ftl=self.ftl_model)
                   if io_stream is not None else None)
        if tele is not None:
            tele.attach_serving(self.driver)
            if self.ftl_model is not None:
                tele.attach_ftl(self.ftl_model)
            if self.io is not None:
                tele.attach_host_io(self.io)
        # -- actor state on top of the classic wiring ------------------------
        self.retired = False
        self._completions: List[SessionRecord] = []
        # fleet seam: fires (drive_id, record) on every terminal session
        self.on_session_terminal: Optional[Callable] = None
        self.driver.on_terminal = self._terminal
        # rebuild / extra background streams injected mid-run
        self._extra_io: List[_HostIOModel] = []

    # -- seam 1: submit --------------------------------------------------------

    def submit(self, t_ns: float, entry, sid: int, measured: bool) -> int:
        """Inject one routed session arriving at ``t_ns`` (>= now);
        returns the drive-local index (see :meth:`schedule_cancel`)."""
        if self.retired:
            raise RuntimeError(
                f"drive {self.drive_id} is retired: the placement layer "
                "must not route sessions to it")
        return self.driver.submit(t_ns, entry, sid, measured)

    def schedule_cancel(self, i: int, t_ns: float) -> None:
        """Hedging's cancel-on-first-win: revoke local copy ``i`` at
        ``t_ns`` *drive time*.  Scheduled as an event (never applied
        retroactively — this drive's clock may trail the winner's), and
        only a still-queued copy actually cancels; an executing copy
        drains, exactly like a timed-out session's in-flight work."""
        self.engine.schedule(max(t_ns, self.engine.now), EventKind.TIMER,
                             lambda _i: self.driver.cancel(_i), payload=i)

    # -- seam 2: poll ----------------------------------------------------------

    def _terminal(self, i: int, rec: SessionRecord) -> None:
        self._completions.append(rec)
        if self.on_session_terminal is not None:
            self.on_session_terminal(self.drive_id, rec)

    def health(self) -> DriveHealth:
        now = self.engine.now
        fm = self.fault_model
        read_only = failed = 0
        recovering = False
        if fm is not None:
            read_only = sum(1 for ro in fm.dies_read_only if ro)
            failed = sum(1 for d in range(fm.n_dies) if fm.die_dead(d, now))
            recovering = any(t > now for t in fm.recovery_until)
        ftl = self.ftl_model
        return DriveHealth(
            drive_id=self.drive_id, t_ns=now,
            active=self.driver.active, backlog=len(self.driver.backlog),
            gc_busy=bool(ftl is not None and ftl.gc_busy),
            gc_active_dies=ftl.gc_active_dies if ftl is not None else 0,
            read_only_dies=read_only, failed_dies=failed,
            recovering=recovering, retired=self.retired)

    def poll(self) -> DrivePoll:
        """Completions since the last poll + a health snapshot."""
        done = tuple(self._completions)
        self._completions.clear()
        return DrivePoll(completions=done, health=self.health())

    # -- seam 3: advance-to-time ----------------------------------------------

    def advance_before(self, t: float) -> float:
        """Process this drive's events strictly before ``t``; events at
        exactly ``t`` stay pending so an arrival submitted *at* ``t``
        interleaves by the engine's (time, seq) order, not call order."""
        return self.engine.run_before(t)

    def drain(self) -> float:
        """Run this drive to quiescence (no pending events)."""
        return self.engine.run()

    # -- fleet-level management ------------------------------------------------

    def retire(self) -> None:
        """Stop accepting sessions.  Already-queued and executing work
        drains normally — retirement is an admission decision, not a
        power cut; the fleet rebuilds the drive's share elsewhere."""
        self.retired = True

    def add_io_stream(self, stream: HostIOStream) -> None:
        """Attach an extra background host-I/O stream mid-fleet — the
        rebuild read traffic a surviving replica serves while a retired
        drive's data is reconstructed.  Folded into this drive's
        makespan and contention but kept out of its serving stats."""
        self._extra_io.append(
            _HostIOModel(stream, self.fabric, self.spec, self.engine,
                         ftl=self.ftl_model))

    # -- result ----------------------------------------------------------------

    def result(self) -> ServingResult:
        res = self.driver.result(self.policy_name, self.io, self.ftl_model)
        for extra in self._extra_io:
            # rebuild traffic keeps the drive busy past its last session
            res.makespan_ns = max(res.makespan_ns, extra.last_complete_ns)
        res.telemetry = self.telemetry
        return res
