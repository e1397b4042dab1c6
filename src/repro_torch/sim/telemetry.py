"""Flight recorder: engine tracing, offload-decision audit, interval metrics.

The simulator so far only reports *aggregate* outcomes (makespans,
percentiles, counters).  This module adds a :class:`FlightRecorder` that
hooks into the event engine, the server pools, the dispatch loop, the FTL
collector and the serving driver as a **pure observer** — zero overhead
when off (the default: every hook site is one ``is not None`` branch),
and bit-identical simulation results when on (the recorder never books
time, never mutates simulation state, and its sampler events carry
pure-read handlers; ``tests/test_telemetry.py`` pins the golden digests
with telemetry fully enabled).

Three products from one hook layer:

1. **Chrome-trace / Perfetto spans** — one track per pool unit (every
   die, channel, compute core, the DRAM bus, PCIe, the offloader), GC
   cycle/copy/erase spans per die, session-lifecycle async spans, and
   host-I/O request spans.  Drop the exported JSON into
   ``chrome://tracing`` or https://ui.perfetto.dev.
2. **Offload-decision audit stream** — per dispatch, the six cost
   features (Table 1) for *every* candidate resource, each candidate's
   Eqn-1 total, and the chosen resource; :meth:`OffloadAudit.explain`
   renders one decision end-to-end.  This stream subsumes the legacy
   ``DecisionRecord`` logging: the record type now lives here (re-exported
   by :mod:`repro_torch.sim.stats` for compatibility) and
   ``SimConfig.record_decisions`` keeps its exact semantics as the thin
   always-available slice of the audit stream.
3. **Interval time-series metrics** — sampled on TIMER events every
   ``TelemetryConfig.interval_ns``: per-pool utilization (busy-time delta
   over the interval), queue depth (pending booked work), GC-busy die
   count, serving backlog/active sessions, and a sliding-window p99 of
   per-op latency; plus a per-instruction latency breakdown (decide vs
   data movement vs queue wait vs compute) aggregated by (op, resource).

Trace schema (``conduit-flight-recorder/v1``)
--------------------------------------------

The export is standard Chrome Trace Event JSON (object form)::

    {
      "traceEvents": [...],          # ts/dur in MICROseconds
      "displayTimeUnit": "ns",
      "otherData": {
        "schema": "conduit-flight-recorder/v1",
        "event_counts": {kind: n},           # engine events by EventKind
        "audit": [ {tenant, iid, op, policy, t_decide_ns, chosen,
                    chosen_total_ns, replayed, candidates: [
                      {resource, supported, latency_comp_ns,
                       latency_dm_ns, delay_dd_ns, delay_queue_ns,
                       total_ns} ]} ],
        "intervals": [ {t_ns, utilization: {pool: x}, queue_depth_ns:
                        {pool: ns}, gc_active_dies, backlog,
                        active_sessions, p99_op_ns} ],
        "breakdown": [ {op, resource, count, decide_ns, dm_ns,
                        queue_ns, compute_ns, total_ns} ],   # sums
        "ops": [ {tenant, iid, op, resource, unit, deps, t_decide_ns,
                  decide_end_ns, ready_ns, move_end_ns, start_ns,
                  end_ns, dm_ns, replayed} ],   # per-dispatch phase record
        "meta": {spec_sha, policy, seed, entry, telemetry: {...}},
        "dropped_spans": n, "dropped_audit": n,  # loud truncation counts
        "dropped_ops": n
      }
    }

The ``ops`` stream (one record per dispatched instruction, with the
exact phase boundaries ``t_decide <= decide_end <= ready <= move_end <=
start <= end`` and the instruction's dependency iids) is what
:mod:`repro_torch.sim.analysis` joins against the session/GC/reliability spans
for tail-latency blame and critical-path extraction; ``meta`` carries
the reproducibility fingerprint (spec hash, policy, seed, telemetry
config) that lets ``analysis diff`` refuse apples-to-oranges
comparisons.  Both are additive to schema v1: traces without them stay
valid, and consumers degrade gracefully.

``traceEvents`` uses five phases: ``"X"`` complete spans (pool bookings
on pid 1 "fabric", GC activity on pid 2 "ftl-gc"), ``"b"``/``"e"`` async
spans (sessions on pid 3, host I/O on pid 4 — every ``b`` has a matching
``e``, including rejected sessions), ``"i"`` instants (admissions,
rejections, GC suspends), ``"C"`` counters (pid 5 "metrics": the interval
samples, rendered as counter tracks by Perfetto), and ``"M"`` metadata
naming processes/threads.  :func:`validate_trace` checks all of this
structurally; the ``summarize``/``validate`` CLI::

    python -m repro_torch.sim.telemetry summarize trace.json
    python -m repro_torch.sim.telemetry validate  trace.json

Wiring: pass ``telemetry=TelemetryConfig(...)`` (or a ``FlightRecorder``)
to :func:`repro_torch.sim.machine.simulate`,
:func:`repro_torch.sim.tenancy.simulate_mix` or
:func:`repro_torch.sim.serving.simulate_serving`; the recorder comes back on
``result.telemetry``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import re
import sys
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, TextIO,
                    Tuple, Union)

from repro_torch.core.isa import Resource
from repro_torch.sim.events import EventEngine, EventKind

SCHEMA = "conduit-flight-recorder/v1"

# fixed Chrome-trace process ids (named via "M" metadata on export)
PID_FABRIC = 1      # one thread per (pool, unit): every booking is a span
PID_FTL = 2         # one thread per die: GC cycle / copy / erase spans
PID_SESSIONS = 3    # async b/e per session (arrival -> done/reject)
PID_HOST_IO = 4     # async b/e per host request (arrival -> complete)
PID_METRICS = 5     # "C" counter tracks fed by the interval sampler
PID_RELIABILITY = 6  # per-die recovery/rebuild spans, retirement events

_NS_TO_US = 1e-3    # Chrome-trace ts/dur are microseconds


@dataclasses.dataclass
class DecisionRecord:
    """One dispatch outcome — the always-available slice of the audit
    stream (:class:`OffloadAudit` is the telemetry-enabled superset with
    per-candidate costs).  ``SimConfig.record_decisions`` governs whether
    the simulator keeps one of these per dispatch; re-exported by
    :mod:`repro_torch.sim.stats` for existing callers."""

    iid: int
    op: str
    resource: Resource
    t_decide: float
    t_start: float
    t_end: float
    dm_ns: float
    replayed: bool = False


@dataclasses.dataclass(frozen=True)
class CandidateCost:
    """One candidate resource's six-feature cost vector at decision time
    (Table 1 / Eqn 1): what the policy saw, per resource it considered."""

    resource: str
    supported: bool
    latency_comp_ns: float
    latency_dm_ns: float
    delay_dd_ns: float
    delay_queue_ns: float
    total_ns: float          # latency_comp + latency_dm + max(dd, queue)

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class OffloadAudit:
    """One offloading decision end-to-end: the six cost features per
    candidate, every candidate's Eqn-1 total, and the chosen resource."""

    tenant: str
    iid: int
    op: str
    policy: str
    t_decide_ns: float
    chosen: str
    chosen_total_ns: float
    candidates: Tuple[CandidateCost, ...]
    replayed: bool = False
    # fault injection: the decision sent work to a die whose recovery
    # ladder (retry/soft-decode/rebuild) was still draining at decide
    # time — the queue features the policy saw included recovery work
    mid_recovery: bool = False

    def explain(self) -> str:
        """Render the decision as a table: features -> costs -> choice."""
        lines = [
            f"dispatch iid={self.iid} op={self.op!r} tenant={self.tenant!r}"
            f" policy={self.policy} at t={self.t_decide_ns:.0f} ns",
            f"  {'resource':<10} {'sup':<4} {'comp_ns':>12} {'dm_ns':>12}"
            f" {'dd_ns':>12} {'queue_ns':>12} {'total_ns':>12}",
        ]
        for c in self.candidates:
            mark = "->" if c.resource == self.chosen else "  "
            total = "inf" if math.isinf(c.total_ns) else f"{c.total_ns:.0f}"
            comp = "inf" if math.isinf(c.latency_comp_ns) \
                else f"{c.latency_comp_ns:.0f}"
            lines.append(
                f"{mark}{c.resource:<10} {str(c.supported):<4} {comp:>12}"
                f" {c.latency_dm_ns:>12.0f} {c.delay_dd_ns:>12.0f}"
                f" {c.delay_queue_ns:>12.0f} {total:>12}")
        lines.append(
            f"  chosen: {self.chosen}"
            f" (total {self.chosen_total_ns:.0f} ns"
            f"{', replayed on fault' if self.replayed else ''}"
            f"{', landed mid-recovery' if self.mid_recovery else ''})")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, object]:
        return {
            "tenant": self.tenant, "iid": self.iid, "op": self.op,
            "policy": self.policy, "t_decide_ns": self.t_decide_ns,
            "chosen": self.chosen, "chosen_total_ns": self.chosen_total_ns,
            "replayed": self.replayed, "mid_recovery": self.mid_recovery,
            "candidates": [c.as_dict() for c in self.candidates],
        }


@dataclasses.dataclass
class IntervalSample:
    """One sampler tick: the drive's state over the last interval."""

    t_ns: float
    utilization: Dict[str, float]      # pool -> busy delta / interval
    queue_depth_ns: Dict[str, float]   # pool -> pending booked work
    gc_active_dies: int
    backlog: int
    active_sessions: int
    p99_op_ns: float                   # sliding-window per-op p99

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """What the flight recorder captures.

    ``spans`` drives product (1) (pool/GC/session/IO spans), ``audit``
    product (2) (per-candidate cost vectors — recomputed read-only from
    the policy's own feature derivation, so enabling it cannot perturb
    the decision), ``interval_ns > 0`` product (3) (the TIMER sampler;
    0 disables sampling).  ``sliding_window`` sizes the p99 window;
    ``max_spans`` / ``max_audit`` cap memory with *loud* truncation —
    the export carries ``dropped_spans`` / ``dropped_audit`` counts and
    ``summarize`` reports them, never silently."""

    spans: bool = True
    audit: bool = True
    interval_ns: float = 0.0
    sliding_window: int = 512
    max_spans: int = 200_000
    max_audit: int = 100_000

    def __post_init__(self) -> None:
        if self.interval_ns < 0.0:
            raise ValueError("interval_ns must be >= 0 (0 = sampler off)")
        if self.sliding_window < 1:
            raise ValueError("sliding_window must be >= 1")
        if self.max_spans < 1 or self.max_audit < 1:
            raise ValueError("max_spans/max_audit must be >= 1")


TelemetryLike = Union[None, bool, TelemetryConfig, "FlightRecorder"]


def as_recorder(telemetry: TelemetryLike) -> Optional["FlightRecorder"]:
    """Normalize the ``telemetry=`` argument of the simulate entry points:
    ``None``/``False`` -> no recorder, ``True`` -> default config,
    a :class:`TelemetryConfig` -> fresh recorder, a recorder -> itself."""
    if telemetry is None or telemetry is False:
        return None
    if telemetry is True:
        return FlightRecorder()
    if isinstance(telemetry, TelemetryConfig):
        return FlightRecorder(telemetry)
    if isinstance(telemetry, FlightRecorder):
        return telemetry
    raise TypeError(f"telemetry must be None/bool/TelemetryConfig/"
                    f"FlightRecorder, got {type(telemetry).__name__}")


class FlightRecorder:
    """Pure-observer recorder for one simulation run.

    Attach with :meth:`attach` (fabric and/or engine), plus
    :meth:`attach_ftl` / :meth:`attach_host_io` / :meth:`attach_serving`
    for the optional subsystems; the entry points in
    :mod:`repro_torch.sim.machine` / :mod:`repro_torch.sim.tenancy` /
    :mod:`repro_torch.sim.serving` do all of this when given ``telemetry=``.

    Invariants the hook sites rely on (and the golden tests pin):

    * no method ever books pool time or mutates engine/simulation state —
      sampler TIMER events only *read* (pool busy/pending probes and the
      registered lambdas), so interleaving them shifts event sequence
      numbers without changing any simulated timestamp;
    * ``ctx`` is written by the handler that is about to book pool time
      (dispatch, epilogue, GC, host I/O) and read by the pool tracer to
      attribute the booking's span — it never feeds back into simulation.
    """

    def __init__(self, config: Optional[TelemetryConfig] = None):
        self.cfg = config or TelemetryConfig()
        #: attribution label for the next pool booking (set by handlers)
        self.ctx: Optional[str] = None
        #: structured attribution for the next pool booking — a dict the
        #: handler shares across every booking of one dispatch/GC step
        #: (lossless join key: the span name alone would need parsing)
        self.ctx_args: Optional[dict] = None

        # product 1: spans
        self.spans: List[dict] = []          # "X" on fabric/ftl pids
        self.async_events: List[dict] = []   # "b"/"e"/"i"
        self.counters: List[dict] = []       # "C" from the sampler
        self.dropped_spans = 0
        self._meta: List[dict] = []
        self._tids: Dict[Tuple[int, str], int] = {}

        # product 2: audit + breakdown
        self.audit: List[OffloadAudit] = []
        self.dropped_audit = 0
        # (op, resource) -> [count, decide, dm, queue, compute, total] sums
        self.breakdown: Dict[Tuple[str, str], List[float]] = {}

        # per-dispatch phase records for post-hoc analysis (blame /
        # critical path): plain dicts, exported under otherData["ops"]
        self.ops: List[dict] = []
        self.dropped_ops = 0
        # reproducibility fingerprint, filled by the simulate entry
        # points (policy, seed, entry) and at export time (spec hash)
        self.run_meta: Dict[str, object] = {}

        # product 3: interval samples
        self.intervals: List[IntervalSample] = []
        self.sample_probes: Dict[str, Callable[[], float]] = {}
        self._latwin: Deque[float] = deque(maxlen=self.cfg.sliding_window)

        self.event_counts: Dict[str, int] = {}
        self._engine: Optional[EventEngine] = None
        self._fabric = None
        self._faults = None
        self._prev_busy: Dict[str, float] = {}
        self._prev_t = 0.0
        self._sampler_on = False

    # -- attachment -----------------------------------------------------------

    def attach(self, fabric=None, engine: Optional[EventEngine] = None
               ) -> "FlightRecorder":
        """Hook into a fabric (pool-booking tracer) and/or engine (event
        counts + interval sampler).  Idempotent; returns self."""
        if fabric is not None:
            self._fabric = fabric
            fabric.telemetry = self
            if self.cfg.spans:
                tracer = self._on_booking
                for p in fabric.all_pools():
                    p.tracer = tracer
        if engine is not None:
            self._engine = engine
            engine.telemetry = self
        self._start_sampler()
        return self

    def attach_ftl(self, ftl_model) -> None:
        """Register the FTL: GC span hooks plus the gc-busy sampler probe."""
        ftl_model.telemetry = self
        self.sample_probes["gc_active_dies"] = \
            lambda: ftl_model.gc_active_dies

    def attach_host_io(self, io_model) -> None:
        """Register the host I/O model for request-lifecycle spans."""
        io_model.telemetry = self

    def attach_faults(self, fault_model) -> None:
        """Register the fault subsystem: recovery/retirement spans, die
        failure / read-only instants, and the mid-recovery flag on the
        offload audit.  The ECC pool is created after :meth:`attach` has
        already set the pool tracers, so it is wired here."""
        fault_model.telemetry = self
        self._faults = fault_model
        if self.cfg.spans:
            fault_model.ecc.tracer = self._on_booking

    def attach_serving(self, driver) -> None:
        """Register the serving driver: session-lifecycle spans plus the
        backlog / active-session sampler probes."""
        driver.telemetry = self
        self.sample_probes["backlog"] = lambda: len(driver.backlog)
        self.sample_probes["active_sessions"] = lambda: driver.active

    def _start_sampler(self) -> None:
        eng = self._engine
        if (self._sampler_on or eng is None or self._fabric is None
                or self.cfg.interval_ns <= 0.0):
            return
        self._sampler_on = True
        self._prev_busy = {p.name: p.busy_ns
                           for p in self._fabric.all_pools()}
        self._prev_t = eng.now
        eng.schedule(eng.now + self.cfg.interval_ns, EventKind.TIMER,
                     self._on_sample)

    # -- engine hook ----------------------------------------------------------

    def on_event(self, t: float, kind: EventKind) -> None:
        """Called by the engine run loop (and the host-I/O burst batcher,
        which mirrors the loop's bookkeeping) for every processed event."""
        c = self.event_counts
        k = kind.value
        c[k] = c.get(k, 0) + 1

    # -- pool-booking tracer (product 1) --------------------------------------

    def _tid(self, pid: int, name: str) -> int:
        key = (pid, name)
        t = self._tids.get(key)
        if t is None:
            t = len(self._tids) + 1
            self._tids[key] = t
            self._meta.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": t,
                               "args": {"name": name}})
        return t

    def _on_booking(self, pool_name: str, unit: int, start: float,
                    end: float) -> None:
        """ServerPool tracer: one "X" span per acquire on the unit's
        track, named by the current ``ctx`` attribution."""
        if len(self.spans) >= self.cfg.max_spans:
            self.dropped_spans += 1
            return
        ev = {
            "ph": "X", "pid": PID_FABRIC,
            "tid": self._tid(PID_FABRIC, f"{pool_name}/{unit}"),
            "name": self.ctx or "?",
            "ts": start * _NS_TO_US, "dur": (end - start) * _NS_TO_US,
        }
        if self.ctx_args is not None:
            # shared by reference across one dispatch's bookings — the
            # handlers build one dict per dispatch, not per booking
            ev["args"] = self.ctx_args
        self.spans.append(ev)

    def _gc_span(self, die: int, name: str, t0: float, t1: float,
                 args: Optional[dict] = None) -> None:
        if len(self.spans) >= self.cfg.max_spans:
            self.dropped_spans += 1
            return
        ev = {"ph": "X", "pid": PID_FTL,
              "tid": self._tid(PID_FTL, f"die{die}"),
              "name": name, "ts": t0 * _NS_TO_US,
              "dur": (t1 - t0) * _NS_TO_US}
        if args:
            ev["args"] = args
        self.spans.append(ev)

    # -- dispatch hook (products 2 + 3) ---------------------------------------

    def on_dispatch(self, tenant: str, policy: str, instr, resource,
                    feats, t_decide: float, decide_end: float,
                    ready: float, move_end: float, start: float,
                    end: float, dm_ns: float,
                    replayed: bool = False,
                    unit: Optional[int] = None) -> None:
        """Called once per dispatched instruction, after all bookings.

        ``feats`` is the per-candidate :class:`~repro_torch.core.cost.Features`
        dict (None when the audit product is off) — computed by the
        policy's own read-only ``_feats`` derivation right after the
        selection, before any booking mutated pool state, so it is the
        exact decision-time view.  ``unit`` is the die an IFP decision
        executed on (None otherwise): under fault injection the audit
        flags decisions that landed on a die whose recovery ladder was
        still draining at decide time."""
        lat = end - t_decide
        self._latwin.append(lat)
        rname = resource.value
        key = (instr.op, rname)
        row = self.breakdown.get(key)
        if row is None:
            row = self.breakdown[key] = [0, 0.0, 0.0, 0.0, 0.0, 0.0]
        row[0] += 1
        row[1] += decide_end - t_decide      # decision overhead window
        row[2] += move_end - ready           # operand data movement
        row[3] += start - move_end           # queue wait at the exec pool
        row[4] += end - start                # compute occupancy
        row[5] += lat
        if self.cfg.spans:
            # per-dispatch phase record for the analysis layer (blame /
            # critical path) — the aggregated breakdown above cannot be
            # joined back to a session or a dependency chain
            if len(self.ops) >= self.cfg.max_spans:
                self.dropped_ops += 1
            else:
                self.ops.append({
                    "tenant": tenant, "iid": instr.iid, "op": instr.op,
                    "resource": rname, "unit": unit,
                    "deps": list(instr.deps),
                    "t_decide_ns": t_decide, "decide_end_ns": decide_end,
                    "ready_ns": ready, "move_end_ns": move_end,
                    "start_ns": start, "end_ns": end, "dm_ns": dm_ns,
                    "replayed": replayed})
        if feats is None:
            return
        if len(self.audit) >= self.cfg.max_audit:
            self.dropped_audit += 1
            return
        cands = tuple(
            CandidateCost(r.value, f.supported, f.latency_comp,
                          f.latency_dm, f.delay_dd, f.delay_queue, f.total)
            for r, f in feats.items())
        chosen = feats.get(resource)
        fm = self._faults
        mid_recovery = (fm is not None and unit is not None
                        and fm.recovery_until[unit] > t_decide)
        self.audit.append(OffloadAudit(
            tenant=tenant, iid=instr.iid, op=instr.op, policy=policy,
            t_decide_ns=t_decide, chosen=rname,
            chosen_total_ns=(chosen.total if chosen is not None
                             else float("nan")),
            candidates=cands, replayed=replayed,
            mid_recovery=mid_recovery))

    # -- GC hooks (product 1) -------------------------------------------------

    def on_gc_cycle(self, die: int, victim: int, t0: float, t1: float,
                    pages_copied: int) -> None:
        if self.cfg.spans:
            self._gc_span(die, f"gc-cycle b{victim}", t0, t1,
                          {"die": die, "victim": victim,
                           "pages_copied": pages_copied})

    def on_gc_copy(self, die: int, t0: float, t1: float,
                   kind: str = "copy") -> None:
        if self.cfg.spans:
            self._gc_span(die, f"gc-{kind}", t0, t1, {"die": die})

    def on_gc_suspend(self, die: int, t: float) -> None:
        if self.cfg.spans:
            self.async_events.append({
                "ph": "i", "pid": PID_FTL,
                "tid": self._tid(PID_FTL, f"die{die}"),
                "name": "gc-suspend", "ts": t * _NS_TO_US, "s": "t"})

    # -- reliability hooks (product 1, fault injection) -----------------------

    def _rel_span(self, die: int, name: str, t0: float, t1: float,
                  args: Optional[dict] = None) -> None:
        if len(self.spans) >= self.cfg.max_spans:
            self.dropped_spans += 1
            return
        ev = {"ph": "X", "pid": PID_RELIABILITY,
              "tid": self._tid(PID_RELIABILITY, f"die{die}"),
              "name": name, "ts": t0 * _NS_TO_US,
              "dur": (t1 - t0) * _NS_TO_US}
        if args:
            ev["args"] = args
        self.spans.append(ev)

    def on_recovery(self, die: int, stage: str, t0: float,
                    t1: float) -> None:
        """One recovery-ladder stage on a die: read-retry, soft-decode,
        uncorrectable, rebuild or read-failed — span on the die's track."""
        if self.cfg.spans:
            self._rel_span(die, f"recovery:{stage}", t0, t1,
                           {"die": die, "stage": stage})

    def on_retirement(self, die: int, blk: int, t0: float, t1: float,
                      relocated: int) -> None:
        """Bad-block retirement: the survivor-relocation span."""
        if self.cfg.spans:
            self._rel_span(die, f"retire b{blk}", t0, t1,
                           {"die": die, "pages_relocated": relocated})

    def on_die_failure(self, die: int, t: float) -> None:
        if self.cfg.spans:
            self.async_events.append({
                "ph": "i", "pid": PID_RELIABILITY,
                "tid": self._tid(PID_RELIABILITY, f"die{die}"),
                "name": "die-failure", "ts": t * _NS_TO_US, "s": "t"})

    def on_read_only(self, die: int, t: float) -> None:
        if self.cfg.spans:
            self.async_events.append({
                "ph": "i", "pid": PID_RELIABILITY,
                "tid": self._tid(PID_RELIABILITY, f"die{die}"),
                "name": "read-only", "ts": t * _NS_TO_US, "s": "t"})

    # -- session hooks (product 1) --------------------------------------------

    def on_session_arrival(self, sid: int, kind: str, t: float) -> None:
        if self.cfg.spans:
            self.async_events.append({
                "ph": "b", "cat": "session", "id": sid,
                "pid": PID_SESSIONS, "tid": 0,
                "name": f"session:{kind}", "ts": t * _NS_TO_US})

    def on_session_admit(self, sid: int, t: float) -> None:
        if self.cfg.spans:
            self.async_events.append({
                "ph": "i", "pid": PID_SESSIONS, "tid": 0,
                "name": f"admit s{sid}", "ts": t * _NS_TO_US, "s": "t"})

    def on_session_done(self, sid: int, kind: str, t: float) -> None:
        if self.cfg.spans:
            self.async_events.append({
                "ph": "e", "cat": "session", "id": sid,
                "pid": PID_SESSIONS, "tid": 0,
                "name": f"session:{kind}", "ts": t * _NS_TO_US})

    def on_session_timeout(self, sid: int, kind: str, t: float) -> None:
        # close the async span at abandonment time (the in-flight work
        # drains unobserved) and mark the deadline miss
        if self.cfg.spans:
            ts = t * _NS_TO_US
            self.async_events.append({
                "ph": "e", "cat": "session", "id": sid,
                "pid": PID_SESSIONS, "tid": 0,
                "name": f"session:{kind}", "ts": ts,
                "args": {"timed_out": True}})
            self.async_events.append({
                "ph": "i", "pid": PID_SESSIONS, "tid": 0,
                "name": f"timeout s{sid}", "ts": ts, "s": "t"})

    def on_session_cancel(self, sid: int, kind: str, t: float) -> None:
        # a hedged twin lost the race while still queued: close the
        # async span (b/e balance) and mark the revocation
        if self.cfg.spans:
            ts = t * _NS_TO_US
            self.async_events.append({
                "ph": "e", "cat": "session", "id": sid,
                "pid": PID_SESSIONS, "tid": 0,
                "name": f"session:{kind}", "ts": ts,
                "args": {"cancelled": True}})
            self.async_events.append({
                "ph": "i", "pid": PID_SESSIONS, "tid": 0,
                "name": f"cancel s{sid}", "ts": ts, "s": "t"})

    def on_session_reject(self, sid: int, kind: str, t: float) -> None:
        # close the async span so b/e stay balanced, and mark the bounce
        if self.cfg.spans:
            ts = t * _NS_TO_US
            self.async_events.append({
                "ph": "e", "cat": "session", "id": sid,
                "pid": PID_SESSIONS, "tid": 0,
                "name": f"session:{kind}", "ts": ts,
                "args": {"rejected": True}})
            self.async_events.append({
                "ph": "i", "pid": PID_SESSIONS, "tid": 0,
                "name": f"reject s{sid}", "ts": ts, "s": "t"})

    # -- host-I/O hooks (product 1) -------------------------------------------

    def on_io_issue(self, req: int, arrival_ns: float, is_read: bool,
                    die: int) -> None:
        if self.cfg.spans:
            self.async_events.append({
                "ph": "b", "cat": "host_io", "id": req,
                "pid": PID_HOST_IO, "tid": 0,
                "name": f"io:{'read' if is_read else 'write'}",
                "ts": arrival_ns * _NS_TO_US, "args": {"die": die}})

    def on_io_complete(self, req: int, is_read: bool, t: float) -> None:
        if self.cfg.spans:
            self.async_events.append({
                "ph": "e", "cat": "host_io", "id": req,
                "pid": PID_HOST_IO, "tid": 0,
                "name": f"io:{'read' if is_read else 'write'}",
                "ts": t * _NS_TO_US})

    def on_io_timeout(self, req: int, is_read: bool, t: float) -> None:
        """Op-timeout detected: close the attempt's async span (the retry
        re-issues a fresh ``b`` for the same id) and mark the deadline."""
        if self.cfg.spans:
            ts = t * _NS_TO_US
            self.async_events.append({
                "ph": "e", "cat": "host_io", "id": req,
                "pid": PID_HOST_IO, "tid": 0,
                "name": f"io:{'read' if is_read else 'write'}",
                "ts": ts, "args": {"timed_out": True}})
            self.async_events.append({
                "ph": "i", "pid": PID_HOST_IO, "tid": 0,
                "name": f"io-timeout r{req}", "ts": ts, "s": "t"})

    # -- interval sampler (product 3) -----------------------------------------

    def _on_sample(self, _payload=None) -> None:
        """TIMER handler: sample, emit counters, re-arm while work remains.

        Pure reads only — pool busy/pending probes and the registered
        lambdas never mutate simulation state, so the extra TIMER events
        shift sequence numbers without changing any simulated timestamp
        (the telemetry-on golden-digest law)."""
        eng = self._engine
        now = eng.now
        dt = now - self._prev_t
        util: Dict[str, float] = {}
        qdepth: Dict[str, float] = {}
        prev = self._prev_busy
        for p in self._fabric.all_pools():
            busy = p.busy_ns
            if dt > 0.0:
                # busy time accrues at (lazy) booking time, so a heavily
                # booked interval can read > 1.0 — same caveat as the
                # serving window utilization
                util[p.name] = (busy - prev.get(p.name, 0.0)) \
                    / (dt * p.units)
            prev[p.name] = busy
            qdepth[p.name] = p.pending_work_ns(now)
        self._prev_t = now
        probes = self.sample_probes
        gc_dies = int(probes["gc_active_dies"]()) \
            if "gc_active_dies" in probes else 0
        backlog = int(probes["backlog"]()) if "backlog" in probes else 0
        active = int(probes["active_sessions"]()) \
            if "active_sessions" in probes else 0
        p99 = _p99(self._latwin)
        self.intervals.append(IntervalSample(
            t_ns=now, utilization=util, queue_depth_ns=qdepth,
            gc_active_dies=gc_dies, backlog=backlog,
            active_sessions=active, p99_op_ns=p99))
        ts = now * _NS_TO_US
        counters = self.counters
        if util:
            counters.append({"ph": "C", "pid": PID_METRICS, "tid": 0,
                             "name": "utilization", "ts": ts,
                             "args": {k: round(v, 4)
                                      for k, v in util.items()}})
        counters.append({"ph": "C", "pid": PID_METRICS, "tid": 0,
                         "name": "queue_depth_ns", "ts": ts,
                         "args": {k: round(v, 1)
                                  for k, v in qdepth.items()}})
        counters.append({"ph": "C", "pid": PID_METRICS, "tid": 0,
                         "name": "drive", "ts": ts,
                         "args": {"gc_active_dies": gc_dies,
                                  "backlog": backlog,
                                  "active_sessions": active,
                                  "p99_op_ns": p99}})
        # re-arm only while the run is live: the sampler must not keep an
        # otherwise-drained engine spinning (runs end when the heap does)
        if not eng.empty():
            eng.schedule(now + self.cfg.interval_ns, EventKind.TIMER,
                         self._on_sample)

    # -- export ---------------------------------------------------------------

    def breakdown_rows(self) -> List[Dict[str, object]]:
        """Per-(op, resource) latency breakdown — summed ns per phase."""
        rows = []
        for (op, res), row in sorted(self.breakdown.items()):
            rows.append({"op": op, "resource": res, "count": int(row[0]),
                         "decide_ns": row[1], "dm_ns": row[2],
                         "queue_ns": row[3], "compute_ns": row[4],
                         "total_ns": row[5]})
        return rows

    def chrome_trace(self) -> Dict[str, object]:
        """Assemble the full Chrome-trace object (see module docstring)."""
        events: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": PID_FABRIC,
             "args": {"name": "fabric"}},
            {"ph": "M", "name": "process_name", "pid": PID_FTL,
             "args": {"name": "ftl-gc"}},
            {"ph": "M", "name": "process_name", "pid": PID_SESSIONS,
             "args": {"name": "sessions"}},
            {"ph": "M", "name": "process_name", "pid": PID_HOST_IO,
             "args": {"name": "host-io"}},
            {"ph": "M", "name": "process_name", "pid": PID_METRICS,
             "args": {"name": "metrics"}},
            {"ph": "M", "name": "process_name", "pid": PID_RELIABILITY,
             "args": {"name": "reliability"}},
        ]
        events += self._meta
        events += self.spans
        events += self.async_events
        events += self.counters
        # reproducibility fingerprint: entry-point facts (policy, seed,
        # entry) stamped into run_meta by the simulate_* wrappers, plus a
        # hash of the hardware spec and the telemetry knobs — computed at
        # export time only, never on the hot path
        meta: Dict[str, object] = dict(self.run_meta)
        if self._fabric is not None:
            meta["spec_sha"] = hashlib.sha256(
                repr(self._fabric.spec).encode()).hexdigest()[:16]
        meta["telemetry"] = dataclasses.asdict(self.cfg)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ns",
            "otherData": {
                "schema": SCHEMA,
                "event_counts": dict(self.event_counts),
                "audit": [a.as_dict() for a in self.audit],
                "intervals": [s.as_dict() for s in self.intervals],
                "breakdown": self.breakdown_rows(),
                "ops": self.ops,
                "meta": meta,
                "dropped_spans": self.dropped_spans,
                "dropped_audit": self.dropped_audit,
                "dropped_ops": self.dropped_ops,
            },
        }

    def export(self, path: str) -> Dict[str, object]:
        """Write the Chrome-trace JSON to ``path``; returns the object."""
        obj = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(obj, f)
        return obj


def _p99(values) -> float:
    """Nearest-rank p99 over the sliding window (0.0 when empty).

    Thin delegate to :func:`repro_torch.sim.stats.percentile` — one validated
    percentile implementation everywhere (the import is deferred because
    ``stats`` imports :class:`DecisionRecord` from this module)."""
    from repro_torch.sim.stats import percentile
    return percentile(list(values), 99.0)


# -- fleet trace merging -------------------------------------------------------

def merge_fleet_trace(traces: List[Any]) -> Dict[str, object]:
    """Merge per-drive traces into one fleet Chrome-trace timeline.

    ``traces`` is the ``FleetResult.telemetry`` list (one
    :class:`FlightRecorder` or exported trace dict per drive, index =
    drive id; ``None`` entries are skipped).  Merge arithmetic, reversed
    by :func:`repro_torch.sim.analysis.split_fleet_trace`:

    * pids: drive ``k``'s process ``p`` becomes ``10*k + p`` (the six
      base pids stay < 10, so ``pid // 10`` recovers the drive and
      ``pid % 10`` the base process);
    * process names gain a ``d{k}:`` prefix (``d0:fabric``,
      ``d3:reliability``, ...) — the vocabulary
      :func:`validate_trace` checks;
    * async span ids gain a ``d{k}/`` prefix so hedged twins of one
      fleet session (same sid on two drives) stay distinct spans;
    * ``otherData`` record streams (audit / intervals / breakdown /
      ops) are concatenated with a ``"drive": k`` tag on every record;
      ``meta`` keeps drive 0's keys plus ``n_drives`` and the per-drive
      ``drives`` list."""
    events: List[dict] = []
    event_counts: Dict[str, int] = {}
    streams: Dict[str, List[dict]] = {
        "audit": [], "intervals": [], "breakdown": [], "ops": []}
    metas: List[dict] = []
    dropped = {"dropped_spans": 0, "dropped_audit": 0, "dropped_ops": 0}
    for k, t in enumerate(traces):
        if t is None:
            continue
        if hasattr(t, "chrome_trace"):
            t = t.chrome_trace()
        for ev in t.get("traceEvents", []):
            ev = dict(ev)
            pid = ev.get("pid")
            if isinstance(pid, int):
                ev["pid"] = 10 * k + pid
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                ev["args"] = {"name": f"d{k}:{ev['args']['name']}"}
            if ev.get("ph") in ("b", "e") and "id" in ev:
                ev["id"] = f"d{k}/{ev['id']}"
            events.append(ev)
        other = t.get("otherData", {})
        for kind, cnt in (other.get("event_counts") or {}).items():
            event_counts[kind] = event_counts.get(kind, 0) + cnt
        for name, acc in streams.items():
            for rec in other.get(name) or []:
                rec = dict(rec)
                rec["drive"] = k
                acc.append(rec)
        metas.append(dict(other.get("meta") or {}))
        for dk in dropped:
            dropped[dk] += other.get(dk, 0)
    meta: Dict[str, object] = dict(metas[0]) if metas else {}
    meta["entry"] = "simulate_fleet"
    meta["n_drives"] = len(traces)
    meta["drives"] = metas
    out: Dict[str, object] = {
        "traceEvents": events,
        "displayTimeUnit": "ns",
        "otherData": {"schema": SCHEMA, "event_counts": event_counts,
                      "meta": meta, **streams, **dropped},
    }
    return out


def export_fleet_trace(traces: List[Any], path: str) -> Dict[str, object]:
    """Merge (:func:`merge_fleet_trace`) and write to ``path``."""
    obj = merge_fleet_trace(traces)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


# -- validation / summary ------------------------------------------------------

_LEGAL_PH = frozenset("XMbeiC")

#: legal drive-prefixed process names in a merged fleet trace — exactly
#: the six base processes behind a ``d<number>:`` prefix
_DRIVE_PROC_RE = re.compile(
    r"^d\d+:(fabric|ftl-gc|sessions|host-io|metrics|reliability)$")


def validate_trace(obj: Any) -> List[str]:
    """Structural validation of an exported trace; returns error strings
    (empty = valid).  Checks the envelope, the schema tag, every event's
    phase/timestamps, non-negative span durations, b/e balance per
    (cat, id), per-track counter monotonicity and non-negative counter
    values, and the reliability process's span/instant vocabulary —
    everything :func:`summarize` and :mod:`repro_torch.sim.analysis` rely on."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return [f"trace must be a JSON object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        errors.append("missing/invalid traceEvents list")
        events = []
    other = obj.get("otherData")
    if not isinstance(other, dict):
        errors.append("missing/invalid otherData object")
        other = {}
    schema = other.get("schema")
    if schema != SCHEMA:
        errors.append(f"otherData.schema is {schema!r}, expected {SCHEMA!r}")
    # pid -> process name, so the reliability checks below don't depend on
    # metadata/event ordering in the list
    pname: Dict[Any, str] = {}
    for ev in events:
        if isinstance(ev, dict) and ev.get("ph") == "M" \
                and ev.get("name") == "process_name":
            args = ev.get("args")
            if isinstance(args, dict):
                pname[ev.get("pid")] = args.get("name")
    # merged fleet traces prefix every process with "d<drive>:"; anything
    # that *looks* drive-prefixed but doesn't resolve to a known base
    # process is a malformed merge, not a new vocabulary
    for pid, name in sorted(pname.items(), key=lambda kv: str(kv[0])):
        if isinstance(name, str) and name.startswith("d") and ":" in name \
                and not _DRIVE_PROC_RE.match(name):
            errors.append(
                f"process {pid}: malformed drive-prefixed process name "
                f"{name!r} (expected d<drive>:<fabric|ftl-gc|sessions|"
                f"host-io|metrics|reliability>)")
    open_async: Dict[Tuple[str, Any], int] = {}
    last_counter_ts: Dict[Tuple[Any, Any, Any], float] = {}
    for n, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event #{n}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _LEGAL_PH:
            errors.append(f"event #{n}: illegal ph {ph!r}")
            continue
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                errors.append(f"event #{n} ({ph}): non-numeric ts {ts!r}")
            if "pid" not in ev:
                errors.append(f"event #{n} ({ph}): missing pid")
        proc = pname.get(ev.get("pid"))
        if isinstance(proc, str) and _DRIVE_PROC_RE.match(proc):
            # per-drive track of a merged fleet trace: the base
            # process's vocabulary rules apply unchanged
            proc = proc.split(":", 1)[1]
        if proc == "reliability":
            name = ev.get("name", "")
            if ph == "X" and not (name.startswith("recovery:")
                                  or name.startswith("retire b")):
                errors.append(f"event #{n}: unknown reliability span "
                              f"{name!r}")
            elif ph == "i" and name not in ("die-failure", "read-only"):
                errors.append(f"event #{n}: unknown reliability instant "
                              f"{name!r}")
        if ph == "C":
            key = (ev.get("pid"), ev.get("tid"), ev.get("name"))
            ts = ev.get("ts")
            if isinstance(ts, (int, float)):
                prev = last_counter_ts.get(key)
                if prev is not None and ts < prev:
                    errors.append(
                        f"event #{n} (C): non-monotonic counter track "
                        f"{key[2]!r} (ts {ts} < {prev})")
                else:
                    last_counter_ts[key] = ts
            args = ev.get("args")
            if isinstance(args, dict):
                for k, v in args.items():
                    if isinstance(v, (int, float)) and v < 0:
                        errors.append(f"event #{n} (C): negative counter "
                                      f"value {k}={v}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event #{n} (X): bad dur {dur!r}")
        elif ph in "be":
            key = (ev.get("cat"), ev.get("id"))
            if key[0] is None or key[1] is None:
                errors.append(f"event #{n} ({ph}): missing cat/id")
                continue
            if ph == "b":
                open_async[key] = open_async.get(key, 0) + 1
            else:
                cnt = open_async.get(key, 0)
                if cnt <= 0:
                    errors.append(f"event #{n} (e): unmatched end {key}")
                else:
                    open_async[key] = cnt - 1
    for key, cnt in open_async.items():
        if cnt != 0:
            errors.append(f"async span {key}: {cnt} unmatched begin(s)")
    for field in ("audit", "intervals", "breakdown", "ops"):
        val = other.get(field)
        if val is not None and not isinstance(val, list):
            errors.append(f"otherData.{field} must be a list")
    for i, a in enumerate(other.get("audit") or []):
        if not isinstance(a, dict) or "chosen" not in a \
                or "candidates" not in a:
            errors.append(f"audit #{i}: missing chosen/candidates")
            break
    ops = other.get("ops")
    if isinstance(ops, list):
        required = ("tenant", "iid", "t_decide_ns", "end_ns")
        for i, o in enumerate(ops):
            if not isinstance(o, dict) \
                    or any(k not in o for k in required):
                errors.append(f"ops #{i}: missing one of {required}")
                break
    return errors


def summarize(obj: Any) -> Dict[str, object]:
    """Condense a validated trace: span counts per process, engine event
    counts, audit/interval sizes, and the heaviest (op, resource) rows.
    Raises ``ValueError`` on an invalid trace — the round-trip law is
    that ``validate`` accepts everything ``summarize`` accepts."""
    errors = validate_trace(obj)
    if errors:
        raise ValueError("invalid trace: " + "; ".join(errors[:5]))
    events = obj["traceEvents"]
    other = obj.get("otherData", {})
    pname: Dict[Any, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pname[ev.get("pid")] = ev["args"]["name"]
    spans_by_proc: Dict[str, int] = {}
    phases: Dict[str, int] = {}
    for ev in events:
        ph = ev["ph"]
        phases[ph] = phases.get(ph, 0) + 1
        if ph == "X":
            name = pname.get(ev.get("pid"), str(ev.get("pid")))
            spans_by_proc[name] = spans_by_proc.get(name, 0) + 1
    rows = sorted(other.get("breakdown") or [],
                  key=lambda r: -r.get("total_ns", 0.0))
    return {
        "schema": other.get("schema"),
        "n_events": len(events),
        "phases": phases,
        "spans_by_process": spans_by_proc,
        "engine_event_counts": other.get("event_counts", {}),
        "n_audit": len(other.get("audit") or []),
        "n_intervals": len(other.get("intervals") or []),
        "n_ops": len(other.get("ops") or []),
        "dropped_spans": other.get("dropped_spans", 0),
        "dropped_audit": other.get("dropped_audit", 0),
        "dropped_ops": other.get("dropped_ops", 0),
        "top_breakdown": rows[:5],
    }


def main(argv: Optional[List[str]] = None,
         out: TextIO = sys.stdout) -> int:
    """``python -m repro_torch.sim.telemetry summarize|validate <trace.json>``"""
    ap = argparse.ArgumentParser(
        prog="repro_torch.sim.telemetry",
        description="Inspect flight-recorder traces "
                    f"(schema {SCHEMA})")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, hlp in (("summarize", "print a condensed trace summary"),
                      ("validate", "structurally validate a trace")):
        p = sub.add_parser(name, help=hlp)
        p.add_argument("trace", help="path to an exported trace JSON")
        if name == "summarize":
            p.add_argument("--json", action="store_true",
                           help="emit one compact machine-readable JSON "
                                "line (sorted keys) instead of the "
                                "pretty-printed summary")
    args = ap.parse_args(argv)
    try:
        with open(args.trace) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: cannot read {args.trace}: {e}", file=out)
        return 2
    errors = validate_trace(obj)
    if args.cmd == "validate":
        if errors:
            for e in errors:
                print(f"INVALID: {e}", file=out)
            return 1
        print(f"OK: {args.trace} is a valid {SCHEMA} trace "
              f"({len(obj['traceEvents'])} events)", file=out)
        return 0
    if errors:
        print(f"error: invalid trace ({errors[0]})", file=out)
        return 1
    s = summarize(obj)
    if getattr(args, "json", False):
        print(json.dumps(s, sort_keys=True, separators=(",", ":")),
              file=out)
    else:
        print(json.dumps(s, indent=2), file=out)
    return 0


if __name__ == "__main__":                       # pragma: no cover
    sys.exit(main())
