"""Discrete-event core of the SSD NDP simulator (MQSim/FTL-SIM style).

The simulator is organised around a single time-ordered event heap
(:class:`EventEngine`) plus FIFO resource queues (:class:`ServerPool` /
:class:`~repro_torch.sim.servers.Fabric`).  Every concurrent activity in the
machine — a tenant's offloader dispatching its next vector instruction, a
host I/O request arriving at the NVMe front end, a trace's epilogue flush —
is a scheduled ``(kind, handler, payload)`` record; handlers book time on
the contended server pools and schedule their own follow-on events.

Semantics:

* Events pop in (time, sequence) order; the sequence counter breaks ties
  deterministically, so identical inputs always replay identically.
* Timestamps are monotone: a handler may only schedule events at or after
  the engine's current time (asserted), so the global timeline never runs
  backwards — the invariant `tests/test_events.py` checks.
* Resource occupancy uses the *lazy-acquire* discipline of
  :class:`~repro_torch.sim.servers.ServerPool`: a handler processed at time *t*
  books a unit from the unit's free time onwards, which serialises work in
  event (== dispatch) order per unit — the FIFO queue of an event-driven
  SSD simulator without materialising one pending-job list per unit.
  Caveat: a dispatch whose operands are not ready yet still reserves its
  unit *now* for a start in the future, so a later arrival (another
  tenant, a host I/O request) queues behind work that has not physically
  started even if the unit is idle in between.  This keeps single-trace
  results identical to the pre-event-engine simulator and is conservative
  (pessimistic) for cross-tenant interference; operand-ready re-queueing
  is a ROADMAP follow-on.

Performance notes:

* An event IS its heap entry: a plain ``(time, seq, kind, handler,
  payload)`` tuple.  Ordering is decided entirely by the ``(time, seq)``
  prefix — ``seq`` is unique, so tuple comparison never reaches the
  ``kind``/``handler``/``payload`` elements — and no per-event object or
  side-table record is ever allocated.
* Handlers take the event's *payload* directly (``handler(payload)``) —
  there is no event object to pass.  Keep them allocation-light: booking
  time on pools costs O(log k) heap pushes (see :mod:`repro_torch.sim.servers`);
  anything that allocates per event (list comprehensions over units,
  per-call closures, rebuilding latency tables) shows up directly in
  events/sec — ``benchmarks/perf_bench.py`` tracks the trajectory in
  ``BENCH_sim_perf.json``.

Single-trace runs degenerate to a single event source processed in program
order, which is why :func:`repro_torch.sim.tenancy.simulate_mix` with one trace
reproduces :func:`repro_torch.sim.machine.simulate` exactly.
"""
from __future__ import annotations

import enum
from heapq import heappop, heappush
from typing import Any, Callable, List, Optional, Tuple


class EventKind(enum.Enum):
    """Typed events of the NDP simulation (§5.1 simulator structure)."""

    DISPATCH = "dispatch"        # offloader decides + issues one instruction
    EPILOGUE = "epilogue"        # end-of-trace result flush to host (§4.4 ii)
    IO_ARRIVAL = "io_arrival"    # host read/write request enters the SSD
    IO_COMPLETE = "io_complete"  # host request leaves (latency accounting)
    GC = "gc"                    # FTL garbage-collection cycle (background tenant)
    SESSION_ARRIVAL = "session_arrival"  # open-loop session enters admission
    TIMER = "timer"              # generic callback (tests, snapshots, policies)


class EventEngine:
    """Time-ordered event heap with deterministic tie-breaking.

    ``record=True`` keeps a ``(time, kind)`` log of every processed event —
    used by the monotonicity tests and handy for debugging interleavings.
    """

    #: tolerance for the monotone-schedule assertion (float round-off)
    EPS = 1e-6

    def __init__(self, record: bool = False):
        self.now: float = 0.0
        self.processed: int = 0
        # heap of (time, seq, kind, handler, payload); (time, seq) is a
        # unique sort key, the trailing elements are never compared
        self._heap: List[tuple] = []
        self._seq: int = 0
        self.record = record
        self.log: List[Tuple[float, EventKind]] = []
        # optional pure-observer flight recorder (repro_torch.sim.telemetry);
        # attach before run() — the loop hoists it once
        self.telemetry = None
        # clock bound of the innermost run()/run_before() call, or None
        # when running to quiescence.  Event sources that batch work
        # inline past the heap (see tenancy._HostIOModel._on_arrival)
        # must not advance ``now`` to or beyond the horizon: the caller
        # may inject new events there (the fleet's advance-to-time seam).
        self.horizon: Optional[float] = None

    def schedule(self, time: float, kind: EventKind,
                 handler: Callable[[Any], None],
                 payload: Any = None) -> None:
        """Schedule ``handler(payload)`` at ``time`` (>= now: time cannot
        run back)."""
        now = self.now
        if time < now:
            if time < now - self.EPS:
                raise ValueError(
                    f"event {kind} scheduled at {time} < now {now}")
            time = now
        seq = self._seq
        self._seq = seq + 1
        heappush(self._heap, (time, seq, kind, handler, payload))

    def empty(self) -> bool:
        return not self._heap

    def next_time(self) -> Optional[float]:
        """Timestamp of the next pending event, or None if the heap is
        empty — lets arrival sources batch work that cannot interleave
        with anything (see :mod:`repro_torch.sim.tenancy`)."""
        heap = self._heap
        return heap[0][0] if heap else None

    def run(self, until: Optional[float] = None) -> float:
        """Process events in time order; returns the final clock value."""
        heap = self._heap
        record = self.record
        tele = self.telemetry
        pop = heappop
        prev_horizon = self.horizon
        self.horizon = until
        try:
            while heap:
                time = heap[0][0]
                if until is not None and time > until:
                    break
                ev = pop(heap)
                if time > self.now:
                    self.now = time
                self.processed += 1
                if record:
                    self.log.append((self.now, ev[2]))
                if tele is not None:
                    tele.on_event(self.now, ev[2])
                ev[3](ev[4])
        finally:
            self.horizon = prev_horizon
        return self.now

    def run_before(self, t: float) -> float:
        """Process events strictly before ``t``; returns the clock.

        The advance-to-time seam of a :class:`~repro_torch.sim.drive.DriveActor`:
        ``run(until=t)`` would also pop events at exactly ``t``, but a
        fleet front-end that is about to inject a session *at* ``t`` must
        leave same-instant events pending so their relative order against
        the injected arrival is decided by the heap's ``(time, seq)`` key,
        not by who called ``run`` first.  Bookkeeping mirrors :meth:`run`."""
        heap = self._heap
        record = self.record
        tele = self.telemetry
        pop = heappop
        prev_horizon = self.horizon
        self.horizon = t
        try:
            while heap and heap[0][0] < t:
                ev = pop(heap)
                if ev[0] > self.now:
                    self.now = ev[0]
                self.processed += 1
                if record:
                    self.log.append((self.now, ev[2]))
                if tele is not None:
                    tele.on_event(self.now, ev[2])
                ev[3](ev[4])
        finally:
            self.horizon = prev_horizon
        return self.now
