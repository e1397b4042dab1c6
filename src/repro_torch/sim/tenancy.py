"""Multi-tenant trace interleaving on one shared SSD (§5 scaled out).

The paper evaluates one trace at a time; the regime the ROADMAP targets —
heavy traffic from many users — means *several* NDP programs plus ordinary
host read/write I/O contending for the same channels, dies, DRAM bus and
PCIe link.  :func:`simulate_mix` builds one shared
:class:`~repro_torch.sim.servers.Fabric`, binds every trace's
:class:`~repro_torch.sim.machine.Simulation` to one
:class:`~repro_torch.sim.events.EventEngine` (optionally at a staggered
``start_ns`` arrival offset per tenant), and optionally injects a
synthetic :class:`HostIOStream`; dispatches interleave in global time
order, so completion is out-of-order across tenants and the interference
is visible in per-tenant slowdown, Jain fairness and host-I/O tail
latency (:class:`~repro_torch.sim.stats.MixResult`).

Host I/O realism: requests target logical block addresses — uniformly or
Zipf-skewed (``zipf_theta``) — and the LBA hashes to the die, so repeated
writes to a hot LBA always land on (and invalidate pages of) the same
die.  Arrivals are pseudo-Poisson, optionally gated into on/off bursts
(``burst_duty`` / ``burst_len``), and an NVMe queue-depth cap
(``queue_depth``) defers arrivals beyond the outstanding-command limit at
the front end.

Passing ``ftl=FTLConfig(...)`` routes every host write through the
page-mapping flash translation layer of :mod:`repro_torch.sim.ftl`: writes
allocate physical pages in over-provisioned per-die block pools, and the
garbage collector runs as an event-driven background tenant whose page
copies and erases contend for the same die/channel pools (write
amplification shows up in every tenant's slowdown and in
``MixResult.ftl``).

API::

    mix = simulate_mix([trace_a, trace_b], "conduit",
                       io_stream=HostIOStream(rate_iops=50_000),
                       ftl=FTLConfig(op_ratio=0.12, prefill=0.9),
                       start_ns=[0.0, 2e6])
    mix.slowdowns        # {tenant: elapsed / solo_makespan}
    mix.host_io.p(99)    # host I/O tail latency under NDP + GC interference
    mix.ftl.write_amplification

``simulate_mix([trace])`` with no I/O stream reproduces
:func:`~repro_torch.sim.machine.simulate` exactly (the equivalence law in
``tests/test_events.py``), and an FTL with ``gc_enabled=False`` is
bit-identical to no FTL at all (``tests/test_ftl.py``).
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.policies import Policy, make_policy
from repro_torch.core.trace import Trace
from repro_torch.hw.ssd_spec import DEFAULT_SSD, SSDSpec
from repro_torch.sim.events import EventEngine, EventKind
from repro_torch.sim.ftl import FTLConfig, FTLModel, OutOfPhysicalBlocks
from repro_torch.sim.machine import SimConfig, Simulation, _hash01, simulate
from repro_torch.sim.servers import Fabric
from repro_torch.sim.stats import HostIOStats, MixResult
from repro_torch.sim.telemetry import TelemetryLike, as_recorder

PolicyLike = Union[str, Policy]

#: seed the FTL's LBA->die hash uses when no I/O stream is configured
DEFAULT_IO_SEED = 0xC0FFEE


def _die_of_lpn(lpn: int, seed: int, total_dies: int) -> int:
    """Stable LBA->die placement hash, shared by the host I/O stream and
    the FTL so the two always agree on where a logical page lives."""
    return int(_hash01(lpn, seed ^ 0xD1E) * total_dies) % total_dies


def build_ftl_model(ftl: FTLConfig, spec: SSDSpec, fabric: "Fabric",
                    engine: EventEngine,
                    io_stream: Optional["HostIOStream"]) -> FTLModel:
    """The one way an FTL is wired to a run (``simulate_mix`` and
    ``simulate_serving`` both call this): the stream's seed keys the
    shared LBA->die hash, so every entry point preconditions — and
    memoizes via the prefill snapshot cache — the same drive state for
    the same stream."""
    io_seed = io_stream.seed if io_stream is not None else DEFAULT_IO_SEED
    total_dies = spec.flash.total_dies
    return FTLModel(
        ftl, spec, fabric, engine,
        die_of=lambda lpn: _die_of_lpn(lpn, io_seed, total_dies),
        prefill_key=(io_seed, total_dies))


@functools.lru_cache(maxsize=8)
def _zipf_cdf(n: int, theta: float) -> Tuple[float, ...]:
    """Cumulative Zipf(theta) weights over ranks 1..n (rank == LBA)."""
    acc, out = 0.0, []
    for r in range(1, n + 1):
        acc += r ** -theta
        out.append(acc)
    return tuple(out)


@functools.lru_cache(maxsize=8)
def _request_plan(stream: "HostIOStream", space: int, total_dies: int
                  ) -> Tuple[Tuple[float, int, bool, int], ...]:
    """Per-request ``(arrival_ns, lpn, is_read, hashed_die)`` for a stream.

    Everything here is a pure function of the (frozen, hashable) stream
    spec, the LBA space and the die count, so sweeps that replay one
    stream against several FTL/fabric configurations (e.g. the GC-off
    vs. GC-on pairs of ``gc_interference``) hash the arrival process once
    instead of re-deriving it per run.  The FTL's dynamic L2P read
    resolution still happens at issue time."""
    seed = stream.seed
    lpn_seed = seed ^ 0x1BA5
    read_seed = seed ^ 0x4EAD
    theta = stream.zipf_theta
    cdf = _zipf_cdf(space, round(theta, 6)) if theta > 0.0 else None
    read_fraction = stream.read_fraction
    plan = []
    for i, t in enumerate(stream.arrival_times_ns()):
        u = min(0.999999, max(0.0, _hash01(i, lpn_seed)))
        if cdf is None:
            lpn = min(space - 1, int(u * space))
        else:
            lpn = min(space - 1, bisect.bisect_left(cdf, u * cdf[-1]))
        is_read = _hash01(i, read_seed) < read_fraction
        die = _die_of_lpn(lpn, seed, total_dies)
        plan.append((t, lpn, is_read, die))
    return tuple(plan)


@dataclasses.dataclass(frozen=True)
class HostIOStream:
    """Synthetic background host I/O: page-sized NVMe reads/writes.

    Arrivals follow a deterministic pseudo-Poisson process (inverse-CDF
    exponential gaps from a hashed uniform stream), so identical seeds
    replay identical workloads.  Each request targets an LBA — uniform
    over ``n_logical_pages`` or Zipf-skewed when ``zipf_theta > 0`` — and
    the LBA hashes to a die and its channel plus the PCIe link: the same
    contended units NDP operand movement and FTL garbage collection use.

    ``burst_duty < 1`` compresses arrivals into on/off bursts (``burst_len``
    requests per ON window at rate/duty, then an OFF pause) at the same
    mean rate; ``queue_depth`` models the NVMe front end's outstanding-
    command limit (excess arrivals queue before touching the fabric)."""

    rate_iops: float = 50_000.0      # mean arrival rate (requests / second)
    read_fraction: float = 0.7       # remainder are (SLC-program) writes
    n_requests: int = 256
    seed: int = DEFAULT_IO_SEED
    start_ns: float = 0.0
    n_logical_pages: int = 1 << 16   # LBA space the stream addresses
    zipf_theta: float = 0.0          # 0 = uniform; ~0.99 = classic hot/cold
    burst_duty: float = 1.0          # ON fraction of the arrival cycle
    burst_len: int = 32              # requests per ON window
    queue_depth: Optional[int] = None  # NVMe QD cap (None = unbounded)

    def __post_init__(self) -> None:
        if self.queue_depth is not None and self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1 (or None)")
        if self.burst_len < 1:
            raise ValueError("burst_len must be >= 1")
        if self.n_logical_pages < 1:
            raise ValueError("n_logical_pages must be >= 1")

    def arrival_times_ns(self) -> List[float]:
        mean_gap = 1e9 / max(1e-9, self.rate_iops)
        duty = min(1.0, max(1e-3, self.burst_duty))
        on_gap = mean_gap * duty
        off_pause = self.burst_len * mean_gap * (1.0 - duty)
        t = self.start_ns
        out = []
        for i in range(self.n_requests):
            u = min(0.999999, max(1e-9, _hash01(i, self.seed)))
            t += -on_gap * math.log(1.0 - u)
            out.append(t)
            if duty < 1.0 and (i + 1) % self.burst_len == 0:
                t += off_pause
        return out


class _HostIOModel:
    """Binds a :class:`HostIOStream` to the engine + fabric (+ FTL)."""

    def __init__(self, stream: HostIOStream, fabric: Fabric,
                 spec: SSDSpec, engine: EventEngine,
                 ftl: Optional[FTLModel] = None):
        self.stream = stream
        self.fabric = fabric
        self.spec = spec
        self.engine = engine
        self.ftl = ftl
        if ftl is not None:
            ftl.attach_host(self)      # GC suspend throttle probes our QD
        # when an FTL is present its logical space bounds the LBAs (the
        # stream's space folds into it; size them equal for exact studies)
        self.space = ftl.n_logical if ftl is not None \
            else max(1, stream.n_logical_pages)
        self.latency_by_req: Dict[int, float] = {}
        self.n_reads = 0
        self.n_writes = 0
        self.outstanding = 0
        self.pending: Deque[Tuple[int, float]] = deque()
        self.last_complete_ns = 0.0
        # fault subsystem (None when inactive — the common case); the
        # FaultModel is constructed before the host I/O model, so the
        # fabric slot is already populated here
        self.faults = fabric.faults
        self.failed_reqs: set = set()       # ops surfaced as failed
        self.attempts: Dict[int, int] = {}  # req id -> timeout re-issues
        self.n_failed = 0
        # optional flight recorder (repro_torch.sim.telemetry): request spans
        self.telemetry = None
        # hoisted per-request constants (the issue path runs per event)
        f, h = spec.flash, spec.host
        nb = spec.page_size
        self._xfer_ns = f.t_dma_ns + nb * f.channel_ns_per_byte
        self._link_ns = nb * h.pcie_ns_per_byte + h.pcie_latency_ns
        self._qd = stream.queue_depth
        # per-request (arrival, lpn, is_read, hashed_die), memoized across
        # runs replaying the same stream spec.  Arrivals are *chained*:
        # only the first is scheduled here; _on_arrival consumes runs of
        # consecutive arrivals inline (batched) and schedules a real event
        # only for the first arrival that something else could preempt.
        self.plan = _request_plan(stream, self.space, spec.flash.total_dies)
        if self.plan:
            engine.schedule(self.plan[0][0], EventKind.IO_ARRIVAL,
                            self._on_arrival, payload=0)

    def _on_arrival(self, i: int) -> None:
        engine = self.engine
        qd = self._qd
        if qd is not None and self.outstanding >= qd:
            self.pending.append((i, engine.now))  # NVMe QD front-end cap
        else:
            self._issue(i, engine.now)
        # Burst batching: every later arrival that strictly precedes the
        # next pending event cannot interleave with anything — process it
        # here with the same clock updates, processed count and log records
        # the engine's run loop would have applied, and fall back to a real
        # event at the first arrival that ties or follows one.  IO_COMPLETE
        # and GC events scheduled by _issue land in the heap immediately,
        # so they bound the batch exactly as before.
        plan = self.plan
        n = len(plan)
        j = i + 1
        if j >= n:
            return
        record = engine.record
        tele = engine.telemetry
        while True:
            t_j = plan[j][0]
            nt = engine.next_time()
            horizon = engine.horizon
            if (nt is not None and t_j >= nt) or \
                    (horizon is not None and t_j >= horizon):
                # an arrival at/after the run horizon must go back on the
                # heap: the caller of run(until)/run_before() may inject
                # events there (fleet advance-to-time seam)
                engine.schedule(t_j, EventKind.IO_ARRIVAL, self._on_arrival,
                                payload=j)
                return
            if t_j > engine.now:
                engine.now = t_j
            engine.processed += 1
            if record:
                engine.log.append((engine.now, EventKind.IO_ARRIVAL))
            if tele is not None:
                tele.on_event(engine.now, EventKind.IO_ARRIVAL)
            arr = engine.now
            if qd is not None and self.outstanding >= qd:
                self.pending.append((j, arr))
            else:
                self._issue(j, arr)
            j += 1
            if j >= n:
                return

    def _issue(self, i: int, arrival_ns: float) -> None:
        self.outstanding += 1
        f = self.spec.flash
        now = self.engine.now
        _, lpn, is_read, die = self.plan[i]
        during_gc = self.ftl is not None and self.ftl.gc_busy
        tele = self.telemetry
        if tele is not None:
            tele.ctx = f"io#{i}:{'r' if is_read else 'w'}"
            tele.ctx_args = {"io": i, "die": die,
                             "rw": "r" if is_read else "w"}
        xfer = self._xfer_ns
        link = self._link_ns
        fm = self.faults
        retry = i in self.attempts     # timeout re-issue: counters already
        if is_read:                    # advanced on the first attempt
            if not retry:
                self.n_reads += 1
            if self.ftl is not None:
                die = self.ftl.read_die(lpn, die)   # L2P-resolved placement
            chan = die % f.channels
            t = self.fabric.dies.acquire_end(now, f.t_read_ns, unit=die)
            if fm is not None:
                blk = pg = -1
                if self.ftl is not None:
                    ppn = self.ftl.read_ppn(lpn)
                    if ppn is not None:
                        blk, pg = ppn[1], ppn[2]
                t, ok = fm.check_read(t, die, blk, pg)
                if not ok:
                    # unrecoverable read: the command completes with an
                    # error status — surfaced, never silently dropped
                    self.failed_reqs.add(i)
            t = self.fabric.channels.acquire_end(t, xfer, unit=chan)
            t = self.fabric.pcie.acquire_end(t, link)
        else:
            if not retry:
                self.n_writes += 1
            chan = die % f.channels
            rejected = fm is not None and not fm.write_ok(die, now)
            if not rejected and self.ftl is not None:
                try:
                    self.ftl.host_write(lpn, die)   # map + invalidate old PPN
                except OutOfPhysicalBlocks:
                    # retirement drained the die's pool: degrade loudly
                    fm.mark_read_only(die)
                    rejected = True
            if rejected:
                fm.note_failed_write(die)
                self.failed_reqs.add(i)
                # the rejected command still crosses the link (error
                # completion); the flash program never happens
                t = self.fabric.pcie.acquire_end(now, link)
            else:
                t = self.fabric.pcie.acquire_end(now, link)
                t = self.fabric.channels.acquire_end(t, xfer, unit=chan)
                t = self.fabric.dies.acquire_end(t, f.t_prog_ns, unit=die)
                if self.ftl is not None:
                    self.ftl.maybe_start_gc(die)    # watermark check
        if tele is not None:
            tele.on_io_issue(i, arrival_ns, is_read, die)
        self.engine.schedule(t, EventKind.IO_COMPLETE, self._on_complete,
                             payload=(i, arrival_ns, during_gc))

    def _on_complete(self, payload: Tuple[int, float, bool]) -> None:
        i, arrival, during_gc = payload
        now = self.engine.now
        lat = now - arrival
        fm = self.faults
        failed = i in self.failed_reqs
        if fm is not None and not failed and fm.op_deadline_exceeded(lat):
            st = fm.stats_
            st.n_op_timeouts += 1
            attempt = self.attempts.get(i, 0)
            if attempt < fm.cfg.max_op_retries:
                # the host aborts and re-issues after exponential backoff;
                # the recorded latency spans first arrival -> final done
                self.attempts[i] = attempt + 1
                st.n_op_retries += 1
                self.outstanding -= 1
                if self.telemetry is not None:
                    # close this attempt's async span — the retry's
                    # _issue emits a fresh "b" for the same request id,
                    # so without this the b/e balance check would reject
                    # every trace from an op-timeout run
                    self.telemetry.on_io_timeout(i, self.plan[i][2], now)
                self.engine.schedule(now + fm.op_backoff_ns(attempt),
                                     EventKind.IO_ARRIVAL, self._on_retry,
                                     payload=(i, arrival))
                if self.pending:
                    j, arr = self.pending.popleft()
                    self._issue(j, arr)             # aborted slot freed
                return
            st.n_failed_ops += 1                    # retry budget spent
            self.failed_reqs.add(i)
            failed = True
        if failed:
            self.n_failed += 1      # excluded from the latency population
        else:
            self.latency_by_req[i] = lat
        if during_gc:
            self.ftl.note_host_latency_during_gc(lat)
        self.last_complete_ns = max(self.last_complete_ns, now)
        if self.telemetry is not None:
            self.telemetry.on_io_complete(i, self.plan[i][2], now)
        self.outstanding -= 1
        if self.pending:
            j, arr = self.pending.popleft()
            self._issue(j, arr)                     # QD slot freed

    def _on_retry(self, payload: Tuple[int, float]) -> None:
        """Re-issue a timed-out op after its backoff; the retry respects
        the NVMe queue-depth cap exactly like a fresh arrival."""
        i, arrival = payload
        if self._qd is not None and self.outstanding >= self._qd:
            self.pending.append((i, arrival))
        else:
            self._issue(i, arrival)

    def stats(self) -> HostIOStats:
        # latencies indexed by request id (not completion order), so two
        # runs of the same stream compare request-for-request
        lats = [self.latency_by_req[i] for i in sorted(self.latency_by_req)]
        return HostIOStats(n_reads=self.n_reads, n_writes=self.n_writes,
                           latencies_ns=lats, n_failed=self.n_failed)


def clone_trace(tr: Trace) -> Trace:
    """Clone a Trace template for an independent tenant/session.

    A Trace owns its PageTable (mutable residency state): concurrent
    executions must never share one.  Everything else — the instruction
    list, the input/output page-id lists — is immutable during simulation
    and *shared*, which also shares the per-instruction cost-function
    memos: sessions of the same catalog kind in an open-loop serving run
    derive the static features once, not once per admission."""
    return Trace(instrs=tr.instrs, pages=tr.pages.clone(),
                 input_pages=tr.input_pages, output_pages=tr.output_pages,
                 name=tr.name)


def _as_policies(policies: Union[PolicyLike, Sequence[PolicyLike]],
                 n: int, spec: SSDSpec) -> List[Policy]:
    if isinstance(policies, (str, Policy)):
        policies = [policies] * n
    if len(policies) != n:
        raise ValueError(f"{len(policies)} policies for {n} traces")
    return [make_policy(p, spec) if isinstance(p, str) else p
            for p in policies]


def simulate_mix(traces: Sequence[Trace],
                 policies: Union[PolicyLike, Sequence[PolicyLike]] = "conduit",
                 io_stream: Optional[HostIOStream] = None,
                 spec: SSDSpec = DEFAULT_SSD,
                 config: Optional[SimConfig] = None,
                 compute_solo: bool = True,
                 engine: Optional[EventEngine] = None,
                 ftl: Optional[FTLConfig] = None,
                 start_ns: Optional[Sequence[float]] = None,
                 record_decisions: Optional[bool] = None,
                 telemetry: TelemetryLike = None,
                 faults=None) -> MixResult:
    """Run several traces concurrently on one SSD, plus optional host I/O.

    ``policies`` is one policy (applied to every trace) or one per trace;
    strings go through :func:`make_policy`.  ``compute_solo`` additionally
    runs each (trace, policy) alone on a private fabric to provide the
    solo makespans behind :attr:`MixResult.slowdowns` — disable it for
    large sweeps where only the contended numbers matter.  ``start_ns``
    staggers tenant arrivals (one offset per trace; slowdowns compare
    elapsed time from each tenant's own arrival).  ``ftl`` enables the
    flash translation layer of :mod:`repro_torch.sim.ftl` with garbage
    collection as a background tenant.  Pass a ``record=True``
    :class:`EventEngine` to capture the event timeline.
    ``record_decisions=False`` is the fast mode: skip per-dispatch
    DecisionRecord allocation (timing identical; op latencies stay
    available) — overrides the same flag on ``config``.  ``telemetry``
    attaches a :class:`~repro_torch.sim.telemetry.FlightRecorder` to the shared
    engine/fabric/FTL/I-O model (solo reference runs stay unobserved);
    the recorder comes back on ``result.telemetry``.  ``faults`` takes a
    :class:`~repro_torch.sim.faults.FaultConfig`: an active config arms the
    RBER error model, the read-recovery ladder, bad-block retirement and
    the host op-timeout machinery on the shared fabric (solo reference
    runs stay fault-free); ``None`` or an all-off config is bit-identical
    to a build without the fault subsystem.
    """
    traces = list(traces)
    if not traces:
        raise ValueError("simulate_mix needs at least one trace")
    starts = list(start_ns) if start_ns is not None else [0.0] * len(traces)
    if len(starts) != len(traces):
        raise ValueError(f"{len(starts)} start offsets for {len(traces)} traces")
    if any(s < 0 for s in starts):
        raise ValueError("start_ns offsets must be >= 0")
    cfg = config or SimConfig()
    if record_decisions is not None:
        cfg = dataclasses.replace(cfg, record_decisions=record_decisions)
    pols = _as_policies(policies, len(traces), spec)

    # A Trace owns its PageTable (mutable residency state): tenants must
    # not share one, so duplicate Trace objects get an isolated clone
    # (instruction metadata stays shared — see clone_trace).
    seen: set = set()
    tenant_traces: List[Trace] = []
    for tr in traces:
        if id(tr) in seen:
            tr = clone_trace(tr)
        seen.add(id(tr))
        tenant_traces.append(tr)

    names = [f"t{i}:{tr.name or 'trace'}"
             for i, tr in enumerate(tenant_traces)]

    solo: Dict[str, float] = {}
    if compute_solo:
        for name, tr, pol in zip(names, tenant_traces, pols):
            solo[name] = simulate(tr, pol, spec, cfg).makespan_ns

    engine = engine or EventEngine()
    fabric = Fabric(spec, pud_units=cfg.pud_units)
    fm = None
    if faults is not None and faults.active:
        from repro_torch.sim.faults import FaultModel
        fm = FaultModel(faults, spec, fabric, engine)
    tele = as_recorder(telemetry)
    if tele is not None:
        tele.attach(fabric=fabric, engine=engine)
        if fm is not None:
            tele.attach_faults(fm)
        tele.run_meta.setdefault("entry", "simulate_mix")
        tele.run_meta.setdefault(
            "policy", ",".join(sorted({p.name for p in pols})))
    ftl_model = (build_ftl_model(ftl, spec, fabric, engine, io_stream)
                 if ftl is not None else None)
    if ftl_model is not None and fm is not None:
        ftl_model.attach_faults(fm)
    if tele is not None and ftl_model is not None:
        tele.attach_ftl(ftl_model)
    sims = [Simulation(tr, pol, spec, cfg, fabric=fabric, tenant=name,
                       start_ns=st)
            for name, tr, pol, st in zip(names, tenant_traces, pols, starts)]
    for sim in sims:
        sim.bind(engine)
    io = (_HostIOModel(io_stream, fabric, spec, engine, ftl=ftl_model)
          if io_stream is not None else None)
    if tele is not None and io is not None:
        tele.attach_host_io(io)
    engine.run()

    results = [sim.result() for sim in sims]
    # the GC tail counts: collector copy/erase bookings regularly finish
    # after the last session and the last host completion
    makespan = max([r.makespan_ns for r in results]
                   + ([io.last_complete_ns] if io else [])
                   + ([ftl_model.last_booked_ns]
                      if ftl_model is not None else []))
    return MixResult(tenants=results, solo_makespan_ns=solo,
                     host_io=io.stats() if io else None,
                     fabric_busy_ns=fabric.busy_ns(),
                     makespan_ns=makespan,
                     ftl=ftl_model.stats() if ftl_model is not None else None,
                     telemetry=tele,
                     faults=fm.stats() if fm is not None else None)
