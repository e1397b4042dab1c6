"""Discrete-event SSD NDP simulator (§5.1-§5.2).

Inherits MQSim's structural model — channels/dies as contended units, L2P
mapping with a DFTL-style cache, per-resource execution queues — and adds
the five Conduit NDP extensions (§5.1): (1) an internal DRAM model,
(2) compute models for ISP / PuD-SSD / IFP, (3) dedicated execution queues
per compute resource, (4) offloader-coupled scheduling of operand movement,
(5) NDP-aware page placement (same-block constraint for MWS ops).

Execution is driven by the time-ordered event heap in
:mod:`repro_torch.sim.events`: each trace's offloader core emits ``DISPATCH``
events (in-order issue, pipelined across offloader cores, charging the §4.5
overhead); the handler decides a target resource, books operand movement
over the contended links, books execution on the resource's FIFO queue, and
schedules the next dispatch.  Instruction *completion* is therefore
out-of-order — across resources within one trace, and across tenants when
several traces share one :class:`~repro_torch.sim.servers.Fabric` (see
:func:`repro_torch.sim.tenancy.simulate_mix`).  A single trace degenerates to one
event source processed in program order, so :func:`simulate` is the exact
single-tenant special case of the event engine.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.cost import (HOME, HOME_BY_INDEX, SystemView, dm_energy_nj,
                                   exec_energy_nj, exec_latency_ns)
from repro_torch.core.isa import Location, Resource, VectorInstr
from repro_torch.core.policies import Policy, make_policy
from repro_torch.core.trace import Trace
from repro_torch.hw.ssd_spec import DEFAULT_SSD, SSDSpec
from repro_torch.sim.events import EventEngine, EventKind
from repro_torch.sim.servers import Fabric, ServerPool
from repro_torch.sim.stats import SimResult
from repro_torch.sim.telemetry import DecisionRecord, TelemetryLike, as_recorder


@dataclasses.dataclass
class SimConfig:
    dram_capacity_pages: Optional[int] = None    # default: footprint/8
    host_capacity_pages: Optional[int] = None    # default: footprint/4
    fail_rate: float = 0.0                       # transient-fault injection
    move_outputs_to_host: bool = True            # epilogue (§4.4 trigger ii)
    pud_units: int = 8                           # per-bank bbop engines
    seed: int = 0x5AFA11
    # False = fast mode: skip allocating one DecisionRecord per dispatch
    # (open-loop serving runs at high arrival rates would otherwise
    # accumulate unbounded per-dispatch records).  Timing/energy results
    # are bit-identical either way; per-op latencies stay available via
    # SimResult.op_latencies_ns, which is a plain float list.
    record_decisions: bool = True


STATIC_DISPATCH_NS = 200.0   # queue-push cost for compile-time-mapped policies
BUFFER_DEPTH = 4             # pages buffered per plane (S/A/B/C data latches)

# hot-loop constants (module-level load beats enum-class attribute chain)
_DISPATCH = EventKind.DISPATCH
_EPILOGUE = EventKind.EPILOGUE


def _hash01(iid: int, seed: int) -> float:
    x = (iid * 2654435761 + seed) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x45D9F3B) & 0xFFFFFFFF
    x ^= x >> 16
    return x / 2**32


def _zero_queue(r: Resource) -> float:
    """Queue feature of the contention-free Ideal policy view."""
    return 0.0


class Simulation:
    """One trace executing on one (possibly shared) SSD fabric.

    ``fabric=None`` builds a private :class:`Fabric` — the single-tenant
    case.  :func:`repro_torch.sim.tenancy.simulate_mix` passes a shared fabric
    plus a shared :class:`EventEngine` so several Simulations interleave on
    the same channels/dies/buses in global time order.
    """

    def __init__(self, trace: Trace, policy: Policy,
                 spec: SSDSpec = DEFAULT_SSD,
                 config: Optional[SimConfig] = None,
                 fabric: Optional[Fabric] = None,
                 tenant: str = "",
                 start_ns: float = 0.0):
        self.trace = trace
        self.policy = policy
        self.spec = spec
        self.cfg = config or SimConfig()
        self.tenant = tenant or trace.name
        self.start_ns = start_ns      # arrival offset (staggered tenants)
        self.fabric = fabric or Fabric(spec, pud_units=self.cfg.pud_units)
        self.pools: Dict[Resource, ServerPool] = self.fabric.pools
        self._pools_by_index = self.fabric.pools_by_index
        self.offloader = self.fabric.offloader
        self.channels = self.fabric.channels
        self.dies = self.fabric.dies
        self.dram_bus = self.fabric.dram_bus
        self.pcie = self.fabric.pcie

        self.pages = trace.pages
        if not self.pages._initial:
            self.pages.snapshot_initial()
        self.pages.reset()
        npages = len(self.pages)
        self.dram_cap = self.cfg.dram_capacity_pages or max(32, npages // 8)
        self.host_cap = self.cfg.host_capacity_pages or max(32, npages // 4)
        # plain dicts as LRUs: insertion order is the recency order
        # (pop + reinsert moves to back, next(iter(...)) is the victim)
        self.dram_lru: Dict[int, float] = {}
        self.host_lru: Dict[int, float] = {}

        # completion times indexed by iid (the Trace builder numbers iids
        # 0..n-1 in emit order, so a flat list replaces dict hashing on
        # the dependency scan; None = not yet dispatched)
        self._comp_size = 1 + max(
            (ins.iid for ins in trace.instrs), default=-1)
        self.completion: List[Optional[float]] = [None] * self._comp_size
        # IFP page buffers: each channel-unit holds up to BUFFER_DEPTH pages
        # in its planes' S/D latches; page -> unit map gives latch affinity.
        self.unit_buffers: Dict[int, List[int]] = {}
        self.buffered: Dict[int, int] = {}             # page -> unit
        # Static per-version liveness (compile-time metadata): a page is
        # live at instruction i iff its next event after i is a READ; if the
        # next event is a WRITE (the value is dead — the physical page gets
        # recycled) it can be discarded from latches/caches without a
        # write-back.
        self.page_events: Dict[int, List[Tuple[int, bool]]] = {}
        for ins in trace.instrs:
            for s in ins.srcs:
                self.page_events.setdefault(s, []).append((ins.iid, True))
            self.page_events.setdefault(ins.dst, []).append((ins.iid, False))
        self.out_pages_set = {p for pl in trace.output_pages for p in pl}
        self._cursor_iid = 0

        # event-driven dispatch state
        self.engine: Optional[EventEngine] = None
        # flight recorder routed via the fabric (bind() re-reads it): the
        # dispatch loop's hooks collapse to one branch when unset
        self._tele = None
        self._idx = 0                       # next instruction to dispatch
        self._prev_decide_end = start_ns    # offloader pipeline cursor
        self._makespan = start_ns
        self.done = False
        # an NDP operand sense came back unrecoverable (fault injection):
        # the trace still drains — timing stays honest — but the result is
        # marked failed and the serving layer surfaces it as a failed op
        self.failed = False
        # fault subsystem, if one is attached to the fabric (re-read in
        # bind(): tenancy/serving construct the FaultModel after the sims)
        self._faults = None
        self._last_ifp_unit: Optional[int] = None
        # completion hook: the open-loop serving driver uses this to free
        # an admission slot / record session latency the moment a trace
        # drains (set before bind(); never affects simulation timing)
        self.on_done: Optional[Callable[["Simulation"], None]] = None

        # -- hoisted per-dispatch structures (perf) ---------------------------
        # Link-latency constants (page-sized transfers; float addition is
        # commutative, so one constant serves both operand directions).
        f, d, h = spec.flash, spec.dram, spec.host
        nb = spec.page_size
        self._chan_xfer_ns = f.t_dma_ns + nb * f.channel_ns_per_byte
        self._bus_ns = nb * d.bus_ns_per_byte
        self._pcie_ns = nb * h.pcie_ns_per_byte + h.pcie_latency_ns
        self._pcie_nolat_ns = nb * h.pcie_ns_per_byte
        # Movement-path queue feature: pool lists per location pair live on
        # the (possibly shared) fabric — computed once per SSD, not per
        # tenant.  Flat int-indexed form: see Fabric.path_pools_by_index.
        self._path_pools_flat = self.fabric.path_pools_by_index
        self._n_locations = self.fabric.n_locations
        # Persistent SystemViews: the offloader's runtime snapshot reuses
        # bound methods reading the cursor fields below instead of building
        # a dataclass plus three closures per dispatch.
        self._view_now = 0.0
        self._cur_deps_ready = start_ns
        self._view = SystemView(
            now_ns=0.0,
            queue_delay_ns=self._queue_feature,
            dep_ready_ns=self._dep_feature,
            location_of=self.pages.location,
            move_queue_ns=self._move_queue_feature,
            tenant=self.tenant,
            # fast-path mirrors: select_fast probes these directly
            # (pages.reset() mutates entries in place, so the dict
            # reference stays valid across pooled re-admissions)
            pools_by_index=self._pools_by_index,
            path_pools_flat=self._path_pools_flat,
            n_locations=self._n_locations,
            page_entries=self.pages.entries)
        self._ideal_view = SystemView(
            0.0, _zero_queue, self._dep_feature, self.pages.location,
            tenant=self.tenant)

        # accounting
        self.compute_energy = 0.0
        self.movement_energy = 0.0
        self.overhead_total = 0.0
        self.coherence_syncs = 0
        self.evictions = 0
        self.replays = 0
        self.colocations = 0
        self.decisions: List[DecisionRecord] = []
        # per-op dispatch-to-completion latencies, kept even when full
        # DecisionRecord logging is off (floats only — the cheap part)
        self.op_latencies: List[float] = []
        self._record_decisions = self.cfg.record_decisions
        # fault replay is the only consumer of the full per-candidate
        # feature dict; without it the dispatch loop can take the
        # allocation-free select_fast path (bit-identical argmin)
        self._fast_select = self.cfg.fail_rate == 0.0
        # dispatch-loop hoists: per-dispatch reads of immutable state
        self._instrs = trace.instrs
        self._n_instrs = len(trace.instrs)
        self._policy_dynamic = policy.dynamic
        self._ignores_contention = policy.ignores_contention
        self._select_fast_fn = policy.select_fast
        # list-backed by Resource.index (enum hashing off the hot path);
        # result() rebuilds the public Dict[Resource, int] form
        self._resource_counts: List[int] = [0] * len(Resource)
        # §4.5 decision-overhead constants that do not depend on the
        # instruction: folded once (decision_overhead_ns inlined in
        # _on_dispatch; equivalence pinned in test_cost_and_policies)
        self._decide_const_ns = (spec.queue_delay_track_ns
                                 + spec.dm_latency_lookup_ns
                                 + spec.comp_latency_lookup_ns
                                 + spec.translation_lookup_ns)
        self._l2p_dram_ns = spec.l2p_lookup_dram_ns
        self._l2p_flash_ns = spec.l2p_lookup_flash_ns
        self._dep_track_ns = spec.dep_delay_track_ns
        self._inject_faults = self.cfg.fail_rate > 0.0

    def reset(self, tenant: str = "", start_ns: float = 0.0) -> None:
        """Rewind for a fresh admission of the same trace.

        The open-loop serving driver pools Simulations per catalog entry:
        re-admitting a session reuses the trace clone, the PageTable and
        every hoisted per-trace structure, restoring only the state a run
        mutates.  Equivalent to constructing a new Simulation over a fresh
        ``clone_trace`` (pinned by the pooling-law tests).  ``decisions``
        and ``op_latencies`` get NEW lists — a previously returned
        ``result()`` keeps references to the old ones."""
        self.tenant = tenant or self.trace.name
        self.start_ns = start_ns
        self.pages.reset()
        self.dram_lru.clear()
        self.host_lru.clear()
        self.completion = [None] * self._comp_size
        self.unit_buffers.clear()
        self.buffered.clear()
        self._cursor_iid = 0
        self.engine = None
        self._tele = None
        self._idx = 0
        self._prev_decide_end = start_ns
        self._makespan = start_ns
        self.done = False
        self.failed = False
        self._faults = None
        self._last_ifp_unit = None
        self.on_done = None
        self._view_now = 0.0
        self._cur_deps_ready = start_ns
        self._view.tenant = self.tenant
        self._ideal_view.tenant = self.tenant
        self.compute_energy = 0.0
        self.movement_energy = 0.0
        self.overhead_total = 0.0
        self.coherence_syncs = 0
        self.evictions = 0
        self.replays = 0
        self.colocations = 0
        self.decisions = []
        self.op_latencies = []
        counts = self._resource_counts
        for i in range(len(counts)):
            counts[i] = 0

    # -- data movement --------------------------------------------------------

    def _move_page(self, pid: int, to: Location, ready: float) -> float:
        """Move one page; returns completion time.  Occupies the interconnect
        servers on the path and performs the §4.4 lazy-coherence updates."""
        ent = self.pages[pid]
        src = ent.location
        if src == to:
            self._touch(pid, to, ready)
            return ready
        f = self.spec.flash
        nb = self.spec.page_size
        t = ready
        if ent.dirty and ent.owner not in (Location.FLASH, to):
            self.coherence_syncs += 1      # cross-resource request on dirty page

        if src == Location.FLASH:
            if pid not in self.buffered:   # latched pages skip the sense
                t = self.dies.acquire_end(t, f.t_read_ns, unit=ent.die)
                fm = self._faults
                if fm is not None:
                    # NDP operand senses are unmapped by the FTL
                    # (blk/pg = -1): base + retention error rate only
                    t, ok = fm.check_read(t, ent.die)
                    if not ok:
                        self.failed = True
            t = self.channels.acquire_end(
                t, self._chan_xfer_ns, unit=ent.channel)
            if to in (Location.DRAM, Location.CTRL):
                t = self.dram_bus.acquire_end(t, self._bus_ns)
            elif to == Location.HOST:
                t = self.pcie.acquire_end(t, self._pcie_ns)
        elif src in (Location.DRAM, Location.CTRL):
            t = self.dram_bus.acquire_end(t, self._bus_ns)
            if to == Location.FLASH:
                t = self.channels.acquire_end(
                    t, self._chan_xfer_ns, unit=ent.channel)
                t = self.dies.acquire_end(t, f.t_prog_ns, unit=ent.die)
            elif to == Location.HOST:
                t = self.pcie.acquire_end(t, self._pcie_ns)
        elif src == Location.HOST:
            t = self.pcie.acquire_end(t, self._pcie_ns)
            if to == Location.FLASH:
                t = self.channels.acquire_end(
                    t, self._chan_xfer_ns, unit=ent.channel)
                t = self.dies.acquire_end(t, f.t_prog_ns, unit=ent.die)
            elif to in (Location.DRAM, Location.CTRL):
                t = self.dram_bus.acquire_end(t, self._bus_ns)
        self.movement_energy += dm_energy_nj(src, to, nb, self.spec)
        if pid in self.buffered:
            u = self.buffered.pop(pid)
            if pid in self.unit_buffers.get(u, []):
                self.unit_buffers[u].remove(pid)
        if to == Location.FLASH:
            ent.owner = Location.FLASH
            ent.dirty = False
            ent.version = 0                 # commit (§4.4)
        self.pages.move(pid, to)
        self._touch(pid, to, t)
        return t

    def _touch(self, pid: int, loc: Location, now: float) -> None:
        if loc in (Location.DRAM, Location.CTRL):
            lru, cap = self.dram_lru, self.dram_cap
        elif loc == Location.HOST:
            lru, cap = self.host_lru, self.host_cap
        else:
            self.dram_lru.pop(pid, None)
            self.host_lru.pop(pid, None)
            return
        lru.pop(pid, None)
        lru[pid] = now
        while len(lru) > cap:
            victim = next(iter(lru))
            del lru[victim]
            self._evict(victim, now)

    def _evict(self, pid: int, now: float) -> None:
        """Capacity eviction — sync trigger (iii) of §4.4.

        Dead pages (no future reader, not a trace output) are scratch the
        runtime can discard; only live data pays the flash commit."""
        ent = self.pages[pid]
        self.evictions += 1
        if not self._is_live(pid, self._cursor_iid - 1):
            ent.owner = Location.FLASH
            ent.dirty = False
            self.pages.move(pid, Location.FLASH)
            return
        if ent.owner in (Location.DRAM, Location.CTRL, Location.HOST):
            # latest version off-flash -> commit asynchronously
            f = self.spec.flash
            t = self.dram_bus.acquire_end(now, self._bus_ns) \
                if ent.location != Location.HOST else \
                self.pcie.acquire_end(now, self._pcie_nolat_ns)
            t = self.channels.acquire_end(
                t, self._chan_xfer_ns, unit=ent.channel)
            self.dies.acquire_end(t, f.t_prog_ns, unit=ent.die)
            self.movement_energy += dm_energy_nj(
                ent.location, Location.FLASH, self.spec.page_size, self.spec)
            self.coherence_syncs += 1
        ent.owner = Location.FLASH
        ent.dirty = False
        ent.version = 0
        self.pages.move(pid, Location.FLASH)

    def _is_live(self, pid: int, after_iid: int) -> bool:
        """True iff the page's current value will be read again (its next
        trace event strictly after ``after_iid`` is a read), or it is a
        trace output."""
        ev = self.page_events.get(pid)
        if ev is not None:
            k = bisect.bisect_right(ev, (after_iid, True))
            if k < len(ev):
                return ev[k][1]
        return pid in self.out_pages_set

    def _path_queue_ns(self, src: Location, dst: Location, now: float) -> float:
        """Queueing delay along the movement path src->dst (feature 4
        generalized: the instruction waits on these queues too).  The pool
        list per location pair is precomputed in ``__init__``."""
        best = 0.0
        pools = self._path_pools_flat[src.index * self._n_locations
                                      + dst.index]
        for p in pools:
            q = p.queue_delay_ns(now)
            if q > best:
                best = q
        return best

    # -- SystemView feature callbacks (bound once, read the dispatch cursor) --

    def _queue_feature(self, r: Resource) -> float:
        return self._pools_by_index[r.index].queue_delay_ns(self._view_now)

    def _dep_feature(self, instr: VectorInstr) -> float:
        return self._cur_deps_ready

    def _move_queue_feature(self, src: Location, dst: Location) -> float:
        # _path_queue_ns inlined: probed per off-home operand per candidate
        now = self._view_now
        best = 0.0
        for p in self._path_pools_flat[src.index * self._n_locations
                                       + dst.index]:
            q = p.queue_delay_ns(now)
            if q > best:
                best = q
        return best

    # -- execution ------------------------------------------------------------

    def _exec_on(self, instr: VectorInstr, r: Resource, ready: float,
                 allow_contention: bool = True) -> Tuple[float, float]:
        """Run ``instr`` on resource ``r``; returns (start, end)."""
        latched = False
        if r is Resource.IFP:
            flash_srcs = [s for s in instr.srcs
                          if self.pages.location(s) == Location.FLASH
                          and s not in self.buffered]   # latched pages are
                          # in the peripheral latches, not the array: MWS
                          # same-block placement does not apply to them
            # Flash-Cosmos same-block layout constraint for MWS ops
            if instr.op in ("and", "or", "nand", "nor") and len(flash_srcs) > 1:
                if not self.pages.same_block(flash_srcs):
                    moved = self.pages.co_locate(flash_srcs)
                    self.colocations += moved
                    f = self.spec.flash
                    for s in flash_srcs[1:1 + moved]:
                        t0 = self.dies.acquire_end(
                            ready, f.t_read_ns, unit=self.pages[s].die)
                        t0 = self.channels.acquire_end(
                            t0, self.spec.page_size * f.channel_ns_per_byte,
                            unit=self.pages[s].channel)
                        ready = self.dies.acquire_end(
                            t0, f.t_prog_ns, unit=self.pages[s].die)
                        self.movement_energy += (
                            f.e_read_nj_per_channel * 0.3 + f.e_prog_nj_per_channel)
            # latch affinity: prefer the unit already buffering an operand
            unit = None
            for s in instr.srcs:
                if s in self.buffered:
                    unit = self.buffered[s]
                    latched = True
                    break
            if unit is None:
                unit = (self.pages[instr.srcs[0]].die
                        if instr.srcs else 0)
            self._last_ifp_unit = unit   # audit: which die executed
        else:
            unit = None
        if r is Resource.PUD:
            # ACT/PRE command issue serializes on the DRAM command/data bus
            # even though banks execute bbops concurrently (MIMDRAM model).
            issue = 0.18 * exec_latency_ns(instr, r, self.spec)
            ready = self.dram_bus.acquire_end(ready, issue)

        lat = exec_latency_ns(instr, r, self.spec, operands_latched=latched)
        pool = self._pools_by_index[r.index]
        if allow_contention:
            start, end = pool.acquire_se(ready, lat, unit=unit)
        else:
            start, end = ready, ready + lat
            pool.busy_ns += lat
            pool.jobs += 1
        self.compute_energy += exec_energy_nj(instr, r, self.spec, lat)

        home = HOME_BY_INDEX[r.index]
        self.pages.record_write(instr.dst, home)
        if r is Resource.IFP:
            # Result lands in the plane's page buffer (S/D latches hold up to
            # BUFFER_DEPTH pages per unit).  Displacing a buffered page
            # triggers its (pipelined) SLC program write-back — but only if
            # that page is still LIVE (future reader or trace output); dead
            # latch intermediates are discarded, as in Flash-Cosmos chaining.
            buf = self.unit_buffers.setdefault(unit, [])
            if instr.dst in buf:
                buf.remove(instr.dst)
            buf.append(instr.dst)
            self.buffered[instr.dst] = unit
            self.pages[instr.dst].die = unit           # affinity follows data
            self.pages[instr.dst].channel = unit % self.spec.flash.channels
            while len(buf) > BUFFER_DEPTH:
                prev = buf.pop(0)
                self.buffered.pop(prev, None)
                if self._is_live(prev, instr.iid):
                    # live result flows UP the hierarchy: DMA out of the
                    # page buffer to SSD DRAM (a program back into the
                    # array would cost 400us; the controller drains hot
                    # data through the normal read path instead).
                    t = self.channels.acquire_end(
                        end, self._chan_xfer_ns,
                        unit=self.pages[prev].channel)
                    t = self.dram_bus.acquire_end(t, self._bus_ns)
                    self.movement_energy += dm_energy_nj(
                        Location.FLASH, Location.DRAM,
                        self.spec.page_size, self.spec)
                    self.pages[prev].owner = Location.DRAM
                    self.pages[prev].dirty = True
                    self.pages.move(prev, Location.DRAM)
                    self._touch(prev, Location.DRAM, t)
                else:
                    self.pages[prev].dirty = False
                    self.pages[prev].owner = Location.FLASH
        else:
            self._touch(instr.dst, home, end)
        return start, end

    # -- event-driven dispatch -------------------------------------------------

    def bind(self, engine: EventEngine) -> None:
        """Attach this trace to an event engine and schedule its first
        dispatch.  Several Simulations sharing one engine + fabric
        interleave their dispatches in global time order."""
        self.engine = engine
        self._tele = self.fabric.telemetry
        self._faults = self.fabric.faults
        self._idx = 0
        self._prev_decide_end = self.start_ns
        self._makespan = self.start_ns
        self.done = False
        if self.trace.instrs:
            engine.schedule(self.start_ns, EventKind.DISPATCH,
                            self._on_dispatch)
        elif (self.cfg.move_outputs_to_host
              and not self.policy.ignores_contention):
            # degenerate empty trace: the epilogue flush still runs
            engine.schedule(self.start_ns, EventKind.EPILOGUE,
                            self._on_epilogue)
        else:
            self._finish()

    def _finish(self) -> None:
        """Mark the trace drained and fire the completion hook."""
        self.done = True
        if self.on_done is not None:
            self.on_done(self)

    def _deps_ready(self, instr: VectorInstr) -> float:
        # hand-rolled max-over-present: no generator frame on the hot path
        completion = self.completion
        best = None
        for d in instr.deps:
            c = completion[d]
            if c is not None and (best is None or c > best):
                best = c
        return self.start_ns if best is None else best

    def _after_instr(self, instr_end: float) -> None:
        """Schedule the next dispatch (or the epilogue) after one
        instruction has been issued."""
        if instr_end > self._makespan:
            self._makespan = instr_end
        self._idx += 1
        engine = self.engine
        if self._idx < self._n_instrs:
            if self._ignores_contention:
                nxt = self._deps_ready(self._instrs[self._idx])
                when = max(engine.now, nxt)
            else:
                # in-order issue, pipelined across the offloader cores: the
                # next decision may start once this one occupies its core.
                now = engine.now
                prev = self._prev_decide_end
                when = now if now > prev else prev
            engine.schedule(when, EventKind.DISPATCH, self._on_dispatch)
        elif self.cfg.move_outputs_to_host and not self.policy.ignores_contention:
            engine.schedule(max(engine.now, self._makespan),
                            EventKind.EPILOGUE, self._on_epilogue)
        else:
            self._finish()

    def _on_dispatch(self, _payload=None) -> None:
        """Offloader core picks up the next instruction in program order:
        decide (§4.5 overhead), move operands, book execution."""
        spec = self.spec
        instr = self._instrs[self._idx]
        self._cursor_iid = instr.iid
        deps_ready = self._deps_ready(instr)
        tele = self._tele
        if tele is not None:
            # attribution for every pool booking this dispatch performs;
            # ctx_args carries the structured join key (the span name
            # alone would need parsing in the analysis layer)
            tele.ctx = f"{self.tenant}:{instr.op}#{instr.iid}"
            tele.ctx_args = {"tenant": self.tenant, "iid": instr.iid}

        if self._ignores_contention:
            # Ideal (§5.3): zero data-movement latency, zero decision
            # overhead, fastest resource per instruction.  Execution
            # still occupies the (contention-free scheduled) compute
            # units — an upper bound on realizable offloading.
            self._cur_deps_ready = deps_ready
            r = self.policy.select_fast(instr, self._ideal_view)
            lat = exec_latency_ns(instr, r, spec)
            start, end = self._pools_by_index[r.index].acquire_se(
                deps_ready, lat)
            self.compute_energy += exec_energy_nj(instr, r, spec, lat)
            self.pages.record_write(instr.dst, HOME_BY_INDEX[r.index])
            self.completion[instr.iid] = end
            self._resource_counts[r.index] += 1
            self.op_latencies.append(end - start)
            if self._record_decisions:
                self.decisions.append(DecisionRecord(
                    instr.iid, instr.op, r, start, start, end, 0.0))
            if tele is not None:
                feats = self.policy._feats(instr, self._ideal_view) \
                    if tele.cfg.audit else None
                tele.on_dispatch(self.tenant, self.policy.name, instr, r,
                                 feats, start, start, start, start, start,
                                 end, 0.0)
            self._after_instr(end)
            return

        if self._policy_dynamic:
            # decision_overhead_ns inlined (§4.5): per-operand L2P lookups
            # plus the constant tracking/lookup terms folded in __init__.
            # ``deps_ready`` is the max completion over present deps and
            # ``_prev_decide_end`` is monotone from start_ns, so "any dep
            # completes after the pipeline cursor" == deps_ready > cursor.
            overhead = self._decide_const_ns
            if deps_ready > self._prev_decide_end:
                overhead += self._dep_track_ns
            dram_ns = self._l2p_dram_ns
            flash_ns = self._l2p_flash_ns
            entries = self.pages.entries
            for s in instr.srcs:
                ent = entries[s]
                if ent.l2p_cached:
                    overhead += dram_ns
                else:
                    ent.l2p_cached = True
                    overhead += flash_ns
        else:
            # compile-time-mapped policy: queue push only
            overhead = STATIC_DISPATCH_NS
        now, decide_end = self.offloader.acquire_se(
            self._prev_decide_end, overhead)
        self._prev_decide_end = now
        self.overhead_total += overhead

        self._view_now = now
        self._cur_deps_ready = deps_ready
        view = self._view
        view.now_ns = now
        view.dep_ready_abs = deps_ready
        if self._fast_select:
            r = self._select_fast_fn(instr, view)
        else:
            decision = self.policy.select(instr, view)
            r = decision.resource
        feats = None
        if tele is not None and tele.cfg.audit:
            # decision-time candidate costs for the audit stream: _feats
            # is the policy's own read-only derivation, taken here —
            # after the selection, before any booking mutates pool state
            feats = decision.features if not self._fast_select \
                else self.policy._feats(instr, view)

        # operand movement to the resource's home (overlapped per page)
        ready = max(decide_end, deps_ready)
        home = HOME_BY_INDEX[r.index]
        # recency bookkeeping for on-home operands: the LRU is a function
        # of ``home`` alone, so hoist _touch's branch out of the loop
        # (home is FLASH only for IFP — that shape keeps the _touch call)
        if home is Location.DRAM or home is Location.CTRL:
            lru, cap = self.dram_lru, self.dram_cap
        elif home is Location.HOST:
            lru, cap = self.host_lru, self.host_cap
        else:
            lru = None
        move_end = ready
        dm_ns = 0.0
        entries = self.pages.entries
        for s in instr.srcs:
            if entries[s].location is not home:
                t = self._move_page(s, home, ready)
                dm_ns += t - ready
                if t > move_end:
                    move_end = t
            elif lru is None:
                self._touch(s, home, ready)
            else:
                lru.pop(s, None)
                lru[s] = ready
                while len(lru) > cap:
                    victim = next(iter(lru))
                    del lru[victim]
                    self._evict(victim, ready)

        if r is Resource.IFP:
            start, end = self._exec_on(instr, r, move_end)
        else:
            # _exec_on inlined for the ISP/PUD/host resources: no latch
            # affinity, no same-block constraint — book and account.
            lat = exec_latency_ns(instr, r, spec)
            if r is Resource.PUD:
                move_end = self.dram_bus.acquire_end(move_end, 0.18 * lat)
            start, end = self._pools_by_index[r.index].acquire_se(
                move_end, lat)
            self.compute_energy += exec_energy_nj(instr, r, spec, lat)
            # record_write inlined (enum __eq__ is identity, so ``is``)
            ent = entries[instr.dst]
            if not (ent.owner is home and ent.dirty):
                ent.owner = home
                ent.dirty = True
            ent.bump_version()
            ent.location = home
            if lru is None:
                self._touch(instr.dst, home, end)
            else:
                dst = instr.dst
                lru.pop(dst, None)
                lru[dst] = end
                while len(lru) > cap:
                    victim = next(iter(lru))
                    del lru[victim]
                    self._evict(victim, end)

        # transient-fault injection (§4.4 failure handling): replay on
        # another resource using the latest data version.
        if self._inject_faults and \
                _hash01(instr.iid, self.cfg.seed) < self.cfg.fail_rate:
            self.replays += 1
            alts = [x for x in self.policy.candidates
                    if x != r and decision.features.get(x) is not None
                    and decision.features[x].supported] or [Resource.ISP]
            alt = min(alts, key=lambda x: decision.features[x].latency_comp
                      if x in decision.features else float("inf"))
            ready2 = end
            for s in instr.srcs:
                if self.pages.location(s) != HOME[alt]:
                    ready2 = max(ready2, self._move_page(s, HOME[alt], end))
            _, end = self._exec_on(instr, alt, ready2)
            r = alt

        self.completion[instr.iid] = end
        self._resource_counts[r.index] += 1
        self.op_latencies.append(end - now)
        if self._record_decisions:
            self.decisions.append(DecisionRecord(
                instr.iid, instr.op, r, now, start, end, dm_ns,
                replayed=self._inject_faults
                and _hash01(instr.iid, self.cfg.seed) < self.cfg.fail_rate))
        if tele is not None:
            tele.on_dispatch(
                self.tenant, self.policy.name, instr, r, feats,
                now, decide_end, ready, move_end, start, end, dm_ns,
                replayed=self._inject_faults
                and _hash01(instr.iid, self.cfg.seed) < self.cfg.fail_rate,
                unit=self._last_ifp_unit if r is Resource.IFP else None)
        # _after_instr inlined (this branch never ignores contention)
        if end > self._makespan:
            self._makespan = end
        idx = self._idx + 1
        self._idx = idx
        engine = self.engine
        if idx < self._n_instrs:
            # in-order issue, pipelined across the offloader cores: the
            # next decision may start once this one occupies its core.
            enow = engine.now
            prev = self._prev_decide_end
            engine.schedule(enow if enow > prev else prev,
                            _DISPATCH, self._on_dispatch)
        elif self.cfg.move_outputs_to_host:
            engine.schedule(max(engine.now, self._makespan),
                            _EPILOGUE, self._on_epilogue)
        else:
            self._finish()

    def _on_epilogue(self, _payload=None) -> None:
        """End of trace: results become visible to the host (§4.4 ii)."""
        if self._tele is not None:
            self._tele.ctx = f"{self.tenant}:epilogue"
            self._tele.ctx_args = {"tenant": self.tenant, "epilogue": True}
        makespan = self._makespan
        for pl in self.trace.output_pages:
            for pid in pl:
                if self.pages.location(pid) != Location.HOST:
                    makespan = max(
                        makespan, self._move_page(pid, Location.HOST, makespan))
        self._makespan = makespan
        self._finish()

    def result(self) -> SimResult:
        """Collect the per-trace result (call after the engine drained)."""
        return SimResult(
            policy=self.policy.name, workload=self.trace.name,
            makespan_ns=self._makespan, n_instrs=len(self.trace.instrs),
            compute_energy_nj=self.compute_energy,
            movement_energy_nj=self.movement_energy,
            decision_overhead_ns_total=self.overhead_total,
            decisions=self.decisions,
            op_latencies_ns=self.op_latencies,
            resource_counts={r: self._resource_counts[r.index]
                             for r in Resource if self._resource_counts[r.index]},
            resource_busy_ns=self.fabric.busy_ns(),
            coherence_syncs=self.coherence_syncs, evictions=self.evictions,
            replays=self.replays, colocations=self.colocations,
            tenant=self.tenant, start_ns=self.start_ns,
            failed=self.failed)

    def run(self) -> SimResult:
        """Single-tenant convenience: drive a private event loop to empty."""
        engine = EventEngine()
        self.bind(engine)
        engine.run()
        return self.result()


def simulate(trace: Trace, policy: str | Policy,
             spec: SSDSpec = DEFAULT_SSD,
             config: Optional[SimConfig] = None,
             record_decisions: Optional[bool] = None,
             telemetry: TelemetryLike = None,
             faults=None) -> SimResult:
    """Run one workload trace under one offloading policy.

    The single-tenant special case of the event engine; for concurrent
    traces sharing the SSD see :func:`repro_torch.sim.tenancy.simulate_mix`.
    ``record_decisions=False`` is the fast mode (no per-dispatch
    DecisionRecord allocation, identical timing) — overrides the same
    flag on ``config``.  ``telemetry`` takes a
    :class:`~repro_torch.sim.telemetry.TelemetryConfig` (or a prepared
    :class:`~repro_torch.sim.telemetry.FlightRecorder`); the recorder observes
    without perturbing timing and comes back on ``result.telemetry``.
    ``faults`` takes a :class:`~repro_torch.sim.faults.FaultConfig`: an active
    config arms the error model on the private fabric (NDP operand
    senses roll the RBER model and walk the recovery ladder); ``None``
    or an all-off config is bit-identical to a build without the fault
    subsystem.
    """
    if isinstance(policy, str):
        policy = make_policy(policy, spec)
    if record_decisions is not None:
        config = dataclasses.replace(config or SimConfig(),
                                     record_decisions=record_decisions)
    sim = Simulation(trace, policy, spec, config)
    tele = as_recorder(telemetry)
    fault_on = faults is not None and faults.active
    if tele is None and not fault_on:
        return sim.run()
    engine = EventEngine()
    if fault_on:
        from repro_torch.sim.faults import FaultModel
        FaultModel(faults, spec, sim.fabric, engine)
    if tele is not None:
        tele.attach(fabric=sim.fabric, engine=engine)
        if sim.fabric.faults is not None:
            tele.attach_faults(sim.fabric.faults)
        tele.run_meta.setdefault("entry", "simulate")
        tele.run_meta.setdefault("policy", policy.name)
        tele.run_meta.setdefault("workload", trace.name)
    sim.bind(engine)
    engine.run()
    res = sim.result()
    if tele is not None:
        res.telemetry = tele
    if sim.fabric.faults is not None:
        res.faults = sim.fabric.faults.stats()
    return res
