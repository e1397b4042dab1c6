"""Server pools: the contention model of the event-driven simulator.

Every contended unit in the SSD — compute resources (ISP core, DRAM bank
groups, flash channels' compute), interconnects (flash channels, DRAM bus,
PCIe link) and the offloader core itself — is a :class:`ServerPool` with k
units.  Work items acquire a unit FIFO; the pool tracks per-unit
free-times, total busy time, and the queue-delay feature (Table 1,
``delay_queue``) the cost function reads.

Performance: the channel x die fabrics make ``acquire``/``peek_start``/
``queue_delay_ns`` the innermost loop of the simulator, so the pool keeps
an incrementally maintained min-structure instead of scanning all k units
per call:

* ``_heap`` is a lazy min-heap of ``(free_time, unit)`` entries.  Every
  update of a unit's free time pushes a fresh entry; entries whose value
  no longer matches ``free[unit]`` are stale and skipped on pop.  Free
  times are monotone per unit (FIFO booking never rewinds), so stale
  entries always sort *before* the live entry of the same unit and are
  discarded in O(log k) amortized.  Tie-breaking matches the old linear
  scan exactly: the heap orders by ``(free_time, unit)``, i.e. the
  lowest-indexed unit among equally-free units wins.
* ``_pending_work`` is the running pending-work counter (the paper's §4.5
  footnote 5 incremental queue counter): the sum of all units' booked
  free times, maintained in O(1) per acquire.  ``pending_work_ns(now)``
  subtracts each unit's already-elapsed share (``min(free_u, now)``) from
  the counter, which equals the brute-force ``sum(max(0, free_u - now))``
  for *any* probe time — asserted in ``tests/test_servers_fastpath.py``.

:class:`Fabric` groups one full SSD's worth of pools so that several
concurrent tenants (and a background host I/O stream) can contend for the
*same* channels, dies, DRAM bus and PCIe link — the multi-tenant regime of
:func:`repro_torch.sim.tenancy.simulate_mix`.
"""
from __future__ import annotations

from heapq import heappop, heappush
from typing import Dict, List, NamedTuple, Optional


class Acquisition(NamedTuple):
    unit: int
    start: float
    end: float


class ServerPool:
    __slots__ = ("name", "units", "free", "busy_ns", "jobs", "_heap",
                 "_pending_work", "_single", "tracer")

    def __init__(self, name: str, units: int):
        assert units >= 1
        self.name = name
        self.units = units
        self.free: List[float] = [0.0] * units
        self.busy_ns: float = 0.0
        self.jobs: int = 0
        # lazy min-heap over (free_time, unit); one live entry per unit
        self._heap: List[tuple] = [(0.0, u) for u in range(units)]
        # Running counter of booked work (the paper's §4.5 footnote 5
        # incremental queue counter): the sum of all units' free times,
        # maintained in O(1) on every acquire.  Pending work at time t is
        # this counter minus each unit's elapsed share (pending_work_ns).
        self._pending_work: float = 0.0
        # Single-unit pools (DRAM bus, PCIe, host CPU/GPU) are booked on
        # nearly every page move: they skip the heap entirely — free[0]
        # IS the min — with arithmetic identical to the heap path.  NB
        # the heap is then never maintained for them; every reader below
        # must branch on the flag before touching it.
        self._single: bool = units == 1
        # optional booking observer, set by the flight recorder
        # (repro_torch.sim.telemetry): called (name, unit, start, end) after
        # every acquire.  None (the default) costs one predictable
        # branch per booking.
        self.tracer = None

    # -- min-structure maintenance --------------------------------------------

    def _min_unit(self) -> tuple:
        """(free_time, unit) of the earliest-free unit, lowest index on
        ties — identical to the old ``min(range(units))`` scan."""
        if self._single:
            return self.free[0], 0
        heap = self._heap
        free = self.free
        while True:
            f, u = heap[0]
            if free[u] == f:
                return f, u
            heappop(heap)          # stale: the unit was re-booked since

    # -- queue features --------------------------------------------------------

    def queue_delay_ns(self, now: float) -> float:
        """Expected wait before a new job could start (Table 1 feature)."""
        # inlined _min_unit: this is the cost function's innermost probe
        if self._single:
            d = self.free[0] - now
            return d if d > 0.0 else 0.0
        heap = self._heap
        free = self.free
        while True:
            f, u = heap[0]
            if free[u] == f:
                break
            heappop(heap)
        d = f - now
        return d if d > 0.0 else 0.0

    def pending_work_ns(self, now: float) -> float:
        """Total booked-but-unfinished work across units at ``now``:
        the maintained counter minus each unit's already-elapsed share.

        The counter accumulates incrementally, so the result can differ
        from the direct ``sum(max(0, f - now))`` by float-rounding ulps;
        it is clamped at zero so an idle pool always reads exactly 0.0."""
        pending = self._pending_work
        for f in self.free:
            pending -= f if f < now else now
        return pending if pending > 0.0 else 0.0

    def utilization(self, makespan: float) -> float:
        if makespan <= 0 or self.jobs == 0:
            return 0.0
        return self.busy_ns / (makespan * self.units)

    # -- booking ---------------------------------------------------------------

    def acquire(self, ready: float, dur: float,
                unit: Optional[int] = None) -> Acquisition:
        """FIFO-acquire a unit at the earliest feasible start >= ready."""
        free = self.free
        if self._single:
            f = free[0]
            start = ready if ready > f else f
            end = start + dur
            free[0] = end
            self._pending_work += end - f
            self.busy_ns += dur
            self.jobs += 1
            if self.tracer is not None:
                self.tracer(self.name, 0, start, end)
            return Acquisition(0, start, end)
        if unit is None:
            heap = self._heap
            while True:
                f, u = heap[0]
                if free[u] == f:
                    break
                heappop(heap)
            unit = u
        else:
            f = free[unit]
        start = ready if ready > f else f
        end = start + dur
        free[unit] = end
        heappush(self._heap, (end, unit))
        self._pending_work += end - f
        self.busy_ns += dur
        self.jobs += 1
        if self.tracer is not None:
            self.tracer(self.name, unit, start, end)
        return Acquisition(unit, start, end)

    def acquire_se(self, ready: float, dur: float,
                   unit: Optional[int] = None) -> tuple:
        """:meth:`acquire`, returning a plain ``(start, end)`` tuple.

        For booking sites that need both endpoints but not the unit:
        skips the NamedTuple construction on the per-dispatch path."""
        free = self.free
        if self._single:
            f = free[0]
            start = ready if ready > f else f
            end = start + dur
            free[0] = end
            self._pending_work += end - f
            self.busy_ns += dur
            self.jobs += 1
            if self.tracer is not None:
                self.tracer(self.name, 0, start, end)
            return start, end
        if unit is None:
            heap = self._heap
            while True:
                f, u = heap[0]
                if free[u] == f:
                    break
                heappop(heap)
            unit = u
        else:
            f = free[unit]
        start = ready if ready > f else f
        end = start + dur
        free[unit] = end
        heappush(self._heap, (end, unit))
        self._pending_work += end - f
        self.busy_ns += dur
        self.jobs += 1
        if self.tracer is not None:
            self.tracer(self.name, unit, start, end)
        return start, end

    def acquire_end(self, ready: float, dur: float,
                    unit: Optional[int] = None) -> float:
        """:meth:`acquire`, returning only the completion time.

        The allocation-free fast path for the (majority of) booking sites
        that chain on ``.end`` and never read the unit or start."""
        free = self.free
        if self._single:
            f = free[0]
            end = (ready if ready > f else f) + dur
            free[0] = end
            self._pending_work += end - f
            self.busy_ns += dur
            self.jobs += 1
            if self.tracer is not None:
                self.tracer(self.name, 0, end - dur, end)
            return end
        if unit is None:
            heap = self._heap
            while True:
                f, u = heap[0]
                if free[u] == f:
                    break
                heappop(heap)
            unit = u
        else:
            f = free[unit]
        end = (ready if ready > f else f) + dur
        free[unit] = end
        heappush(self._heap, (end, unit))
        self._pending_work += end - f
        self.busy_ns += dur
        self.jobs += 1
        if self.tracer is not None:
            self.tracer(self.name, unit, end - dur, end)
        return end

    def peek_start(self, ready: float, unit: Optional[int] = None) -> float:
        f = self._min_unit()[0] if unit is None else self.free[unit]
        return ready if ready > f else f

    @property
    def horizon_ns(self) -> float:
        """Latest booked completion across units (end of all queued work);
        0.0 for a pool that never saw a job."""
        return max(self.free) if self.free else 0.0


class Fabric:
    """One SSD's contended hardware: compute pools plus interconnects.

    A :class:`~repro_torch.sim.machine.Simulation` owns a private Fabric for
    single-trace runs; :func:`repro_torch.sim.tenancy.simulate_mix` builds one
    Fabric and hands it to every tenant so all traces (and the synthetic
    host I/O stream) share channels, dies, the DRAM bus and the PCIe link.
    """

    def __init__(self, spec, pud_units: int = 8):
        # late import: repro_torch.core.isa imports hw specs, no cycle via servers
        from repro_torch.core.isa import Resource
        f = spec.flash
        self.spec = spec
        # optional flight recorder (repro_torch.sim.telemetry): set by
        # FlightRecorder.attach; tenant Simulations bound to this fabric
        # read it to route their dispatch hooks
        self.telemetry = None
        # optional fault model (repro_torch.sim.faults): set by the simulate_*
        # wiring when a FaultConfig with active error sources is passed;
        # tenant Simulations and the host I/O model read it to route
        # flash reads through the recovery ladder
        self.faults = None
        # pools that exist only in some configurations (e.g. the ECC
        # soft-decode engines the fault model registers).  Kept out of
        # ``pools`` so ``busy_ns()`` — and hence the golden digests — is
        # unchanged whenever the list is empty.
        self.extra: List[ServerPool] = []
        self.pools: Dict = {
            Resource.ISP: ServerPool("isp", spec.isp.compute_cores),
            Resource.PUD: ServerPool("pud", pud_units),
            # one pool models the dies: IFP execution, read senses and
            # program write-backs all occupy a die (a die cannot sense
            # while programming) — so die congestion is visible to the
            # cost function's queue feature.
            Resource.IFP: ServerPool("ifp_die", f.total_dies),
            Resource.HOST_CPU: ServerPool("cpu", 1),
            Resource.HOST_GPU: ServerPool("gpu", 1),
        }
        # dense tuple indexed by ``Resource.index`` — the dispatch loop's
        # form of the mapping above (enum definition order == index order)
        self.pools_by_index = tuple(self.pools[r] for r in Resource)
        # computation mode (§4.4) suspends host I/O: every controller core
        # not used for ISP compute runs offloading/transformation tasks.
        self.offloader = ServerPool(
            "offloader", max(1, spec.isp.cores - spec.isp.compute_cores))
        self.channels = ServerPool("flash_chan", f.channels)
        self.dies = self.pools[Resource.IFP]   # alias: same physical units
        self.dram_bus = ServerPool("dram_bus", 1)
        self.pcie = ServerPool("pcie", 1)
        # movement-path queue feature: which pools a src->dst page transfer
        # waits on, precomputed for all 16 location pairs (shared by every
        # tenant Simulation bound to this fabric)
        from repro_torch.core.isa import Location
        self.path_pools: Dict = {}
        for src in Location:
            for dst in Location:
                pools: List[ServerPool] = []
                if src != dst:
                    if src is Location.FLASH or dst is Location.FLASH:
                        pools += [self.dies, self.channels]
                    if (Location.DRAM in (src, dst)
                            or Location.CTRL in (src, dst)):
                        pools.append(self.dram_bus)
                    if Location.HOST in (src, dst):
                        pools.append(self.pcie)
                self.path_pools[(src, dst)] = tuple(pools)
        # flat form indexed by ``src.index * N_LOCATIONS + dst.index`` —
        # the dispatch loop probes a movement path per off-home operand,
        # and an int-indexed tuple read beats hashing an enum pair
        from repro_torch.core.isa import N_LOCATIONS
        self.n_locations = N_LOCATIONS
        self.path_pools_by_index = tuple(
            self.path_pools[(s, d)] for s in Location for d in Location)

    def all_pools(self) -> List[ServerPool]:
        return list(self.pools.values()) + [
            self.offloader, self.channels, self.dram_bus, self.pcie] \
            + self.extra

    def busy_ns(self) -> Dict[str, float]:
        return {p.name: p.busy_ns for p in self.all_pools()}

    @property
    def horizon_ns(self) -> float:
        """End of all booked work anywhere in the fabric."""
        return max(p.horizon_ns for p in self.all_pools())
