"""Conduit's holistic cost function (§4.3.2, Table 1, Eqns 1-2).

For each vector instruction and each candidate resource the cost function
combines six features:

  (1) operation type          -> latency_comp model (isa.compute_latency_ns)
  (2) operand location        -> L2P lookups feeding latency_dm
  (3) data dependence delay   -> delay_dd
  (4) resource queueing delay -> delay_queue
  (5) data movement latency   -> latency_dm (precomputed, contention-free)
  (6) expected comp latency   -> latency_comp

  total_latency_r = latency_comp + latency_dm + max(delay_dd, delay_queue)   (1)
  target          = argmin_r total_latency_r                                 (2)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.isa import (Location, Resource, VectorInstr,
                                  compute_energy_nj, compute_latency_ns, supports)
from repro_torch.hw.ssd_spec import SSDSpec

# Operand "home" for each compute resource: where operands must reside for
# the resource to execute on them.
HOME: Dict[Resource, Location] = {
    Resource.ISP: Location.DRAM,
    Resource.PUD: Location.DRAM,
    Resource.IFP: Location.FLASH,
    Resource.HOST_CPU: Location.HOST,
    Resource.HOST_GPU: Location.HOST,
}

#: ``HOME`` as a dense tuple indexed by ``resource.index`` (hot-path form).
HOME_BY_INDEX: Tuple[Location, ...] = tuple(HOME[r] for r in Resource)


def dm_latency_ns(src: Location, dst: Location, nbytes: int,
                  spec: SSDSpec) -> float:
    """Contention-free data-movement latency estimate (feature 5).

    Precomputed in the paper and stored in SSD DRAM; we compute it from the
    same Table 2 link constants.  Movement *into* flash requires an
    (expensive) SLC-mode program — the reason good policies rarely move
    DRAM-resident data back into the flash array for IFP.
    """
    if src == dst:
        return 0.0
    # NB: the sums below replicate the original per-pair expressions
    # term-for-term (float addition is not associative) — the fast path
    # only avoids building the full 12-entry table per call.
    f, d, h = spec.flash, spec.dram, spec.host
    if src is Location.FLASH:
        head = f.t_read_ns + f.t_dma_ns + nbytes * f.channel_ns_per_byte
        if dst is Location.CTRL:
            return head
        if dst is Location.DRAM:
            return head + nbytes * d.bus_ns_per_byte
        return head + (nbytes * h.pcie_ns_per_byte + h.pcie_latency_ns)
    chan = nbytes * f.channel_ns_per_byte
    if dst is Location.FLASH:
        if src is Location.CTRL:
            return chan + f.t_dma_ns + f.t_prog_ns
        if src is Location.DRAM:
            return nbytes * d.bus_ns_per_byte + chan + f.t_dma_ns + f.t_prog_ns
        return (nbytes * h.pcie_ns_per_byte + h.pcie_latency_ns
                + chan + f.t_dma_ns + f.t_prog_ns)
    bus = nbytes * d.bus_ns_per_byte
    pcie = nbytes * h.pcie_ns_per_byte + h.pcie_latency_ns
    if Location.HOST not in (src, dst):
        return bus                               # DRAM <-> CTRL
    if src is Location.CTRL or dst is Location.CTRL:
        return pcie                              # CTRL <-> HOST
    return bus + pcie if src is Location.DRAM else pcie + bus


def dm_energy_nj(src: Location, dst: Location, nbytes: int,
                 spec: SSDSpec) -> float:
    """Energy of moving ``nbytes`` between locations (§5.2 energy model)."""
    if src == dst:
        return 0.0
    f, d, h = spec.flash, spec.dram, spec.host
    kb = nbytes / 1024.0
    e = 0.0
    crosses_chan = (Location.FLASH in (src, dst))
    crosses_pcie = (Location.HOST in (src, dst))
    if src == Location.FLASH:
        e += f.e_read_nj_per_channel * 0.3 + f.e_dma_nj_per_channel
    if dst == Location.FLASH:
        e += f.e_prog_nj_per_channel + f.e_dma_nj_per_channel
    if crosses_chan:
        e += 2.0 * kb                      # channel toggling
    if Location.DRAM in (src, dst) or (crosses_pcie and not crosses_chan):
        e += d.e_bus_nj_per_kb * kb
    if crosses_pcie:
        e += h.e_pcie_nj_per_kb * kb
    return e


@dataclasses.dataclass(slots=True)
class Features:
    """Per-(instruction, resource) feature vector — logged for Fig. 9/10."""

    resource: Resource
    latency_comp: float
    latency_dm: float
    delay_dd: float
    delay_queue: float
    supported: bool

    @property
    def total(self) -> float:
        # Eqn 1: dd and queue delays overlap -> max().
        return (self.latency_comp + self.latency_dm
                + max(self.delay_dd, self.delay_queue))


@dataclasses.dataclass
class SystemView:
    """Runtime state snapshot the offloader reads (real-time knowledge the
    SSD controller has of its own resources, §4.3.2)."""

    now_ns: float
    queue_delay_ns: Callable[[Resource], float]
    dep_ready_ns: Callable[[VectorInstr], float]     # abs time operands ready
    location_of: Callable[[int], Location]
    # queueing on the operand-movement path (defaults to zero: the paper's
    # static dm estimate; the simulator wires the real path queues in)
    move_queue_ns: Callable[[Location, Location], float] = lambda s, d: 0.0
    # Multi-tenant plumbing: which trace/tenant this decision serves.  The
    # single-tenant simulator passes the trace name; simulate_mix passes a
    # unique tenant id — a QoS-aware policy can prioritize per tenant.
    tenant: str = ""
    # -- fast-path mirrors (optional; wired by the simulator) ----------------
    # Direct structure references that let ``select_fast`` probe queues and
    # operand locations without a bound-method hop per candidate.  A view
    # that leaves them at their defaults (hand-built views in tests) makes
    # ``select_fast`` fall back to the callable API above — same argmin.
    pools_by_index: Optional[tuple] = None   # ServerPool per Resource.index
    path_pools_flat: Optional[tuple] = None  # src.index*n_locations+dst.index
    n_locations: int = 0
    page_entries: Optional[dict] = None      # pid -> PageEntry (.location)
    dep_ready_abs: float = 0.0               # dep_ready_ns(instr) of the
                                             # instr being dispatched


def static_features(instr: VectorInstr, resource: Resource,
                    spec: SSDSpec) -> Tuple[bool, float, Location,
                                            Tuple[float, float, float, float]]:
    """Compile-time metadata of the cost function, memoized per instruction.

    Returns ``(supported, latency_comp, home, dm_by_location)`` where
    ``dm_by_location[loc.value]`` is the contention-free movement latency
    of one operand page from ``loc`` to the resource's home.  Everything
    here depends only on the instruction and the hardware spec — op type,
    operand sizes, supported-resource masks, link constants — so the
    offloader computes it once per :class:`VectorInstr` instead of
    re-deriving it for every candidate resource at every dispatch.

    The memo lives on the instruction object and pins the spec it was
    computed for (compared by identity, so a different spec for the same
    trace recomputes rather than aliasing).  Slots 1 and 2 are dense lists
    indexed by ``resource.index`` — the dispatch loop reads them for every
    candidate of every instruction, so no dict hashing on that path."""
    cache = instr.__dict__.get("_static_feats")
    if cache is None or cache[0] is not spec:
        n = len(Resource)
        cache = (spec, [None] * n, [None] * n, {})
        instr._static_feats = cache
    per = cache[1][resource.index]
    if per is None:
        ok = supports(resource, instr) and instr.op_class.name != "CONTROL" \
            or resource in (Resource.ISP, Resource.HOST_CPU)
        home = HOME[resource]
        lat = compute_latency_ns(instr, resource, spec) if ok else float("inf")
        nbytes = instr.nbytes
        dm_by_loc = (dm_latency_ns(Location.FLASH, home, nbytes, spec),
                     dm_latency_ns(Location.DRAM, home, nbytes, spec),
                     dm_latency_ns(Location.CTRL, home, nbytes, spec),
                     dm_latency_ns(Location.HOST, home, nbytes, spec))
        per = (ok, lat, home, dm_by_loc)
        cache[1][resource.index] = per
    return per


def candidate_table(instr: VectorInstr, candidates: Tuple[Resource, ...],
                    spec: SSDSpec) -> Tuple:
    """The supported candidates with their static features pre-joined:
    ``((resource, latency_comp, home, dm_by_location), ...)`` in
    ``candidates`` order, memoized per instruction.

    This is the ``select_fast`` inner loop: one cached-tuple read per
    dispatch replaces one :func:`static_features` call (plus the skip of
    unsupported rows) per candidate.  Two cache levels: a single-slot
    ``_cand_tab = (candidates, spec, table)`` triple — two identity checks,
    the steady state when one policy drives one trace — backed by a dict
    keyed by ``id(candidates)`` with an identity check on the stored tuple
    (int hashing instead of hashing an enum tuple per dispatch; the check
    makes a recycled id a recompute, never a wrong table)."""
    d = instr.__dict__
    ct = d.get("_cand_tab")
    if ct is not None and ct[0] is candidates and ct[1] is spec:
        return ct[2]
    cache = d.get("_static_feats")
    if cache is not None and cache[0] is spec:
        ent = cache[3].get(id(candidates))
        if ent is not None and ent[0] is candidates:
            table = ent[1]
            instr._cand_tab = (candidates, spec, table)
            return table
    static_features(instr, candidates[0], spec)      # pins the cache to spec
    cache = instr._static_feats[3]
    table = tuple((r,) + static_features(instr, r, spec)[1:]
                  for r in candidates
                  if static_features(instr, r, spec)[0])
    cache[id(candidates)] = (candidates, table)
    instr._cand_tab = (candidates, spec, table)
    return table


def exec_latency_ns(instr: VectorInstr, resource: Resource, spec: SSDSpec,
                    operands_latched: bool = False) -> float:
    """Memoized :func:`~repro_torch.core.isa.compute_latency_ns` for the
    simulator's execution booking (both operand-latch variants cached
    per instruction alongside the static features)."""
    cache = instr.__dict__.get("_static_feats")
    if not operands_latched:
        if cache is not None and cache[0] is spec:
            per = cache[1][resource.index]
            if per is not None:
                if per[0]:
                    return per[1]
                return compute_latency_ns(instr, resource, spec)
        ok, lat, _, _ = static_features(instr, resource, spec)
        if ok:
            return lat
        return compute_latency_ns(instr, resource, spec)
    static_features(instr, resource, spec)           # pins the cache
    cache = instr._static_feats[2]
    lat = cache[resource.index]
    if lat is None:
        lat = compute_latency_ns(instr, resource, spec,
                                 operands_latched=True)
        cache[resource.index] = lat
    return lat


def exec_energy_nj(instr: VectorInstr, resource: Resource, spec: SSDSpec,
                   latency_ns: float) -> float:
    """Memoized :func:`~repro_torch.core.isa.compute_energy_nj` for the
    simulator's execution booking — a pure function of the instruction,
    resource and (already-memoized) latency."""
    cache = instr.__dict__.get("_static_feats")
    if cache is None or cache[0] is not spec:
        static_features(instr, resource, spec)  # pins the cache to spec
        cache = instr._static_feats
    cache = cache[3]
    key = (resource.index, latency_ns)
    e = cache.get(key)
    if e is None:
        e = compute_energy_nj(instr, resource, spec, latency_ns)
        cache[key] = e
    return e


def features_for(instr: VectorInstr, resource: Resource, view: SystemView,
                 spec: SSDSpec, dep_delay_ns: Optional[float] = None
                 ) -> Features:
    """One (instruction, resource) feature vector.

    ``dep_delay_ns`` lets the policy pass the (resource-independent)
    data-dependence delay it already computed; by default it is derived
    from the view exactly as before."""
    ok, lat, home, dm_by_loc = static_features(instr, resource, spec)
    dm = 0.0
    mq = 0.0
    location_of = view.location_of
    move_queue_ns = view.move_queue_ns
    for s in instr.srcs:
        loc = location_of(s)
        dm += dm_by_loc[loc.index]
        if loc is not home:
            m = move_queue_ns(loc, home)
            if m > mq:
                mq = m
    if dep_delay_ns is None:
        dep_delay_ns = max(0.0, view.dep_ready_ns(instr) - view.now_ns)
    q = view.queue_delay_ns(resource)
    if mq > q:
        q = mq
    return Features(resource, lat, dm, dep_delay_ns, q, ok)


def decision_overhead_ns(instr: VectorInstr, spec: SSDSpec,
                         l2p_lookup: Optional[Callable[[int], float]] = None,
                         has_pending_deps: bool = False) -> float:
    """Runtime latency overhead of one offloading decision (§4.5).

    Components: per-operand L2P lookups (100 ns hit / 30 µs DFTL miss),
    dependence tracking (1 µs when deps are pending), queue-counter reads
    (1 µs), precomputed dm-latency lookup (100 ns), comp-latency lookup
    (150 ns), and instruction transformation (300 ns table lookup).
    Average ≈ 3.77 µs, worst ≈ 33 µs — validated in tests.
    """
    t = 0.0
    for s in instr.srcs:
        t += l2p_lookup(s) if l2p_lookup else spec.l2p_lookup_dram_ns
    if has_pending_deps:
        t += spec.dep_delay_track_ns
    t += spec.queue_delay_track_ns
    t += spec.dm_latency_lookup_ns
    t += spec.comp_latency_lookup_ns
    t += spec.translation_lookup_ns
    return t
