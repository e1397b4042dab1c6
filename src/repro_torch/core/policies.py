"""Offloading policies: Conduit + the six evaluated baselines (§5.3).

Every policy maps a vector instruction (plus the runtime SystemView) to a
target compute resource.  The event-driven simulator (repro_torch.sim) invokes
``select`` once per instruction at dispatch time.

* ``ConduitPolicy``    — the paper's contribution: Eqns 1-2 over six features.
* ``BWOffloading``     — lowest bandwidth/queue utilization [28,38,210-213].
* ``DMOffloading``     — minimize operand data movement [29,36,214,215].
* ``IdealPolicy``      — lowest computation latency; the simulator runs it
                         with contention and movement disabled (§5.3).
* ``StaticPolicy``     — single-resource NDP baselines (ISP, PuD-SSD,
                         Flash-Cosmos, Ares-Flash) with ISP fallback for
                         unsupported ops, as the paper's baselines do.
* ``HostPolicy``       — OSP on host CPU or GPU over NVMe/PCIe.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost import (HOME, Features, SystemView, candidate_table,
                                   features_for, static_features)
from repro_torch.core.isa import (NDP_RESOURCES, Location, OpClass, Resource,
                                  VectorInstr, compute_latency_ns, supports)
from repro_torch.hw.ssd_spec import SSDSpec


@dataclasses.dataclass
class Decision:
    resource: Resource
    features: Dict[Resource, Features]
    reason: str = ""


class Policy:
    """Base offloading policy.

    Policies are *stateless across dispatches*: ``select`` reads only the
    instruction, the :class:`SystemView` snapshot, and spec-derived
    constants fixed at construction.  One instance can therefore be shared
    by any number of concurrent tenants — including the open-loop serving
    regime (:mod:`repro_torch.sim.serving`) where sessions arrive and depart
    mid-run and rebuilding a policy per admission would be pure churn; use
    :func:`shared_policy` for that."""

    name = "base"
    candidates: Tuple[Resource, ...] = NDP_RESOURCES
    ignores_contention = False      # Ideal: simulator disables contention
    # Dynamic policies evaluate runtime features per instruction inside the
    # SSD controller and pay the §4.5 decision overhead; static policies
    # (single-resource NDP baselines, host execution) are compile-time
    # mapped and only pay a queue-push.
    dynamic = True

    def __init__(self, spec: SSDSpec):
        self.spec = spec

    def _feats(self, instr: VectorInstr, view: SystemView
               ) -> Dict[Resource, Features]:
        # the data-dependence delay is resource-independent: compute it
        # once per dispatch, not once per candidate resource
        dd = view.dep_ready_ns(instr) - view.now_ns
        if dd < 0.0:
            dd = 0.0
        spec = self.spec
        return {r: features_for(instr, r, view, spec, dep_delay_ns=dd)
                for r in self.candidates}

    def _supported(self, instr: VectorInstr,
                   feats: Dict[Resource, Features]) -> List[Resource]:
        # feats[r].supported implies supports(r, instr): the only fallback
        # path to supported=True is ISP/HOST_CPU, whose SUPPORTED mask is
        # the full OpClass set — so the old `and supports(r, instr)`
        # re-check was always redundant
        ok = [r for r in self.candidates if feats[r].supported]
        if instr.op_class is OpClass.CONTROL or not ok:
            # control-intensive regions always fall back to the cores
            fallback = (Resource.ISP if Resource.ISP in self.candidates
                        else self.candidates[0])
            return [fallback]
        return ok

    def _fallback(self) -> Resource:
        return (Resource.ISP if Resource.ISP in self.candidates
                else self.candidates[0])

    def select(self, instr: VectorInstr, view: SystemView) -> Decision:
        raise NotImplementedError

    def select_fast(self, instr: VectorInstr, view: SystemView) -> Resource:
        """Allocation-free ``select``: same argmin, target resource only.

        The simulator's hot dispatch path calls this when nothing reads
        the full per-candidate feature dict (no fault replay configured);
        each override replicates its ``select`` term-for-term — same
        accumulation order, same tie-breaking — so the chosen resource and
        every downstream float are bit-identical to the ``select`` path."""
        return self.select(instr, view).resource


class ConduitPolicy(Policy):
    """The paper's holistic cost function: argmin Eqn 1 over resources."""

    name = "conduit"

    def select(self, instr: VectorInstr, view: SystemView) -> Decision:
        feats = self._feats(instr, view)
        ok = self._supported(instr, feats)
        best = min(ok, key=lambda r: feats[r].total)
        return Decision(best, feats, reason=f"min_total={feats[best].total:.0f}ns")

    def select_fast(self, instr: VectorInstr, view: SystemView) -> Resource:
        pools = view.pools_by_index
        if pools is None:          # hand-built view: no fast-path mirrors
            return self.select(instr, view).resource
        # no CONTROL check: candidate_table keeps only ISP for CONTROL
        # instrs (static_features gate), and the loop then picks it —
        # the same resource select() and _fallback() produce
        now = view.now_ns
        dd = view.dep_ready_abs - now
        if dd < 0.0:
            dd = 0.0
        entries = view.page_entries
        flat = view.path_pools_flat
        nloc = view.n_locations
        locs = [entries[s].location for s in instr.srcs]
        best = prev_home = None
        best_total = dm = mq = 0.0
        for r, lat, home, dm_by_loc in candidate_table(
                instr, self.candidates, self.spec):
            # dm/mq depend only on the home location (same operands):
            # consecutive same-home candidates (ISP, PUD -> DRAM) reuse
            if home is not prev_home:
                prev_home = home
                dm = 0.0
                mq = 0.0
                hbase = home.index
                probed = None
                for loc in locs:
                    dm += dm_by_loc[loc.index]
                    # co-located operands (the common case) share one
                    # path probe: same (loc, home) -> same pool maxima
                    if loc is not home and loc is not probed:
                        probed = loc
                        for p in flat[loc.index * nloc + hbase]:
                            m = p.queue_delay_ns(now)
                            if m > mq:
                                mq = m
            q = pools[r.index].queue_delay_ns(now)
            if mq > q:
                q = mq
            total = lat + dm + (dd if dd > q else q)
            if best is None or total < best_total:
                best, best_total = r, total
        return best if best is not None else self._fallback()


class BWOffloading(Policy):
    """Bandwidth-utilization-based offloading: prefer the least-utilized
    resource, ignoring operand movement cost (§3.2, §5.3)."""

    name = "bw"

    def select(self, instr: VectorInstr, view: SystemView) -> Decision:
        feats = self._feats(instr, view)
        ok = self._supported(instr, feats)
        best = min(ok, key=lambda r: (feats[r].delay_queue,
                                      feats[r].latency_comp))
        return Decision(best, feats, reason="min_queue")

    def select_fast(self, instr: VectorInstr, view: SystemView) -> Resource:
        pools = view.pools_by_index
        if pools is None:          # hand-built view: no fast-path mirrors
            return self.select(instr, view).resource
        now = view.now_ns
        entries = view.page_entries
        flat = view.path_pools_flat
        nloc = view.n_locations
        locs = [entries[s].location for s in instr.srcs]
        best = prev_home = None
        best_q = best_lat = mq = 0.0
        for r, lat, home, _ in candidate_table(
                instr, self.candidates, self.spec):
            if home is not prev_home:
                prev_home = home
                mq = 0.0
                hbase = home.index
                probed = None
                for loc in locs:
                    # co-located operands share one path probe
                    if loc is not home and loc is not probed:
                        probed = loc
                        for p in flat[loc.index * nloc + hbase]:
                            m = p.queue_delay_ns(now)
                            if m > mq:
                                mq = m
            q = pools[r.index].queue_delay_ns(now)
            if mq > q:
                q = mq
            if (best is None or q < best_q
                    or (q == best_q and lat < best_lat)):
                best, best_q, best_lat = r, q, lat
        return best if best is not None else self._fallback()


class DMOffloading(Policy):
    """Data-movement-minimizing offloading: prefer the resource that moves
    the fewest operand BYTES, ignoring contention (§3.2, §5.3)."""

    name = "dm"

    def select(self, instr: VectorInstr, view: SystemView) -> Decision:
        feats = self._feats(instr, view)
        ok = self._supported(instr, feats)

        def moved_bytes(r):
            home = HOME[r]
            return sum(instr.nbytes for s in instr.srcs
                       if view.location_of(s) != home)

        best = min(ok, key=lambda r: (moved_bytes(r), feats[r].latency_comp))
        return Decision(best, feats, reason="min_dm_bytes")

    def select_fast(self, instr: VectorInstr, view: SystemView) -> Resource:
        nbytes = instr.nbytes
        entries = view.page_entries
        if entries is not None:
            locs = [entries[s].location for s in instr.srcs]
        else:
            location_of = view.location_of
            locs = [location_of(s) for s in instr.srcs]
        best = prev_home = None
        best_moved = moved = 0
        best_lat = 0.0
        for r, lat, home, _ in candidate_table(
                instr, self.candidates, self.spec):
            if home is not prev_home:
                prev_home = home
                moved = 0
                for loc in locs:
                    if loc != home:
                        moved += nbytes
            if (best is None or moved < best_moved
                    or (moved == best_moved and lat < best_lat)):
                best, best_moved, best_lat = r, moved, lat
        return best if best is not None else self._fallback()


class IdealPolicy(Policy):
    """Upper bound (§5.3): no queueing, zero movement, fastest resource."""

    name = "ideal"
    ignores_contention = True
    dynamic = False

    def select(self, instr: VectorInstr, view: SystemView) -> Decision:
        feats = self._feats(instr, view)
        ok = self._supported(instr, feats)
        best = min(ok, key=lambda r: feats[r].latency_comp)
        return Decision(best, feats, reason="min_comp")

    def select_fast(self, instr: VectorInstr, view: SystemView) -> Resource:
        best = None
        best_lat = 0.0
        for r, lat, _, _ in candidate_table(
                instr, self.candidates, self.spec):
            if best is None or lat < best_lat:
                best, best_lat = r, lat
        return best if best is not None else self._fallback()


class StaticPolicy(Policy):
    """Single-resource NDP baselines with ISP fallback (§5.3).

    ``ops`` restricts which mnemonics the primary resource accelerates
    (e.g. Flash-Cosmos: MWS AND/OR/NOT only)."""

    dynamic = False

    def __init__(self, spec: SSDSpec, primary: Resource,
                 ops: Optional[Sequence[str]] = None, name: str = ""):
        super().__init__(spec)
        self.primary = primary
        self.ops = frozenset(ops) if ops is not None else None
        self.name = name or primary.value

    def select(self, instr: VectorInstr, view: SystemView) -> Decision:
        feats = self._feats(instr, view)
        ok_primary = (feats[self.primary].supported
                      and supports(self.primary, instr)
                      and instr.op_class is not OpClass.CONTROL
                      and (self.ops is None or instr.op in self.ops))
        if ok_primary and self.primary is Resource.IFP:
            # Flash-Cosmos/Ares-Flash compute on data stored in the flash
            # array (or chained in latches); they never program operands
            # back into flash just to compute on them.
            ok_primary = all(view.location_of(s) == Location.FLASH
                             for s in instr.srcs)
        target = self.primary if ok_primary else Resource.ISP
        return Decision(target, feats, reason="static")

    def select_fast(self, instr: VectorInstr, view: SystemView) -> Resource:
        primary = self.primary
        ok, _, _, _ = static_features(instr, primary, self.spec)
        ok_primary = (ok and supports(primary, instr)
                      and instr.op_class is not OpClass.CONTROL
                      and (self.ops is None or instr.op in self.ops))
        if ok_primary and primary is Resource.IFP:
            ok_primary = all(view.location_of(s) == Location.FLASH
                             for s in instr.srcs)
        return primary if ok_primary else Resource.ISP


class HostPolicy(Policy):
    """Outside-storage processing on host CPU/GPU (§5.3)."""

    ignores_contention = False
    dynamic = False

    def __init__(self, spec: SSDSpec, device: Resource):
        super().__init__(spec)
        assert device in (Resource.HOST_CPU, Resource.HOST_GPU)
        self.device = device
        self.name = device.value
        # GPU baselines run control-intensive regions on the host CPU.
        self.candidates = ((device,) if device is Resource.HOST_CPU
                           else (device, Resource.HOST_CPU))

    def select(self, instr: VectorInstr, view: SystemView) -> Decision:
        feats = self._feats(instr, view)
        target = self.device
        if (instr.op_class is OpClass.CONTROL
                and self.device is Resource.HOST_GPU):
            target = Resource.HOST_CPU
        return Decision(target, feats, reason="host")

    def select_fast(self, instr: VectorInstr, view: SystemView) -> Resource:
        if (instr.op_class is OpClass.CONTROL
                and self.device is Resource.HOST_GPU):
            return Resource.HOST_CPU
        return self.device


# -- factory -----------------------------------------------------------------

FLASH_COSMOS_OPS = ("and", "or", "nand", "nor", "not", "xor")
ARES_FLASH_OPS = FLASH_COSMOS_OPS + ("add", "sub", "mul", "copy")


def make_policy(name: str, spec: SSDSpec) -> Policy:
    name = name.lower()
    if name == "conduit":
        return ConduitPolicy(spec)
    if name in ("bw", "bw_offloading"):
        return BWOffloading(spec)
    if name in ("dm", "dm_offloading"):
        return DMOffloading(spec)
    if name == "ideal":
        return IdealPolicy(spec)
    if name == "isp":
        return StaticPolicy(spec, Resource.ISP, name="isp")
    if name in ("pud", "pud_ssd"):
        return StaticPolicy(spec, Resource.PUD, name="pud")
    if name in ("flash_cosmos", "flashcosmos"):
        return StaticPolicy(spec, Resource.IFP, FLASH_COSMOS_OPS,
                            name="flash_cosmos")
    if name in ("ares_flash", "aresflash", "ifp"):
        return StaticPolicy(spec, Resource.IFP, ARES_FLASH_OPS,
                            name="ares_flash")
    if name == "cpu":
        return HostPolicy(spec, Resource.HOST_CPU)
    if name == "gpu":
        return HostPolicy(spec, Resource.HOST_GPU)
    raise ValueError(f"unknown policy {name!r}")


@functools.lru_cache(maxsize=64)
def shared_policy(name: str, spec: SSDSpec) -> Policy:
    """Process-wide cached policy instance for high-churn callers.

    Safe because policies are stateless across ``select`` calls (see
    :class:`Policy`); the open-loop serving driver admits thousands of
    short sessions per run and must not rebuild the policy — or re-derive
    its spec-pinned tables — per admission.  Callers that mutate a policy
    (none in-tree) must use :func:`make_policy` instead."""
    return make_policy(name, spec)


ALL_POLICIES = ("cpu", "gpu", "isp", "pud", "flash_cosmos", "ares_flash",
                "bw", "dm", "conduit", "ideal")
