"""Batched saturation sweeps: the vectorized driver over the event engine.

:func:`~repro_torch.sim.serving.find_saturation` answers one question — the
sustainable rate of one (catalog, policy, seed) configuration.  The
fleet/grid studies the ROADMAP targets ask it many times over: every
offloading policy x several arrival seeds x whole rate grids.  This module
is the batch layer for those sweeps:

* :func:`array_backend` — plain ``numpy``, always.  This is the one place
  the port differs from the JAX package, whose backend is ``jax.numpy``
  when JAX is importable with ``jax_enable_x64`` on: the port imports no
  JAX.  The lockstep bisection below promises bit-identity with the scalar
  search, whose ``mid = 0.5 * (lo + hi)`` is IEEE double, and numpy's
  float64 keeps it.  The bisection is a handful of doubles between
  host-Python simulations, so moving it to the GPU would add a sync per
  round and save nothing.
* :func:`batched_poisson_arrival_times_ns` — the arrival times of a whole
  probe grid (``n_rates x n_sessions``) in one vectorized expression: the
  integer hash of :func:`repro_torch.sim.machine._hash01`, the inverse-CDF
  exponential gaps and the running sum are all array ops.  Each row matches
  the scalar ``PoissonArrivals.at_rate(r).arrival_times_ns()`` loop
  (tolerance-tested; the integer hash is exact by construction, the float
  tail can differ by accumulation ulps across backends).
* :func:`batched_find_saturation` — many saturation searches in lockstep.
  Each bisection round computes *every* live lane's midpoint as one array
  op, then runs the serving probes (the event-driven core is inherently
  scalar — that is what it models).  Results are bit-identical to calling
  ``find_saturation`` per lane (tested law in ``tests/test_serving.py``):
  the probe body is shared verbatim
  (:func:`repro_torch.sim.serving._saturation_probe`) and float64 midpoint
  arithmetic is associativity-free, so batching cannot change any probe.

Lanes, not loops: a :class:`SweepLane` is one (policy, seed, base-process)
configuration; the batch dimension is the lane list.  Per-lane engine runs
stay independent — a lane that brackets early (both endpoints decided)
drops out of the lockstep rounds without perturbing its neighbours.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

from repro_torch.hw.ssd_spec import DEFAULT_SSD, SSDSpec
from repro_torch.sim.ftl import FTLConfig
from repro_torch.sim.machine import SimConfig
from repro_torch.sim.serving import (SaturationProbe, SaturationResult,
                               ServingConfig, _saturation_probe)
from repro_torch.sim.tenancy import HostIOStream
from repro_torch.sim.workgen import ArrivalProcess, PoissonArrivals, SessionCatalog

PolicyLike = Union[str, object]


def array_backend():
    """The sweep layer's array module: ``numpy``, whose float64 keeps the
    bisection in IEEE double (the bit-identity law with the scalar
    search)."""
    import numpy as np
    return np


# -- vectorized arrival generation ---------------------------------------------

def batched_poisson_arrival_times_ns(rates_per_sec: Sequence[float],
                                     n_sessions: int,
                                     seed: int = 0x0A11,
                                     start_ns: float = 0.0,
                                     xp=None):
    """Arrival-time matrix (``len(rates) x n_sessions``) for a Poisson
    probe grid, fully vectorized.

    Row ``i`` reproduces ``PoissonArrivals(rate_per_sec=rates[i],
    n_sessions=n_sessions, seed=seed, start_ns=start_ns)
    .arrival_times_ns()``: same hashed uniforms (exact — the hash is pure
    integer arithmetic), same inverse-CDF gaps, same accumulation order
    (per-row gap scaling *then* the running sum, matching the scalar
    ``t += gap`` loop).  One expression replaces ``n_rates`` Python loops
    when a sweep wants the whole offered-load grid up front."""
    xp = xp or array_backend()
    import numpy as np                   # integer hash stays in numpy:
    rates = np.asarray(rates_per_sec, dtype=np.float64)
    if rates.ndim != 1 or rates.size == 0:
        raise ValueError("rates_per_sec must be a non-empty 1-D sequence")
    if (rates <= 0.0).any():
        raise ValueError("rates_per_sec must be > 0")
    if n_sessions < 1:
        raise ValueError("n_sessions must be >= 1")
    # _hash01, vectorized: uint64 holds iid * 2654435761 exactly and every
    # step masks back to 32 bits, so this is the scalar hash bit-for-bit
    x = (np.arange(n_sessions, dtype=np.uint64) * 2654435761
         + np.uint64(seed & 0xFFFFFFFF)) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x45D9F3B) & 0xFFFFFFFF
    x ^= x >> 16
    u = np.clip(x / 2**32, 1e-9, 0.999999)        # _exp_gap's clamp
    unit_gaps = -np.log(1.0 - u)                  # exponential(1) gaps,
    # spelled exactly as _exp_gap spells it (log(1-u), not the closer
    # log1p) so rows match the scalar loop to the ulp on one platform
    mean_gap = xp.asarray(1e9 / rates)[:, None]
    # scale each gap to its row's mean first, then accumulate — the same
    # op order as the scalar loop's ``t += -mean * log(1 - u)``
    return start_ns + xp.cumsum(mean_gap * xp.asarray(unit_gaps), axis=1)


# -- lockstep saturation search ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepLane:
    """One lane of a batched saturation sweep: a (policy, arrivals)
    configuration searched independently of its neighbours.  ``base``
    overrides the default Poisson process (e.g. an MMPP burst lane);
    ``seed``/``n_sessions`` only apply to the default."""

    policy: PolicyLike
    seed: int = 0xA117
    n_sessions: int = 64
    base: Optional[ArrivalProcess] = None

    def base_process(self, rate_lo: float) -> ArrivalProcess:
        return self.base or PoissonArrivals(rate_per_sec=rate_lo,
                                            n_sessions=self.n_sessions,
                                            seed=self.seed)


def batched_find_saturation(catalog: SessionCatalog,
                            lanes: Sequence[SweepLane],
                            slo_p99_ns: float,
                            rate_lo: float,
                            rate_hi: float,
                            iters: int = 6,
                            spec: SSDSpec = DEFAULT_SSD,
                            config: Optional[SimConfig] = None,
                            serving: Optional[ServingConfig] = None,
                            io_stream: Optional[HostIOStream] = None,
                            ftl: Optional[FTLConfig] = None,
                            xp=None) -> List[SaturationResult]:
    """Run one saturation search per lane, bisections in lockstep.

    Bit-identical to ``[find_saturation(catalog, lane.policy, ...) for
    lane in lanes]`` — the probe body is shared
    (:func:`repro_torch.sim.serving._saturation_probe`) and each round's
    midpoints ``0.5 * (lo + hi)`` are one float64 array op, which per
    element is exactly the scalar expression.  The batch layer buys the
    sweep shape (one call, results in lane order, lanes that resolve at
    the endpoints drop out of later rounds) without perturbing any
    individual search."""
    if rate_lo <= 0.0 or rate_hi <= rate_lo:
        raise ValueError("need 0 < rate_lo < rate_hi")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    if not lanes:
        raise ValueError("need at least one SweepLane")
    xp = xp or array_backend()
    scfg = serving or ServingConfig(keep_session_results=False)

    n = len(lanes)
    bases = [lane.base_process(rate_lo) for lane in lanes]
    names = [lane.policy if isinstance(lane.policy, str)
             else lane.policy.name for lane in lanes]
    probes: List[List[SaturationProbe]] = [[] for _ in range(n)]
    results: List[Optional[SaturationResult]] = [None] * n

    def probe(i: int, rate: float) -> bool:
        return _saturation_probe(catalog, bases[i], lanes[i].policy, rate,
                                 slo_p99_ns, scfg, spec, config, io_stream,
                                 ftl, probes[i])

    # endpoint rounds: lanes where even rate_lo fails (result 0.0) or
    # rate_hi holds (result rate_hi) resolve here and leave the lockstep
    live: List[int] = []
    for i in range(n):
        if not probe(i, rate_lo):
            results[i] = SaturationResult(names[i], slo_p99_ns, 0.0,
                                          (0.0, rate_lo), probes[i])
        elif probe(i, rate_hi):
            results[i] = SaturationResult(names[i], slo_p99_ns, rate_hi,
                                          (rate_hi, rate_hi), probes[i])
        else:
            live.append(i)

    if live:
        lo = xp.full(len(live), float(rate_lo), dtype=xp.float64)
        hi = xp.full(len(live), float(rate_hi), dtype=xp.float64)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)          # every live lane, one array op
            ok = xp.asarray([probe(i, float(m))
                             for i, m in zip(live, mid)], dtype=bool)
            lo = xp.where(ok, mid, lo)
            hi = xp.where(ok, hi, mid)
        for k, i in enumerate(live):
            results[i] = SaturationResult(names[i], slo_p99_ns,
                                          float(lo[k]),
                                          (float(lo[k]), float(hi[k])),
                                          probes[i])
    return results  # type: ignore[return-value]


# -- lockstep fleet saturation search ------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetSweepLane:
    """One lane of a batched *fleet* saturation sweep: a (policy, fleet
    topology, arrivals) configuration — e.g. one placement x hedging
    cell of the fleet bench grid.  ``fleet=None`` uses the caller's
    shared default."""

    policy: PolicyLike
    fleet: Optional[object] = None       # FleetConfig override
    seed: int = 0xA117
    n_sessions: int = 64
    base: Optional[ArrivalProcess] = None

    def base_process(self, rate_lo: float) -> ArrivalProcess:
        return self.base or PoissonArrivals(rate_per_sec=rate_lo,
                                            n_sessions=self.n_sessions,
                                            seed=self.seed)


def batched_find_fleet_saturation(catalog: SessionCatalog,
                                  lanes: Sequence[FleetSweepLane],
                                  slo_p99_ns: float,
                                  rate_lo: float,
                                  rate_hi: float,
                                  iters: int = 6,
                                  spec: SSDSpec = DEFAULT_SSD,
                                  config: Optional[SimConfig] = None,
                                  serving: Optional[ServingConfig] = None,
                                  fleet=None,
                                  io_stream: Optional[HostIOStream] = None,
                                  ftl: Optional[FTLConfig] = None,
                                  faults=None,
                                  min_availability: float = 1.0,
                                  xp=None) -> List[SaturationResult]:
    """Fleet saturation searches in lockstep, one per lane.

    The fleet analogue of :func:`batched_find_saturation`, with the same
    bit-identity law against the scalar search: the probe body is shared
    verbatim (:func:`repro_torch.sim.fleet._fleet_saturation_probe`) and every
    round's midpoints are one float64 array op.  Lanes carry their own
    :class:`~repro_torch.sim.fleet.FleetConfig` so a placement x hedging grid
    is one call."""
    from repro_torch.sim.fleet import FleetConfig, _fleet_saturation_probe
    from repro_torch.sim.placement import make_placement
    if rate_lo <= 0.0 or rate_hi <= rate_lo:
        raise ValueError("need 0 < rate_lo < rate_hi")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    if not lanes:
        raise ValueError("need at least one FleetSweepLane")
    xp = xp or array_backend()
    scfg = serving or ServingConfig(keep_session_results=False)
    default_fleet = fleet or FleetConfig()

    n = len(lanes)
    bases = [lane.base_process(rate_lo) for lane in lanes]
    fleets = [lane.fleet or default_fleet for lane in lanes]
    names = []
    for lane, fcfg in zip(lanes, fleets):
        pol = (lane.policy if isinstance(lane.policy, str)
               else lane.policy.name)
        pl = make_placement(fcfg.placement, fcfg.n_drives).name
        names.append(f"{pol}[{pl}x{fcfg.n_drives}]")
    probes: List[List[SaturationProbe]] = [[] for _ in range(n)]
    results: List[Optional[SaturationResult]] = [None] * n

    def probe(i: int, rate: float) -> bool:
        return _fleet_saturation_probe(
            catalog, bases[i], lanes[i].policy, rate, slo_p99_ns, scfg,
            fleets[i], spec, config, io_stream, ftl, probes[i],
            faults=faults, min_availability=min_availability)

    live: List[int] = []
    for i in range(n):
        if not probe(i, rate_lo):
            results[i] = SaturationResult(names[i], slo_p99_ns, 0.0,
                                          (0.0, rate_lo), probes[i])
        elif probe(i, rate_hi):
            results[i] = SaturationResult(names[i], slo_p99_ns, rate_hi,
                                          (rate_hi, rate_hi), probes[i])
        else:
            live.append(i)

    if live:
        lo = xp.full(len(live), float(rate_lo), dtype=xp.float64)
        hi = xp.full(len(live), float(rate_hi), dtype=xp.float64)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            ok = xp.asarray([probe(i, float(m))
                             for i, m in zip(live, mid)], dtype=bool)
            lo = xp.where(ok, mid, lo)
            hi = xp.where(ok, hi, mid)
        for k, i in enumerate(live):
            results[i] = SaturationResult(names[i], slo_p99_ns,
                                          float(lo[k]),
                                          (float(lo[k]), float(hi[k])),
                                          probes[i])
    return results  # type: ignore[return-value]
