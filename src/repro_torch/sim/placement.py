"""Placement policies + per-drive RNG lineage for the SSD fleet.

A placement policy answers two questions, both deterministically:

* **replicas(sid)** — which ``r`` distinct drives hold session ``sid``'s
  data (the *replica set*, primary first).  This is data placement: it
  never depends on load, only on the session id, so the same session
  always lands on the same drives across runs and policies can be
  compared apples-to-apples.
* **route(sid, candidates, health)** — in what order the fleet should
  *prefer* the replica set right now.  Static policies return the
  candidates unchanged; :class:`HeatAwarePlacement` (``needs_health``)
  reorders by a load score from the drives'
  :class:`~repro_torch.sim.drive.DriveHealth` snapshots.

Read steering and hedging are *fleet* mechanisms layered on the route
order (:mod:`repro_torch.sim.fleet`), not policy internals — so every policy
composes with both.

Seed lineage (ISSUE 10 satellite): :func:`derive_drive_seed` gives each
drive of a fleet a deterministic but distinct RNG stream from one fleet
seed.  Two laws, both tested:

* ``derive_drive_seed(seed, 0) == seed`` — drive 0 inherits the fleet
  seed unchanged, which is what makes a 1-drive fleet bit-identical to
  the single-drive entry points.
* The derivation is per-drive pure: adding drive k+1 to a fleet never
  perturbs the draws of drives 0..k (no shared RNG object to advance).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

_MASK64 = (1 << 64) - 1


def mix64(x: int) -> int:
    """SplitMix64 finalizer: a cheap, well-distributed 64-bit mix."""
    x &= _MASK64
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def derive_drive_seed(seed: int, drive: int, salt: int = 0) -> int:
    """Per-drive seed from one fleet seed; deterministic and distinct.

    ``drive == 0`` with the default salt returns ``seed`` unchanged —
    the identity that makes the N=1 fleet equivalence law exact.  Other
    drives get independent splitmix-derived streams; ``salt``
    distinguishes stream *kinds* on one drive (0: host-I/O arrivals,
    1: fault draws) so the two never correlate."""
    if drive == 0 and salt == 0:
        return seed
    x = mix64(seed ^ 0x9E3779B97F4A7C15)
    x = mix64(x + drive)           # sequential splitmix-style absorption:
    return mix64(x + (salt << 32))  # every (drive, salt) is a fresh stream


class PlacementPolicy:
    """Deterministic session→drives mapping; see the module docstring."""

    #: registry / display name
    name = "base"
    #: True if :meth:`route` consumes DriveHealth snapshots — forces the
    #: fleet into the lockstep driver loop (static policies pre-partition)
    needs_health = False

    def __init__(self, n_drives: int):
        if n_drives < 1:
            raise ValueError("n_drives must be >= 1")
        self.n_drives = n_drives

    def replicas(self, sid: int, r: int) -> Tuple[int, ...]:
        """``r`` distinct drives holding session ``sid``, primary first."""
        raise NotImplementedError

    def route(self, sid: int, candidates: Sequence[int],
              health: Optional[Dict[int, object]] = None
              ) -> Tuple[int, ...]:
        """Preference order over the replica set; default: placement
        order (primary first), independent of load."""
        return tuple(candidates)


class HashPlacement(PlacementPolicy):
    """Hash the session id; replicas by chained declustering.

    Primary ``mix64(sid) % N``; the ``j``-th replica is the next drive
    modulo N, so each drive's replica load spreads over its neighbours
    (chained declustering) and a retirement fans rebuild reads out
    instead of doubling one mirror's load."""

    name = "hash"

    def replicas(self, sid: int, r: int) -> Tuple[int, ...]:
        r = min(r, self.n_drives)
        p = mix64(sid + 0x5851F42D4C957F2D) % self.n_drives
        return tuple((p + j) % self.n_drives for j in range(r))


class ConsistentHashPlacement(PlacementPolicy):
    """Consistent hashing with virtual nodes.

    Each drive owns ``vnodes`` points on a 64-bit ring; a session maps
    to the first ``r`` *distinct* drives clockwise from its hash.  The
    property bought over plain hashing: resizing the fleet from N to
    N+1 remaps only ~1/(N+1) of sessions, so saturation-vs-N sweeps
    measure contention, not wholesale reshuffling."""

    name = "consistent"

    def __init__(self, n_drives: int, vnodes: int = 64):
        super().__init__(n_drives)
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        points: List[Tuple[int, int]] = []
        for d in range(n_drives):
            for v in range(vnodes):
                points.append((mix64((d << 20) | v | 0xC0FFEE << 40), d))
        points.sort()
        self._ring_keys = [k for k, _ in points]
        self._ring_drives = [d for _, d in points]

    def replicas(self, sid: int, r: int) -> Tuple[int, ...]:
        r = min(r, self.n_drives)
        i = bisect.bisect_right(self._ring_keys,
                                mix64(sid + 0x2545F4914F6CDD1D))
        n = len(self._ring_keys)
        out: List[int] = []
        for step in range(n):
            d = self._ring_drives[(i + step) % n]
            if d not in out:
                out.append(d)
                if len(out) == r:
                    break
        return tuple(out)


class HeatAwarePlacement(HashPlacement):
    """Hash-placed data, heat-routed sessions.

    The replica *set* is still :class:`HashPlacement` (data cannot move
    per request) but :meth:`route` orders the set by a load score from
    live :class:`~repro_torch.sim.drive.DriveHealth` snapshots: queue depth
    plus penalties for active GC, recovery windows and degraded dies.
    Ties preserve placement order, keeping the routing deterministic."""

    name = "heat"
    needs_health = True

    #: score penalties, in units of queued sessions
    GC_PENALTY = 4.0
    RECOVERY_PENALTY = 8.0
    DEGRADED_PENALTY = 2.0

    def route(self, sid: int, candidates: Sequence[int],
              health: Optional[Dict[int, object]] = None
              ) -> Tuple[int, ...]:
        if not health:
            return tuple(candidates)

        def score(d: int) -> float:
            h = health.get(d)
            if h is None:
                return 0.0
            if h.retired:
                return float("inf")
            s = float(h.inflight)
            if h.gc_busy:
                s += self.GC_PENALTY + h.gc_active_dies
            if h.recovering:
                s += self.RECOVERY_PENALTY
            s += self.DEGRADED_PENALTY * (h.read_only_dies + h.failed_dies)
            return s

        # stable sort: equal scores keep placement (primary-first) order
        return tuple(sorted(candidates, key=score))


_REGISTRY = {
    "hash": HashPlacement,
    "consistent": ConsistentHashPlacement,
    "heat": HeatAwarePlacement,
}


def make_placement(name, n_drives: int) -> PlacementPolicy:
    """Resolve a placement by registry name (``hash`` / ``consistent`` /
    ``heat``) or pass a :class:`PlacementPolicy` instance through."""
    if isinstance(name, PlacementPolicy):
        return name
    try:
        return _REGISTRY[name](n_drives)
    except KeyError:
        raise ValueError(
            f"unknown placement {name!r}: expected one of "
            f"{sorted(_REGISTRY)} or a PlacementPolicy instance") from None
