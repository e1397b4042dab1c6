"""Open-loop session workload generators (the serving-regime front end).

The batch entry points (:func:`~repro_torch.sim.machine.simulate`,
:func:`~repro_torch.sim.tenancy.simulate_mix`) measure the makespan of a *fixed*
tenant set.  The regime the ROADMAP targets — a drive serving heavy traffic
from millions of users — is open loop: sessions keep arriving whether or
not earlier ones have finished, and the question becomes *sustainable
throughput at bounded tail latency*.  This module generates those arrivals:

* :class:`SessionCatalog` — a weighted catalog of vectorized traces
  (optionally with a per-kind policy override).  Each arriving session
  deterministically draws one catalog entry, so a serving run is a seeded
  mixture of workload kinds, not one trace repeated.
* Arrival processes, all frozen/hashable and fully seeded (the same
  inverse-CDF hashed-uniform discipline as :class:`HostIOStream`, so
  identical seeds replay identical workloads):

  - :class:`PoissonArrivals`       — memoryless open-loop arrivals, the
    canonical serving model;
  - :class:`MMPPArrivals`          — a 2-state Markov-modulated Poisson
    process (ON/OFF dwell times, different rates per state) for bursty,
    correlated traffic;
  - :class:`DeterministicArrivals` — fixed inter-arrival gap (closed-form
    offered load, useful for calibration);
  - :class:`TraceReplayArrivals`   — explicit timestamps replayed verbatim
    (production arrival logs);
  - :class:`SuperposedArrivals`    — the merge of several processes (e.g.
    a Poisson base load plus an MMPP burst source).

Every process exposes ``mean_rate_per_sec`` and ``at_rate(rate)`` — a
rescaled copy with the same shape (burstiness, replay pattern) at a new
offered load — which is what :func:`repro_torch.sim.serving.find_saturation`
bisects over.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.trace import Trace
from repro_torch.sim.machine import _hash01


def _exp_gap(mean_ns: float, u: float) -> float:
    """Inverse-CDF exponential gap from one uniform draw (always > 0)."""
    u = min(0.999999, max(1e-9, u))
    return -mean_ns * math.log(1.0 - u)


# -- arrival processes ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Base class: a finite, seeded stream of session arrival times."""

    def arrival_times_ns(self) -> List[float]:
        raise NotImplementedError

    @property
    def mean_rate_per_sec(self) -> float:
        """Nominal offered load (sessions per second)."""
        raise NotImplementedError

    def at_rate(self, rate_per_sec: float) -> "ArrivalProcess":
        """A copy rescaled to a new mean rate, preserving the process
        shape (burst structure, replay pattern) and the seed."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless session arrivals at ``rate_per_sec`` (open-loop)."""

    rate_per_sec: float = 1000.0
    n_sessions: int = 64
    seed: int = 0x0A11
    start_ns: float = 0.0

    def __post_init__(self) -> None:
        if self.rate_per_sec <= 0.0:
            raise ValueError("rate_per_sec must be > 0")
        if self.n_sessions < 1:
            raise ValueError("n_sessions must be >= 1")

    def arrival_times_ns(self) -> List[float]:
        mean_gap = 1e9 / self.rate_per_sec
        t = self.start_ns
        out = []
        for i in range(self.n_sessions):
            t += _exp_gap(mean_gap, _hash01(i, self.seed))
            out.append(t)
        return out

    @property
    def mean_rate_per_sec(self) -> float:
        return self.rate_per_sec

    def at_rate(self, rate_per_sec: float) -> "PoissonArrivals":
        return dataclasses.replace(self, rate_per_sec=rate_per_sec)


@dataclasses.dataclass(frozen=True)
class DeterministicArrivals(ArrivalProcess):
    """Fixed inter-arrival gap: exactly ``rate_per_sec`` offered load."""

    rate_per_sec: float = 1000.0
    n_sessions: int = 64
    start_ns: float = 0.0

    def __post_init__(self) -> None:
        if self.rate_per_sec <= 0.0:
            raise ValueError("rate_per_sec must be > 0")
        if self.n_sessions < 1:
            raise ValueError("n_sessions must be >= 1")

    def arrival_times_ns(self) -> List[float]:
        gap = 1e9 / self.rate_per_sec
        return [self.start_ns + (i + 1) * gap for i in range(self.n_sessions)]

    @property
    def mean_rate_per_sec(self) -> float:
        return self.rate_per_sec

    def at_rate(self, rate_per_sec: float) -> "DeterministicArrivals":
        return dataclasses.replace(self, rate_per_sec=rate_per_sec)


@dataclasses.dataclass(frozen=True)
class MMPPArrivals(ArrivalProcess):
    """2-state Markov-modulated Poisson process (ON/OFF burst traffic).

    The modulating chain alternates ON and OFF states with exponentially
    distributed dwell times (``mean_on_ns`` / ``mean_off_ns``); within a
    state, arrivals are Poisson at that state's rate.  ``rate_off_per_sec
    = 0`` gives classic ON/OFF bursts; a nonzero OFF rate models a base
    load with periodic surges.  The long-run mean rate is the dwell-time-
    weighted average of the two state rates."""

    rate_on_per_sec: float = 4000.0
    rate_off_per_sec: float = 0.0
    mean_on_ns: float = 10e6
    mean_off_ns: float = 10e6
    n_sessions: int = 64
    seed: int = 0x0A11
    start_ns: float = 0.0

    def __post_init__(self) -> None:
        if self.rate_on_per_sec <= 0.0:
            raise ValueError("rate_on_per_sec must be > 0")
        if self.rate_off_per_sec < 0.0:
            raise ValueError("rate_off_per_sec must be >= 0")
        if self.mean_on_ns <= 0.0 or self.mean_off_ns <= 0.0:
            raise ValueError("dwell times must be > 0")
        if self.n_sessions < 1:
            raise ValueError("n_sessions must be >= 1")

    def arrival_times_ns(self) -> List[float]:
        out: List[float] = []
        t = self.start_ns
        on = True
        dwell_i = 0          # counter for dwell-time draws
        gap_i = 0            # counter for arrival-gap draws
        dwell_seed = self.seed ^ 0xD3E11
        gap_seed = self.seed ^ 0x6A99
        while len(out) < self.n_sessions:
            mean_dwell = self.mean_on_ns if on else self.mean_off_ns
            rate = self.rate_on_per_sec if on else self.rate_off_per_sec
            dwell = _exp_gap(mean_dwell, _hash01(dwell_i, dwell_seed))
            dwell_i += 1
            if rate > 0.0:
                mean_gap = 1e9 / rate
                tau = t
                while len(out) < self.n_sessions:
                    tau += _exp_gap(mean_gap, _hash01(gap_i, gap_seed))
                    gap_i += 1
                    if tau > t + dwell:
                        break
                    out.append(tau)
            t += dwell
            on = not on
        return out

    @property
    def mean_rate_per_sec(self) -> float:
        span = self.mean_on_ns + self.mean_off_ns
        return (self.rate_on_per_sec * self.mean_on_ns
                + self.rate_off_per_sec * self.mean_off_ns) / span

    def at_rate(self, rate_per_sec: float) -> "MMPPArrivals":
        f = rate_per_sec / self.mean_rate_per_sec
        return dataclasses.replace(
            self, rate_on_per_sec=self.rate_on_per_sec * f,
            rate_off_per_sec=self.rate_off_per_sec * f)


@dataclasses.dataclass(frozen=True)
class TraceReplayArrivals(ArrivalProcess):
    """Replay an explicit arrival-time log (ns, non-decreasing)."""

    times_ns: Tuple[float, ...] = ()
    start_ns: float = 0.0

    def __post_init__(self) -> None:
        if not self.times_ns:
            raise ValueError("times_ns must be non-empty")
        if any(t < 0 for t in self.times_ns):
            raise ValueError("times_ns must be >= 0")
        if any(b < a for a, b in zip(self.times_ns, self.times_ns[1:])):
            raise ValueError("times_ns must be non-decreasing")

    def arrival_times_ns(self) -> List[float]:
        return [self.start_ns + t for t in self.times_ns]

    @property
    def mean_rate_per_sec(self) -> float:
        span = self.times_ns[-1] - self.times_ns[0]
        if span <= 0.0:
            return float("inf")
        # n arrivals over the log's span (first arrival opens the window)
        return (len(self.times_ns) - 1) / (span / 1e9)

    def at_rate(self, rate_per_sec: float) -> "TraceReplayArrivals":
        """Time-compress/stretch the log to a new mean rate (the replay
        pattern — relative gap structure — is preserved exactly)."""
        mean = self.mean_rate_per_sec
        if not math.isfinite(mean):
            # a zero-span log has no rate to rescale: f would be inf and
            # the rescaled times NaN, which float-compares its way past
            # every downstream validation
            raise ValueError("cannot rescale a zero-span replay log")
        f = mean / rate_per_sec
        base = self.times_ns[0]
        return dataclasses.replace(
            self, times_ns=tuple(base + (t - base) * f for t in self.times_ns))


@dataclasses.dataclass(frozen=True)
class SuperposedArrivals(ArrivalProcess):
    """The merge of several arrival processes (sorted interleave)."""

    parts: Tuple[ArrivalProcess, ...] = ()

    def __post_init__(self) -> None:
        if not self.parts:
            raise ValueError("superposition needs at least one process")

    def arrival_times_ns(self) -> List[float]:
        return sorted(t for p in self.parts for t in p.arrival_times_ns())

    @property
    def mean_rate_per_sec(self) -> float:
        return sum(p.mean_rate_per_sec for p in self.parts)

    def at_rate(self, rate_per_sec: float) -> "SuperposedArrivals":
        f = rate_per_sec / self.mean_rate_per_sec
        return dataclasses.replace(
            self, parts=tuple(p.at_rate(p.mean_rate_per_sec * f)
                              for p in self.parts))


# -- session catalog -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CatalogEntry:
    """One session kind: a vectorized trace template plus its draw weight.

    The trace is a *template*: the serving driver clones it per admitted
    session (a Trace owns mutable PageTable residency state, so concurrent
    sessions must never share one).  ``policy`` optionally overrides the
    run-wide offloading policy for sessions of this kind; ``timeout_ns``
    optionally overrides ``ServingConfig.session_timeout_ns`` — the
    host-side deadline after which an admitted session of this kind is
    abandoned (marked timed-out, slot freed)."""

    name: str
    trace: Trace
    weight: float = 1.0
    policy: Optional[str] = None
    timeout_ns: Optional[float] = None

    def __post_init__(self) -> None:
        if self.weight <= 0.0:
            raise ValueError(f"catalog entry {self.name!r}: weight must be > 0")
        if self.timeout_ns is not None and self.timeout_ns <= 0.0:
            raise ValueError(f"catalog entry {self.name!r}: timeout_ns must "
                             f"be > 0 (or None), got {self.timeout_ns}")


class SessionCatalog:
    """Weighted catalog of session kinds with a deterministic draw.

    ``draw(session_id)`` hashes the session id against the catalog seed
    into the cumulative-weight table, so the kind sequence is a pure
    function of ``(entries, seed)`` — independent of arrival times, policy
    and engine state, which keeps serving runs replayable and lets
    saturation probes at different rates serve the *same* kind sequence.
    """

    def __init__(self, entries: Sequence[CatalogEntry], seed: int = 0x5E55):
        entries = tuple(entries)
        if not entries:
            raise ValueError("session catalog needs at least one entry")
        names = [e.name for e in entries]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate catalog entry names: {names}")
        self.entries = entries
        self.seed = seed
        acc, cum = 0.0, []
        for e in entries:
            acc += e.weight
            cum.append(acc)
        self._cum = cum
        self._total = acc

    def __len__(self) -> int:
        return len(self.entries)

    def draw(self, session_id: int) -> CatalogEntry:
        """The catalog entry session ``session_id`` executes."""
        u = _hash01(session_id, self.seed ^ 0xCA7) * self._total
        return self.entries[min(len(self.entries) - 1,
                                bisect.bisect_right(self._cum, u))]

    def kind_counts(self, n_sessions: int) -> dict:
        """Kind -> draw count over the first ``n_sessions`` ids (what a
        serving run of that length will execute)."""
        out = {e.name: 0 for e in self.entries}
        for sid in range(n_sessions):
            out[self.draw(sid).name] += 1
        return out
