"""Fault injection and error recovery: the reliability subsystem.

The engine's flash was perfect: every sense decoded on the first try and
the wear histogram the GC policy suite flattens had no downstream
consequence.  Real NAND pays for reliability in *latency* — a read whose
raw bit error rate (RBER) exceeds the hard-decode ECC limit escalates
through a recovery ladder that books real time on the same contended
pools every other tenant uses — and in *capacity*: blocks that keep
producing uncorrectable reads are retired, draining the per-die reserve
until the drive degrades to read-only.  This module models both sides.

Error model (per read)
----------------------
The raw bit error rate of a page is additive in the three classic
stressors, each scaled by a :class:`FaultConfig` knob::

    rber = rber_base                                   (intrinsic)
         + rber_per_pe * erase_count(block)            (P/E wear)
         + rber_retention * age_ns / retention_scale_ns  (retention)

``erase_count`` is the FTL's real per-block wear counter, so a
wear-aware victim policy that flattens the histogram *measurably* lowers
the drive's error rate — the first quantitative payoff for wear leveling
in this repo.  ``age_ns`` is the time since the page's last program
(tracked by :meth:`FaultModel.on_program`; pages never programmed in-run
age from t=0).  The hard decoder corrects up to
``ReliabilitySpec.ecc_hard_rber``; the decode-failure probability is the
sharp threshold curve ``p_fail(e) = min(1, (e / ecc_hard_rber) **
ecc_steepness)``.

Recovery ladder (every stage is real contention)
------------------------------------------------
A failed hard decode escalates, booking each stage on the live pools:

1. **Read-retry** — up to ``max_read_retries`` re-senses at shifted
   reference voltages.  Step ``k`` books ``t_read_ns + (k+1) *
   read_retry_ns`` on the page's die plus a channel transfer, and shrinks
   the effective RBER by ``retry_rber_factor`` per step.
2. **Soft decode** — one LDPC soft-decode of ``soft_decode_ns`` on the
   controller's ECC engines (a :class:`~repro_torch.sim.servers.ServerPool` of
   ``ecc_engines`` units that exists only while faults are active), at
   ``soft_rber_factor`` times the raw RBER.
3. **Superpage-parity rebuild** — the read is *uncorrectable*: the page
   is reconstructed by reading every sibling die of its stripe (the dies
   sharing ``die // channels`` — one per channel, so the senses run in
   parallel on distinct channels) and XORing them on the ECC engines.
   With ``parity=False``, or when a stripe sibling has failed, the data
   is gone and the read is surfaced as a **failed op** — never silently
   dropped.

Uncorrectable reads count against their block; at ``retire_after`` the
block is **retired**: surviving valid pages are relocated through the GC
machinery (real read/transfer/program bookings), the block leaves the
pool forever, and the die's free list shrinks.  While faults are active
the FTL's infinite-over-provisioning escape hatch is disabled, so a die
that runs out of physical blocks enters **read-only mode**: its writes
fail loudly (counted, surfaced) instead of hanging or silently growing.
A whole-die failure (``die_failures``) makes every read on the die a
rebuild and every write/GC a no-op from its failure time onward.

Determinism contract
--------------------
One uniform draw decides each checked read via the engine-wide
:func:`~repro_torch.sim.machine._hash01` counter hash: draw ``i`` is a pure
function of ``(i, seed)``, and the counter advances in event order, so a
seeded run replays bit-identically.  The *same* uniform is compared
against every rung's (monotonically shrinking) failure probability, so a
read recovers at the earliest rung that can hold it — the ladder depth
is monotone in the page's RBER.  With the all-off default
``FaultConfig()`` (``.active == False``) the subsystem is never even
constructed and the engine is bit-identical to a build without this
module (pinned by the golden digests in
``tests/test_golden_equivalence.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.hw.ssd_spec import SSDSpec
from repro_torch.sim.servers import Fabric, ServerPool


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Error-injection knobs (the *rate* side; hardware recovery costs
    live in :class:`~repro_torch.hw.ssd_spec.ReliabilitySpec`).

    The default is all-off: ``active`` is False and the simulate wiring
    skips the subsystem entirely, bit-identical to no fault support at
    all.  ``die_failures`` is a tuple of ``(die, t_ns)`` pairs: die
    ``die`` fails hard at simulated time ``t_ns``.  ``op_timeout_ns``
    arms the host-I/O timeout/retry machinery (bounded retries with
    exponential backoff) independent of the error sources."""

    rber_base: float = 0.0            # intrinsic RBER of a fresh page
    rber_per_pe: float = 0.0          # RBER added per block erase (wear)
    rber_retention: float = 0.0       # RBER added per retention_scale_ns
    retention_scale_ns: float = 1e9   # retention-age unit
    parity: bool = True               # superpage parity rebuild available
    retire_after: int = 2             # uncorrectables before block retirement
    die_failures: Tuple[Tuple[int, float], ...] = ()
    seed: int = 0xFA17
    op_timeout_ns: Optional[float] = None  # host op timeout (None: off)
    max_op_retries: int = 2           # host op retries after a timeout
    op_retry_backoff_ns: float = 50_000.0  # base backoff, doubles per retry

    def __post_init__(self) -> None:
        for name in ("rber_base", "rber_per_pe", "rber_retention"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        if self.retention_scale_ns <= 0.0:
            raise ValueError(
                f"retention_scale_ns must be > 0, got {self.retention_scale_ns}")
        if self.retire_after < 1:
            raise ValueError(
                f"retire_after must be >= 1, got {self.retire_after}")
        for pair in self.die_failures:
            if (not isinstance(pair, tuple) or len(pair) != 2
                    or int(pair[0]) != pair[0] or pair[0] < 0
                    or pair[1] < 0.0):
                raise ValueError(
                    "die_failures entries must be (die >= 0, t_ns >= 0) "
                    f"pairs, got {pair!r}")
        if self.op_timeout_ns is not None and self.op_timeout_ns <= 0.0:
            raise ValueError(
                f"op_timeout_ns must be > 0 (or None), got {self.op_timeout_ns}")
        if self.max_op_retries < 0:
            raise ValueError(
                f"max_op_retries must be >= 0, got {self.max_op_retries}")
        if self.op_retry_backoff_ns < 0.0:
            raise ValueError("op_retry_backoff_ns must be >= 0, got "
                             f"{self.op_retry_backoff_ns}")

    @property
    def active(self) -> bool:
        """Whether any fault source (or the op-timeout machinery) is on.
        Inactive configs are treated exactly like ``faults=None``."""
        return bool(self.rber_base > 0.0 or self.rber_per_pe > 0.0
                    or self.rber_retention > 0.0 or self.die_failures
                    or self.op_timeout_ns is not None)


@dataclasses.dataclass
class FaultStats:
    """Snapshot of the fault subsystem's counters after a run."""

    n_reads_checked: int = 0          # reads that rolled the error model
    n_hard_fails: int = 0             # hard-decode failures (ladder entries)
    n_retry_reads: int = 0            # read-retry re-senses booked
    n_retry_recovered: int = 0        # reads recovered by a retry step
    n_soft_decodes: int = 0           # LDPC soft decodes booked
    n_soft_recovered: int = 0         # reads recovered by soft decode
    n_uncorrectable: int = 0          # reads past soft decode (rebuild/fail)
    n_rebuilds: int = 0               # parity reconstructions completed
    n_rebuild_reads: int = 0          # stripe-sibling senses booked
    n_failed_reads: int = 0           # unrecoverable (no parity / dead stripe)
    n_blocks_retired: int = 0
    n_pages_relocated: int = 0        # survivor pages moved by retirement
    n_failed_writes: int = 0          # writes rejected (read-only / dead die)
    n_dies_failed: int = 0            # die_failures that took effect
    n_read_only_dies: int = 0         # dies degraded to read-only
    n_op_timeouts: int = 0            # host ops past op_timeout_ns
    n_op_retries: int = 0             # host op re-issues (bounded backoff)
    n_failed_ops: int = 0             # host ops failed after the last retry
    errors_by_die: List[int] = dataclasses.field(default_factory=list)

    @property
    def recovered(self) -> int:
        return (self.n_retry_recovered + self.n_soft_recovered
                + self.n_rebuilds)

    def summary(self) -> str:
        return (f"reads checked={self.n_reads_checked} "
                f"hard-fails={self.n_hard_fails} "
                f"(retry={self.n_retry_recovered} "
                f"soft={self.n_soft_recovered} rebuild={self.n_rebuilds} "
                f"failed={self.n_failed_reads}) "
                f"retired={self.n_blocks_retired} blocks "
                f"({self.n_pages_relocated} pages relocated), "
                f"{self.n_read_only_dies} read-only dies, "
                f"{self.n_failed_writes} failed writes, "
                f"op timeouts={self.n_op_timeouts} "
                f"retries={self.n_op_retries} failed={self.n_failed_ops}")


class FaultModel:
    """Binds a :class:`FaultConfig` to one fabric: the per-read error
    roll, the recovery ladder, retirement and die-failure bookkeeping.

    Construction registers the ECC soft-decode engines as an extra
    :class:`~repro_torch.sim.servers.ServerPool` on the fabric and sets
    ``fabric.faults`` so the host I/O model and tenant Simulations find
    the ladder.  One model serves one run (the uniform-draw counter and
    retention clocks are run state); build a fresh one per run."""

    def __init__(self, cfg: FaultConfig, spec: SSDSpec, fabric: Fabric,
                 engine) -> None:
        if not cfg.active:
            raise ValueError("FaultModel needs an active FaultConfig; "
                             "pass faults=None (or an all-off config) to "
                             "run without fault injection")
        f = spec.flash
        for die, _t in cfg.die_failures:
            if die >= f.total_dies:
                raise ValueError(
                    f"die_failures names die {die}, but the drive has "
                    f"{f.total_dies} dies")
        self.cfg = cfg
        self.rel = spec.reliability
        self.spec = spec
        self.fabric = fabric
        self.engine = engine
        self.n_dies = f.total_dies
        self.n_channels = f.channels
        # one-way page transfer (DMA + channel streaming), the ladder's
        # per-re-sense channel cost — same formula as every other reader
        self._chan_xfer_ns = f.t_dma_ns + spec.page_size * f.channel_ns_per_byte
        self.ecc = ServerPool("ecc", self.rel.ecc_engines)
        fabric.extra.append(self.ecc)
        fabric.faults = self
        # seeded-uniform draw counter: advances once per checked read, in
        # event order (the determinism contract in the module docstring)
        self._n_draws = 0
        # retention clocks: (die, blk, pg) -> last program time
        self.prog_ns: Dict[Tuple[int, int, int], float] = {}
        # uncorrectable-read counts per (die, blk) — retirement trigger
        self.uncorrectable: Dict[Tuple[int, int], int] = {}
        # per-die recovery horizon: latest completion of any ladder work,
        # read by the offload audit to flag decisions landing mid-recovery
        self.recovery_until: List[float] = [0.0] * self.n_dies
        self.dies_read_only: List[bool] = [False] * self.n_dies
        self._die_fail_ns: Dict[int, float] = {
            int(d): float(t) for d, t in cfg.die_failures}
        self._dies_failed: set = set()
        self.stats_ = FaultStats(errors_by_die=[0] * self.n_dies)
        # attached collaborators (optional)
        self.ftl = None                # FTLModel: wear counts + retirement
        self.telemetry = None          # FlightRecorder: spans + instants

    # -- attachment ------------------------------------------------------------

    def attach_ftl(self, ftl) -> None:
        """Register the FTL whose wear counters feed the error model and
        whose machinery performs block retirement."""
        self.ftl = ftl

    # -- error model -----------------------------------------------------------

    def _u(self) -> float:
        from repro_torch.sim.machine import _hash01
        u = _hash01(self._n_draws, self.cfg.seed)
        self._n_draws += 1
        return u

    def page_rber(self, die: int, blk: int, pg: int, now: float) -> float:
        """Raw bit error rate of one physical page at time ``now``."""
        cfg = self.cfg
        rber = cfg.rber_base
        if blk >= 0 and cfg.rber_per_pe > 0.0 and self.ftl is not None:
            d = self.ftl.dies[die]
            if blk < len(d.erase_count):
                rber += cfg.rber_per_pe * d.erase_count[blk]
        if cfg.rber_retention > 0.0:
            age = now - self.prog_ns.get((die, blk, pg), 0.0)
            if age > 0.0:
                rber += cfg.rber_retention * age / cfg.retention_scale_ns
        return rber

    def _p_fail(self, rber: float) -> float:
        """Hard/soft decode failure probability at effective RBER ``rber``:
        a sharp threshold curve around the ECC correction limit."""
        if rber <= 0.0:
            return 0.0
        p = (rber / self.rel.ecc_hard_rber) ** self.rel.ecc_steepness
        return p if p < 1.0 else 1.0

    def die_dead(self, die: int, now: float) -> bool:
        t = self._die_fail_ns.get(die)
        if t is None or now < t:
            return False
        if die not in self._dies_failed:
            self._dies_failed.add(die)
            self.stats_.n_dies_failed += 1
            if self.telemetry is not None:
                self.telemetry.on_die_failure(die, t)
        return True

    def write_ok(self, die: int, now: float) -> bool:
        """Whether a host write to ``die`` can be accepted at ``now``."""
        return not (self.dies_read_only[die] or self.die_dead(die, now))

    def note_failed_write(self, die: int) -> None:
        self.stats_.n_failed_writes += 1

    def mark_read_only(self, die: int) -> None:
        """Degrade ``die`` to read-only (its physical blocks ran out)."""
        if not self.dies_read_only[die]:
            self.dies_read_only[die] = True
            self.stats_.n_read_only_dies += 1
            if self.telemetry is not None:
                self.telemetry.on_read_only(die, self.engine.now)

    @property
    def read_only(self) -> bool:
        """Whether any die has degraded to read-only mode."""
        return any(self.dies_read_only)

    # -- program/erase bookkeeping (retention clocks) --------------------------

    def on_program(self, die: int, blk: int, pg: int, t_ns: float) -> None:
        self.prog_ns[(die, blk, pg)] = t_ns

    def on_erase(self, die: int, blk: int) -> None:
        # drop every retention clock of the erased block
        prog = self.prog_ns
        stale = [k for k in prog if k[0] == die and k[1] == blk]
        for k in stale:
            del prog[k]
        # a fresh erase also clears the block's uncorrectable history
        self.uncorrectable.pop((die, blk), None)

    # -- the read-recovery ladder ----------------------------------------------

    def check_read(self, t: float, die: int, blk: int = -1,
                   pg: int = -1) -> Tuple[float, bool]:
        """Roll the error model for a page read completing at ``t``; on
        hard-decode failure, walk the recovery ladder booking real time.

        Returns ``(t_end, ok)``: the completion time including any
        recovery work, and whether the data was obtained.  ``ok=False``
        means the read is unrecoverable — the caller must surface a
        failed op.  ``blk/pg = -1`` marks reads the FTL does not map
        (NDP operand senses): they see ``rber_base`` + retention of an
        untracked page, and a lost page cannot be retired."""
        st = self.stats_
        now = self.engine.now
        if self.die_dead(die, now):
            # the die is gone: no sense possible, straight to rebuild
            st.errors_by_die[die] += 1
            return self._rebuild(t, die, blk, count_uncorrectable=False)
        rber = self.page_rber(die, blk, pg, t)
        if rber <= 0.0:
            return t, True
        st.n_reads_checked += 1
        p = self._p_fail(rber)
        if p <= 0.0:
            return t, True
        u = self._u()
        if u >= p:
            return t, True
        # hard decode failed: escalate.  The same uniform is compared to
        # each rung's shrinking failure probability (monotone ladder).
        st.n_hard_fails += 1
        st.errors_by_die[die] += 1
        rel = self.rel
        f = self.spec.flash
        dies_pool = self.fabric.dies
        chan_pool = self.fabric.channels
        chan = die % self.n_channels
        t0 = t
        eff = rber
        for k in range(rel.max_read_retries):
            eff *= rel.retry_rber_factor
            t = dies_pool.acquire_end(
                t, f.t_read_ns + rel.read_retry_ns * (k + 1), unit=die)
            t = chan_pool.acquire_end(t, self._chan_xfer_ns, unit=chan)
            st.n_retry_reads += 1
            if u >= self._p_fail(eff):
                st.n_retry_recovered += 1
                self._note_recovery(die, "read-retry", t0, t)
                return t, True
        # soft decode on the controller ECC engines
        t = self.ecc.acquire_end(t, rel.soft_decode_ns)
        st.n_soft_decodes += 1
        if u >= self._p_fail(rber * rel.soft_rber_factor):
            st.n_soft_recovered += 1
            self._note_recovery(die, "soft-decode", t0, t)
            return t, True
        # uncorrectable: parity rebuild or a failed op
        st.n_uncorrectable += 1
        self._note_recovery(die, "uncorrectable", t0, t)
        return self._rebuild(t, die, blk)

    def _note_recovery(self, die: int, stage: str, t0: float,
                       t1: float) -> None:
        if t1 > self.recovery_until[die]:
            self.recovery_until[die] = t1
        if self.telemetry is not None:
            self.telemetry.on_recovery(die, stage, t0, t1)

    def _rebuild(self, t: float, die: int, blk: int,
                 count_uncorrectable: bool = True) -> Tuple[float, bool]:
        """Superpage-parity reconstruction: read the stripe's sibling
        dies (one per channel, in parallel) and XOR on the ECC engines.
        Falls through to a failed op when parity is off or a sibling die
        is dead.  Feeds the block's retirement counter either way."""
        st = self.stats_
        now = self.engine.now
        t0 = t
        ok = False
        if self.cfg.parity:
            group = die // self.n_channels
            siblings = [group * self.n_channels + c
                        for c in range(self.n_channels)]
            siblings = [s for s in siblings if s != die and s < self.n_dies]
            if siblings and not any(self.die_dead(s, now) for s in siblings):
                f = self.spec.flash
                dies_pool = self.fabric.dies
                chan_pool = self.fabric.channels
                end = t
                for s in siblings:
                    e = dies_pool.acquire_end(t, f.t_read_ns, unit=s)
                    e = chan_pool.acquire_end(e, self._chan_xfer_ns,
                                              unit=s % self.n_channels)
                    if e > end:
                        end = e
                t = self.ecc.acquire_end(
                    end, self.rel.rebuild_xor_ns_per_page * len(siblings))
                st.n_rebuilds += 1
                st.n_rebuild_reads += len(siblings)
                ok = True
        if not ok:
            st.n_failed_reads += 1
        self._note_recovery(die, "rebuild" if ok else "read-failed", t0, t)
        if count_uncorrectable and blk >= 0:
            t = self._note_uncorrectable(die, blk, t)
        return t, ok

    def _note_uncorrectable(self, die: int, blk: int, t: float) -> float:
        """Count an uncorrectable read against its block; retire the
        block through the FTL once ``retire_after`` is reached."""
        key = (die, blk)
        n = self.uncorrectable.get(key, 0) + 1
        self.uncorrectable[key] = n
        if (n >= self.cfg.retire_after and self.ftl is not None):
            t = self.ftl.retire_block(die, blk, t)
        return t

    # -- host op timeout/retry knobs (read by the host I/O model) --------------

    def op_deadline_exceeded(self, latency_ns: float) -> bool:
        to = self.cfg.op_timeout_ns
        return to is not None and latency_ns > to

    def op_backoff_ns(self, attempt: int) -> float:
        """Exponential backoff before re-issuing a timed-out op."""
        return self.cfg.op_retry_backoff_ns * (2.0 ** attempt)

    # -- results ---------------------------------------------------------------

    def stats(self) -> FaultStats:
        return dataclasses.replace(
            self.stats_, errors_by_die=list(self.stats_.errors_by_die))
