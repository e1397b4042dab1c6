"""Flash translation layer with event-driven garbage collection.

The seed simulator models an idealized drive: host writes land on hashed
dies with no logical-to-physical mapping, no over-provisioning and no
garbage collection, so firmware background activity — the first-order
obstacle to in-storage processing named by the on-disk-processing
literature — is invisible.  This module adds a page-mapping FTL in the
style of wiscsee/FTL-SIM, scaled down geometrically so event-driven
simulation stays tractable (the real Table-2 geometry lives untouched in
:class:`~repro_torch.hw.ssd_spec.FlashSpec`).

Event flow (mirrors the discipline of :mod:`repro_torch.sim.tenancy`):

* A host write arrives at :class:`~repro_torch.sim.tenancy._HostIOModel`, which
  hashes its LBA to a die and calls :meth:`FTLModel.host_write`.  The FTL
  allocates the next page of that die's *active block* (die-local append
  point), records the L2P mapping, and invalidates the page the LBA
  previously occupied.  The physical program the host model books on the
  die/channel pools is unchanged — with GC disabled the simulation is
  bit-identical to running without an FTL at all (the equivalence law in
  ``tests/test_ftl.py``).
* After each write the host model calls :meth:`FTLModel.maybe_start_gc`.
  If the die's free-page fraction has fallen below the low watermark and
  no collector is active on that die, an :data:`EventKind.GC` event is
  scheduled *now* — GC is one more tenant on the shared
  :class:`~repro_torch.sim.events.EventEngine`.
* The GC handler picks a victim block via the configured
  :class:`VictimPolicy`, and for every valid page books a page read, a
  channel round-trip (page buffer -> controller -> destination page
  buffer: the controller re-encodes ECC, so no on-die copyback) and an
  SLC program on the *same* die/channel
  :class:`~repro_torch.sim.servers.ServerPool`\\ s that NDP dispatch and host
  I/O acquire; then it books the block erase.  The lazy-acquire FIFO
  discipline makes every host request or NDP operand fetch behind the
  collector wait — write amplification directly inflates per-tenant
  slowdown and host-I/O tail latency.
* At the end of the booked cycle the handler re-schedules itself: the
  collector keeps reclaiming blocks until the free fraction recovers to
  the high watermark (or no victim with a free page remains), then sleeps
  until the next watermark crossing.

GC policy suite (each knob defaults to the legacy bit-identical behavior):

* **Victim selection** is a strategy object (:data:`VICTIM_POLICIES`):
  ``greedy`` (minimum valid pages, the default), ``cost_benefit`` (the
  classic age-weighted ``(1-u)/2u`` score of Rosenblum's LFS cleaner,
  paired with its age-sorting rewrite side: still-hot survivors rejoin
  the hot append point instead of re-polluting cold compaction blocks —
  scoring alone measures within noise of greedy), and ``wear_aware``
  (valid-count choice penalized by the block's erase count above the die
  minimum, flattening the
  :attr:`~repro_torch.sim.stats.FTLStats.erase_counts` wear histogram).
* **Hot/cold separation** (``hot_cold=True``) splits the host append
  point in two: LBAs whose lifetime write count reaches
  ``hot_threshold`` land on the HOT append point, the rest on COLD, so
  hot pages die together and Zipf-skewed streams produce nearly-empty
  victims (lower write amplification).
* **GC suspend/throttle** (``gc_suspend=True``) replaces the monolithic
  per-victim booking with one event per page copy: the collector yields
  the die/channel pools between copies (host requests arriving mid-cycle
  book ahead of later copies instead of FIFO-queueing behind the whole
  victim), and while the host has ``gc_suspend_qd`` or more requests
  outstanding it backs off ``gc_backoff_ns`` instead of booking at all —
  latency-critical host reads stop waiting behind a full victim cycle.
* ``gc_reserve_blocks=1`` holds one free block per die back from host
  append-point allocation so a mid-collection copy can never be starved
  into silent overflow growth (``0`` keeps the legacy semantics where
  the host may drain the pool and the collector overflow-grows).

Mapping state (L2P/valid bitmaps) updates at event-handler time while the
latencies occupy the pools — a simplification shared with FTL-SIM: the
map is sequentially consistent in event order.

With ``gc_enabled=False`` the block pool grows without bound (infinite
over-provisioning): allocation never blocks, nothing is ever erased, and
write amplification is exactly 1.0.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.hw.ssd_spec import DEFAULT_SSD, SSDSpec
from repro_torch.sim.events import EventEngine, EventKind
from repro_torch.sim.servers import Fabric
from repro_torch.sim.stats import FTLStats

#: physical page address: (die, block-within-die, page-within-block)
PPN = Tuple[int, int, int]


class OutOfPhysicalBlocks(RuntimeError):
    """A die's free block pool is exhausted and overflow growth is
    forbidden (fault injection active): the drive must degrade to
    read-only instead of silently growing capacity."""


@dataclasses.dataclass(frozen=True)
class FTLConfig:
    """Simulation-scale FTL knobs.

    ``blocks_per_die`` / ``pages_per_block`` set the *scaled* geometry the
    mapping operates on; ``op_ratio``, the watermarks and the policy
    parameters default to the firmware values in
    :class:`~repro_torch.hw.ssd_spec.FTLSpec`.  ``prefill`` writes that fraction
    of the logical space through the allocator at t=0 (state only, no time
    booked) — the standard preconditioning step without which a fresh
    drive never garbage collects.

    The GC policy suite (``victim_policy`` / ``hot_cold`` /
    ``gc_suspend`` / ``gc_reserve_blocks``) defaults to the legacy
    collector: ``greedy`` victims, one host append point, monolithic
    per-victim booking, no reserve — bit-identical to the pre-policy FTL
    (the golden digests in ``tests/test_golden_equivalence.py``)."""

    blocks_per_die: int = 16
    pages_per_block: int = 32
    op_ratio: Optional[float] = None          # default: spec.ftl.op_ratio
    gc_low_watermark: Optional[float] = None
    gc_high_watermark: Optional[float] = None
    gc_enabled: bool = True
    prefill: float = 0.0
    # -- GC policy suite ------------------------------------------------------
    victim_policy: str = "greedy"             # greedy|cost_benefit|wear_aware
    hot_cold: bool = False                    # two host append points by heat
    hot_threshold: Optional[int] = None       # default: spec.ftl.hot_threshold
    wear_alpha: Optional[float] = None        # default: spec.ftl.wear_alpha
    gc_suspend: bool = False                  # per-page-copy yielding/backoff
    gc_suspend_qd: Optional[int] = None       # default: spec.ftl.gc_suspend_qd
    gc_backoff_ns: Optional[float] = None     # default: spec.ftl.gc_backoff_ns
    gc_reserve_blocks: int = 0                # free blocks held back for GC
    # -- wear preconditioning -------------------------------------------------
    # state-only Zipf overwrite churn applied at model build (after
    # prefill): the drive starts the timed run with the wear histogram
    # its own victim policy produces after ``prewear_writes`` writes —
    # the substrate for wear-dependent error injection (repro_torch.sim.faults)
    prewear_writes: int = 0
    prewear_theta: float = 0.99

    def __post_init__(self) -> None:
        if self.victim_policy not in VICTIM_POLICIES:
            raise ValueError(
                f"unknown victim_policy {self.victim_policy!r}; "
                f"choose from {sorted(VICTIM_POLICIES)}")
        if self.gc_reserve_blocks < 0:
            raise ValueError("gc_reserve_blocks must be >= 0")
        if self.prewear_writes < 0:
            raise ValueError("prewear_writes must be >= 0")
        if self.prewear_theta <= 0.0:
            raise ValueError("prewear_theta must be > 0")
        if self.gc_reserve_blocks >= self.blocks_per_die:
            raise ValueError("gc_reserve_blocks must leave host blocks")
        if self.hot_threshold is not None and self.hot_threshold < 2:
            # threshold 1 routes every write hot: no cold stream ever
            # allocates, so the prefill-era HOST append point would be
            # stranded partially filled forever (never a GC victim)
            raise ValueError("hot_threshold must be >= 2 (1 means every "
                             "write is hot: no hot/cold split at all)")
        # qd 0 is always-suspended (0 >= 0 even with no host attached) and
        # a zero backoff re-queues at a frozen timestamp: both livelock
        # the suspend-mode collector, so the engine would never drain
        if self.gc_suspend_qd is not None and self.gc_suspend_qd < 1:
            raise ValueError("gc_suspend_qd must be >= 1")
        if self.gc_backoff_ns is not None and self.gc_backoff_ns <= 0.0:
            raise ValueError("gc_backoff_ns must be > 0")

    def physical_pages(self, spec: SSDSpec = DEFAULT_SSD) -> int:
        return (spec.flash.total_dies * self.blocks_per_die
                * self.pages_per_block)

    def logical_pages(self, spec: SSDSpec = DEFAULT_SSD) -> int:
        """Advertised LBA space: physical capacity net of over-provisioning."""
        op = self.op_ratio if self.op_ratio is not None else spec.ftl.op_ratio
        return max(1, int(self.physical_pages(spec) / (1.0 + op)))


class _DieFTL:
    """One die's block pool: free list, append points, valid accounting."""

    FREE, HOST, GC, USED = "free", "host", "gc", "used"
    HOST_HOT, HOST_COLD = "host_hot", "host_cold"   # hot/cold append points
    RETIRED = "retired"               # bad block: out of the pool forever

    def __init__(self, blocks: int, pages_per_block: int):
        self.ppb = pages_per_block
        self.n_blocks = blocks
        self.state: List[str] = [self.FREE] * blocks
        # FIFO free list; deque so append-point opens are O(1), preserving
        # the exact pop order of the original list.pop(0)
        self.free: Deque[int] = deque(range(blocks))
        self.valid_count: List[int] = [0] * blocks
        self.valid: List[List[bool]] = [[False] * pages_per_block
                                        for _ in range(blocks)]
        self.page_lpn: List[List[int]] = [[-1] * pages_per_block
                                          for _ in range(blocks)]
        self.erase_count: List[int] = [0] * blocks
        # logical write clock (per-die allocation sequence) + per-block
        # last-write stamp: the "age" the cost-benefit score weighs by
        self.write_seq = 0
        self.last_write_seq: List[int] = [0] * blocks
        # (block, next-page) append points; None until first allocation
        self.active: Dict[str, Optional[Tuple[int, int]]] = {
            self.HOST: None, self.GC: None,
            self.HOST_HOT: None, self.HOST_COLD: None}
        self.grown_blocks = 0          # overflow allocations (infinite OP)
        self.gc_grown_blocks = 0       # of which: GC append-point fallbacks
        self.retired_blocks = 0        # bad blocks retired (fault injection)
        # fault injection forbids the infinite-OP escape hatch: an empty
        # pool raises OutOfPhysicalBlocks instead of growing
        self.no_grow = False
        self.gc_running = False
        # free blocks held back from host append points (collector reserve)
        self.reserve = 0
        # suspend-mode collection cursor (victim being copied page by page)
        self.gc_victim: Optional[int] = None
        self.gc_cursor = 0

    # -- capacity -------------------------------------------------------------

    @property
    def physical_pages(self) -> int:
        return self.n_blocks * self.ppb

    def free_pages(self) -> int:
        n = len(self.free) * self.ppb
        for ap in self.active.values():
            if ap is not None:
                n += self.ppb - ap[1]
        return n

    def free_fraction(self) -> float:
        """Host-available free fraction: the collector's reserved blocks
        are not writable capacity, so the GC watermarks must not count
        them — otherwise a reserve the size of the low watermark would
        keep the collector asleep forever while the host overflow-grows.
        Identical to the raw free-page fraction when ``reserve == 0``."""
        return ((self.free_pages() - self.reserve * self.ppb)
                / self.physical_pages)

    # -- allocation -----------------------------------------------------------

    def _grow(self) -> int:
        """Append a fresh block (infinite-OP / saturation fallback)."""
        b = len(self.state)
        self.state.append(self.FREE)
        self.valid_count.append(0)
        self.valid.append([False] * self.ppb)
        self.page_lpn.append([-1] * self.ppb)
        self.erase_count.append(0)
        self.last_write_seq.append(0)
        self.free.append(b)
        self.grown_blocks += 1
        return b

    def _take_free_block(self, kind: str, gc: bool) -> int:
        """Pop the next free block for a ``kind`` append point.

        With ``reserve > 0`` the last ``reserve`` free blocks are the
        collector's: a host append point overflow-grows instead of
        draining them, so a mid-collection copy is never starved by host
        pressure — the silent-growth-during-GC bug the reserve exists to
        close.  ``gc`` marks allocations made *by the collector* (the
        cold GC stream and a segregating cleaner's hot-survivor stream
        alike), which may use the reserve; they can still find the pool
        empty when preconditioning exhausted the die before any reserve
        could be honored (e.g. a hot die prefilled to 100%), and that
        fallback growth is counted separately in ``gc_grown_blocks`` so
        tests can assert it stays zero on sanely-provisioned
        reserve-enabled runs.  ``reserve == 0`` keeps the legacy
        first-come semantics bit-identically."""
        free = self.free
        if gc:
            if free:
                return free.popleft()
            if self.no_grow:
                raise OutOfPhysicalBlocks("collector starved: no free block")
            self.gc_grown_blocks += 1
            self._grow()
            return free.pop()          # the block _grow just appended
        if len(free) > self.reserve:
            return free.popleft()
        if self.no_grow:
            # retirement drained the pool down to (or past) the reserve:
            # the die degrades to read-only rather than silently growing
            raise OutOfPhysicalBlocks("host append point starved: "
                                      f"{len(free)} free <= reserve "
                                      f"{self.reserve}")
        # host overflow growth: the infinite-OP / saturation escape valve —
        # and, with a reserve, what happens *instead of* stealing the
        # collector's block mid-collection
        self._grow()
        return free.pop()              # take the grown block, not the reserve

    def alloc(self, lpn: int, kind: str, gc: bool = False) -> Tuple[int, int]:
        """Claim the next page of the ``kind`` append point for ``lpn``.

        ``gc`` marks a collector-side allocation (GC compaction or
        hot-survivor routing), which may draw on the block reserve."""
        ap = self.active[kind]
        if ap is None:
            if kind == self.HOST_COLD and self.active[self.HOST] is not None:
                # adopt the prefill-era single append point as the cold
                # stream (heat counters start at zero, so preconditioned
                # data is cold by definition)
                ap = self.active[self.HOST]
                self.active[self.HOST] = None
                self.state[ap[0]] = kind
            else:
                blk = self._take_free_block(kind, gc)
                self.state[blk] = kind
                ap = (blk, 0)
        blk, pg = ap
        self.valid[blk][pg] = True
        self.page_lpn[blk][pg] = lpn
        self.valid_count[blk] += 1
        self.write_seq += 1
        self.last_write_seq[blk] = self.write_seq
        if pg + 1 == self.ppb:
            self.state[blk] = self.USED     # full: eligible GC victim
            self.active[kind] = None
        else:
            self.active[kind] = (blk, pg + 1)
        return blk, pg

    def invalidate(self, blk: int, pg: int) -> None:
        assert self.valid[blk][pg], "double invalidation"
        self.valid[blk][pg] = False
        self.valid_count[blk] -= 1

    # -- garbage collection ---------------------------------------------------

    def pick_victim(self) -> Optional[int]:
        """Greedy policy: the full block with the fewest valid pages."""
        best, best_valid = None, None
        for b, st in enumerate(self.state):
            if st != self.USED:
                continue
            if best_valid is None or self.valid_count[b] < best_valid:
                best, best_valid = b, self.valid_count[b]
        return best

    def erase(self, blk: int) -> None:
        assert self.state[blk] != self.RETIRED, "erasing a retired block"
        assert self.valid_count[blk] == 0, "erasing block with valid pages"
        self.valid[blk] = [False] * self.ppb
        self.page_lpn[blk] = [-1] * self.ppb
        self.erase_count[blk] += 1
        self.state[blk] = self.FREE
        self.free.append(blk)

    def clone(self) -> "_DieFTL":
        """Deep-enough copy for the prefill snapshot cache."""
        c = _DieFTL.__new__(_DieFTL)
        c.ppb = self.ppb
        c.n_blocks = self.n_blocks
        c.state = list(self.state)
        c.free = deque(self.free)
        c.valid_count = list(self.valid_count)
        c.valid = [list(v) for v in self.valid]
        c.page_lpn = [list(p) for p in self.page_lpn]
        c.erase_count = list(self.erase_count)
        c.write_seq = self.write_seq
        c.last_write_seq = list(self.last_write_seq)
        c.active = dict(self.active)
        c.grown_blocks = self.grown_blocks
        c.gc_grown_blocks = self.gc_grown_blocks
        c.retired_blocks = self.retired_blocks
        c.no_grow = self.no_grow
        c.gc_running = self.gc_running
        c.reserve = self.reserve
        c.gc_victim = self.gc_victim
        c.gc_cursor = self.gc_cursor
        return c


# -- victim-selection strategies -----------------------------------------------

class VictimPolicy:
    """Strategy object: which full block a die's collector reclaims next.

    ``select`` returns a block index among the die's ``USED`` (full)
    blocks, or ``None``/a fully-valid block when nothing is reclaimable —
    the caller treats both as "go to sleep".  A policy must therefore
    never *prefer* a fully-valid block while a reclaimable one exists
    (the collector would sleep spuriously and the die would silently
    overflow-grow); score-based policies skip fully-valid candidates
    outright, while greedy's minimum-valid choice satisfies the contract
    by construction.

    ``segregates_survivors`` is the cleaner's rewrite side: policies that
    set it route still-hot survivor pages back to the hot append point
    instead of burying them in the cold compaction blocks (the
    age-sorting half of Rosenblum's cost-benefit cleaner — without it,
    victim *scoring* alone cannot beat greedy, because every copied hot
    page re-pollutes a cold block and must be copied again)."""

    name = "base"
    segregates_survivors = False

    def select(self, die: _DieFTL) -> Optional[int]:
        raise NotImplementedError


class GreedyVictim(VictimPolicy):
    """Minimum valid pages (lowest block index on ties) — the legacy
    collector; cheapest copies *right now*, blind to data temperature."""

    name = "greedy"

    def select(self, die: _DieFTL) -> Optional[int]:
        return die.pick_victim()


class CostBenefitVictim(VictimPolicy):
    """The classic LFS/cost-benefit cleaner: maximize ``(1-u)/(2u) * age``.

    ``u`` is the block's valid fraction (copying cost: ``2u`` reads+writes
    per ``1-u`` page reclaimed) and ``age`` the time since the block last
    absorbed a write (measured on the die's allocation clock, so it is
    simulation-deterministic).  Old, stable blocks win over hot blocks of
    equal occupancy — the hot block's pages are about to die on their own,
    so copying them is wasted amplification.  Ties break toward fewer
    valid pages, then the lower block index (greedy's order).

    The policy also enables the cleaner's *age-sorting* half
    (``segregates_survivors``): survivor pages whose LBA is still hot
    rejoin the hot append point instead of being compacted into the cold
    GC blocks.  Rosenblum's measurements — reproduced by the
    ``gc_policies`` sweep — show this is where the cost-benefit cleaner's
    write-amplification win over greedy actually comes from: scoring
    alone re-copies every hot survivor out of a polluted cold block again
    and again, and empirically lands within noise of greedy."""

    name = "cost_benefit"
    segregates_survivors = True

    def select(self, die: _DieFTL) -> Optional[int]:
        best, best_key = None, None
        now = die.write_seq
        ppb = die.ppb
        for b, st in enumerate(die.state):
            if st != die.USED:
                continue
            v = die.valid_count[b]
            if v >= ppb:
                continue                # fully valid: not reclaimable
            age = now - die.last_write_seq[b]
            if v == 0:
                score = float("inf")    # a free win: nothing to copy
            else:
                u = v / ppb
                score = (1.0 - u) / (2.0 * u) * age
            key = (-score, v, b)
            if best_key is None or key < best_key:
                best, best_key = b, key
        return best


class WearAwareVictim(VictimPolicy):
    """Greedy choice penalized by wear: minimize ``valid + alpha * (erase -
    die_min_erase)``.

    Blocks already worn above the die's least-worn block look ``alpha``
    valid pages more expensive per extra erase, so the collector rotates
    reclamation across the pool and the
    :attr:`~repro_torch.sim.stats.FTLStats.erase_counts` histogram flattens
    instead of cycling the same physically-hot blocks (static wear
    leveling folded into victim choice)."""

    name = "wear_aware"

    def __init__(self, alpha: float):
        self.alpha = alpha

    def select(self, die: _DieFTL) -> Optional[int]:
        erase = die.erase_count
        min_erase = min(erase)
        alpha = self.alpha
        ppb = die.ppb
        best, best_key = None, None
        for b, st in enumerate(die.state):
            if st != die.USED:
                continue
            v = die.valid_count[b]
            if v >= ppb:
                continue                # fully valid: not reclaimable
            key = (v + alpha * (erase[b] - min_erase), b)
            if best_key is None or key < best_key:
                best, best_key = b, key
        return best


#: victim_policy name -> factory(cfg_resolved_wear_alpha) registry
VICTIM_POLICIES: Dict[str, Callable[[float], VictimPolicy]] = {
    "greedy": lambda alpha: GreedyVictim(),
    "cost_benefit": lambda alpha: CostBenefitVictim(),
    "wear_aware": lambda alpha: WearAwareVictim(alpha),
}


def make_victim_policy(name: str, wear_alpha: float) -> VictimPolicy:
    """Instantiate a registered victim-selection strategy by name."""
    try:
        return VICTIM_POLICIES[name](wear_alpha)
    except KeyError:
        raise ValueError(f"unknown victim_policy {name!r}; "
                         f"choose from {sorted(VICTIM_POLICIES)}") from None


#: memoized post-prefill (dies, l2p) snapshots — preconditioning a drive is
#: a pure function of the geometry + LBA->die hash, and sweeps precondition
#: the same drive dozens of times (e.g. every GC-off/GC-on pair).  Policy
#: knobs are *not* part of the key: prefill always writes through the
#: single legacy HOST append point (heat counters start at zero, so the
#: preconditioned data is cold), making the snapshot policy-independent.
_PREFILL_CACHE: Dict[tuple, Tuple[List["_DieFTL"], Dict[int, PPN]]] = {}
_PREFILL_CACHE_MAX = 8


class FTLModel:
    """Binds an :class:`FTLConfig` to one fabric + event engine.

    ``die_of`` is the LBA->die hash the host I/O model uses for placement —
    passing it in keeps the FTL and the stream bit-consistent (the same
    LBA always lands on the same die, which is what makes the GC-disabled
    run identical to the no-FTL run).  ``prefill_key`` optionally
    identifies that hash (e.g. the I/O seed) so the preconditioning
    snapshot can be memoized across runs; ``None`` disables caching."""

    def __init__(self, cfg: FTLConfig, spec: SSDSpec, fabric: Fabric,
                 engine: EventEngine, die_of: Callable[[int], int],
                 prefill_key: Optional[tuple] = None):
        self.cfg = cfg
        self.spec = spec
        self.fabric = fabric
        self.engine = engine
        self.die_of = die_of
        f = spec.flash
        self.n_dies = f.total_dies
        self.n_logical = cfg.logical_pages(spec)
        self.low_wm = (cfg.gc_low_watermark
                       if cfg.gc_low_watermark is not None
                       else spec.ftl.gc_low_watermark)
        self.high_wm = (cfg.gc_high_watermark
                        if cfg.gc_high_watermark is not None
                        else spec.ftl.gc_high_watermark)
        self.hot_threshold = (cfg.hot_threshold
                              if cfg.hot_threshold is not None
                              else spec.ftl.hot_threshold)
        if cfg.hot_cold and self.hot_threshold < 2:
            raise ValueError("hot_threshold must be >= 2 (see FTLConfig)")
        wear_alpha = (cfg.wear_alpha if cfg.wear_alpha is not None
                      else spec.ftl.wear_alpha)
        self.suspend_qd = (cfg.gc_suspend_qd
                           if cfg.gc_suspend_qd is not None
                           else spec.ftl.gc_suspend_qd)
        self.backoff_ns = (cfg.gc_backoff_ns
                           if cfg.gc_backoff_ns is not None
                           else spec.ftl.gc_backoff_ns)
        if cfg.gc_suspend and (self.suspend_qd < 1 or self.backoff_ns <= 0):
            raise ValueError("gc_suspend needs gc_suspend_qd >= 1 and "
                             "gc_backoff_ns > 0 (else the throttled "
                             "collector livelocks; see FTLConfig)")
        self.victim = make_victim_policy(cfg.victim_policy, wear_alpha)
        # cleaner-side survivor segregation (the cost-benefit cleaner's
        # age-sorting half): hot survivors rejoin the hot append point
        self._route_survivors = self.victim.segregates_survivors
        self._gc_handler = (self._on_gc_page if cfg.gc_suspend
                            else self._on_gc)
        self.dies = [_DieFTL(cfg.blocks_per_die, cfg.pages_per_block)
                     for _ in range(self.n_dies)]
        self.l2p: Dict[int, PPN] = {}
        # per-LBA lifetime write counts (runtime heat; prefill is cold) —
        # tracked unconditionally: both the hot/cold host split and the
        # cost-benefit cleaner's survivor routing read it
        self.heat: Dict[int, int] = {}
        # the host I/O model attaches itself so the suspend throttle can
        # probe the outstanding-command depth (None: throttle never fires)
        self._host_io = None
        # optional flight recorder (repro_torch.sim.telemetry): GC cycle/copy
        # spans and suspend instants; pure observer, never books time
        self.telemetry = None
        # optional fault model (repro_torch.sim.faults): wear-dependent read
        # errors, bad-block retirement, read-only degradation
        self.faults = None

        # accounting
        self.host_pages_written = 0
        self.hot_pages_written = 0
        self.cold_pages_written = 0
        self.gc_pages_copied = 0
        self.blocks_erased = 0
        self.gc_invocations = 0
        self.pages_relocated = 0       # survivor pages moved by retirement
        self.gc_suspensions = 0
        self.gc_active_dies = 0
        self.gc_energy_nj = 0.0
        self.host_during_gc_ns: List[float] = []
        # latest completion the collector booked on any pool — GC copy and
        # erase work regularly outlives the last host request / session,
        # and a makespan that stops at the last *host* completion would
        # silently exclude that tail (see ServingResult/MixResult)
        self.last_booked_ns = 0.0

        n_prefill = int(cfg.prefill * self.n_logical)
        if n_prefill:
            key = None
            if prefill_key is not None:
                key = (prefill_key, cfg.blocks_per_die, cfg.pages_per_block,
                       self.n_dies, n_prefill)
            hit = _PREFILL_CACHE.get(key) if key is not None else None
            if hit is not None:
                dies_snap, l2p_snap = hit
                self.dies = [d.clone() for d in dies_snap]
                self.l2p = dict(l2p_snap)
            else:
                for lpn in range(n_prefill):
                    self._map_write(lpn, die_of(lpn), _DieFTL.HOST)
                if key is not None:
                    if len(_PREFILL_CACHE) >= _PREFILL_CACHE_MAX:
                        _PREFILL_CACHE.pop(next(iter(_PREFILL_CACHE)))
                    _PREFILL_CACHE[key] = ([d.clone() for d in self.dies],
                                           dict(self.l2p))
        if cfg.prewear_writes:
            self._apply_prewear(prefill_key)
        # the reserve is a per-run policy, not prefill state: apply after
        # any snapshot restore (a cached snapshot may have been taken
        # under a different reserve/GC setting)
        reserve = cfg.gc_reserve_blocks if cfg.gc_enabled else 0
        for d in self.dies:
            d.reserve = reserve

    def _apply_prewear(self, prefill_key: Optional[tuple]) -> None:
        """Build-time wear preconditioning: churn a *private* clone of
        this drive with a seeded Zipf overwrite stream and adopt the
        resulting state (mapping, heat, and — the point — the per-block
        erase histogram the run's own victim policy produces).

        State-only by construction: the churn runs on a throwaway
        fabric/engine, so nothing is booked on the live pools and the
        timed run is unperturbed.  Runtime accounting (WA, erase and GC
        counters) starts at zero — prewear is drive *state*, like
        ``prefill``.  Memoized alongside the prefill snapshots: the
        outcome is a pure function of (LBA->die hash, full FTLConfig)."""
        from repro_torch.sim.tenancy import _zipf_cdf
        cfg = self.cfg
        key = None
        if prefill_key is not None:
            key = ("prewear", prefill_key, cfg)
        hit = _PREFILL_CACHE.get(key) if key is not None else None
        if hit is not None:
            dies_snap, l2p_snap, heat_snap = hit
            self.dies = [d.clone() for d in dies_snap]
            self.l2p = dict(l2p_snap)
            self.heat = dict(heat_snap)
            return
        from repro_torch.sim.machine import _hash01
        sub = dataclasses.replace(cfg, prewear_writes=0, prefill=0.0)
        tmp = FTLModel(sub, self.spec, Fabric(self.spec), EventEngine(),
                       self.die_of)
        tmp.dies = self.dies               # continue from the prefill state
        tmp.l2p = self.l2p
        reserve = cfg.gc_reserve_blocks if cfg.gc_enabled else 0
        for d in tmp.dies:
            d.reserve = reserve
        space = tmp.n_logical
        cdf = _zipf_cdf(space, cfg.prewear_theta)
        lpn_seed = 0x9EA7                  # fixed: prewear replays exactly
        for i in range(cfg.prewear_writes):
            u = min(0.999999, max(0.0, _hash01(i, lpn_seed)))
            lpn = min(space - 1, bisect.bisect_left(cdf, u * cdf[-1]))
            die = tmp.die_of(lpn)
            tmp.host_write(lpn, die)
            tmp.maybe_start_gc(die)
            tmp.engine.run()
        tmp.check_invariants()
        self.dies = tmp.dies
        self.l2p = tmp.l2p
        self.heat = tmp.heat
        if key is not None:
            if len(_PREFILL_CACHE) >= _PREFILL_CACHE_MAX:
                _PREFILL_CACHE.pop(next(iter(_PREFILL_CACHE)))
            _PREFILL_CACHE[key] = ([d.clone() for d in self.dies],
                                   dict(self.l2p), dict(self.heat))

    # -- host I/O attachment ---------------------------------------------------

    def attach_host(self, host_io) -> None:
        """Register the host I/O model whose queue depth throttles GC."""
        self._host_io = host_io

    def attach_faults(self, fm) -> None:
        """Register a :class:`~repro_torch.sim.faults.FaultModel`: its wear/
        retention error model gates every flash read, and uncorrectable
        reads feed block retirement through this FTL.

        Retirement permanently drains free blocks, so a GC-enabled run
        *must* hold a collector reserve — without one, a retirement that
        lands while the host has drained the pool would underflow the
        free list mid-collection.  Rejected loudly here rather than
        failing as a deque underflow deep inside a GC cycle."""
        if self.cfg.gc_enabled and self.cfg.gc_reserve_blocks < 1:
            raise ValueError(
                "fault injection on a GC-enabled FTL requires "
                "gc_reserve_blocks >= 1 (got "
                f"{self.cfg.gc_reserve_blocks}): block retirement drains "
                "the per-die free pool, and without a collector reserve "
                "the free list underflows mid-collection")
        self.faults = fm
        fm.attach_ftl(self)
        # growth stays allowed until a die actually retires a block (see
        # retire_block): an error-free faulted run keeps the legacy
        # overflow-valve dynamics bit-for-bit, and only a drive that is
        # genuinely losing blocks trades the infinite-OP escape hatch
        # for read-only degradation

    def _host_qd(self) -> int:
        h = self._host_io
        if h is None:
            return 0
        return h.outstanding + len(h.pending)   # in-flight + NVMe-QD-deferred

    # -- mapping --------------------------------------------------------------

    def _map_write(self, lpn: int, die: int, kind: str,
                   gc: bool = False) -> PPN:
        """Allocate a physical page for ``lpn`` on ``die`` and remap.

        Allocation happens *before* the old mapping is invalidated (the
        two touch disjoint state) so an :class:`OutOfPhysicalBlocks` from
        a fault-degraded die leaves the mapping untouched."""
        blk, pg = self.dies[die].alloc(lpn, kind, gc)
        old = self.l2p.get(lpn)
        if old is not None:
            self.dies[old[0]].invalidate(old[1], old[2])
        ppn = (die, blk, pg)
        self.l2p[lpn] = ppn
        if self.faults is not None:
            self.faults.on_program(die, blk, pg, self.engine.now)
        return ppn

    def host_write(self, lpn: int, die: int) -> PPN:
        """One host page write through the mapping (caller books the time).

        Raises :class:`OutOfPhysicalBlocks` when fault injection has
        drained the die's pool — the caller surfaces a failed write and
        the die degrades to read-only.  Counters only advance on
        success."""
        heat = self.heat
        n = heat.get(lpn, 0) + 1
        heat[lpn] = n
        kind = _DieFTL.HOST
        if self.cfg.hot_cold:
            if n >= self.hot_threshold:
                kind = _DieFTL.HOST_HOT
            else:
                kind = _DieFTL.HOST_COLD
        ppn = self._map_write(lpn, die, kind)
        self.host_pages_written += 1
        if kind == _DieFTL.HOST_HOT:
            self.hot_pages_written += 1
        elif kind == _DieFTL.HOST_COLD:
            self.cold_pages_written += 1
        return ppn

    def _survivor_kind(self, lpn: int) -> str:
        """Where a GC-copied survivor lands: cold compaction by default;
        under a segregating cleaner, still-hot LBAs rejoin the hot
        append point so they do not re-pollute cold blocks."""
        if (self._route_survivors
                and self.heat.get(lpn, 0) >= self.hot_threshold):
            return _DieFTL.HOST_HOT
        return _DieFTL.GC

    def read_die(self, lpn: int, default: int) -> int:
        """Die physically holding ``lpn`` (``default`` when never written)."""
        ppn = self.l2p.get(lpn)
        return ppn[0] if ppn is not None else default

    def read_ppn(self, lpn: int) -> Optional[PPN]:
        """Full physical address of ``lpn`` (None when never written)."""
        return self.l2p.get(lpn)

    # -- bad-block retirement (fault injection) --------------------------------

    def retire_block(self, die: int, blk: int, t: float) -> float:
        """Retire a bad block: relocate its surviving valid pages through
        the GC machinery (real read/transfer/program bookings starting at
        ``t``) and remove the block from the die's pool forever.

        Returns the completion time of the relocation work.  When the
        die cannot absorb the survivors (:class:`OutOfPhysicalBlocks`)
        the die degrades to read-only and the block stays in place — its
        pages remain readable through the parity-rebuild path."""
        d = self.dies[die]
        if blk >= len(d.state) or d.state[blk] == _DieFTL.RETIRED:
            return t
        fm = self.faults
        if fm is not None and fm.die_dead(die, self.engine.now):
            return t                   # the whole die is already gone
        # the die is now genuinely losing capacity: close the infinite-OP
        # overflow valve so further exhaustion surfaces as read-only
        # degradation instead of silent growth
        d.no_grow = True
        f = self.spec.flash
        nb = self.spec.page_size
        chan = die % f.channels
        xfer = 2.0 * (f.t_dma_ns + nb * f.channel_ns_per_byte)
        dies_pool = self.fabric.dies
        chan_pool = self.fabric.channels
        t0 = t
        relocated = 0
        for pg in range(d.ppb):
            if not d.valid[blk][pg]:
                continue
            lpn = d.page_lpn[blk][pg]
            try:
                # mapping first: a failed allocation must leave the page
                # in place (still rebuildable), not half-moved
                self._map_write(lpn, die, self._survivor_kind(lpn), gc=True)
            except OutOfPhysicalBlocks:
                if fm is not None:
                    fm.mark_read_only(die)
                return t               # block not retired; pages stay put
            t = dies_pool.acquire_end(t, f.t_read_ns, unit=die)
            t = chan_pool.acquire_end(t, xfer, unit=chan)
            t = dies_pool.acquire_end(t, f.t_prog_ns, unit=die)
            relocated += 1
            self.gc_energy_nj += self._copy_energy(f)
        # out of the pool forever: never free, never an append point
        if d.state[blk] == _DieFTL.FREE:
            try:
                d.free.remove(blk)
            except ValueError:
                pass
        for kind, ap in list(d.active.items()):
            if ap is not None and ap[0] == blk:
                d.active[kind] = None
        d.state[blk] = _DieFTL.RETIRED
        d.retired_blocks += 1
        self.pages_relocated += relocated
        if t > self.last_booked_ns:
            self.last_booked_ns = t
        if fm is not None:
            fm.stats_.n_blocks_retired += 1
            fm.stats_.n_pages_relocated += relocated
            fm.uncorrectable.pop((die, blk), None)
        tele = self.telemetry
        if tele is not None:
            tele.on_retirement(die, blk, t0, t, relocated)
        # the pool just shrank: the collector may need to wake
        self.maybe_start_gc(die)
        return t

    # -- garbage collection as a background tenant ----------------------------

    def maybe_start_gc(self, die: int) -> None:
        """Wake the collector on ``die`` if the low watermark is crossed.

        With a block reserve configured, a drained free *list* is a wake
        trigger in its own right: pages left in open append points count
        toward the free fraction but cannot seed a new append point, so a
        die running several streams (hot/cold split, survivor routing)
        can have every free block consumed while the fraction still reads
        above the watermark — and would overflow-grow on the next
        append-point open instead of collecting."""
        d = self.dies[die]
        if not self.cfg.gc_enabled or d.gc_running:
            return
        if (self.faults is not None
                and self.faults.die_dead(die, self.engine.now)):
            return                     # a failed die has nothing to collect
        if (d.free_fraction() >= self.low_wm
                and (d.reserve == 0 or len(d.free) > d.reserve)):
            return
        d.gc_running = True
        self.gc_active_dies += 1
        self.gc_invocations += 1
        self.engine.schedule(self.engine.now, EventKind.GC,
                             self._gc_handler, payload=die)

    def _gc_sleep(self, die: int) -> None:
        d = self.dies[die]
        if d.gc_running:
            d.gc_running = False
            self.gc_active_dies -= 1

    def _collection_done(self, d: _DieFTL) -> bool:
        """Stop condition for a collection burst — the mirror of the
        wake condition in :meth:`maybe_start_gc`.  With a reserve, the
        free list must hold a block beyond the collector's before the
        high watermark counts as recovered: open append points hold
        pages the free *fraction* counts but that cannot seed a new
        append point, and sleeping on the fraction alone would make the
        drained-list wake re-fire on the very next append-point open —
        the collector would thrash wake/sleep without ever reclaiming
        while the host overflow-grows."""
        if d.reserve and len(d.free) <= d.reserve:
            return False
        return d.free_fraction() >= self.high_wm

    def _copy_energy(self, f) -> float:
        return (f.e_read_nj_per_channel + 2.0 * f.e_dma_nj_per_channel
                + f.e_prog_nj_per_channel)

    def _on_gc(self, die: int) -> None:
        """Reclaim one victim block in a single monolithic booking; re-arm
        until the high watermark (the legacy, non-suspend collector)."""
        d = self.dies[die]
        if self._collection_done(d):
            self._gc_sleep(die)
            return
        victim = self.victim.select(d)
        if victim is None or d.valid_count[victim] >= d.ppb:
            # nothing reclaimable (all-valid blocks): the die is saturated;
            # future allocations overflow-grow rather than deadlock
            self._gc_sleep(die)
            return
        f = self.spec.flash
        nb = self.spec.page_size
        chan = die % f.channels
        xfer = 2.0 * (f.t_dma_ns + nb * f.channel_ns_per_byte)
        t = self.engine.now
        tele = self.telemetry
        if tele is not None:
            tele.ctx = f"gc:die{die}"
            tele.ctx_args = {"gc_die": die}
        t0 = t
        pages0 = self.gc_pages_copied
        dies_pool = self.fabric.dies
        chan_pool = self.fabric.channels
        fm = self.faults
        for pg in range(d.ppb):
            if not d.valid[victim][pg]:
                continue
            lpn = d.page_lpn[victim][pg]
            t = dies_pool.acquire_end(t, f.t_read_ns, unit=die)
            if fm is not None:
                t, ok = fm.check_read(t, die, victim, pg)
                if not d.valid[victim][pg]:
                    continue    # check_read retired this very block and
                                # already relocated the page
                if not ok:
                    # unrecoverable mid-GC: the data is gone.  Drop the
                    # mapping (counted in FaultStats.n_failed_reads)
                    # rather than program garbage.
                    d.invalidate(victim, pg)
                    del self.l2p[lpn]
                    continue
            t = chan_pool.acquire_end(t, xfer, unit=chan)
            try:
                self._map_write(lpn, die, self._survivor_kind(lpn), gc=True)
            except OutOfPhysicalBlocks:
                fm.mark_read_only(die)     # no_grow implies fm is attached
                self._gc_sleep(die)
                return
            t = dies_pool.acquire_end(t, f.t_prog_ns, unit=die)
            self.gc_pages_copied += 1
            self.gc_energy_nj += self._copy_energy(f)
        if d.state[victim] == _DieFTL.RETIRED:
            # retirement beat the collector to this block: nothing to erase
            if t > self.last_booked_ns:
                self.last_booked_ns = t
            self.engine.schedule(t, EventKind.GC, self._on_gc, payload=die)
            return
        t = self.fabric.dies.acquire_end(t, f.t_erase_ns, unit=die)
        d.erase(victim)
        if fm is not None:
            fm.on_erase(die, victim)
        self.blocks_erased += 1
        self.gc_energy_nj += f.e_erase_nj_per_block
        if t > self.last_booked_ns:
            self.last_booked_ns = t
        if tele is not None:
            tele.on_gc_cycle(die, victim, t0, t,
                             self.gc_pages_copied - pages0)
        # re-check at cycle completion: keep collecting or go back to sleep
        self.engine.schedule(t, EventKind.GC, self._on_gc, payload=die)

    def _on_gc_page(self, die: int) -> None:
        """Suspend-mode collector: one event per page copy.

        Each copy books the die/channel pools *at its own event time*, so
        host requests arriving between copies book ahead of the remaining
        cycle instead of FIFO-queueing behind a whole victim; and while
        the host queue is ``suspend_qd`` deep or more, the collector backs
        off ``backoff_ns`` without booking anything.  Pages of the victim
        invalidated mid-cycle (the host overwrote the LPN while the
        collector was suspended) are skipped — their copy would have been
        pure amplification."""
        d = self.dies[die]
        engine = self.engine
        if d.gc_victim is None:
            # victim-selection step (between victims: watermark re-check)
            if self._collection_done(d):
                self._gc_sleep(die)
                return
            victim = self.victim.select(d)
            if victim is None or d.valid_count[victim] >= d.ppb:
                self._gc_sleep(die)
                return
            d.gc_victim, d.gc_cursor = victim, 0
        tele = self.telemetry
        # throttle: yield to a deep host queue before booking anything
        if self._host_qd() >= self.suspend_qd:
            self.gc_suspensions += 1
            if tele is not None:
                tele.on_gc_suspend(die, engine.now)
            engine.schedule(engine.now + self.backoff_ns, EventKind.GC,
                            self._on_gc_page, payload=die)
            return
        f = self.spec.flash
        victim = d.gc_victim
        pg = d.gc_cursor
        valid = d.valid[victim]
        while pg < d.ppb and not valid[pg]:
            pg += 1
        if pg < d.ppb:
            # copy exactly one page, then yield the pools
            nb = self.spec.page_size
            chan = die % f.channels
            xfer = 2.0 * (f.t_dma_ns + nb * f.channel_ns_per_byte)
            lpn = d.page_lpn[victim][pg]
            if tele is not None:
                tele.ctx = f"gc:die{die}"
                tele.ctx_args = {"gc_die": die}
            t = self.fabric.dies.acquire_end(engine.now, f.t_read_ns,
                                             unit=die)
            fm = self.faults
            if fm is not None:
                t, ok = fm.check_read(t, die, victim, pg)
                if not d.valid[victim][pg] or not ok:
                    # either check_read retired the block (page already
                    # relocated) or the data is unrecoverable: skip it
                    if d.valid[victim][pg]:
                        d.invalidate(victim, pg)
                        del self.l2p[lpn]
                    d.gc_cursor = pg + 1
                    if t > self.last_booked_ns:
                        self.last_booked_ns = t
                    engine.schedule(t, EventKind.GC, self._on_gc_page,
                                    payload=die)
                    return
            t = self.fabric.channels.acquire_end(t, xfer, unit=chan)
            t = self.fabric.dies.acquire_end(t, f.t_prog_ns, unit=die)
            try:
                self._map_write(lpn, die, self._survivor_kind(lpn), gc=True)
            except OutOfPhysicalBlocks:
                fm.mark_read_only(die)     # no_grow implies fm is attached
                self._gc_sleep(die)
                return
            self.gc_pages_copied += 1
            self.gc_energy_nj += self._copy_energy(f)
            d.gc_cursor = pg + 1
            if t > self.last_booked_ns:
                self.last_booked_ns = t
            if tele is not None:
                tele.on_gc_copy(die, engine.now, t)
            engine.schedule(t, EventKind.GC, self._on_gc_page, payload=die)
            return
        # no valid pages left: erase, then move to the next victim
        if d.state[victim] == _DieFTL.RETIRED:
            # retirement beat the collector to this block: nothing to erase
            d.gc_victim, d.gc_cursor = None, 0
            engine.schedule(engine.now, EventKind.GC, self._on_gc_page,
                            payload=die)
            return
        if tele is not None:
            tele.ctx = f"gc:die{die}"
            tele.ctx_args = {"gc_die": die}
        t = self.fabric.dies.acquire_end(engine.now, f.t_erase_ns, unit=die)
        d.erase(victim)
        if self.faults is not None:
            self.faults.on_erase(die, victim)
        self.blocks_erased += 1
        self.gc_energy_nj += f.e_erase_nj_per_block
        d.gc_victim, d.gc_cursor = None, 0
        if t > self.last_booked_ns:
            self.last_booked_ns = t
        if tele is not None:
            tele.on_gc_copy(die, engine.now, t, kind="erase")
        engine.schedule(t, EventKind.GC, self._on_gc_page, payload=die)

    # -- observability --------------------------------------------------------

    def note_host_latency_during_gc(self, latency_ns: float) -> None:
        self.host_during_gc_ns.append(latency_ns)

    @property
    def gc_busy(self) -> bool:
        return self.gc_active_dies > 0

    def check_invariants(self) -> None:
        """The FTL laws ``tests/test_ftl.py`` asserts mid-run.

        Each live logical page maps to exactly one physical page; the
        reverse map (page_lpn) agrees; per-block valid counts match the
        bitmaps; and the total valid-page count equals the live mapping
        size (conservation across GC cycles)."""
        seen_ppns = set()
        for lpn, (die, blk, pg) in self.l2p.items():
            assert (die, blk, pg) not in seen_ppns, "two LPNs share a PPN"
            seen_ppns.add((die, blk, pg))
            d = self.dies[die]
            assert d.valid[blk][pg], f"lpn {lpn} maps to an invalid page"
            assert d.page_lpn[blk][pg] == lpn, "L2P/P2L disagree"
        total_valid = 0
        for d in self.dies:
            for b in range(len(d.state)):
                n = sum(d.valid[b])
                assert n == d.valid_count[b], "valid count drifted"
                total_valid += n
                if d.state[b] == _DieFTL.RETIRED:
                    assert n == 0, "retired block still holds valid pages"
                    assert b not in d.free, "retired block on the free list"
                    assert all(ap is None or ap[0] != b
                               for ap in d.active.values()), \
                        "retired block is an append point"
        assert total_valid == len(self.l2p), "valid pages != live mappings"

    def stats(self) -> FTLStats:
        erase_counts = [c for d in self.dies for c in d.erase_count]
        return FTLStats(
            gc_enabled=self.cfg.gc_enabled,
            n_logical_pages=self.n_logical,
            n_physical_pages=sum(d.physical_pages for d in self.dies),
            host_pages_written=self.host_pages_written,
            gc_pages_copied=self.gc_pages_copied,
            blocks_erased=self.blocks_erased,
            gc_invocations=self.gc_invocations,
            overflow_blocks=sum(d.grown_blocks for d in self.dies),
            gc_energy_nj=self.gc_energy_nj,
            erase_counts=erase_counts,
            host_during_gc_ns=list(self.host_during_gc_ns),
            victim_policy=self.victim.name,
            hot_cold=self.cfg.hot_cold,
            gc_suspend=self.cfg.gc_suspend,
            gc_suspensions=self.gc_suspensions,
            hot_pages_written=self.hot_pages_written,
            cold_pages_written=self.cold_pages_written,
            gc_overflow_blocks=sum(d.gc_grown_blocks for d in self.dies),
            last_booked_ns=self.last_booked_ns,
            blocks_retired=sum(d.retired_blocks for d in self.dies),
            pages_relocated=self.pages_relocated)


def drive_zipf_overwrites(cfg: FTLConfig, spec: SSDSpec,
                          n_writes: int, theta: float = 0.99,
                          seed: int = 7, check: bool = True) -> FTLStats:
    """Precondition one FTL and churn it with a seeded Zipf overwrite
    stream; return its stats.

    The shared calibration driver behind the ``gc_policies`` bench, its
    example walkthrough and the policy-law tests: LBAs follow the same
    inverse-CDF hashed-uniform discipline as
    :class:`~repro_torch.sim.tenancy.HostIOStream` (identical seeds replay
    identical streams), and the run is *state-only* — WA/wear policy
    comparisons need mapping churn, not pool bookings.  Pass a scaled
    ``spec`` (few dies) to concentrate per-die churn so thousands of GC
    cycles, where victim choice actually matters, simulate in seconds.
    ``check=True`` asserts the FTL invariants after the run."""
    # late import: tenancy imports this module (no cycle at call time)
    from repro_torch.sim.machine import _hash01
    from repro_torch.sim.tenancy import _die_of_lpn, _zipf_cdf

    engine = EventEngine()
    fabric = Fabric(spec)
    dies = spec.flash.total_dies
    model = FTLModel(cfg, spec, fabric, engine,
                     die_of=lambda lpn: _die_of_lpn(lpn, seed, dies))
    space = model.n_logical
    cdf = _zipf_cdf(space, theta)
    lpn_seed = seed ^ 0x1BA5
    for i in range(n_writes):
        u = min(0.999999, max(0.0, _hash01(i, lpn_seed)))
        lpn = min(space - 1, bisect.bisect_left(cdf, u * cdf[-1]))
        die = model.die_of(lpn)
        model.host_write(lpn, die)
        model.maybe_start_gc(die)
        engine.run()
    if check:
        model.check_invariants()
    return model.stats()
