"""Logical-page mapping (FTL view) and Conduit's data-placement model (§4.4).

All data is addressed at logical-page granularity; the L2P table tracks each
page's current physical residence.  Conduit extends each L2P entry with the
lazy-coherence triple (owner, state, version) — see §4.4 "Coherence".

The FTL also enforces NDP layout constraints: Flash-Cosmos requires all
operands of an in-flash MWS AND to live in pages of the *same flash block*;
we model this with a ``flash_block`` group id per page and a one-time
co-location (read+program) cost when the constraint is violated.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.isa import Location
from repro_torch.hw.ssd_spec import SSDSpec


@dataclasses.dataclass
class PageEntry:
    pid: int
    location: Location = Location.FLASH
    owner: Location = Location.FLASH          # who holds the latest version
    dirty: bool = False
    version: int = 0                          # 1-byte monotone counter (§4.4)
    flash_block: int = -1                     # layout group for MWS AND
    channel: int = 0                          # home flash channel (parallelism)
    die: int = 0                              # home die (channel*dies+die_idx)
    name: str = ""
    l2p_cached: bool = True                   # DFTL: entry resident in DRAM?

    VERSION_MAX = 255

    def bump_version(self) -> None:
        # Paper: flush before wrap-around; we assert the flush happened.
        self.version = (self.version + 1) % (self.VERSION_MAX + 1)


class PageTable:
    """L2P mapping + Conduit coherence metadata + placement policy."""

    def __init__(self, spec: SSDSpec, l2p_cache_fraction: float = 0.9):
        self.spec = spec
        self.entries: Dict[int, PageEntry] = {}
        self._next_pid = itertools.count()
        self._next_block = itertools.count()
        self._nchan = spec.flash.channels
        self._ndies = spec.flash.channels * spec.flash.dies_per_channel
        self._alloc_cursor = 0
        # DFTL-style demand cache: a fraction of entries resident in DRAM.
        self.l2p_cache_fraction = l2p_cache_fraction
        self._initial: Dict[int, tuple] = {}

    # -- allocation ---------------------------------------------------------

    def alloc_array(self, nbytes: int, name: str = "",
                    location: Location = Location.FLASH) -> List[int]:
        """Allocate logical pages for an array; pages stripe across channels
        (internal parallelism) and share one flash block group per stripe set
        (Flash-Cosmos-friendly placement by the extended FTL, §5.1)."""
        psize = self.spec.page_size
        npages = max(1, -(-nbytes // psize))
        block = next(self._next_block)
        pids = []
        for i in range(npages):
            pid = next(self._next_pid)
            ent = PageEntry(
                pid=pid, location=location, owner=location,
                flash_block=block, channel=self._alloc_cursor % self._nchan,
                die=self._alloc_cursor % self._ndies,
                name=f"{name}[{i}]" if name else "",
                l2p_cached=(pid % 100) < int(self.l2p_cache_fraction * 100),
            )
            self._alloc_cursor += 1
            self.entries[pid] = ent
            pids.append(pid)
        return pids

    def reset(self) -> None:
        """Restore every page to its initial (post-load) placement so the
        same trace can be simulated under several policies independently."""
        for pid, snap in self._initial.items():
            ent = self.entries[pid]
            (ent.location, ent.owner, ent.dirty, ent.version,
             ent.flash_block, ent.l2p_cached, ent.channel, ent.die) = snap

    def snapshot_initial(self) -> None:
        self._initial = {
            pid: (e.location, e.owner, e.dirty, e.version,
                  e.flash_block, e.l2p_cached, e.channel, e.die)
            for pid, e in self.entries.items()}

    def clone(self) -> "PageTable":
        """Independent copy of the mutable residency state.

        Much cheaper than ``copy.deepcopy``: the spec is immutable and
        shared, the ``_initial`` snapshot values are tuples and shared,
        and only the :class:`PageEntry` records — the state a Simulation
        mutates — are duplicated.  This is the open-loop serving driver's
        per-session admission cost, so it sits on a measured path."""
        new = PageTable.__new__(PageTable)
        new.spec = self.spec
        new.entries = {pid: copy.copy(e) for pid, e in self.entries.items()}
        new._next_pid = copy.deepcopy(self._next_pid)
        new._next_block = copy.deepcopy(self._next_block)
        new._nchan = self._nchan
        new._ndies = self._ndies
        new._alloc_cursor = self._alloc_cursor
        new.l2p_cache_fraction = self.l2p_cache_fraction
        new._initial = dict(self._initial)
        return new

    def __getitem__(self, pid: int) -> PageEntry:
        return self.entries[pid]

    def __len__(self) -> int:
        return len(self.entries)

    # -- feature: operand location (L2P lookup, §4.5 latencies) -------------

    def lookup_latency_ns(self, pid: int) -> float:
        ent = self.entries[pid]
        if ent.l2p_cached:
            return self.spec.l2p_lookup_dram_ns
        # demand-fetch the mapping entry from flash, then it is cached
        ent.l2p_cached = True
        return self.spec.l2p_lookup_flash_ns

    def location(self, pid: int) -> Location:
        return self.entries[pid].location

    # -- coherence (§4.4) ----------------------------------------------------

    def record_write(self, pid: int, by: Location) -> None:
        """A computation resource modified the page: update owner/state/version."""
        ent = self.entries[pid]
        if ent.owner == by and ent.dirty:
            ent.bump_version()                  # same-owner update: version only
        else:
            ent.owner = by
            ent.dirty = True
            ent.bump_version()
        ent.location = by

    def commit(self, pid: int) -> bool:
        """Sync trigger: commit the latest version to flash; returns True if a
        flash program was actually needed (page was dirty off-flash)."""
        ent = self.entries[pid]
        needed = ent.dirty and ent.owner != Location.FLASH
        ent.owner = Location.FLASH
        ent.location = Location.FLASH
        ent.dirty = False
        ent.version = 0
        return needed

    def move(self, pid: int, to: Location) -> None:
        ent = self.entries[pid]
        ent.location = to

    # -- layout constraints ---------------------------------------------------

    def same_block(self, pids: Sequence[int]) -> bool:
        blocks = {self.entries[p].flash_block for p in pids}
        return len(blocks) <= 1

    def co_locate(self, pids: Sequence[int]) -> int:
        """Force pages into one flash block group (FTL relocation).  Returns
        the number of pages that had to be physically relocated."""
        if not pids:
            return 0
        target = self.entries[pids[0]].flash_block
        moved = 0
        for p in pids[1:]:
            ent = self.entries[p]
            if ent.flash_block != target:
                ent.flash_block = target
                moved += 1
        return moved

    # -- accounting -----------------------------------------------------------

    def dirty_pages(self) -> List[int]:
        return [p for p, e in self.entries.items() if e.dirty]

    def owner_counts(self) -> Dict[Location, int]:
        out: Dict[Location, int] = {}
        for e in self.entries.values():
            out[e.owner] = out.get(e.owner, 0) + 1
        return out
