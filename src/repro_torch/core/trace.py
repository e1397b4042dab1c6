"""The Conduit binary: a traced program as page-aligned vector instructions.

:class:`Trace` is what compile-time preprocessing (:mod:`repro_torch.core.
vectorize`) hands to the runtime (:mod:`repro_torch.sim.machine`).  It lives
here, apart from the tracer, so that the engine imports no tracer.

:func:`trace_to_dict` / :func:`trace_from_dict` carry a trace across as plain
ints, strs, bools and lists.  The dict is read from attribute names only, so
any trace with the same ``VectorInstr`` and ``PageTable`` fields serialises
the same way; a trace made elsewhere then runs in this package's engine, and
an engine fault shows apart from a tracer fault.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List

from repro_torch.core.isa import Location, OpClass, VectorInstr, latency_band
from repro_torch.core.mapping import PageEntry, PageTable
from repro_torch.hw.ssd_spec import DEFAULT_SSD, SSDSpec


@dataclasses.dataclass
class TraceStats:
    """Table 3 workload characterization."""

    total_instrs: int
    vectorizable_pct: float          # fraction of vectorizable instructions
    avg_reuse: float                 # reads per distinct page before overwrite
    band_mix: Dict[str, float]       # {low, medium, high} fractions
    op_mix: Dict[str, int]
    footprint_bytes: int

    def as_row(self) -> Dict[str, Any]:
        return {
            "vectorizable_pct": round(100 * self.vectorizable_pct, 1),
            "avg_reuse": round(self.avg_reuse, 1),
            "low_pct": round(100 * self.band_mix.get("low", 0.0)),
            "medium_pct": round(100 * self.band_mix.get("medium", 0.0)),
            "high_pct": round(100 * self.band_mix.get("high", 0.0)),
            "instrs": self.total_instrs,
        }


@dataclasses.dataclass
class Trace:
    """Output of compile-time preprocessing: the Conduit binary."""

    instrs: List[VectorInstr]
    pages: PageTable
    input_pages: Dict[str, List[int]]
    output_pages: List[List[int]]
    name: str = ""

    def characterize(self) -> TraceStats:
        """Workload characterization (Table 3).

        ``avg_reuse``: operations consuming the same data *version* before
        it is replaced — reads of each page between consecutive writes,
        averaged over versions.
        """
        cur_reads: Dict[int, int] = {}
        version_reads: List[int] = []
        bands: Dict[str, int] = {"low": 0, "medium": 0, "high": 0}
        ops: Dict[str, int] = {}
        nvec = 0
        for ins in self.instrs:
            for s in ins.srcs:
                cur_reads[s] = cur_reads.get(s, 0) + 1
            if ins.dst in cur_reads:
                version_reads.append(cur_reads.pop(ins.dst))
            if ins.vectorizable:
                nvec += 1
                # Band mix counts computation ops only — COPY instructions
                # are data staging, not computation (Table 3 counts ops).
                if ins.op_class is not OpClass.COPY:
                    bands[latency_band(ins.op_class)] += 1
            ops[ins.op] = ops.get(ins.op, 0) + 1
        version_reads.extend(cur_reads.values())   # final live versions
        total = len(self.instrs)
        nbv = max(1, sum(bands.values()))
        avg_reuse = (sum(version_reads) / max(1, len(version_reads)))
        return TraceStats(
            total_instrs=total,
            vectorizable_pct=nvec / max(1, total),
            avg_reuse=avg_reuse,
            band_mix={k: v / nbv for k, v in bands.items()},
            op_mix=ops,
            footprint_bytes=len(self.pages) * self.pages.spec.page_size,
        )


class TraceBudgetExceeded(RuntimeError):
    pass


def _compact(instrs: List[VectorInstr], pages: PageTable,
             input_pages: Dict[str, List[int]],
             output_pages: List[List[int]], spec: SSDSpec):
    """Liveness-based page recycling (the buffer-reuse pass every real
    compiler performs: LLVM's vectorized loops update arrays in place, they
    do not allocate fresh SSA storage per operation).

    Input/const pages (live-in data) and trace outputs are pinned; every
    intermediate page is remapped onto a recycled physical pool once its
    last reader has issued.  SSA dependency edges (iids) are untouched —
    only page identities change — so execution ordering is preserved.
    """
    pinned = set()
    for pl in input_pages.values():
        pinned.update(pl)
    for pl in output_pages:
        pinned.update(pl)
    written: set = set()
    for ins in instrs:
        for s in ins.srcs:
            if s not in written:
                pinned.add(s)        # read-before-write: live-in constant
        written.add(ins.dst)

    last_use: Dict[int, int] = {}
    for ins in instrs:
        for p in ins.srcs + (ins.dst,):
            last_use[p] = ins.iid

    new_pages = PageTable(spec)
    mapping: Dict[int, int] = {}
    for vp in sorted(pinned):
        ent = pages[vp]
        npid = new_pages.alloc_array(spec.page_size, name=ent.name,
                                     location=ent.location)[0]
        mapping[vp] = npid

    free: List[int] = []
    release_at: Dict[int, List[int]] = {}
    for vp, iid in last_use.items():
        if vp not in pinned:
            release_at.setdefault(iid, []).append(vp)

    def lookup(vp: int) -> int:
        if vp in mapping:
            return mapping[vp]
        if free:
            npid = free.pop()
        else:
            npid = new_pages.alloc_array(
                spec.page_size, name="tmp", location=Location.DRAM)[0]
        mapping[vp] = npid
        return npid

    for ins in instrs:
        ins.srcs = tuple(lookup(s) for s in ins.srcs)
        ins.dst = lookup(ins.dst)
        for vp in release_at.get(ins.iid, ()):
            if vp in mapping:
                free.append(mapping.pop(vp))

    # pinned pages stay in `mapping` (never released)
    new_inputs = {k: [mapping[p] for p in pl] for k, pl in input_pages.items()}
    new_outputs = [[mapping[p] for p in pl if p in mapping]
                   for pl in output_pages]
    return new_pages, new_inputs, new_outputs


# -- carrying a trace across as plain data -------------------------------------

_INSTR_FIELDS = ("iid", "op", "vlen", "elem_bytes", "srcs", "dst", "deps",
                 "tag", "vectorizable")
# PageEntry fields after ``pid``; the two Location-valued ones go by name
_ENTRY_FIELDS = ("location", "owner", "dirty", "version", "flash_block",
                 "channel", "die", "name", "l2p_cached")
_LOCATION_FIELDS = ("location", "owner")
# PageTable._initial snapshot tuple order (see PageTable.snapshot_initial)
_SNAP_FIELDS = ("location", "owner", "dirty", "version", "flash_block",
                "l2p_cached", "channel", "die")


def _plain(field: str, value):
    if field in _LOCATION_FIELDS:
        return value.name
    if isinstance(value, tuple):
        return list(value)
    return value


def _counter_next(counter) -> int:
    """The value ``next(counter)`` would return, without consuming it
    (``repr(itertools.count(5))`` is ``'count(5)'``)."""
    return int(repr(counter)[len("count("):-1])


def trace_to_dict(trace) -> Dict[str, Any]:
    """Plain-data form of ``trace``: ints, strs, bools and lists only."""
    pt = trace.pages
    return {
        "name": trace.name,
        "page_size": pt.spec.page_size,
        "instrs": [[_plain(f, getattr(ins, f)) for f in _INSTR_FIELDS]
                   for ins in trace.instrs],
        "entries": [[pid] + [_plain(f, getattr(ent, f))
                             for f in _ENTRY_FIELDS]
                    for pid, ent in pt.entries.items()],
        "initial": [[pid] + [_plain(f, v) for f, v in zip(_SNAP_FIELDS, snap)]
                    for pid, snap in pt._initial.items()],
        "l2p_cache_fraction": pt.l2p_cache_fraction,
        "next_pid": _counter_next(pt._next_pid),
        "next_block": _counter_next(pt._next_block),
        "alloc_cursor": pt._alloc_cursor,
        "input_pages": {k: list(v) for k, v in trace.input_pages.items()},
        "output_pages": [list(pl) for pl in trace.output_pages],
    }


def _typed(field: str, value):
    if field in _LOCATION_FIELDS:
        return Location[value]
    if field in ("srcs", "deps"):
        return tuple(value)
    return value


def trace_from_dict(d: Dict[str, Any], spec: SSDSpec = DEFAULT_SSD) -> Trace:
    """Rebuild a :class:`Trace` from :func:`trace_to_dict`'s output."""
    if d["page_size"] != spec.page_size:
        raise ValueError(f"trace was made for {d['page_size']}-byte pages, "
                         f"spec has {spec.page_size}")
    pt = PageTable(spec, l2p_cache_fraction=d["l2p_cache_fraction"])
    for row in d["entries"]:
        kw = {f: _typed(f, v) for f, v in zip(_ENTRY_FIELDS, row[1:])}
        pt.entries[row[0]] = PageEntry(pid=row[0], **kw)
    pt._initial = {row[0]: tuple(_typed(f, v) for f, v
                                 in zip(_SNAP_FIELDS, row[1:]))
                   for row in d["initial"]}
    pt._next_pid = itertools.count(d["next_pid"])
    pt._next_block = itertools.count(d["next_block"])
    pt._alloc_cursor = d["alloc_cursor"]
    instrs = [VectorInstr(**{f: _typed(f, v)
                             for f, v in zip(_INSTR_FIELDS, row)})
              for row in d["instrs"]]
    return Trace(instrs=instrs, pages=pt,
                 input_pages={k: list(v) for k, v in d["input_pages"].items()},
                 output_pages=[list(pl) for pl in d["output_pages"]],
                 name=d["name"])
