"""The program's own spans and counters (``repro_torch.spans``) over the
traced rounds.

The program records them by itself while ``torch.profiler`` is on (the
traced rounds only), and ``program(ctx)`` reads its latest such record,
where it is one of the traced rounds: a program without the recorder
gives nothing, and nothing raises.  ``summary`` gives, by span name, the
spans' count and host milliseconds; prefill's and the decode steps'
host time less their ``serve.sync`` read-backs; the time scans' host time
inside prefill; each counter's total by the ``serve.*`` span it was
added in.

``reduce`` lays a record over a profiler's trace of the same rounds
(``spans_cost.py``; the cell's run hands its readers no trace events):

* the traced window and the device's busy union as ``trace.reduce``
  builds them: the same device operations, the same ``round`` spans,
  ``trace._union``;
* each idle gap (the window less the busy union) split over the innermost
  program span open at each of its instants: an exact intersection in
  nanoseconds, the rest under ``(no program span)``; and the device's
  idle time while the host is inside a scan.

The program's times are on the profiler's clock (``Recorder.spans``).
"""
from __future__ import annotations

import importlib
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
from torch.autograd import DeviceType

from cardbench import trace

NO_SPAN = "(no program span)"
OTHER = "(other program spans)"
SCAN = "ssm.scan"
SYNC = "serve.sync"


def _gaps(prof) -> Dict:
    """The traced window and its idle gaps, as ``trace.reduce`` has
    them."""
    dev_s, dev_e, rounds = [], [], []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        name = e.name()
        if e.device_type() != DeviceType.CPU:
            if name not in trace.SPANS:
                dev_s.append(start)
                dev_e.append(end)
        elif name in trace.WINDOW_SPANS:
            rounds.append((start, end))
    if not rounds:
        return {}
    w0 = min(s for s, _ in rounds)
    w1 = max(e for _, e in rounds)
    dev_s, dev_e = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    inside = (dev_e > w0) & (dev_s < w1)
    bs, be = trace._union(np.clip(dev_s[inside], w0, w1),
                          np.clip(dev_e[inside], w0, w1))
    gap_s, gap_e = np.append(w0, be), np.append(bs, w1)
    keep = gap_e > gap_s
    return {"w0": w0, "w1": w1, "busy_ns": int((be - bs).sum()),
            "gap_s": gap_s[keep], "gap_e": gap_e[keep]}


def _idle_before(gap_s: np.ndarray, gap_e: np.ndarray):
    """The function t -> idle nanoseconds before t, over sorted disjoint
    gaps."""
    before = np.concatenate([[0], np.cumsum(gap_e - gap_s)])

    def at(t) -> np.ndarray:
        t = np.asarray(t, np.int64)
        if gap_s.size == 0:
            return np.zeros_like(t)
        i = np.searchsorted(gap_s, t, side="right") - 1
        j = np.clip(i, 0, None)
        part = np.clip(t - gap_s[j], 0, gap_e[j] - gap_s[j])
        return np.where(i >= 0, before[j] + part, 0)
    return at


def _innermost(record: List[Dict], kids: Dict[int, List[Dict]]):
    """Disjoint (starts, ends, names): each span's interval less its
    children's (``kids``: the spans by their parent's id, in order)."""
    starts, ends, names = [], [], []
    for s in record:
        t = s["start_ns"]
        for c in kids[s["id"]]:
            if c["start_ns"] > t:
                starts.append(t)
                ends.append(c["start_ns"])
                names.append(s["name"])
            t = max(t, c["end_ns"])
        if s["end_ns"] > t:
            starts.append(t)
            ends.append(s["end_ns"])
            names.append(s["name"])
    return (np.asarray(starts, np.int64), np.asarray(ends, np.int64),
            names)


def _kids(record: List[Dict]) -> Dict[int, List[Dict]]:
    kids = defaultdict(list)
    for s in record:
        kids[s["parent"]].append(s)
    return kids


def _ms(s: Dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def summary(rec) -> Dict:
    """A record's spans, phases and counters, with no device trace."""
    record = rec.spans()
    by_id = {s["id"]: s for s in record}
    kids = _kids(record)
    serve_of: Dict[int, str] = {}      # the innermost serve.* span's name
    for s in record:
        serve_of[s["id"]] = (s["name"] if s["name"].startswith("serve.")
                             else serve_of.get(s["parent"], ""))
    spans: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"n": 0, "ms": 0.0})
    for s in record:
        spans[s["name"]]["n"] += 1
        spans[s["name"]]["ms"] += _ms(s)
    phases = {}
    for name in ("serve.prefill", "serve.decode_step"):
        tops = [s for s in record if s["name"] == name]
        sync = sum(_ms(c) for s in tops for c in kids[s["id"]]
                   if c["name"] == SYNC)
        phases[name] = {"n": len(tops), "sync_ms": sync,
                        "host_ms": sum(_ms(s) for s in tops) - sync}
    phases["serve.prefill"]["scan_ms"] = sum(
        _ms(s) for s in record
        if s["name"] == SCAN and serve_of[s["id"]] == "serve.prefill")

    counts: Dict[str, Dict[str, int]] = defaultdict(dict)
    for c in rec.counters():
        where = by_id[c["span"]]["name"] if c["span"] in by_id else ""
        counts[where][c["name"]] = counts[where].get(c["name"], 0) \
            + c["value"]
    return {"batches": sum(s["name"] == "serve.batch" for s in record),
            "spans": dict(spans), "counts": dict(counts),
            "prefill": phases["serve.prefill"],
            "decode_step": phases["serve.decode_step"]}


def program(ctx) -> Optional[Dict]:
    """The ``summary`` of the program's record of a cell's traced rounds;
    None where the program records nothing under the profiler, or its
    latest record holds another number of batches than the rounds (one
    ``serve_requests`` batch a round)."""
    try:
        recorder = importlib.import_module("repro_torch.spans")
    except ImportError:
        return None
    last = getattr(recorder, "last_profiled", None)
    rec = last() if last is not None else None
    if rec is None:
        return None
    out = summary(rec)
    if not out["batches"] or out["batches"] != ctx["trace"].get("rounds"):
        return None
    return out


def reduce(prof, rec) -> Dict:
    """``summary`` of ``rec`` and the idle split over its spans of the
    profiler ``prof``'s trace of the same rounds; {} where the trace has
    no ``round`` span."""
    g = _gaps(prof)
    if not g:
        return {}
    record = rec.spans()
    scans = [s for s in record if s["name"] == SCAN]
    idle_at = _idle_before(g["gap_s"], g["gap_e"])
    idle_ns = int((g["gap_e"] - g["gap_s"]).sum())
    seg_s, seg_e, seg_name = _innermost(record, _kids(record))
    idle = defaultdict(int)
    for name, ns in zip(seg_name, idle_at(seg_e) - idle_at(seg_s)):
        idle[name] += int(ns)
    idle_scan = int(sum(idle_at([s["end_ns"] for s in scans])
                        - idle_at([s["start_ns"] for s in scans]))) \
        if scans else 0
    rows = sorted(((n, v) for n, v in idle.items() if v),
                  key=lambda kv: -kv[1])
    by_span = [[n, v / 1e6] for n, v in rows[:trace.TOP]]
    if rows[trace.TOP:]:
        by_span.append([OTHER, sum(v for _, v in rows[trace.TOP:]) / 1e6])
    by_span.append([NO_SPAN, (idle_ns - sum(idle.values())) / 1e6])
    return dict(summary(rec), window_ms=(g["w1"] - g["w0"]) / 1e6,
                busy_ms=g["busy_ns"] / 1e6, idle_ms=idle_ns / 1e6,
                idle_in_scan_ms=idle_scan / 1e6, idle_by_span=by_span)
