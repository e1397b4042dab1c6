"""A traced segment: ``torch.profiler`` over a few rounds after
the measured window, reduced to what the per-layer readers take.

The harness marks its own spans with ``record_function``: ``round``,
``serve_requests``, and, around the program's own prefill
and decode step functions, ``prefill`` and ``decode``.  From the trace:

* the traced window: from the first to the last end of a ``round``
  span, on the profiler's clock;
* device busy seconds: the union of every device operation's interval
  (kernels, copies, fills) inside that window;
* device seconds and counts by operation name;
* CUDA runtime launch calls (kernel and graph launches) inside each
  harness span name;
* idle gaps (the window less the busy union), each labelled by the
  innermost harness span and the outermost program op running on the host
  at its middle, summed by label.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# innermost first
SPANS = ("prefill", "decode", "serve_requests", "round")
WINDOW_SPANS = ("round",)
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
            "cudaGraphLaunch", "cuGraphLaunch")
TOP = 10
NAME_CHARS = 120


@contextlib.contextmanager
def traced(cuda: bool) -> Iterator[profile]:
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def _union(starts: np.ndarray, ends: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """The union of intervals as sorted, disjoint (starts, ends)."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    seg_end = np.append(reach[idx[1:] - 1], reach[-1])
    return s[idx], seg_end


def _covering(points: np.ndarray, starts: np.ndarray,
              ends: np.ndarray) -> np.ndarray:
    """Index into disjoint sorted intervals of the one holding each
    point, -1 where none does."""
    if starts.size == 0:
        return np.full(points.size, -1)
    i = np.searchsorted(starts, points, side="right") - 1
    ok = (i >= 0) & (points <= ends[np.clip(i, 0, None)])
    return np.where(ok, i, -1)


def _top_level(starts: np.ndarray, ends: np.ndarray
               ) -> np.ndarray:
    """Indices of intervals contained in no other (sorted by start)."""
    order = np.argsort(starts, kind="stable")
    keep, reach = [], -1
    for i in order:
        if starts[i] >= reach:
            keep.append(i)
            reach = ends[i]
        elif ends[i] > reach:
            reach = ends[i]
    return np.asarray(keep, dtype=np.int64)


def reduce(prof: profile) -> Dict:
    events = prof.profiler.kineto_results.events()
    dev_s, dev_e, dev_name = [], [], []
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    launch_t: List[int] = []
    op_s, op_e, op_name = [], [], []
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        name = e.name()
        if e.device_type() != DeviceType.CPU:
            if name in SPANS:       # the harness's spans, mirrored
                continue
            dev_s.append(start)
            dev_e.append(end)
            dev_name.append(name)
        elif name in SPANS:
            spans[name].append((start, end))
        elif name in LAUNCHES:
            launch_t.append(start)
        elif getattr(e, "activity_type", lambda: "cpu_op")() == "cpu_op":
            op_s.append(start)
            op_e.append(end)
            op_name.append(name)
    window_spans = [iv for n in WINDOW_SPANS for iv in spans.get(n, [])]
    if not window_spans:
        return {}
    w0 = min(s for s, _ in window_spans)
    w1 = max(e for _, e in window_spans)
    dev_s, dev_e = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    inside = (dev_e > w0) & (dev_s < w1)
    bs, be = _union(np.clip(dev_s[inside], w0, w1),
                    np.clip(dev_e[inside], w0, w1))
    busy_ns = int((be - bs).sum())

    op_seconds: Dict[str, float] = defaultdict(float)
    for i in np.flatnonzero(inside):
        op_seconds[dev_name[i]] += (dev_e[i] - dev_s[i]) / 1e9

    sorted_spans = {n: (np.asarray(sorted(v), np.int64).reshape(-1, 2))
                    for n, v in spans.items()}
    launch_t = np.asarray(launch_t, np.int64)
    launches = {}
    for n, iv in sorted_spans.items():
        launches[n] = int((_covering(launch_t, iv[:, 0], iv[:, 1])
                           >= 0).sum())

    gap_s = np.append(w0, be)
    gap_e = np.append(bs, w1)
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    mids = (gap_s + gap_e) // 2
    label = np.full(mids.size, "", dtype=object)
    for n in reversed(SPANS):
        if n in sorted_spans:
            iv = sorted_spans[n]
            hit = _covering(mids, iv[:, 0], iv[:, 1]) >= 0
            label[hit] = n
    op_s, op_e = np.asarray(op_s, np.int64), np.asarray(op_e, np.int64)
    top = _top_level(op_s, op_e) if op_s.size else np.zeros(0, np.int64)
    ts, te = op_s[top], op_e[top]
    at = _covering(mids, ts, te)
    idle: Dict[str, float] = defaultdict(float)
    for lab, j, width in zip(label, at, (gap_e - gap_s) / 1e9):
        op = op_name[top[j]] if j >= 0 else "(no op)"
        idle[f"{lab or '(no span)'}/{op}"[:NAME_CHARS]] += width

    def top_rows(d: Dict[str, float]) -> List[list]:
        rows = sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
        return [[k[:NAME_CHARS], v] for k, v in rows]

    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "device_ops": top_rows(op_seconds),
            "op_seconds": dict(op_seconds),
            "launches": launches,
            "idle_gaps": top_rows(idle)}


def kernel_seconds(reduced: Dict, name: str) -> Optional[float]:
    """Device seconds of the operations whose name holds ``name``; None
    where none ran."""
    hits = [s for k, s in reduced.get("op_seconds", {}).items() if name in k]
    return sum(hits) if hits else None


def idle_percent(reduced: Dict) -> Optional[float]:
    """1 less the busy union over the traced window, in percent; None
    where no device operation ran."""
    if not reduced.get("window_s") or not reduced.get("busy_s"):
        return None
    return (1.0 - reduced["busy_s"] / reduced["window_s"]) * 100.0
