"""Host spans and counters of the serving path, off by default.

The serving loop (``launch/serve.py``), the model's cache path
(``models/model.py``), the time scans (``models/ssm.py``), the cached
attention, MLA and the MoE layer (``models/layers.py``) mark where the
host is, and the decode step's CUDA graph (``launch/graphs.py``) counts
its replays and captures:

* a span is a named interval of the host's clock with an id, its
  parent's id, the serving batch it belongs to and, for a block, its
  layer index;
* a counter adds a number, once per call and never per time step, to the
  innermost open ``serve.*`` span, so that prefill's counts and a decode
  step's stay apart.

Off (the default), a site costs one check of the module's recorder and
returns one shared do-nothing context manager.  On::

    with spans.recording() as rec:
        serve_requests(...)
    rec.spans()      # [{"name", "id", "parent", "batch", "layer",
                     #   "start_ns", "end_ns"[, "rids"]}, ...]
    rec.counters()   # [{"span", "name", "value"}, ...]

While ``torch.profiler`` is on and nothing else records, each
``serve_requests`` call records by itself (``under_profiler``), into one
recording for each unbroken run of profiled calls: ``last_profiled()``
gives the latest, so that whoever profiled the serving loop can lay its
spans over the trace.  A call made with the profiler off ends that run.
The measured serving path, unprofiled, records nothing.

Times are ``time.perf_counter_ns()`` readings moved onto the Unix clock
that ``torch.profiler`` stamps its events with (``Recorder.offset_ns``,
taken when recording starts), so a span can be laid over the device's
trace.  Spans are not mirrored through ``record_function``: the profiler
would put each on the device's timeline as an annotation.  This is the
card's tracing; ``sim/telemetry.py`` records the simulated SSD's time.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch


class _Null:
    """The span of a site while nothing records."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


def _clock_offset(pairs: int = 7) -> int:
    """Unix nanoseconds less ``perf_counter_ns`` at the same instant: the
    median of a few paired readings."""
    return int(statistics.median(time.time_ns() - time.perf_counter_ns()
                                 for _ in range(pairs)))


class _Open:
    __slots__ = ("rec", "sid")

    def __init__(self, rec: "Recorder", sid: int):
        self.rec, self.sid = rec, sid

    def __enter__(self) -> int:
        return self.sid

    def __exit__(self, *exc) -> bool:
        self.rec.close(self.sid)
        return False


class Recorder:
    """The spans and counters of one recording, in memory: a column of
    ints or strings for each field, so that a span leaves no object for the
    garbage collector to track."""

    def __init__(self):
        self.offset_ns = _clock_offset()
        self._name: List[str] = []
        self._parent: List[int] = []
        self._batch: List[int] = []
        self._layer: List[Optional[int]] = []
        self._start: List[int] = []
        self._end: List[Optional[int]] = []
        self._rids: Dict[int, List[int]] = {}
        self._counts: Dict[Tuple[int, str], int] = defaultdict(int)
        self._stack: List[int] = []
        self._serve: List[int] = []       # the open serve.* spans
        self._open_batch = -1
        self._batches = 0

    def open(self, name: str, t_ns: Optional[int] = None,
             layer: Optional[int] = None,
             rids: Optional[List[int]] = None) -> int:
        sid = len(self._name)
        if name == "serve.batch":
            self._open_batch = self._batches
            self._batches += 1
            self._rids[sid] = rids or []
        self._name.append(name)
        self._parent.append(self._stack[-1] if self._stack else -1)
        self._batch.append(self._open_batch)
        self._layer.append(layer)
        self._end.append(None)
        self._stack.append(sid)
        if name.startswith("serve."):
            self._serve.append(sid)
        self._start.append(time.perf_counter_ns() if t_ns is None
                           else t_ns)
        return sid

    def close(self, sid: int, t_ns: Optional[int] = None) -> None:
        """Ends span ``sid`` and any of its descendants still open; a span
        already ended is left as it is."""
        t = time.perf_counter_ns() if t_ns is None else t_ns
        if sid not in self._stack:
            return
        while self._stack:
            top = self._stack.pop()
            self._end[top] = t
            if self._serve and self._serve[-1] == top:
                self._serve.pop()
            if self._name[top] == "serve.batch":
                self._open_batch = -1
            if top == sid:
                return

    def add(self, name: str, n: int) -> None:
        self._counts[(self._serve[-1] if self._serve else -1, name)] += n

    def spans(self) -> List[Dict]:
        """The ended spans in the order they opened, their times on the
        profiler's clock (Unix nanoseconds)."""
        out = []
        for sid, end in enumerate(self._end):
            if end is None:
                continue
            span = {"name": self._name[sid], "id": sid,
                    "parent": self._parent[sid], "batch": self._batch[sid],
                    "layer": self._layer[sid],
                    "start_ns": self._start[sid] + self.offset_ns,
                    "end_ns": end + self.offset_ns}
            if sid in self._rids:
                span["rids"] = list(self._rids[sid])
            out.append(span)
        return out

    def counters(self) -> List[Dict]:
        """Each counter's total in each ``serve.*`` span (``span`` -1:
        outside every one)."""
        return [{"span": sid, "name": name, "value": int(value)}
                for (sid, name), value in self._counts.items()]


_recorder: Optional[Recorder] = None     # None: nothing records
_profiled: Optional[Recorder] = None     # the latest profiled run's
_profiled_run_open = False               # no unprofiled call since
# False: profiled ``serve_requests`` calls record nothing either
FOLLOW_PROFILER = True


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Records every span and counter until the block ends."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are already being recorded")
    _recorder = Recorder()
    try:
        yield _recorder
    finally:
        _recorder = None


@contextlib.contextmanager
def private() -> Iterator[Recorder]:
    """Records into a recording of its own until the block ends, whatever
    records around it: the recording around sees nothing of the block and
    goes on after it (a CUDA graph's capture reads what one step
    counts)."""
    global _recorder
    outer, _recorder = _recorder, Recorder()
    try:
        yield _recorder
    finally:
        _recorder = outer


class _Profiled:
    """One profiled call's recording into ``_profiled``."""
    __slots__ = ()

    def __enter__(self) -> None:
        global _recorder
        _recorder = _profiled

    def __exit__(self, *exc) -> bool:
        global _recorder
        _recorder = None
        return False


_PROFILED = _Profiled()


def under_profiler():
    """The recording of one ``serve_requests`` call: into the profiled
    run's recording while ``torch.profiler`` is on and nothing else
    records (a new one where the last call was unprofiled); else
    nothing."""
    global _profiled, _profiled_run_open
    if _recorder is not None:
        return _NULL
    if not (FOLLOW_PROFILER and torch.autograd._profiler_enabled()):
        _profiled_run_open = False
        return _NULL
    if not _profiled_run_open:
        _profiled, _profiled_run_open = Recorder(), True
    return _PROFILED


def last_profiled() -> Optional[Recorder]:
    """The recording of the latest run of profiled ``serve_requests``
    calls; None before any."""
    return _profiled


def on() -> bool:
    return _recorder is not None


def span(name: str):
    """A span around a ``with`` block."""
    if _recorder is None:
        return _NULL
    return _Open(_recorder, _recorder.open(name))


def block(kind: str, layer: int):
    """The span ``block.<kind>`` of the pattern's entry ``layer``."""
    if _recorder is None:
        return _NULL
    return _Open(_recorder, _recorder.open("block." + kind, layer=layer))


def batch(requests: Sequence):
    """The span ``serve.batch`` of one serving batch, which lists the
    requests' ``rid``; every span inside it carries its batch id."""
    if _recorder is None:
        return _NULL
    return _Open(_recorder, _recorder.open(
        "serve.batch", rids=[r.rid for r in requests]))


def begin(name: str, t_ns: Optional[int] = None) -> Optional[int]:
    """Opens a span whose end another statement than a ``with`` reads
    (``end``); ``t_ns``: a ``perf_counter_ns`` reading the caller shares."""
    if _recorder is None:
        return None
    return _recorder.open(name, t_ns)


def end(sid: Optional[int], t_ns: Optional[int] = None) -> None:
    if _recorder is None or sid is None:
        return
    _recorder.close(sid, t_ns)


def count(name: str, n) -> None:
    """Adds ``n`` to counter ``name`` in the innermost open ``serve.*``
    span."""
    if _recorder is None:
        return
    _recorder.add(name, n)
