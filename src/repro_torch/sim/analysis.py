"""Trace analysis & attribution: tail-latency blame, critical paths, diffs.

The flight recorder (:mod:`repro_torch.sim.telemetry`) records *what happened*;
this module answers *why the tail is what it is* — pure post-processing
over exported ``conduit-flight-recorder/v1`` traces (or live
:class:`~repro_torch.sim.telemetry.FlightRecorder` objects), never touching the
engine.  Three products:

1. **Tail-latency blame decomposition** (:func:`session_blame`) — for
   every session, wall time is attributed to phases by a priority sweep
   over the per-dispatch phase intervals in ``otherData.ops`` joined
   against the session-lifecycle, GC and reliability spans:

   - ``admission_wait`` — arrival to admission,
   - ``decide`` / ``dep_wait`` / ``dm`` / ``queue`` / ``compute`` — the
     dispatch pipeline phases (queue wait is also split per pool),
   - ``gc`` / ``recovery`` — wait time (queue/dm/dep or uncovered) that
     overlapped garbage collection or the error-recovery ladder: the
     interference components,
   - ``other`` — residual wall time no phase covers.

   The sweep walks elementary segments between *all* interval
   boundaries, so the components sum to the recorded session latency
   **exactly** (the accounting identity; property-tested).  GC/recovery
   interference uses the union of GC / recovery activity anywhere on
   the drive — drive-level interference, documented over-attribution in
   exchange for never missing cross-die blocking.  Each phase priority
   is compute > dm > queue > decide > dep_wait: occupancy beats waiting.

2. **Critical-path extraction** (:func:`critical_path`) — walk the
   worst session's dispatch chain backwards: a hop goes to the gating
   dependency when the op waited on one (``ready > decide_end``), else
   to the program-order predecessor (in-order issue); per-hop resource
   and phase breakdown, plus a per-pool bottleneck ranking
   (:func:`pool_rankings`: time-weighted queue depth, mean utilization,
   utilization at the p99 cohort's completion instants).

3. **Cross-run diff** (:func:`diff_reports`) — compare two runs' blame
   shares, pool utilization and offload-decision mix, refusing
   apples-to-oranges comparisons (different hardware spec, policy or
   entry point) loudly unless forced.

Report schema (``conduit-analysis/v1``)
---------------------------------------

:func:`build_report` emits::

    {
      "schema": "conduit-analysis/v1",
      "meta": {spec_sha, policy, seed?, entry, telemetry: {...},
               git_sha},                    # reproducibility fingerprint
      "sessions": {n, n_timed_out, n_rejected, mean_ns, p50_ns, p99_ns},
      "blame": {components: [...], totals_ns: {comp: ns},
                share: {comp: frac},        # of summed session latency
                p99_cohort: {n, threshold_ns, totals_ns, share}},
      "queue_by_pool_ns": {pool: ns},       # queue blame split by pool
      "critical_path": {tenant, latency_ns, n_hops, hops: [...]},
      "pools": [{pool, queue_depth_ns_tw, util_mean, util_at_p99}, ...],
      "decisions": {n, mix: {resource: n}, replayed, mid_recovery},
      "host_io": {n_requests, n_timeouts}
    }

Traces recorded without spans (``ops`` empty) produce an empty-but-valid
report: every trace ``telemetry validate`` accepts is analyzable.

CLI
---

::

    python -m repro_torch.sim.analysis report TRACE.json [--out R.json] [--json]
    python -m repro_torch.sim.analysis diff  A.json B.json [--tol-rel X]
                                       [--force] [--json]

``diff`` accepts traces or reports on either side (detected by schema
tag).  Exit codes, CI-suitable: 0 ok / comparable-within-tolerance,
1 invalid trace or tolerance breach, 2 unreadable input or refused
comparison (``--force`` downgrades a refusal to a warning).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import (Any, Dict, Iterable, List, Optional, TextIO, Tuple)

from repro_torch.sim.telemetry import (PID_FTL, PID_RELIABILITY, PID_SESSIONS,
                                 PID_HOST_IO, SCHEMA as TRACE_SCHEMA,
                                 validate_trace)

REPORT_SCHEMA = "conduit-analysis/v1"
DIFF_SCHEMA = "conduit-analysis-diff/v1"

#: blame components, in report order; the accounting identity is that
#: these sum to the session's recorded wall time (arrival -> done)
COMPONENTS = ("admission_wait", "decide", "dep_wait", "dm", "queue",
              "compute", "gc", "recovery", "other")

#: meta keys that must match for two runs to be comparable — git_sha is
#: deliberately absent (comparing across commits is the whole point)
_COMPARABLE_KEYS = ("spec_sha", "policy", "entry")

_US_TO_NS = 1e3          # trace ts/dur are microseconds; reports are ns


# -- trace ingestion -----------------------------------------------------------

def _as_trace(obj: Any) -> Dict[str, Any]:
    """Normalize the input: a live FlightRecorder, a trace dict, or a
    path-like is turned into the exported trace object."""
    if hasattr(obj, "chrome_trace"):
        return obj.chrome_trace()
    if isinstance(obj, dict):
        return obj
    raise TypeError(f"expected a trace dict or FlightRecorder, "
                    f"got {type(obj).__name__}")


class _Session:
    """One session lifecycle parsed from the async span stream."""

    __slots__ = ("sid", "kind", "arrival_ns", "admit_ns", "done_ns",
                 "timed_out", "rejected", "cancelled")

    def __init__(self, sid, kind):
        self.sid = sid
        self.kind = kind
        self.arrival_ns = 0.0
        self.admit_ns: Optional[float] = None
        self.done_ns: Optional[float] = None
        self.timed_out = False
        self.rejected = False
        self.cancelled = False

    @property
    def tenant(self) -> str:
        """The dispatch attribution key the serving driver uses."""
        return f"s{self.sid}:{self.kind}"

    @property
    def latency_ns(self) -> float:
        return (self.done_ns or self.arrival_ns) - self.arrival_ns


def _merge(intervals: List[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    """Union of possibly-overlapping [t0, t1) intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class _Parsed:
    """Everything the analyses need, pulled out of one trace pass."""

    def __init__(self, trace: Dict[str, Any]):
        other = trace.get("otherData") or {}
        self.meta: Dict[str, Any] = other.get("meta") or {}
        self.ops: List[dict] = other.get("ops") or []
        self.audit: List[dict] = other.get("audit") or []
        self.intervals: List[dict] = other.get("intervals") or []
        self.sessions: List[_Session] = []
        self.gc_union: List[Tuple[float, float]] = []
        self.rec_union: List[Tuple[float, float]] = []
        self.io_requests: set = set()
        self.io_timeouts = 0

        by_sid: Dict[Any, _Session] = {}
        gc_iv: List[Tuple[float, float]] = []
        rec_iv: List[Tuple[float, float]] = []
        for ev in trace.get("traceEvents") or []:
            ph = ev.get("ph")
            pid = ev.get("pid")
            if pid == PID_SESSIONS:
                if ph == "b":
                    name = ev.get("name", "")
                    kind = name.split(":", 1)[1] if ":" in name else name
                    s = by_sid[ev["id"]] = _Session(ev["id"], kind)
                    s.arrival_ns = ev["ts"] * _US_TO_NS
                elif ph == "e":
                    s = by_sid.get(ev["id"])
                    if s is not None:
                        s.done_ns = ev["ts"] * _US_TO_NS
                        args = ev.get("args") or {}
                        s.timed_out = bool(args.get("timed_out"))
                        s.rejected = bool(args.get("rejected"))
                        s.cancelled = bool(args.get("cancelled"))
                elif ph == "i" and ev.get("name", "").startswith("admit s"):
                    sid = int(ev["name"][len("admit s"):])
                    s = by_sid.get(sid)
                    if s is not None:
                        s.admit_ns = ev["ts"] * _US_TO_NS
            elif pid == PID_FTL and ph == "X":
                t0 = ev["ts"] * _US_TO_NS
                gc_iv.append((t0, t0 + ev.get("dur", 0.0) * _US_TO_NS))
            elif pid == PID_RELIABILITY and ph == "X":
                t0 = ev["ts"] * _US_TO_NS
                rec_iv.append((t0, t0 + ev.get("dur", 0.0) * _US_TO_NS))
            elif pid == PID_HOST_IO:
                if ph == "b":
                    self.io_requests.add(ev.get("id"))
                elif ph == "i" and ev.get("name", "").startswith("io-timeout"):
                    self.io_timeouts += 1
        self.sessions = [s for s in by_sid.values() if s.done_ns is not None]
        self.gc_union = _merge(gc_iv)
        self.rec_union = _merge(rec_iv)

        self.ops_by_tenant: Dict[str, List[dict]] = {}
        for o in self.ops:
            self.ops_by_tenant.setdefault(o["tenant"], []).append(o)

    def blame_windows(self) -> List[Tuple[str, float, float, float, bool]]:
        """(tenant-key, arrival, admit, done, timed_out) per analyzable
        window.  Serving traces use real sessions; traces without a
        session stream (single-tenant / mix runs) fall back to one
        pseudo-session per tenant spanning its dispatch activity."""
        if self.sessions:
            return [(s.tenant, s.arrival_ns,
                     s.admit_ns if s.admit_ns is not None else s.arrival_ns,
                     s.done_ns, s.timed_out)
                    for s in self.sessions
                    if not s.rejected and not s.cancelled
                    and s.done_ns > s.arrival_ns]
        out = []
        for tenant, ops in sorted(self.ops_by_tenant.items()):
            arrival = min(o["t_decide_ns"] for o in ops)
            done = max(o["end_ns"] for o in ops)
            if done > arrival:
                out.append((tenant, arrival, arrival, done, False))
        return out


# -- product 1: tail-latency blame ---------------------------------------------

_PHASE_NAMES = ("decide", "dep_wait", "dm", "queue", "compute")
#: occupancy beats waiting: a segment where an op computes is compute
#: time even if another phase interval of the same session overlaps it
_PRIORITY = ("compute", "dm", "queue", "decide", "dep_wait")


def _sweep(ops: List[dict], admit: float, done: float,
           gc_union: List[Tuple[float, float]],
           rec_union: List[Tuple[float, float]]
           ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Blame the [admit, done] window: elementary-segment sweep over the
    ops' phase intervals; returns (components, queue_ns_by_pool).  The
    components (sans admission_wait) sum to ``done - admit`` exactly."""
    comp = {k: 0.0 for k in COMPONENTS if k != "admission_wait"}
    qpool: Dict[str, float] = {}
    if done <= admit:
        return comp, qpool

    # (+1/-1) edge events per phase interval, clipped to the window
    edges: List[Tuple[float, int, str, Optional[str]]] = []
    for o in ops:
        bounds = (o["t_decide_ns"], o["decide_end_ns"], o["ready_ns"],
                  o["move_end_ns"], o["start_ns"], o["end_ns"])
        res = o.get("resource")
        for ph, a, b in zip(_PHASE_NAMES, bounds, bounds[1:]):
            a, b = max(a, admit), min(b, done)
            if b > a:
                edges.append((a, 1, ph, res))
                edges.append((b, -1, ph, res))
    for name, union in (("gc", gc_union), ("recovery", rec_union)):
        for a, b in union:
            a, b = max(a, admit), min(b, done)
            if b > a:
                edges.append((a, 1, name, None))
                edges.append((b, -1, name, None))

    cuts = sorted({admit, done} | {t for t, _, _, _ in edges})
    # edges grouped by timestamp: ends applied before the segment that
    # starts at their timestamp, starts applied before it too (an edge
    # at t affects [t, next) for starts and stops affecting it for ends)
    edges.sort(key=lambda e: (e[0], e[1]))
    active = {ph: 0 for ph in _PRIORITY}
    active["gc"] = active["recovery"] = 0
    qres: Dict[str, int] = {}
    ei, ne = 0, len(edges)
    for i in range(len(cuts) - 1):
        t0, t1 = cuts[i], cuts[i + 1]
        while ei < ne and edges[ei][0] <= t0:
            _, delta, ph, res = edges[ei]
            active[ph] += delta
            if ph == "queue" and res is not None:
                qres[res] = qres.get(res, 0) + delta
            ei += 1
        dt = t1 - t0
        winner = None
        for ph in _PRIORITY:
            if active[ph] > 0:
                winner = ph
                break
        blocked = winner in ("queue", "dm", "dep_wait") or winner is None
        if blocked and active["recovery"] > 0:
            label = "recovery"
        elif blocked and active["gc"] > 0:
            label = "gc"
        elif winner is None:
            label = "other"
        else:
            label = winner
        comp[label] += dt
        if label == "queue":
            pools = sorted(r for r, c in qres.items() if c > 0)
            if pools:
                qpool[pools[0]] = qpool.get(pools[0], 0.0) + dt
    return comp, qpool


def session_blame(trace_or_recorder: Any) -> List[Dict[str, Any]]:
    """Per-session blame rows: ``{tenant, latency_ns, components: {...},
    queue_by_pool_ns: {...}}`` with the accounting identity
    ``sum(components.values()) == latency_ns`` (exact by construction).
    """
    p = _Parsed(_as_trace(trace_or_recorder))
    rows = []
    for tenant, arrival, admit, done, timed_out in p.blame_windows():
        ops = p.ops_by_tenant.get(tenant, [])
        comp, qpool = _sweep(ops, admit, done, p.gc_union, p.rec_union)
        comp = dict(comp)
        comp["admission_wait"] = admit - arrival
        rows.append({"tenant": tenant, "latency_ns": done - arrival,
                     "timed_out": timed_out, "components": comp,
                     "queue_by_pool_ns": qpool})
    return rows


# -- product 2: critical path + pool ranking -----------------------------------

def critical_path(trace_or_recorder: Any, tenant: Optional[str] = None,
                  max_hops: int = 64) -> Dict[str, Any]:
    """Longest dependent chain ending at a tenant's last-finishing op.

    ``tenant=None`` picks the worst blame window (max latency).  A hop
    follows the gating dependency when the op waited on one
    (``ready > decide_end``), else the program-order predecessor — the
    in-order pipeline is itself a dependence.  Each hop carries the
    resource and the phase breakdown, so the path reads as "where the
    tail was built"."""
    p = _Parsed(_as_trace(trace_or_recorder))
    if tenant is None:
        windows = p.blame_windows()
        if not windows:
            return {"tenant": None, "latency_ns": 0.0, "n_hops": 0,
                    "hops": []}
        tenant = max(windows, key=lambda w: w[3] - w[1])[0]
    ops = {o["iid"]: o for o in p.ops_by_tenant.get(tenant, [])}
    if not ops:
        return {"tenant": tenant, "latency_ns": 0.0, "n_hops": 0,
                "hops": []}
    cur = max(ops.values(), key=lambda o: o["end_ns"])
    first = min(ops.values(), key=lambda o: o["t_decide_ns"])
    hops: List[dict] = []
    truncated = False
    while cur is not None:
        if len(hops) >= max_hops:
            truncated = True
            break
        dep_gated = cur["ready_ns"] > cur["decide_end_ns"]
        hops.append({
            "iid": cur["iid"], "op": cur["op"],
            "resource": cur["resource"], "dep_gated": dep_gated,
            "decide_ns": cur["decide_end_ns"] - cur["t_decide_ns"],
            "dep_wait_ns": cur["ready_ns"] - cur["decide_end_ns"],
            "dm_ns": cur["move_end_ns"] - cur["ready_ns"],
            "queue_ns": cur["start_ns"] - cur["move_end_ns"],
            "compute_ns": cur["end_ns"] - cur["start_ns"],
        })
        nxt = None
        if dep_gated:
            deps = [ops[d] for d in cur.get("deps", ()) if d in ops]
            if deps:
                # the dep that released the op: latest end, ties to the
                # smallest iid for determinism
                nxt = max(deps, key=lambda o: (o["end_ns"], -o["iid"]))
        if nxt is None and cur["iid"] - 1 in ops:
            nxt = ops[cur["iid"] - 1]
        cur = nxt
    hops.reverse()
    span_ns = (max(o["end_ns"] for o in ops.values())
               - first["t_decide_ns"])
    return {"tenant": tenant, "latency_ns": span_ns,
            "n_hops": len(hops), "truncated": truncated, "hops": hops}


def pool_rankings(trace_or_recorder: Any,
                  p99_instants_ns: Iterable[float] = ()
                  ) -> List[Dict[str, Any]]:
    """Per-pool bottleneck ranking from the interval sampler stream:
    time-weighted queue depth, mean utilization, and utilization at the
    given instants (pass the p99 cohort's completion times).  Empty when
    the sampler was off — degrade, don't crash."""
    p = _Parsed(_as_trace(trace_or_recorder))
    samples = p.intervals
    if not samples:
        return []
    times = [s["t_ns"] for s in samples]
    # weight sample i by the interval it closed (first: from t=0)
    weights = [times[0]] + [t1 - t0 for t0, t1 in zip(times, times[1:])]
    total_w = sum(weights) or 1.0
    qd: Dict[str, float] = {}
    util: Dict[str, float] = {}
    n_util: Dict[str, float] = {}
    for s, w in zip(samples, weights):
        for pool, v in (s.get("queue_depth_ns") or {}).items():
            qd[pool] = qd.get(pool, 0.0) + v * w
        for pool, v in (s.get("utilization") or {}).items():
            util[pool] = util.get(pool, 0.0) + v * w
            n_util[pool] = n_util.get(pool, 0.0) + w
    at_p99: Dict[str, float] = {}
    instants = sorted(p99_instants_ns)
    if instants:
        counts: Dict[str, int] = {}
        for t in instants:
            # nearest sample to the completion instant
            s = min(samples, key=lambda x: abs(x["t_ns"] - t))
            for pool, v in (s.get("utilization") or {}).items():
                at_p99[pool] = at_p99.get(pool, 0.0) + v
                counts[pool] = counts.get(pool, 0) + 1
        at_p99 = {k: v / counts[k] for k, v in at_p99.items()}
    pools = sorted(qd, key=lambda k: -qd[k])
    return [{"pool": k,
             "queue_depth_ns_tw": qd[k] / total_w,
             "util_mean": (util.get(k, 0.0) / n_util[k]
                           if n_util.get(k) else 0.0),
             "util_at_p99": at_p99.get(k, 0.0)}
            for k in pools]


# -- fleet analysis: split merged traces, blame the fleet tail ------------------

def split_fleet_trace(trace_or_obj: Any) -> Dict[int, Dict[str, Any]]:
    """Invert :func:`repro_torch.sim.telemetry.merge_fleet_trace`: one merged
    fleet trace → ``{drive_id: per-drive trace}`` with base pids
    restored, ``d{k}:`` process prefixes and ``d{k}/`` async-id prefixes
    stripped, and the tagged ``otherData`` record streams filtered back
    to their drives.  Each returned trace is a normal single-drive trace
    every analysis in this module accepts."""
    trace = _as_trace(trace_or_obj)
    other = trace.get("otherData") or {}
    meta = other.get("meta") or {}
    drive_metas = meta.get("drives") or []
    per: Dict[int, Dict[str, Any]] = {}

    def bucket(k: int) -> Dict[str, Any]:
        if k not in per:
            dm = drive_metas[k] if k < len(drive_metas) else {}
            per[k] = {
                "traceEvents": [],
                "displayTimeUnit": "ns",
                "otherData": {
                    "schema": other.get("schema"),
                    # engine event counts are summed fleet-wide by the
                    # merge and not recoverable per drive
                    "event_counts": {},
                    "audit": [], "intervals": [], "breakdown": [],
                    "ops": [], "meta": dict(dm),
                    "dropped_spans": 0, "dropped_audit": 0,
                    "dropped_ops": 0,
                }}
        return per[k]

    for ev in trace.get("traceEvents") or []:
        pid = ev.get("pid")
        if not isinstance(pid, int):
            continue
        k, base = divmod(pid, 10)
        ev = dict(ev)
        ev["pid"] = base
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            name = (ev.get("args") or {}).get("name", "")
            if isinstance(name, str) and name.startswith("d") \
                    and ":" in name:
                ev["args"] = {"name": name.split(":", 1)[1]}
        if ev.get("ph") in ("b", "e"):
            i = ev.get("id")
            prefix = f"d{k}/"
            if isinstance(i, str) and i.startswith(prefix):
                raw = i[len(prefix):]
                # sids / request ids were ints before the merge
                ev["id"] = (int(raw) if raw.lstrip("-").isdigit()
                            else raw)
        bucket(k)["traceEvents"].append(ev)
    for name in ("audit", "intervals", "breakdown", "ops"):
        for rec in other.get(name) or []:
            k = rec.get("drive", 0)
            rec = dict(rec)
            rec.pop("drive", None)
            bucket(k)["otherData"][name].append(rec)
    return per


def fleet_blame(fleet_trace: Any) -> Dict[str, Any]:
    """Which drive — and which component on it — built the fleet tail.

    Accepts a merged fleet trace (dict or path-loaded object) or the
    ``FleetResult.telemetry`` list of per-drive recorders.  The fleet
    p99 is *sample-merged* across drives
    (:func:`repro_torch.sim.stats.merged_percentile`); each drive is then
    scored by its share of the fleet's tail sessions (latency ≥ fleet
    p99), and its tail sessions' blame components
    (:func:`session_blame`) name the mechanism.  The ``straggler`` entry
    is the drive with the largest tail share — ties broken by p99."""
    if isinstance(fleet_trace, (list, tuple)):
        from repro_torch.sim.telemetry import merge_fleet_trace
        fleet_trace = merge_fleet_trace(list(fleet_trace))
    from repro_torch.sim.stats import merged_percentile, percentile
    per = split_fleet_trace(fleet_trace)
    rows_by_drive: Dict[int, List[dict]] = {}
    for k, t in sorted(per.items()):
        rows_by_drive[k] = [r for r in session_blame(t)
                            if not r["timed_out"]]
    fleet_p99 = merged_percentile(
        [[r["latency_ns"] for r in rows] for rows in
         rows_by_drive.values()], 99)
    per_drive: List[Dict[str, Any]] = []
    for k in sorted(rows_by_drive):
        rows = rows_by_drive[k]
        lats = [r["latency_ns"] for r in rows]
        tail = [r for r in rows if r["latency_ns"] >= fleet_p99]
        comp: Dict[str, float] = {}
        for r in tail:
            for c, v in r["components"].items():
                comp[c] = comp.get(c, 0.0) + v
        per_drive.append({
            "drive": k,
            "n_sessions": len(lats),
            "p50_ns": percentile(lats, 50),
            "p99_ns": percentile(lats, 99),
            "tail_sessions": len(tail),
            "dominant_component": (max(sorted(comp), key=comp.get)
                                   if comp else None),
            "tail_components_ns": {c: round(v, 1)
                                   for c, v in sorted(comp.items())},
        })
    n_tail = sum(d["tail_sessions"] for d in per_drive)
    for d in per_drive:
        d["tail_share"] = (d["tail_sessions"] / n_tail) if n_tail else 0.0
    straggler = (max(per_drive,
                     key=lambda d: (d["tail_share"], d["p99_ns"]))
                 if per_drive else None)
    return {
        "schema": "conduit-fleet-analysis/v1",
        "n_drives": len(per_drive),
        "fleet_p99_ns": fleet_p99,
        "per_drive": per_drive,
        "straggler": straggler,
    }


# -- product 3: structured report + cross-run diff -----------------------------

def _git_sha() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def _pctl(values: List[float], p: float) -> float:
    from repro_torch.sim.stats import percentile
    return percentile(values, p)


def build_report(trace_or_recorder: Any,
                 git_sha: Optional[str] = None) -> Dict[str, Any]:
    """The full ``conduit-analysis/v1`` run report (see module doc).

    Raises ``ValueError`` on a structurally invalid trace — the
    round-trip law is that everything ``telemetry validate`` accepts is
    analyzable, and nothing it rejects is."""
    trace = _as_trace(trace_or_recorder)
    errors = validate_trace(trace)
    if errors:
        raise ValueError("invalid trace: " + "; ".join(errors[:5]))
    p = _Parsed(trace)
    rows = session_blame(trace)

    lats = [r["latency_ns"] for r in rows]
    p99 = _pctl(lats, 99.0) if lats else 0.0
    cohort = [r for r in rows if r["latency_ns"] >= p99] if lats else []
    cohort_done: List[float] = []
    done_by_tenant = {s.tenant: s.done_ns for s in p.sessions}
    for r in cohort:
        d = done_by_tenant.get(r["tenant"])
        if d is not None:
            cohort_done.append(d)

    def _blame_agg(rs: List[dict]) -> Dict[str, Any]:
        totals = {c: sum(r["components"].get(c, 0.0) for r in rs)
                  for c in COMPONENTS}
        lat_sum = sum(r["latency_ns"] for r in rs)
        share = {c: (v / lat_sum if lat_sum > 0 else 0.0)
                 for c, v in totals.items()}
        return {"totals_ns": totals, "share": share}

    blame = _blame_agg(rows)
    blame["components"] = list(COMPONENTS)
    blame["p99_cohort"] = dict(_blame_agg(cohort), n=len(cohort),
                               threshold_ns=p99)

    qpool: Dict[str, float] = {}
    for r in rows:
        for pool, v in r["queue_by_pool_ns"].items():
            qpool[pool] = qpool.get(pool, 0.0) + v

    mix: Dict[str, int] = {}
    n_replayed = n_midrec = 0
    for a in p.audit:
        mix[a["chosen"]] = mix.get(a["chosen"], 0) + 1
        n_replayed += bool(a.get("replayed"))
        n_midrec += bool(a.get("mid_recovery"))

    meta = dict(p.meta)
    meta["git_sha"] = git_sha if git_sha is not None else _git_sha()
    return {
        "schema": REPORT_SCHEMA,
        "meta": meta,
        "sessions": {
            "n": len(rows),
            "n_timed_out": sum(r["timed_out"] for r in rows),
            "n_rejected": sum(1 for s in p.sessions if s.rejected),
            "mean_ns": sum(lats) / len(lats) if lats else 0.0,
            "p50_ns": _pctl(lats, 50.0) if lats else 0.0,
            "p99_ns": p99,
        },
        "blame": blame,
        "queue_by_pool_ns": qpool,
        "critical_path": critical_path(trace),
        "pools": pool_rankings(trace, cohort_done),
        "decisions": {"n": len(p.audit), "mix": mix,
                      "replayed": n_replayed, "mid_recovery": n_midrec},
        "host_io": {"n_requests": len(p.io_requests),
                    "n_timeouts": p.io_timeouts},
    }


def blame_story(report: Dict[str, Any]) -> str:
    """Name the tail programmatically: which blame component grew most
    from the average session to the p99 cohort — the walkthrough's
    'the GC pause IS the tail' conclusion, as a function."""
    share = report["blame"]["share"]
    p99 = report["blame"]["p99_cohort"]["share"]
    deltas = {c: p99.get(c, 0.0) - share.get(c, 0.0) for c in COMPONENTS}
    worst = max(deltas, key=lambda c: deltas[c])
    lines = [f"  {'component':<16} {'all sessions':>14} {'p99 cohort':>12}"]
    for c in COMPONENTS:
        if share.get(c, 0.0) < 0.005 and p99.get(c, 0.0) < 0.005:
            continue
        mark = " <-- the tail" if c == worst and deltas[worst] > 0.0 else ""
        lines.append(f"  {c:<16} {share.get(c, 0.0):>13.1%} "
                     f"{p99.get(c, 0.0):>11.1%}{mark}")
    if deltas[worst] > 0.0:
        lines.append(
            f"  -> p99 sessions spend {p99.get(worst, 0.0):.1%} of their "
            f"wall time on '{worst}' vs {share.get(worst, 0.0):.1%} for "
            f"the average session: the tail is {worst}-built")
    return "\n".join(lines)


def _load_side(path: str) -> Tuple[Dict[str, Any], str]:
    """Load a diff operand: returns (report, source-kind).  A flight
    recorder trace is analyzed in place; a report passes through."""
    with open(path) as f:
        obj = json.load(f)
    schema = (obj.get("otherData") or {}).get("schema") \
        if "traceEvents" in obj else obj.get("schema")
    if schema == TRACE_SCHEMA:
        return build_report(obj), "trace"
    if obj.get("schema") == REPORT_SCHEMA:
        return obj, "report"
    raise ValueError(f"{path}: neither a {TRACE_SCHEMA} trace nor a "
                     f"{REPORT_SCHEMA} report")


def diff_reports(a: Dict[str, Any], b: Dict[str, Any],
                 tol_rel: Optional[float] = None) -> Dict[str, Any]:
    """Structured diff of two run reports.

    ``refusals`` lists reproducibility-metadata mismatches (hardware
    spec hash, policy, entry point) that make the comparison
    apples-to-oranges; ``breaches`` lists blame-share / p99 movements
    beyond ``tol_rel`` (relative, with a 1-point absolute floor on
    shares so noise in tiny components never gates CI)."""
    refusals = []
    ma, mb = a.get("meta") or {}, b.get("meta") or {}
    for key in _COMPARABLE_KEYS:
        va, vb = ma.get(key), mb.get(key)
        if va != vb:
            refusals.append(f"meta.{key} differs: {va!r} vs {vb!r}")

    sa, sb = a["blame"]["share"], b["blame"]["share"]
    share_delta = {c: sb.get(c, 0.0) - sa.get(c, 0.0) for c in COMPONENTS}
    p99a = a["sessions"]["p99_ns"]
    p99b = b["sessions"]["p99_ns"]
    p99_rel = (p99b - p99a) / p99a if p99a > 0 else 0.0

    ua = {r["pool"]: r["util_mean"] for r in a.get("pools") or []}
    ub = {r["pool"]: r["util_mean"] for r in b.get("pools") or []}
    util_delta = {k: ub.get(k, 0.0) - ua.get(k, 0.0)
                  for k in sorted(set(ua) | set(ub))}

    da, db = a["decisions"], b["decisions"]

    def _mix_share(d):
        n = d.get("n") or 0
        return {k: v / n for k, v in (d.get("mix") or {}).items()} \
            if n else {}

    mixa, mixb = _mix_share(da), _mix_share(db)
    mix_delta = {k: mixb.get(k, 0.0) - mixa.get(k, 0.0)
                 for k in sorted(set(mixa) | set(mixb))}

    breaches = []
    if tol_rel is not None:
        for c, d in share_delta.items():
            base = sa.get(c, 0.0)
            # relative gate with an absolute floor: a component moving
            # within one share-point never breaches
            if abs(d) > max(tol_rel * base, 0.01):
                breaches.append(
                    f"blame share '{c}': {base:.3f} -> {sb.get(c, 0.0):.3f}"
                    f" (|delta| {abs(d):.3f} > "
                    f"max({tol_rel:g}*{base:.3f}, 0.01))")
        if abs(p99_rel) > tol_rel:
            breaches.append(f"sessions.p99_ns moved {p99_rel:+.1%} "
                            f"(tolerance {tol_rel:.1%})")
    return {
        "schema": DIFF_SCHEMA,
        "comparable": not refusals,
        "refusals": refusals,
        "blame_share_delta": share_delta,
        "p99_ns": {"a": p99a, "b": p99b, "rel_delta": p99_rel},
        "pool_util_delta": util_delta,
        "decision_mix_delta": mix_delta,
        "breaches": breaches,
    }


# -- CLI -----------------------------------------------------------------------

def _print_report(r: Dict[str, Any], out: TextIO) -> None:
    s = r["sessions"]
    print(f"run report ({r['schema']}) — policy "
          f"{r['meta'].get('policy', '?')}, entry "
          f"{r['meta'].get('entry', '?')}, spec "
          f"{r['meta'].get('spec_sha', '?')}", file=out)
    print(f"  sessions: {s['n']} analyzed ({s['n_timed_out']} timed out, "
          f"{s['n_rejected']} rejected); mean {s['mean_ns']:.0f} ns, "
          f"p50 {s['p50_ns']:.0f}, p99 {s['p99_ns']:.0f}", file=out)
    print("  blame (share of wall time, all sessions vs p99 cohort):",
          file=out)
    print(blame_story(r), file=out)
    cp = r["critical_path"]
    if cp["n_hops"]:
        drivers = sorted(
            cp["hops"], key=lambda h: -(h["queue_ns"] + h["dep_wait_ns"]
                                        + h["dm_ns"]))[:3]
        dtxt = ", ".join(f"#{h['iid']} {h['op']}@{h['resource']}"
                         for h in drivers)
        print(f"  critical path: {cp['n_hops']} hops on "
              f"{cp['tenant']!r}; top wait hops: {dtxt}", file=out)
    for row in (r.get("pools") or [])[:3]:
        print(f"  bottleneck {row['pool']}: queue "
              f"{row['queue_depth_ns_tw']:.0f} ns (time-weighted), util "
              f"{row['util_mean']:.2f} mean / {row['util_at_p99']:.2f} "
              f"at p99 completions", file=out)
    d = r["decisions"]
    if d["n"]:
        mix = ", ".join(f"{k}:{v}" for k, v in sorted(d["mix"].items()))
        print(f"  decisions: {d['n']} audited ({mix}); "
              f"{d['replayed']} replayed, {d['mid_recovery']} mid-recovery",
              file=out)


def _print_diff(d: Dict[str, Any], out: TextIO) -> None:
    for r in d["refusals"]:
        print(f"REFUSED: {r}", file=out)
    p99 = d["p99_ns"]
    print(f"p99: {p99['a']:.0f} -> {p99['b']:.0f} ns "
          f"({p99['rel_delta']:+.1%})", file=out)
    movers = sorted(d["blame_share_delta"].items(),
                    key=lambda kv: -abs(kv[1]))
    for c, delta in movers[:5]:
        if abs(delta) >= 0.001:
            print(f"  blame '{c}' share {delta:+.1%}", file=out)
    for k, delta in sorted(d["decision_mix_delta"].items()):
        if abs(delta) >= 0.001:
            print(f"  decision mix '{k}' {delta:+.1%}", file=out)
    for b in d["breaches"]:
        print(f"BREACH: {b}", file=out)


def main(argv: Optional[List[str]] = None,
         out: TextIO = sys.stdout) -> int:
    """``python -m repro_torch.sim.analysis report|diff ...`` (see module doc)."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.sim.analysis",
        description=f"Analyze {TRACE_SCHEMA} traces: blame, critical "
                    f"paths, cross-run diffs ({REPORT_SCHEMA})")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("report", help="build a structured run report")
    pr.add_argument("trace", help="exported trace JSON")
    pr.add_argument("--out", help="also write the report JSON here")
    pr.add_argument("--json", action="store_true",
                    help="print the report as one compact JSON line")
    pd = sub.add_parser("diff", help="compare two runs (traces or reports)")
    pd.add_argument("a", help="baseline trace/report JSON")
    pd.add_argument("b", help="candidate trace/report JSON")
    pd.add_argument("--tol-rel", type=float, default=None,
                    help="gate: max relative blame-share / p99 movement "
                         "(omit = report-only, always exit 0 when "
                         "comparable)")
    pd.add_argument("--force", action="store_true",
                    help="compare despite reproducibility-metadata "
                         "mismatches (refusals become warnings)")
    pd.add_argument("--json", action="store_true",
                    help="print the diff as one compact JSON line")
    args = ap.parse_args(argv)

    if args.cmd == "report":
        try:
            with open(args.trace) as f:
                obj = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: cannot read {args.trace}: {e}", file=out)
            return 2
        try:
            rep = build_report(obj)
        except ValueError as e:
            print(f"error: {e}", file=out)
            return 1
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rep, f, indent=1, sort_keys=True)
        if args.json:
            print(json.dumps(rep, sort_keys=True, separators=(",", ":")),
                  file=out)
        else:
            _print_report(rep, out)
        return 0

    try:
        ra, _ = _load_side(args.a)
        rb, _ = _load_side(args.b)
    except (OSError, json.JSONDecodeError, ValueError) as e:
        print(f"error: {e}", file=out)
        return 2
    d = diff_reports(ra, rb, tol_rel=args.tol_rel)
    if args.json:
        print(json.dumps(d, sort_keys=True, separators=(",", ":")),
              file=out)
    else:
        _print_diff(d, out)
    if d["refusals"] and not args.force:
        print("refusing apples-to-oranges comparison (--force to "
              "override)", file=out)
        return 2
    return 1 if d["breaches"] else 0


if __name__ == "__main__":
    sys.exit(main())
