"""Parser for the Chrome-trace JSON that ``torch.profiler`` exports: the
reading half of the performance observatory (the port of
``gymfx_tpu/telemetry/trace_parse.py``).

:class:`~gymfx_tpu_torch.telemetry.profiler.ProfilerSession` writes one
``*.trace.json.gz`` into each capture bundle.  :func:`parse_trace` turns
it into the JAX package's summary: device and host lanes, per-op duration
totals, the device-busy interval union and the dispatch-gap window,
which :mod:`gymfx_tpu_torch.telemetry.attribution` reads.

Lane split: an "X" (complete) event is DEVICE work when its ``cat`` is
``kernel``, ``gpu_memcpy`` or ``gpu_memset``; it is HOST work when its
``cat`` is ``cpu_op``, ``user_annotation``, ``cuda_runtime`` or
``python_function``.  A trace with no device event (a run on the CPU)
takes its ``cpu_op`` events as the work: there the ops are the device.

Scope by launch, not by time: a kernel's phase is the phase of the host
range that launched it.  Its ``args.correlation`` leads to the runtime
event that launched it (``cudaGraphLaunch`` for every node of a replayed
CUDA graph, ``cudaLaunchKernel`` for an eager kernel), and that event
lies inside a ``torch.profiler.record_function("rollout")`` or
``("update")`` range of the same host thread.  When the two phases run
at once on two streams (the overlapped superstep), their kernels
interleave in time, but each still carries its launch's phase.  A CPU op
takes the phase of the range it runs in.  This stands in for the JAX
package's ``jax.named_scope`` labels and its HLO sidecar; the sidecar
(``scope_map.json``, op name -> scope) is still written and read, for
events whose launch carries no range (hand-built golden traces), and a
range's own scope beats it.

Never raises: a malformed capture yields ``ok=False`` and an empty
summary.
"""
from __future__ import annotations

import bisect
import gzip
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

# the phase ranges the trainers enter around each replay
PHASE_SCOPES = ("rollout", "update")

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")


def find_trace_files(root: str) -> List[str]:
    """Every ``*.trace.json(.gz)`` under ``root`` (a capture bundle, a
    profiler output dir, or one trace file), sorted."""
    try:
        base = Path(root)
        if base.is_file():
            return [str(base)]
        return sorted(str(p) for pattern in ("*.trace.json.gz", "*.trace.json")
                      for p in base.rglob(pattern))
    except Exception:
        return []


def _load_events(path: str) -> List[Dict[str, Any]]:
    raw = Path(path).read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    doc = json.loads(raw.decode("utf-8", errors="replace"))
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
    return [e for e in events if isinstance(e, dict)]


def _merged_span_us(intervals: List[Tuple[float, float]]) -> float:
    """Covered microseconds of the interval union (two streams' kernels
    overlap; a plain sum counts the overlap twice)."""
    total, end = 0.0, None
    for start, stop in sorted(intervals):
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def _empty_summary(error: Optional[str] = None) -> Dict[str, Any]:
    return {
        "ok": error is None,
        "error": error,
        "trace_files": [],
        "events": 0,
        "work": "device",
        "device_lanes": [],
        "host_lanes": [],
        "device_total_us": 0.0,
        "device_busy_us": 0.0,
        "window_us": 0.0,
        "host_total_us": 0.0,
        "ops": {},
        "host_ops": {},
        "phases": {},
        "launches": [],
    }


class _Ranges:
    """The phase ranges of one host thread, innermost first by start."""

    def __init__(self):
        self.spans: List[Tuple[float, float, str]] = []
        self._starts: List[float] = []

    def add(self, ts: float, dur: float, name: str) -> None:
        self.spans.append((ts, ts + dur, name))

    def seal(self) -> None:
        self.spans.sort()
        self._starts = [s for s, _, _ in self.spans]

    def scope_at(self, ts: float) -> Optional[str]:
        """The innermost range holding ``ts`` (the latest start)."""
        i = bisect.bisect_right(self._starts, ts)
        while i > 0:
            i -= 1
            start, stop, name = self.spans[i]
            if start <= ts <= stop:
                return name
        return None


def _number(value: Any) -> float:
    try:
        return float(value)
    except (TypeError, ValueError):
        return 0.0


def parse_trace(root: str, scopes: Sequence[str] = PHASE_SCOPES) -> Dict[str, Any]:
    """Aggregate one capture (bundle dir, output dir or a trace file) into
    a summary dict; never raises.

    ``ops`` maps a work op's name to ``{count, total_us, module, path,
    scope, by_scope}``: ``by_scope`` splits its count and time by the
    phase of each event's launch (key None: no phase range), ``scope`` is
    that phase when every event of the name has the same one.  Totals are
    SELF time for CPU ops (a nested op's children are taken out of its
    parent), whole durations for kernels.  ``host_ops`` aggregates the host
    events by name.  ``phases`` gives each phase's records, op time, busy
    union and span (first start to last stop); ``launches`` each launch
    of device work from a phase range: the runtime call, its phase and
    the records it produced (a graph replay: one launch, every node)."""
    try:
        files = find_trace_files(root)
        if not files:
            return _empty_summary(f"no trace files under {root!r}")
        processes: Dict[Any, str] = {}
        threads: Dict[Tuple[Any, Any], str] = {}
        device: List[list] = []       # [ts, dur, name, lane, args, lane key]
        cpu_ops: List[list] = []
        host_ops: Dict[str, Dict[str, Any]] = {}
        host_lanes: Dict[str, float] = {}
        ranges: Dict[Tuple[Any, Any, Any], _Ranges] = {}
        runtime: Dict[Any, Tuple[Any, Any, Any, float, str]] = {}
        n_events = 0
        parsed_any = False
        for path in files:
            try:
                events = _load_events(path)
            except Exception:
                continue
            parsed_any = True
            for ev in events:
                if ev.get("ph") != "M":
                    continue
                args = ev.get("args") or {}
                if ev.get("name") == "process_name":
                    processes[(path, ev.get("pid"))] = str(args.get("name", ""))
                elif ev.get("name") == "thread_name":
                    threads[(path, ev.get("pid"), ev.get("tid"))] = str(args.get("name", ""))
            for ev in events:
                if ev.get("ph") != "X":
                    continue
                n_events += 1
                cat = str(ev.get("cat", "")).lower()
                args = ev.get("args") or {}
                pid, tid = ev.get("pid"), ev.get("tid")
                key = (path, pid, tid)
                lane = (f"{processes.get((path, pid), str(pid))}/"
                        f"{threads.get(key, str(tid))}")
                name = str(ev.get("name", "?"))
                ts, dur = _number(ev.get("ts", 0.0)), _number(ev.get("dur", 0.0))
                row = [ts, dur, name, lane, args, key]
                if cat in DEVICE_CATS:
                    device.append(row)
                    continue
                if cat not in HOST_CATS:
                    continue
                hop = host_ops.setdefault(name, {"count": 0, "total_us": 0.0})
                hop["count"] += 1
                hop["total_us"] += dur
                host_lanes[lane] = host_lanes.get(lane, 0.0) + dur
                if cat == "user_annotation" and name in scopes:
                    ranges.setdefault(key, _Ranges()).add(ts, dur, name)
                elif cat == "cuda_runtime" and "correlation" in args:
                    runtime[(path, args["correlation"])] = (path, pid, tid, ts, name)
                elif cat == "cpu_op":
                    cpu_ops.append(row)
        if not parsed_any:
            return _empty_summary(f"unparseable trace files under {root!r}")
        for r in ranges.values():
            r.seal()

        def range_scope(key, ts) -> Optional[str]:
            r = ranges.get(key)
            return None if r is None else r.scope_at(ts)

        work, kind = (device, "device") if device else (cpu_ops, "cpu_op")
        launches: Dict[Tuple[Any, Any], Dict[str, Any]] = {}
        for row in work:
            ts, args, key = row[0], row[4], row[5]
            if kind == "cpu_op":
                row.append(range_scope(key, ts))
                continue
            launch = runtime.get((key[0], args.get("correlation")))
            scope = None
            if launch is not None:
                scope = range_scope(launch[:3], launch[3])
                if scope is not None:
                    entry = launches.setdefault((key[0], args.get("correlation")), {
                        "launch": launch[4], "scope": scope, "ts": launch[3], "records": 0})
                    entry["records"] += 1
            row.append(scope)
        # self time per lane: a CPU op's directly contained children leave
        # its total; kernels do not nest (one that starts before the one
        # before it on its stream ends, a programmatic dependent launch,
        # keeps its whole duration)
        nested = kind == "cpu_op"
        per_lane: Dict[Any, List[list]] = {}
        for row in work:
            per_lane.setdefault(row[5], []).append(row)
        ops: Dict[str, Dict[str, Any]] = {}
        device_lanes: Dict[str, float] = {}
        phases: Dict[str, Dict[str, Any]] = {}
        intervals: List[Tuple[float, float]] = []
        for rows in per_lane.values():
            rows.sort(key=lambda e: (e[0], -e[1]))
            stack: List[list] = []
            frames = []
            for row in rows:
                ts, dur = row[0], row[1]
                while stack and stack[-1][0] <= ts:
                    stack.pop()
                if stack and nested:
                    stack[-1][1] += dur
                frame = [ts + dur, 0.0]
                intervals.append((ts, ts + dur))
                stack.append(frame)
                frames.append((row, frame))
            for (ts, dur, name, lane, args, _key, scope), frame in frames:
                self_us = max(0.0, dur - frame[1])
                op = ops.setdefault(name, {"count": 0, "total_us": 0.0, "module": None,
                                           "path": None, "scope": scope, "by_scope": {}})
                op["count"] += 1
                op["total_us"] += self_us
                if op["scope"] != scope:
                    op["scope"] = None
                split = op["by_scope"].setdefault(scope, {"count": 0, "total_us": 0.0})
                split["count"] += 1
                split["total_us"] += self_us
                device_lanes[lane] = device_lanes.get(lane, 0.0) + self_us
                if scope is not None:
                    ph = phases.setdefault(scope, {"records": 0, "op_us": 0.0, "spans": []})
                    ph["records"] += 1
                    ph["op_us"] += self_us
                    ph["spans"].append((ts, ts + dur))
        for ph in phases.values():
            spans = ph.pop("spans")
            ph["busy_us"] = _merged_span_us(spans)
            ph["span_us"] = max(s for _, s in spans) - min(s for s, _ in spans)
        window = 0.0
        if intervals:
            window = max(s for _, s in intervals) - min(s for s, _ in intervals)
        return {
            "ok": True,
            "error": None,
            "trace_files": files,
            "events": n_events,
            "work": kind,
            "device_lanes": sorted(device_lanes),
            "host_lanes": sorted(host_lanes),
            "device_total_us": sum(op["total_us"] for op in ops.values()),
            "device_busy_us": _merged_span_us(intervals),
            "window_us": window,
            "host_total_us": sum(op["total_us"] for op in host_ops.values()),
            "ops": ops,
            "host_ops": host_ops,
            "phases": phases,
            "launches": sorted(launches.values(), key=lambda e: e["ts"]),
        }
    except Exception as exc:  # the never-raises floor
        return _empty_summary(f"trace parse failed: {exc!r}")


def scope_map_from_summary(summary: Dict[str, Any],
                           scopes: Sequence[str] = PHASE_SCOPES) -> Dict[str, str]:
    """``{op name: scope}`` for every op whose events all came from one
    phase: the ``scope_map.json`` sidecar a capture bundle carries."""
    try:
        return {name: op["scope"] for name, op in (summary.get("ops") or {}).items()
                if op.get("scope") in scopes}
    except Exception:
        return {}


def event_scope(scope: Optional[str], name: str, scope_map: Optional[Dict[str, str]],
                scopes: Sequence[str] = PHASE_SCOPES) -> Optional[str]:
    """The phase of a share of op ``name``'s events: their launch's range, else
    the sidecar's entry for ``name`` (an op path reduced to its phase
    component), else None."""
    if scope in scopes:
        return scope
    mapped = (scope_map or {}).get(name)
    if mapped is not None and mapped not in scopes:
        mapped = next((part for part in str(mapped).split("/") if part in scopes), None)
    return mapped


def group_by_scope(summary: Dict[str, Any], scope_map: Optional[Dict[str, str]] = None,
                   scopes: Sequence[str] = PHASE_SCOPES) -> Dict[str, float]:
    """Work time (us) per phase: ``{scope: us, ..., "unattributed": us}``;
    an event's phase is its launch's range, else the sidecar's entry for
    its name, else none."""
    groups: Dict[str, float] = {scope: 0.0 for scope in scopes}
    groups["unattributed"] = 0.0
    try:
        for name, op in (summary.get("ops") or {}).items():
            split = op.get("by_scope") or {op.get("scope"): {"total_us": op.get("total_us", 0.0)}}
            for scope, part in split.items():
                scope = event_scope(scope, name, scope_map, scopes)
                groups[scope if scope in scopes else "unattributed"] += float(
                    part.get("total_us", 0.0))
    except Exception:
        pass
    return groups
