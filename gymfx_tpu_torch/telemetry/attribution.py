"""Measured attribution: a capture bundle -> the schema-pinned profile
report (the port of ``gymfx_tpu/telemetry/attribution.py``).

:func:`build_profile_report` reads one bundle
(:mod:`gymfx_tpu_torch.telemetry.profiler`), parses its trace
(:mod:`gymfx_tpu_torch.telemetry.trace_parse`) and reconciles what the
card measured with what the run inferred: the
``bench_util.measure_phase_split`` baseline in the manifest and the
analytic FLOP model (:mod:`gymfx_tpu_torch.telemetry.mfu`).  The report:

  * ``trace``          device and host lanes, busy and window time, the
                       dispatch gap, and the top-N kernel table: one row
                       a (kernel, phase) with its launch count;
  * ``phases``         device time by phase, each kernel in the phase of
                       the range that launched it; ``busy_ms`` (the
                       union of the device intervals), ``phase_sum_ms``
                       and ``overlap_share`` = 1 - busy / op time, the
                       share of device time that ran beside other device
                       work (0 when the phases run one after the other,
                       more under the overlapped superstep, where the
                       phases sum to more than the busy union); and
                       ``detail``: each phase's records, op ms, busy ms,
                       span ms (first start to last stop) and launches;
  * ``reconciliation`` the trace's phase fractions against the
                       manifest's phase split, with a tolerance verdict;
  * ``mfu_measured``   FLOPs over measured device time, against
                       ``mfu.hw_flops_peak`` (None off the H100).

:func:`validate_profile_report` holds a report to the port's copy of
``profile_report_schema.json``; :func:`compare_profile_reports` diffs two
reports at a per-kernel regression threshold.  ``trace.fusion_coverage``
is null here: the port has no XLA fusions (the schema's ``_comment``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from gymfx_tpu_torch.telemetry.profiler import MANIFEST_NAME, SCOPE_MAP_NAME
from gymfx_tpu_torch.telemetry.trace_parse import (
    PHASE_SCOPES,
    event_scope,
    group_by_scope,
    parse_trace,
)

SCHEMA_PATH = Path(__file__).resolve().parent / "profile_report_schema.json"

PROFILE_REPORT_SCHEMA_VERSION = 1

# the trace's rollout fraction within this of the phase split's
DEFAULT_TOLERANCE = 0.25

_MANIFEST_ECHO_KEYS = (
    "config_sha256", "it_start", "k", "it_end", "label", "platform", "device_kind", "comparable",
    "hw_flops_peak", "algo", "n_envs", "horizon", "steps_per_iter", "fingerprints",
)


def _round(value: Optional[float], digits: int = 4) -> Optional[float]:
    return None if value is None else round(float(value), digits)


def _load_json(path: Path) -> Dict[str, Any]:
    try:
        doc = json.loads(path.read_text(encoding="utf-8"))
        return doc if isinstance(doc, dict) else {}
    except Exception:
        return {}


def build_profile_report(capture_dir: str, *, top_n: int = 15,
                         tolerance: float = DEFAULT_TOLERANCE,
                         scopes: Sequence[str] = PHASE_SCOPES) -> Dict[str, Any]:
    """One capture bundle -> the report dict (never raises; a broken
    bundle gives ``trace.ok=False`` and null attribution)."""
    bundle = Path(capture_dir)
    manifest = _load_json(bundle / MANIFEST_NAME)
    scope_map = _load_json(bundle / str(manifest.get("scope_map_file") or SCOPE_MAP_NAME))
    summary = parse_trace(str(bundle), scopes=scopes)
    groups = group_by_scope(summary, scope_map, scopes=scopes)

    k = manifest.get("k")
    k = int(k) if isinstance(k, (int, float)) and k else 1
    busy_ms = summary["device_busy_us"] / 1e3
    window_ms = summary["window_us"] / 1e3
    gap_ms = max(0.0, window_ms - busy_ms)
    total_op_ms = summary["device_total_us"] / 1e3

    rows = []
    for name, op in (summary.get("ops") or {}).items():
        split = op.get("by_scope") or {op.get("scope"): {"count": op["count"],
                                                         "total_us": op["total_us"]}}
        merged: Dict[Optional[str], List[float]] = {}
        for scope, part in split.items():
            scope = event_scope(scope, name, scope_map, scopes)
            acc = merged.setdefault(scope, [0, 0.0])
            acc[0] += int(part.get("count", 0))
            acc[1] += float(part.get("total_us", 0.0))
        rows += [(name, scope, count, us) for scope, (count, us) in merged.items()]
    rows.sort(key=lambda r: r[3], reverse=True)
    top_kernels = []
    for name, scope, count, us in rows[: max(0, int(top_n))]:
        ms = us / 1e3
        top_kernels.append({
            "name": name,
            "count": int(count),
            "total_ms": _round(ms),
            "total_ms_per_step": _round(ms / k),
            "frac": _round(ms / total_op_ms if total_op_ms else 0.0),
            "scope": scope,
        })

    # -- phases: device time by the range that launched it --------------
    phase_ms = {scope: groups.get(scope, 0.0) / 1e3 for scope in scopes}
    unattributed_ms = groups.get("unattributed", 0.0) / 1e3
    attributed_ms = sum(phase_ms.values())
    rollout_ms, update_ms = phase_ms.get("rollout", 0.0), phase_ms.get("update", 0.0)
    rollout_frac = update_frac = None
    if attributed_ms > 0:
        rollout_frac, update_frac = rollout_ms / attributed_ms, update_ms / attributed_ms
    detail = {}
    for scope, ph in (summary.get("phases") or {}).items():
        detail[scope] = {
            "records": int(ph["records"]),
            "op_ms": _round(ph["op_us"] / 1e3),
            "busy_ms": _round(ph["busy_us"] / 1e3),
            "span_ms": _round(ph["span_us"] / 1e3),
            "launches": [{"launch": e["launch"], "records": e["records"]}
                         for e in summary.get("launches") or () if e["scope"] == scope],
        }
    phases = {
        "rollout_ms": _round(rollout_ms),
        "update_ms": _round(update_ms),
        "unattributed_ms": _round(unattributed_ms),
        "rollout_frac": _round(rollout_frac),
        "update_frac": _round(update_frac),
        "attributed_frac": _round(attributed_ms / total_op_ms if total_op_ms else 0.0),
        "busy_ms": _round(busy_ms),
        "phase_sum_ms": _round(total_op_ms),
        "overlap_share": _round(1.0 - busy_ms / total_op_ms if total_op_ms else None),
        "detail": detail,
    }

    # -- reconciliation against the phase-split baseline ----------------
    split = manifest.get("phase_split") or {}
    split_rollout, split_update = split.get("rollout_ms"), split.get("update_ms")
    split_rollout_frac = None
    if (isinstance(split_rollout, (int, float)) and isinstance(split_update, (int, float))
            and (split_rollout + split_update) > 0):
        split_rollout_frac = split_rollout / (split_rollout + split_update)
    err = within = None
    if split_rollout_frac is not None and rollout_frac is not None:
        err = abs(rollout_frac - split_rollout_frac)
        # relative to the split's fraction, floored at an absolute share so
        # a tiny phase cannot blow the ratio up
        within = bool(err <= float(tolerance) * max(split_rollout_frac, 0.05)
                      or err <= float(tolerance) * 0.5)
    reconciliation = {
        "split_rollout_ms": _round(split_rollout),
        "split_update_ms": _round(split_update),
        "split_rollout_frac": _round(split_rollout_frac),
        "trace_rollout_frac": _round(rollout_frac),
        "rollout_frac_abs_err": _round(err),
        "tolerance": float(tolerance),
        "within_tolerance": within,
        "split_source": split.get("source"),
    }

    # -- measured MFU: FLOPs over measured device time ------------------
    device_ms_per_step = (busy_ms / k) if busy_ms > 0 else None
    xla_flops = manifest.get("xla_flops_per_step")
    analytic_flops = manifest.get("analytic_flops_per_step")
    flops = flops_source = None
    if isinstance(xla_flops, (int, float)) and xla_flops > 0:
        flops, flops_source = float(xla_flops), "xla"
    elif isinstance(analytic_flops, (int, float)) and analytic_flops > 0:
        flops, flops_source = float(analytic_flops), "analytic"
    achieved = None
    if flops is not None and device_ms_per_step:
        achieved = flops / (device_ms_per_step / 1e3)
    peak = manifest.get("hw_flops_peak")
    peak = float(peak) if isinstance(peak, (int, float)) and peak > 0 else None
    mfu_measured = {
        "device_ms_per_step": _round(device_ms_per_step),
        "flops_per_step": flops,
        "flops_source": flops_source,
        "achieved_flops_per_sec": _round(achieved, 1),
        "hw_flops_peak": peak,
        "mfu": _round(achieved / peak if achieved is not None and peak else None, 5),
    }
    analytic_mfu = None
    if (isinstance(analytic_flops, (int, float)) and analytic_flops > 0 and peak
            and device_ms_per_step):
        analytic_mfu = analytic_flops / (device_ms_per_step / 1e3) / peak
    mfu_analytic = {
        "analytic_flops_per_step": (float(analytic_flops)
                                    if isinstance(analytic_flops, (int, float)) else None),
        "hw_flops_peak": peak,
        "mfu_analytic": _round(analytic_mfu, 5),
    }

    return {
        "schema_version": PROFILE_REPORT_SCHEMA_VERSION,
        "capture_dir": str(bundle),
        "manifest": {key: manifest.get(key) for key in _MANIFEST_ECHO_KEYS},
        "trace": {
            "ok": bool(summary.get("ok")),
            "error": summary.get("error"),
            "events": int(summary.get("events", 0)),
            "work": summary.get("work"),
            "device_lanes": summary.get("device_lanes", []),
            "host_lanes": summary.get("host_lanes", []),
            "device_busy_ms": _round(busy_ms),
            "device_op_ms": _round(total_op_ms),
            "window_ms": _round(window_ms),
            "dispatch_gap_ms": _round(gap_ms),
            "dispatch_gap_frac": _round(gap_ms / window_ms if window_ms else None),
            "fusion_coverage": None,
            "top_kernels": top_kernels,
        },
        "phases": phases,
        "reconciliation": reconciliation,
        "mfu_measured": mfu_measured,
        "mfu_analytic": mfu_analytic,
    }


# ---------------------------------------------------------------------------
def load_profile_report_schema() -> Dict[str, Any]:
    with open(SCHEMA_PATH, encoding="utf-8") as fh:
        schema = json.load(fh)
    schema.pop("_comment", None)
    return schema


def validate_profile_report(report: Dict[str, Any],
                            schema: Optional[Dict[str, Any]] = None) -> List[str]:
    """The report's violations of the schema (empty: it conforms): the
    top-level sections, each section's required keys and each kernel
    row's (present; values may be null where the backend cannot say)."""
    if schema is None:
        schema = load_profile_report_schema()
    if not isinstance(report, dict):
        return ["report is not a JSON object"]
    problems: List[str] = []
    for key in schema.get("required", ()):
        if key not in report:
            problems.append(f"missing top-level key {key!r}")
    version = report.get("schema_version")
    if version != schema.get("schema_version"):
        problems.append(f"schema_version {version!r} != {schema.get('schema_version')!r}")
    for section, req_key in (("manifest", "manifest_required"), ("trace", "trace_required"),
                             ("phases", "phases_required"),
                             ("reconciliation", "reconciliation_required"),
                             ("mfu_measured", "mfu_measured_required"),
                             ("mfu_analytic", "mfu_analytic_required")):
        block = report.get(section)
        if not isinstance(block, dict):
            problems.append(f"section {section!r} is not an object")
            continue
        for key in schema.get(req_key, ()):
            if key not in block:
                problems.append(f"{section}: missing required key {key!r}")
    kernels = (report.get("trace") or {}).get("top_kernels")
    if isinstance(kernels, list):
        for i, row in enumerate(kernels):
            if not isinstance(row, dict):
                problems.append(f"top_kernels[{i}]: not an object")
                continue
            for key in schema.get("kernel_required", ()):
                if key not in row:
                    problems.append(f"top_kernels[{i}]: missing required key {key!r}")
    else:
        problems.append("trace.top_kernels is not a list")
    return problems


# ---------------------------------------------------------------------------
def compare_profile_reports(base: Dict[str, Any], new: Dict[str, Any], *,
                            threshold: float = DEFAULT_TOLERANCE,
                            min_ms: float = 0.05) -> Dict[str, Any]:
    """Per-kernel regression diff of two reports: a kernel (its rows of
    every phase summed) regresses when its time a step grows by more than
    ``threshold`` over the base (kernels under ``min_ms`` a step in the
    base are skipped as noise), and the device time a step is gated the
    same way.  ``ok`` is the verdict; ``comparable`` says whether both
    captures came from one platform and device kind."""

    def _kernels(report: Dict[str, Any]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for row in (report.get("trace") or {}).get("top_kernels") or []:
            ms = row.get("total_ms_per_step")
            if isinstance(row.get("name"), str) and isinstance(ms, (int, float)):
                out[row["name"]] = out.get(row["name"], 0.0) + float(ms)
        return out

    base_m, new_m = base.get("manifest") or {}, new.get("manifest") or {}
    comparable = (base_m.get("platform") == new_m.get("platform")
                  and base_m.get("device_kind") == new_m.get("device_kind"))
    base_k, new_k = _kernels(base), _kernels(new)
    regressions: List[Dict[str, Any]] = []
    improvements: List[Dict[str, Any]] = []
    for name in sorted(set(base_k) & set(new_k)):
        b, n = base_k[name], new_k[name]
        if b < float(min_ms):
            continue
        ratio = n / b if b > 0 else None
        entry = {"kind": "kernel", "name": name, "base_ms_per_step": round(b, 4),
                 "new_ms_per_step": round(n, 4),
                 "ratio": round(ratio, 4) if ratio is not None else None}
        if ratio is not None and ratio > 1.0 + float(threshold):
            regressions.append(entry)
        elif ratio is not None and ratio < 1.0 - float(threshold):
            improvements.append(entry)
    b_step = (base.get("mfu_measured") or {}).get("device_ms_per_step")
    n_step = (new.get("mfu_measured") or {}).get("device_ms_per_step")
    if isinstance(b_step, (int, float)) and isinstance(n_step, (int, float)) and b_step > 0:
        ratio = n_step / b_step
        entry = {"kind": "device_time", "name": "device_ms_per_step",
                 "base_ms_per_step": round(float(b_step), 4),
                 "new_ms_per_step": round(float(n_step), 4), "ratio": round(ratio, 4)}
        if ratio > 1.0 + float(threshold):
            regressions.append(entry)
        elif ratio < 1.0 - float(threshold):
            improvements.append(entry)
    return {
        "threshold": float(threshold),
        "min_ms": float(min_ms),
        "comparable": bool(comparable),
        "only_in_base": sorted(set(base_k) - set(new_k)),
        "only_in_new": sorted(set(new_k) - set(base_k)),
        "regressions": regressions,
        "improvements": improvements,
        "ok": not regressions,
    }
