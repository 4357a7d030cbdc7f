"""Turn a profiler capture bundle into the schema-pinned
``profile_report.json`` and a markdown summary, or diff two reports at a
per-kernel regression threshold (the port of ``tools/profile_report.py``).

Report (the newest bundle under the path)::

    python -m gymfx_tpu_torch.profile_report report RUNS/profile [--out R.json] [--top 20]

writes ``profile_report.json`` into the bundle (or ``--out``), prints the
phases, the reconciliation verdict, the measured MFU and the kernel table
(a row a kernel and phase), and exits 1 when the report fails
``validate_profile_report`` (2 when no bundle is found).

Compare::

    python -m gymfx_tpu_torch.profile_report compare BASE.json NEW.json \\
        [--threshold 0.25] [--min-ms 0.05]

prints the verdict JSON and exits 1 when a kernel's time a step (or the
device time a step) regressed past the threshold.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _fmt(value, digits=3, suffix=""):
    if value is None:
        return "-"
    if isinstance(value, float):
        return f"{value:.{digits}f}{suffix}"
    return f"{value}{suffix}"


def render_markdown(report: dict) -> str:
    manifest = report.get("manifest") or {}
    trace = report.get("trace") or {}
    phases = report.get("phases") or {}
    rec = report.get("reconciliation") or {}
    meas = report.get("mfu_measured") or {}
    split = rec.get("split_rollout_frac")
    lines = [
        f"## Profile report — {report.get('capture_dir')}",
        "",
        f"- platform/device: `{manifest.get('platform')}` / `{manifest.get('device_kind')}` "
        f"(comparable={manifest.get('comparable')})",
        f"- supersteps: [{manifest.get('it_start')}, {manifest.get('it_end')}) "
        f"(k={manifest.get('k')})",
        f"- trace: ok={trace.get('ok')} events={trace.get('events')} "
        f"device_busy={_fmt(trace.get('device_busy_ms'))}ms "
        f"window={_fmt(trace.get('window_ms'))}ms "
        f"dispatch_gap={_fmt(trace.get('dispatch_gap_ms'))}ms "
        f"({_fmt(trace.get('dispatch_gap_frac'), 3)} of window)",
        f"- overlap share: {_fmt(phases.get('overlap_share'), 4)} (phases sum "
        f"{_fmt(phases.get('phase_sum_ms'))}ms over a busy union of "
        f"{_fmt(phases.get('busy_ms'))}ms)",
        "",
        "| phase | trace ms | trace frac | split frac |",
        "|---|---|---|---|",
        f"| rollout | {_fmt(phases.get('rollout_ms'))} | {_fmt(phases.get('rollout_frac'), 3)} | "
        f"{_fmt(split, 3)} |",
        f"| update | {_fmt(phases.get('update_ms'))} | {_fmt(phases.get('update_frac'), 3)} | "
        f"{_fmt(1.0 - split, 3) if isinstance(split, float) else '-'} |",
        f"| unattributed | {_fmt(phases.get('unattributed_ms'))} | - | - |",
        "",
        f"- reconciliation: |Δrollout_frac|={_fmt(rec.get('rollout_frac_abs_err'), 4)} "
        f"(tolerance {_fmt(rec.get('tolerance'), 2)}) -> "
        f"within_tolerance={rec.get('within_tolerance')}",
        f"- mfu_measured: device={_fmt(meas.get('device_ms_per_step'))}ms/step, "
        f"flops/step={_fmt(meas.get('flops_per_step'), 0)} ({meas.get('flops_source')}), "
        f"achieved={_fmt(meas.get('achieved_flops_per_sec'), 0)} FLOP/s, "
        f"mfu={_fmt(meas.get('mfu'), 5)}",
        "",
        "| kernel | scope | count | ms/step | frac |",
        "|---|---|---|---|---|",
    ]
    for row in trace.get("top_kernels") or []:
        lines.append(f"| `{row.get('name')}` | {row.get('scope') or '-'} | {row.get('count')} | "
                     f"{_fmt(row.get('total_ms_per_step'))} | {_fmt(row.get('frac'), 3)} |")
    return "\n".join(lines)


def run_compare(args: argparse.Namespace) -> int:
    from gymfx_tpu_torch.telemetry.attribution import compare_profile_reports

    base = json.loads(Path(args.base).read_text(encoding="utf-8"))
    new = json.loads(Path(args.new).read_text(encoding="utf-8"))
    verdict = compare_profile_reports(base, new, threshold=args.threshold, min_ms=args.min_ms)
    print(json.dumps(verdict, indent=2, sort_keys=True))
    return 0 if verdict["ok"] else 1


def run_report(args: argparse.Namespace) -> int:
    from gymfx_tpu_torch.telemetry.attribution import build_profile_report, validate_profile_report
    from gymfx_tpu_torch.telemetry.profiler import find_captures

    captures = find_captures(args.capture)
    if not captures:
        print(f"no capture bundle (manifest.json) under {args.capture!r}", file=sys.stderr)
        return 2
    bundle = captures[-1]  # the newest: bundles are numbered in order
    report = build_profile_report(bundle, top_n=args.top, tolerance=args.tolerance)
    out = Path(args.out) if args.out else Path(bundle) / "profile_report.json"
    out.write_text(json.dumps(report, indent=2, sort_keys=True) + "\n", encoding="utf-8")
    print(render_markdown(report))
    print(f"\nreport: {out}")
    problems = validate_profile_report(report)
    if problems:
        print("SCHEMA VIOLATIONS:", file=sys.stderr)
        for problem in problems:
            print(f"  - {problem}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)
    rep = sub.add_parser("report", help="a capture bundle -> profile_report.json")
    rep.add_argument("capture", help="a capture bundle dir, or an ancestor (its newest bundle)")
    rep.add_argument("--out", default=None,
                     help="report path (default: <bundle>/profile_report.json)")
    rep.add_argument("--top", type=int, default=15, help="kernel table rows (default 15)")
    rep.add_argument("--tolerance", type=float, default=0.25,
                     help="phase reconciliation tolerance (default 0.25)")
    cmp_ = sub.add_parser("compare", help="diff two reports; exit 1 on a kernel regression")
    cmp_.add_argument("base", help="the base report JSON")
    cmp_.add_argument("new", help="the new report JSON")
    cmp_.add_argument("--threshold", type=float, default=0.25,
                      help="per-kernel regression threshold (default 0.25 = +25%%)")
    cmp_.add_argument("--min-ms", type=float, default=0.05,
                      help="skip kernels under this many ms a step in the base (default 0.05)")
    args = ap.parse_args(argv)
    return run_compare(args) if args.command == "compare" else run_report(args)


if __name__ == "__main__":
    sys.exit(main())
