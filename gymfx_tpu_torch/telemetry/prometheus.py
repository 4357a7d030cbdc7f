"""Prometheus text exposition (format version 0.0.4) for a
:class:`~gymfx_tpu_torch.telemetry.registry.MetricsRegistry`: the port
of ``gymfx_tpu/telemetry/prometheus.py``, the same bytes for the same
registry contents.

Deterministic output: families sorted by name, label sets sorted by
label values.
"""
from __future__ import annotations

from typing import Dict, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(text: str) -> str:
    return (
        text.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')
    )


def _format_value(value: float) -> str:
    value = float(value)
    if value != value:  # NaN
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _labels_str(names: Tuple[str, ...], values: Tuple[str, ...],
                extra: Dict[str, str] = None) -> str:
    pairs = [
        f'{n}="{_escape_label_value(v)}"' for n, v in zip(names, values)
    ]
    for k, v in (extra or {}).items():
        pairs.append(f'{k}="{_escape_label_value(v)}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render(registry) -> str:
    """The full ``/metrics`` payload for ``registry``."""
    lines = []
    for fam in registry.families():
        lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        if fam.kind == "histogram":
            for key, state in fam.samples():
                cum = 0
                for edge, count in zip(fam.buckets, state.bucket_counts):
                    cum += count
                    le = _labels_str(
                        fam.label_names, key, {"le": _format_value(edge)}
                    )
                    lines.append(f"{fam.name}_bucket{le} {cum}")
                inf = _labels_str(fam.label_names, key, {"le": "+Inf"})
                lines.append(f"{fam.name}_bucket{inf} {state.count}")
                ls = _labels_str(fam.label_names, key)
                lines.append(f"{fam.name}_sum{ls} {_format_value(state.sum)}")
                lines.append(f"{fam.name}_count{ls} {state.count}")
        else:
            for key, value in fam.samples():
                ls = _labels_str(fam.label_names, key)
                lines.append(f"{fam.name}{ls} {_format_value(value)}")
    return "\n".join(lines) + ("\n" if lines else "")
