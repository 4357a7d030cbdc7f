"""LOB training scenarios: named FlowParams presets.

The port of ``gymfx_tpu/lob/scenarios.py`` (``lob_calm``, ``lob_trend``,
``lob_volatile``, ``lob_thin``, ``lob_flash_crash``; see its module
docstring).  A scenario changes only the order-flow process.  The
per-bar blend for the scenario generator's feed
(``flow_params_from_regime``) comes with ROADMAP.md Queue 1 item 14.
"""
from __future__ import annotations

from typing import Dict, Tuple

from gymfx_tpu_torch.lob.flow import FlowParams

_SCENARIOS: Dict[str, FlowParams] = {
    "lob_calm": FlowParams(),
    "lob_trend": FlowParams(
        p_add=0.70, p_cancel=0.10, band_ticks=3, base_qty=10,
    ),
    "lob_volatile": FlowParams(
        p_add=0.35, p_cancel=0.15, band_ticks=10,
        base_qty=10, qty_jitter=10, market_qty=8,
    ),
    "lob_thin": FlowParams(
        p_add=0.30, p_cancel=0.10, p_noop=0.35,
        base_qty=3, qty_jitter=3, market_qty=2, seed_qty=4,
    ),
    "lob_flash_crash": FlowParams(
        crash_at=24, crash_len=8, crash_qty=48,
    ),
}


def scenario_names() -> Tuple[str, ...]:
    return tuple(sorted(_SCENARIOS))


def scenario_flow_params(name: str) -> FlowParams:
    """Resolve a scenario name (unknown names raise at config binding)."""
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown lob_scenario {name!r}; known: {scenario_names()}"
        ) from None
