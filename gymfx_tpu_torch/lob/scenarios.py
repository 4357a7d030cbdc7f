"""LOB training scenarios: named FlowParams presets.

The port of ``gymfx_tpu/lob/scenarios.py`` (``lob_calm``, ``lob_trend``,
``lob_volatile``, ``lob_thin``, ``lob_flash_crash``; see its module
docstring).  A scenario changes only the order-flow process.

``flow_params_from_regime`` is the per-bar blend of the scenario
generator's feed (``feed=scengen`` with ``venue=lob``): drought bars take
``lob_thin``'s intensities and depth, crash bars arm ``lob_flash_crash``'s
forced-sell burst.  The flags select among four parameter sets only
(neither, drought, crash, both: :data:`REGIME_KINDS`), which
:func:`regime_flow_sets` lists; an env's set is :func:`regime_kind` of
its bar's flags.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from gymfx_tpu_torch.lob.flow import FlowParams
from gymfx_tpu_torch.scengen.params import FLAG_CRASH, FLAG_DROUGHT

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


# the flag kinds an env's flow can take: kind = (flags >> 1) & 3
REGIME_KINDS = (0, FLAG_DROUGHT, FLAG_CRASH, FLAG_DROUGHT | FLAG_CRASH)


def regime_kind(scen_flags):
    """Each bar's index into :data:`REGIME_KINDS`: bit 0 the drought, bit 1
    the crash (FLAG_DROUGHT and FLAG_CRASH are bits 1 and 2)."""
    return (scen_flags >> 1) & 3


def _blend(base: FlowParams, flags: int, n_msgs: int) -> FlowParams:
    thin = _SCENARIOS["lob_thin"]
    crash = _SCENARIOS["lob_flash_crash"]
    src = thin if flags & FLAG_DROUGHT else base
    burst = bool(flags & FLAG_CRASH)
    return FlowParams(
        p_add=src.p_add, p_cancel=src.p_cancel, p_noop=src.p_noop,
        base_qty=src.base_qty, qty_jitter=src.qty_jitter, band_ticks=src.band_ticks,
        market_qty=src.market_qty, seed_qty=src.seed_qty,
        crash_at=max(0, int(n_msgs) // 3) if burst else base.crash_at,
        crash_len=max(1, int(n_msgs) // 8) if burst else base.crash_len,
        crash_qty=crash.crash_qty if burst else base.crash_qty,
    )


def regime_flow_sets(base: FlowParams, n_msgs: int) -> Tuple[FlowParams, ...]:
    """The FlowParams of each of :data:`REGIME_KINDS` (Python numbers).
    Their kind thresholds are float32 sums in the JAX package's blend,
    whose fields are float32 arrays: ``bar_messages(..., f32_sums=True)``."""
    return tuple(_blend(base, k, n_msgs) for k in REGIME_KINDS)


def flow_params_from_regime(base: FlowParams, scen_flags, n_msgs: int) -> FlowParams:
    """Per-bar FlowParams from the generated tape's scenario bitmask
    ``scen_flags`` ((N,) int32): each field an (N,) tensor, float32 for
    the probabilities and int32 for the rest, as the JAX package's
    ``jnp.where`` blend makes them."""
    kind = regime_kind(scen_flags.to(torch.int32)).long()
    sets = regime_flow_sets(base, n_msgs)
    dev = scen_flags.device

    def field(name: str, dtype):
        return torch.tensor([getattr(s, name) for s in sets], dtype=dtype, device=dev)[kind]

    return FlowParams(**{name: field(name, torch.float32 if name.startswith("p_") else torch.int32)
                         for name in FlowParams._fields})
