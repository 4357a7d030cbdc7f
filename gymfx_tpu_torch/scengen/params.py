"""Scenario parameters and the named preset registry.

The port's own copy of ``gymfx_tpu/scengen/params.py`` (numpy only):
``ScenarioParams``, the eight presets, the ``FLAG_*`` bits and
``scenario_params`` (honor-or-reject).  A scenario is a bundle of plain
host-side numbers driving one generative market process (engine.py): a
4-state Markov chain over drift/vol regimes, plus three seeded overlay
processes — flash crashes with recovery tails, gap opens (random +
weekend), and liquidity droughts (spread blowouts with quiet prices).

Regime states (index into ``trans`` / ``drift`` / ``vol`` / ``spread``)::

    0  RANGE      mean-reverting chop, baseline vol
    1  TREND_UP   positive drift
    2  TREND_DOWN negative drift
    3  HIGHVOL    zero drift, elevated vol and spread

Per-bar scenario flags (``scen_flags`` in MarketData — int32 bitmask,
0 on every replayed feed) are the bridge from the generated tape to the
LOB order-flow process (lob/scenarios.flow_params_from_regime)::

    FLAG_TREND    a trending regime is active (state 1 or 2)
    FLAG_DROUGHT  liquidity drought window (spread blowout, thin flow)
    FLAG_CRASH    flash-crash drop phase (forced-sell flow burst)
    FLAG_GAP      this bar opened on a gap (random or weekend)
    FLAG_HIGHVOL  high-volatility regime is active (state 3)
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np

# regime indices
RANGE, TREND_UP, TREND_DOWN, HIGHVOL = 0, 1, 2, 3
N_REGIMES = 4

# scen_flags bits (MarketData.scen_flags; 0 everywhere on replay feeds)
FLAG_TREND = 1
FLAG_DROUGHT = 2
FLAG_CRASH = 4
FLAG_GAP = 8
FLAG_HIGHVOL = 16


class ScenarioParams(NamedTuple):
    """Numeric knobs of one generative scenario (host-side floats/ints,
    float32 arrays for the per-regime rows)."""

    trans: Any                    # (4, 4) row-stochastic regime transitions
    drift: Any                    # (4,) per-bar log drift by regime
    vol: Any                      # (4,) per-bar log-return std by regime
    spread: Any                   # (4,) baseline spread multiplier by regime
    regime0: Any = RANGE          # initial regime state
    hl_range: Any = 1.2           # intrabar H/L extension (x per-bar vol)
    p_crash: Any = 0.0            # per-bar flash-crash start probability
    crash_len: Any = 6            # bars of the drop phase
    crash_size: Any = 0.02        # total log drop across the drop phase
    recovery_len: Any = 24        # bars of the recovery tail
    recovery_frac: Any = 0.6      # fraction of the drop recovered
    crash_spread: Any = 4.0       # spread multiplier during the drop phase
    p_gap: Any = 0.0              # per-bar random gap-open probability
    gap_size: Any = 8e-4          # random gap log-size std
    weekend_gap_size: Any = 1.5e-3  # Monday-open gap log-size std
    p_drought: Any = 0.0          # per-bar drought start probability
    drought_len: Any = 32         # drought duration in bars
    drought_spread: Any = 8.0     # spread multiplier inside a drought
    drought_vol: Any = 0.5        # vol damping inside a drought
    corr: Any = 0.0               # pairwise cross-asset shock correlation
    s0: Any = 1.10                # initial price level


def _trans(rows) -> np.ndarray:
    m = np.asarray(rows, dtype=np.float32)
    if m.shape != (N_REGIMES, N_REGIMES):
        raise ValueError(f"transition matrix must be 4x4, got {m.shape}")
    if not np.allclose(m.sum(axis=1), 1.0, atol=1e-6):
        raise ValueError("transition rows must sum to 1")
    return m


_MIX_TRANS = _trans([
    [0.90, 0.04, 0.04, 0.02],
    [0.05, 0.92, 0.01, 0.02],
    [0.05, 0.01, 0.92, 0.02],
    [0.10, 0.02, 0.02, 0.86],
])
_DRIFT = np.asarray([0.0, 5e-5, -5e-5, 0.0], np.float32)
_VOL = np.asarray([1.5e-4, 2e-4, 2e-4, 6e-4], np.float32)
_SPREAD = np.asarray([1.0, 1.0, 1.0, 2.0], np.float32)
_FLAT_SPREAD = np.ones(N_REGIMES, np.float32)

_PRESETS: Dict[str, ScenarioParams] = {
    # the default: all four regimes visited, mild random gaps
    "regime_mix": ScenarioParams(
        trans=_MIX_TRANS, drift=_DRIFT, vol=_VOL, spread=_SPREAD,
        p_gap=0.002,
    ),
    # persistent one-sided drift, no overlays — the smoke-friendly tape
    "trend_calm": ScenarioParams(
        trans=_trans([
            [0.10, 0.88, 0.01, 0.01],
            [0.02, 0.97, 0.005, 0.005],
            [0.02, 0.96, 0.01, 0.01],
            [0.10, 0.80, 0.05, 0.05],
        ]),
        drift=_DRIFT, vol=_VOL, spread=_FLAT_SPREAD, regime0=TREND_UP,
    ),
    # mean-reverting chop pinned to the range state
    "range_chop": ScenarioParams(
        trans=_trans([
            [0.98, 0.01, 0.01, 0.00],
            [0.90, 0.05, 0.025, 0.025],
            [0.90, 0.025, 0.05, 0.025],
            [0.90, 0.04, 0.04, 0.02],
        ]),
        drift=_DRIFT, vol=_VOL, spread=_FLAT_SPREAD,
    ),
    # regime mix + seeded flash crashes with recovery tails
    "flash_crash": ScenarioParams(
        trans=_MIX_TRANS, drift=_DRIFT, vol=_VOL, spread=_SPREAD,
        p_crash=0.004, crash_len=6, crash_size=0.02,
        recovery_len=24, recovery_frac=0.6, crash_spread=4.0,
        p_gap=0.002,
    ),
    # frequent random gap opens + heavy weekend gaps
    "gap_open": ScenarioParams(
        trans=_MIX_TRANS, drift=_DRIFT, vol=_VOL, spread=_SPREAD,
        p_gap=0.02, gap_size=8e-4, weekend_gap_size=2e-3,
    ),
    # liquidity droughts: spread blows out while the tape goes quiet
    "liquidity_drought": ScenarioParams(
        trans=_MIX_TRANS, drift=_DRIFT, vol=_VOL, spread=_SPREAD,
        p_drought=0.004, drought_len=32, drought_spread=8.0,
        drought_vol=0.5,
    ),
    # correlated multi-asset variants (portfolio trainer feeds)
    "multi_asset_calm": ScenarioParams(
        trans=_MIX_TRANS, drift=_DRIFT, vol=_VOL, spread=_FLAT_SPREAD,
        corr=0.6,
    ),
    "multi_asset_stress": ScenarioParams(
        trans=_MIX_TRANS, drift=_DRIFT, vol=_VOL, spread=_SPREAD,
        corr=0.85, p_crash=0.004, crash_len=6, crash_size=0.02,
        recovery_len=24, recovery_frac=0.6,
        p_drought=0.002, drought_len=32, drought_spread=8.0,
        drought_vol=0.5, p_gap=0.004,
    ),
}


def preset_names() -> Tuple[str, ...]:
    return tuple(sorted(_PRESETS))


def scenario_params(name: str) -> ScenarioParams:
    """Resolve a preset name (honor-or-reject: unknown names raise at
    config-binding time, never mid-generation)."""
    try:
        return _PRESETS[str(name)]
    except KeyError:
        raise ValueError(
            f"unknown scengen preset {name!r}; known: {preset_names()}"
        ) from None
