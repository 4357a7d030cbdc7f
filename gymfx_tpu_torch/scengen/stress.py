"""Structured market stress: a preset's overlays on an existing tape.

The port of ``gymfx_tpu/scengen/stress.py``: ``apply_scengen_stress``
overlays the preset's stress machinery — flash-crash drops with recovery
tails, liquidity-drought spread blowouts, gap level shifts — onto an
EXISTING ``MarketData`` (numpy arrays or tensors; each field keeps its
type, dtype and device).  The JAX package reaches it through the
``fault_profile`` clause ``scengen=<preset>`` (resilience/faults.py), and
so does the port.

Deterministic: the event layout is drawn from ``np.random.default_rng``
on the profile's seed in the JAX package's order (the same draws), and each stress family fires AT LEAST once when
the preset enables it (a chaos run must never silently reduce to the
clean baseline because the draw came up empty).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from gymfx_tpu_torch.scengen.params import FLAG_CRASH, FLAG_DROUGHT, FLAG_GAP, scenario_params


def _event_starts(
    rng: np.random.Generator, n: int, rate: float, width: int,
    at_least_one: bool,
) -> np.ndarray:
    """Non-overlapping window starts drawn at ``rate`` per bar."""
    if rate <= 0 and not at_least_one:
        return np.zeros(0, np.int64)
    count = int(rng.binomial(max(n - width, 1), max(rate, 0.0)))
    if at_least_one:
        count = max(count, 1)
    hi = max(n - width, 1)
    starts = np.sort(rng.integers(0, hi, size=count))
    picked = []
    last_end = -1
    for s in starts:
        if s > last_end:
            picked.append(int(s))
            last_end = int(s) + width
    return np.asarray(picked, np.int64)


def _like(values: np.ndarray, ref: Any) -> Any:
    """Host ``values`` in ``ref``'s form: a tensor on its device, or numpy."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(values)).to(ref.device)
    return values


def _host(x: Any) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def apply_scengen_stress(
    data: Any, preset: str, seed: int = 0
) -> Any:
    """Overlay the preset's stress events onto ``data`` and return the
    rebuilt MarketData (prices scaled multiplicatively, padded_close
    mirrored, event spread/slippage multipliers compounded, scen_flags
    bits set)."""
    p = scenario_params(preset)
    rng = np.random.default_rng(int(seed))
    close = _host(data.close)
    n = int(close.shape[0])

    # per-bar log-price deltas accumulate into a level-shift curve
    delta = np.zeros(n, np.float64)
    spread_mult = np.ones(n, np.float64)
    flags = np.zeros(n, np.int32)

    crash_len = max(int(p.crash_len), 1)
    recovery_len = max(int(p.recovery_len), 1)
    # a family is enabled by its RATE (crash_size is a magnitude with a
    # nonzero default on every preset, so it must not gate the family)
    if float(p.p_crash) > 0:
        width = crash_len + recovery_len
        for s in _event_starts(rng, n, float(p.p_crash), width, True):
            drop = float(p.crash_size) / crash_len
            gain = float(p.crash_size) * float(p.recovery_frac) / recovery_len
            d_end = min(s + crash_len, n)
            r_end = min(d_end + recovery_len, n)
            delta[s:d_end] -= drop
            delta[d_end:r_end] += gain
            spread_mult[s:d_end] *= float(p.crash_spread)
            flags[s:d_end] |= FLAG_CRASH

    if float(p.p_drought) > 0:
        width = max(int(p.drought_len), 1)
        for s in _event_starts(rng, n, float(p.p_drought), width, True):
            end = min(s + width, n)
            spread_mult[s:end] *= float(p.drought_spread)
            flags[s:end] |= FLAG_DROUGHT

    if float(p.p_gap) > 0:
        for b in _event_starts(rng, n, float(p.p_gap), 1, True):
            delta[b] += float(rng.normal(0.0, float(p.gap_size)))
            flags[b] |= FLAG_GAP

    factor = np.exp(np.cumsum(delta))

    replace: Dict[str, Any] = {}
    for field in ("open", "high", "low", "close"):
        host = _host(getattr(data, field))
        replace[field] = _like((host * factor).astype(host.dtype), getattr(data, field))
    padded = _host(data.padded_close).copy()
    pad = padded.shape[0] - n
    padded[pad:] = padded[pad:] * factor
    replace["padded_close"] = _like(padded, data.padded_close)

    ev_spread = _host(data.ev_spread_mult) * spread_mult
    ev_slip = _host(data.ev_slip_mult) * (1.0 + 0.5 * (spread_mult - 1.0))
    replace["ev_spread_mult"] = _like(ev_spread.astype(np.float32), data.ev_spread_mult)
    replace["ev_slip_mult"] = _like(ev_slip.astype(np.float32), data.ev_slip_mult)

    prev = _host(data.scen_flags)
    if prev.shape != flags.shape:  # a feed without flags carries the scalar 0
        prev = np.zeros(n, np.int32)
    replace["scen_flags"] = _like((prev | flags).astype(np.int32), data.close)
    return data._replace(**replace)
