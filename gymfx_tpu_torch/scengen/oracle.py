"""Host-side NumPy oracle twin of the scenario engine.

The port's own copy of ``gymfx_tpu/scengen/oracle.py``: an independently
written loop of ``engine.paths_from_shocks`` consuming the SAME drawn
shocks, the third witness of the generator's tests: regimes and flags
must match the transform EXACTLY (decision comparisons are explicitly
sequenced f32 in both), and prices must agree to float tolerance
(exp/matmul associativity is the only slack).  Deliberately scalar and
slow: clarity over speed.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from gymfx_tpu_torch.scengen.params import (
    FLAG_CRASH,
    FLAG_DROUGHT,
    FLAG_GAP,
    FLAG_HIGHVOL,
    FLAG_TREND,
    HIGHVOL,
    TREND_DOWN,
    TREND_UP,
    ScenarioParams,
)


def oracle_paths(
    shocks: Any, p: ScenarioParams, monday_open: Optional[np.ndarray] = None
):
    """Replay the shock stream through plain Python/NumPy; returns a
    dict of arrays shaped like ``engine.ScenPaths``."""
    f32 = np.float32
    regime_u = np.asarray(shocks.regime_u, f32)
    ret_z = np.asarray(shocks.ret_z, f32)
    gap_z = np.asarray(shocks.gap_z, f32)
    hi_z = np.asarray(shocks.hi_z, f32)
    lo_z = np.asarray(shocks.lo_z, f32)
    crash_u = np.asarray(shocks.crash_u, f32)
    gap_u = np.asarray(shocks.gap_u, f32)
    drought_u = np.asarray(shocks.drought_u, f32)
    n, n_assets = ret_z.shape
    monday = (
        np.zeros(n, bool) if monday_open is None
        else np.asarray(monday_open, bool)
    )

    trans = np.asarray(p.trans, f32)
    drift = np.asarray(p.drift, f32)
    vol = np.asarray(p.vol, f32)
    spread = np.asarray(p.spread, f32)
    hl_range = f32(p.hl_range)
    p_crash = f32(p.p_crash)
    crash_len = int(p.crash_len)
    crash_drop = f32(np.float32(p.crash_size) / max(f32(p.crash_len), f32(1)))
    recovery_len = int(p.recovery_len)
    recov_gain = f32(
        np.float32(p.crash_size) * np.float32(p.recovery_frac)
        / max(f32(p.recovery_len), f32(1))
    )
    crash_spread = f32(p.crash_spread)
    p_gap = f32(p.p_gap)
    gap_size = f32(p.gap_size)
    weekend_gap_size = f32(p.weekend_gap_size)
    p_drought = f32(p.p_drought)
    drought_len = int(p.drought_len)
    drought_spread = f32(p.drought_spread)
    drought_vol = f32(p.drought_vol)

    rho = float(np.asarray(p.corr))
    cmat = (1.0 - rho) * np.eye(n_assets) + rho * np.ones(
        (n_assets, n_assets)
    )
    chol = np.linalg.cholesky(cmat).astype(f32)
    eps = (ret_z @ chol.T).astype(f32)

    regime = int(p.regime0)
    logp = np.log(np.broadcast_to(f32(p.s0), (n_assets,)).astype(f32))
    logp = logp.astype(f32)
    crash_left = recov_left = drought_left = 0

    out = {
        k: np.zeros((n, n_assets), f32)
        for k in ("open", "high", "low", "close")
    }
    out["spread_mult"] = np.zeros(n, f32)
    out["slip_mult"] = np.zeros(n, f32)
    out["flags"] = np.zeros(n, np.int32)
    out["regime"] = np.zeros(n, np.int32)

    for t in range(n):
        # regime transition: same sequenced f32 partial sums as the scan
        row = trans[regime]
        c0 = row[0]
        c1 = f32(c0 + row[1])
        c2 = f32(c1 + row[2])
        u = regime_u[t]
        if u < c0:
            regime = 0
        elif u < c1:
            regime = 1
        elif u < c2:
            regime = 2
        else:
            regime = 3

        if crash_left == 0 and recov_left == 0 and crash_u[t] < p_crash:
            crash_left = crash_len
        in_crash = crash_left > 0
        if in_crash:
            crash_left -= 1
            if crash_left == 0:
                recov_left = recovery_len
        in_recov = (not in_crash) and recov_left > 0
        if in_recov:
            recov_left -= 1

        if drought_left == 0 and drought_u[t] < p_drought:
            drought_left = drought_len
        in_drought = drought_left > 0
        if in_drought:
            drought_left -= 1

        vol_t = f32(vol[regime] * (drought_vol if in_drought else f32(1)))
        overlay = f32(0)
        if in_crash:
            overlay = f32(overlay - crash_drop)
        if in_recov:
            overlay = f32(overlay + recov_gain)
        ret = (drift[regime] + vol_t * eps[t] + overlay).astype(f32)

        gap_evt = bool(gap_u[t] < p_gap) or bool(monday[t])
        gsz = weekend_gap_size if monday[t] else gap_size
        gap = (gap_z[t] * gsz if gap_evt else np.zeros(n_assets)).astype(f32)

        open_ = np.exp((logp + gap).astype(f32)).astype(f32)
        logp = (logp + gap + ret).astype(f32)
        close = np.exp(logp).astype(f32)
        hi = (
            np.maximum(open_, close)
            * np.exp((hl_range * vol_t * np.abs(hi_z[t])).astype(f32))
        ).astype(f32)
        lo = (
            np.minimum(open_, close)
            * np.exp((-hl_range * vol_t * np.abs(lo_z[t])).astype(f32))
        ).astype(f32)

        spread_t = f32(
            spread[regime]
            * (drought_spread if in_drought else f32(1))
            * (crash_spread if in_crash else f32(1))
        )

        flags = 0
        if regime in (TREND_UP, TREND_DOWN):
            flags |= FLAG_TREND
        if in_drought:
            flags |= FLAG_DROUGHT
        if in_crash:
            flags |= FLAG_CRASH
        if gap_evt:
            flags |= FLAG_GAP
        if regime == HIGHVOL:
            flags |= FLAG_HIGHVOL

        out["open"][t] = open_
        out["high"][t] = hi
        out["low"][t] = lo
        out["close"][t] = close
        out["spread_mult"][t] = spread_t
        out["slip_mult"][t] = f32(1.0 + 0.5 * (spread_t - 1.0))
        out["flags"][t] = flags
        out["regime"][t] = regime
    return out
