"""Observation / info assembly, batched over envs.

The port of ``gymfx_tpu/core/obs.py``: every obs block gets a leading
env axis (``features`` is (N, W, F), the agent-state scalars are
(N, 1)).  The feature window goes through kernel K1
(ops/window_zscore.step_obs) — on a CUDA tensor the kernel, on a CPU
tensor its plain version.  Every data read goes through
:func:`local_rows`, the JAX package's ``- data.row0`` rebase
(core/obs.py:124, :210).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from gymfx_tpu_torch.core import broker
from gymfx_tpu_torch.core.types import ACTION_DIAG_KEYS, EXEC_DIAG_KEYS, EnvConfig, EnvParams, EnvState
from gymfx_tpu_torch.data.calendar import CALENDAR_FEATURE_KEYS, FORCE_CLOSE_FEATURE_KEYS
from gymfx_tpu_torch.data.feed import MarketData
from gymfx_tpu_torch.ops import window_zscore

CALENDAR_OBS_KEYS = tuple(k for k in CALENDAR_FEATURE_KEYS if k != "is_no_trade_window")


def local_rows(cfg: EnvConfig, data: MarketData, idx, size: int):
    """Global bar rows ``idx`` as indices into an array of ``data`` with
    ``size`` rows.  The whole tape (row0 0, ``cfg.n_bars`` bars) is read
    as it is; a streamed shard's reads are rebased by ``data.row0`` and
    clamped to the array, as XLA's gather clamps them (torch would wrap a
    negative index and fault past the end; the frozen cursor of an
    episode that ended in an earlier shard reads outside this one).  A
    staged shard's ``row0`` is a 0-d device tensor (core/rollout.py); a
    portfolio's tape, its pairs' tapes end to end, has an (N,) tensor of
    per-row bases (core/portfolio.py)."""
    i = idx.long()
    if isinstance(data.row0, int) and data.row0 == 0 and data.close.shape[0] == cfg.n_bars:
        return i
    return torch.clamp(i - data.row0, 0, size - 1)


def scale_feature_window_host(win, mean, std, neutral, cfg: EnvConfig):
    """The numpy twin of the window's scaling for the serving featurizer
    (serve/features.py), the JAX package's function of the same name
    (gymfx_tpu/core/obs.py:67-89): one (W, F) window, (F,) moments and a
    neutral flag, through the plain version's ops in their order
    (ops/window_zscore.scale_feature_window, which K1 computes bit for
    bit): the z-score (IEEE f32 division), the neutral zero, the binary
    passthrough, the clip when clip > 0, nan_to_num, f32."""
    win = np.asarray(win, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):  # x / 0 is cleaned below
        scaled = np.where(neutral, np.float32(0.0), (win - mean) / std)
    if any(cfg.binary_mask):
        mask = np.asarray(cfg.binary_mask, dtype=bool)
        scaled = np.where(mask[None, :], win, scaled)
    clip = cfg.feature_clip
    if clip and clip > 0:
        scaled = np.clip(scaled, np.float32(-clip), np.float32(clip))
    scaled = np.nan_to_num(scaled, nan=0.0, posinf=clip or 0.0, neginf=-(clip or 0.0))
    return scaled.astype(np.float32)


def _scaled_features(win, mean, std, neutral, cfg: EnvConfig):
    return window_zscore.step_obs(
        win, mean, std, neutral, binary_mask=cfg.binary_mask, clip=cfg.feature_clip
    )


def build_obs(state: EnvState, data: MarketData, cfg: EnvConfig,
              params: EnvParams) -> Dict[str, Any]:
    n = cfg.n_bars
    step = torch.clamp_max(state.t + 1, n).long()
    bars = data.close.shape[0]
    obs: Dict[str, Any] = {}
    if cfg.n_features > 0:
        moment = local_rows(cfg, data, step, data.feat_mean.shape[0])
        obs["features"] = _scaled_features(
            state.feat_window, data.feat_mean[moment], data.feat_std[moment],
            data.feat_neutral[moment], cfg,
        )
    price = data.close[local_rows(cfg, data, state.t, bars)]
    prices = None
    if cfg.include_prices:
        prices = state.price_window
        returns = prices - torch.cat([prices[:, :1], prices[:, :-1]], dim=1)
        obs["prices"] = prices.to(torch.float32)
        obs["returns"] = returns.to(torch.float32)
    if cfg.include_agent_state:
        initial = torch.where(params.initial_cash == 0, 1.0, params.initial_cash)
        pos_sign = broker.sign(state.pos)
        ref_price = prices[:, -1] if prices is not None else price
        unrealized = pos_sign * (price - ref_price) * params.position_size
        obs["position"] = pos_sign.to(torch.float32)[:, None]
        obs["equity_norm"] = (state.equity_delta / initial).to(torch.float32)[:, None]
        obs["unrealized_pnl_norm"] = (unrealized / initial).to(torch.float32)[:, None]
        # the JAX package's explicit f32 reciprocal multiply (same bits on
        # every path, see gymfx_tpu/core/obs.py)
        recip = float(np.float32(1.0) / np.float32(max(1, n)))
        remaining = torch.clamp_min(n - (state.t + 1), 0).to(torch.float32) * recip
        obs["steps_remaining_norm"] = remaining[:, None]
    row = local_rows(cfg, data, torch.clamp_max(step, n - 1), bars)
    if cfg.stage_b_force_close_obs:
        fc = data.force_close[row]
        for i, key in enumerate(FORCE_CLOSE_FEATURE_KEYS):
            obs[key] = fc[:, i : i + 1]
    if cfg.oanda_fx_calendar_obs:
        cal = data.calendar[row]
        for key in CALENDAR_OBS_KEYS:
            i = CALENDAR_FEATURE_KEYS.index(key)
            obs[key] = cal[:, i : i + 1]
        initial = torch.where(params.initial_cash == 0, 1.0, params.initial_cash)
        obs["margin_closeout_percent"] = broker.margin_closeout_percent(
            state, price, params, cfg.margin_model
        ).to(torch.float32)[:, None]
        obs["margin_available_norm"] = (
            (params.initial_cash + state.equity_delta) / initial
        ).to(torch.float32)[:, None]
    return obs


def build_info(state: EnvState, data: MarketData, cfg: EnvConfig,
               params: EnvParams, event_info: Dict[str, Any] | None = None) -> Dict[str, Any]:
    n = cfg.n_bars
    t = state.t.long()
    bars = data.close.shape[0]
    price = data.close[local_rows(cfg, data, t, bars)]
    info: Dict[str, Any] = {
        "equity": params.initial_cash + state.equity_delta,
        "position": broker.sign(state.pos).to(torch.int32),
        "price": price,
        "bar_index": state.t + 1,
        "total_bars": torch.full_like(state.t, n),
        "trades": state.trade_count,
        "commission_paid": state.commission_paid,
        "raw_action_value": state.last_raw_action,
        "coerced_action": state.last_coerced_action,
    }
    for i, key in enumerate(ACTION_DIAG_KEYS):
        info[f"action_diagnostics/{key}"] = state.action_diag[:, i]
    info["action_diagnostics/raw_abs_sum"] = state.raw_abs_sum
    info["action_diagnostics/raw_min"] = state.raw_min
    info["action_diagnostics/raw_max"] = state.raw_max
    for i, key in enumerate(EXEC_DIAG_KEYS):
        info[f"execution_diagnostics/{key}"] = state.exec_diag[:, i]
    if event_info:
        info.update(event_info)
    row = local_rows(cfg, data, torch.clamp_max(torch.clamp_max(t + 1, n), n - 1), bars)
    if cfg.stage_b_force_close_obs:
        fc = data.force_close[row]
        for i, key in enumerate(FORCE_CLOSE_FEATURE_KEYS):
            info[key] = fc[:, i]
    if cfg.oanda_fx_calendar_obs:
        cal = data.calendar[row]
        for i, key in enumerate(CALENDAR_FEATURE_KEYS):
            info[key] = cal[:, i]
        initial = torch.where(params.initial_cash == 0, 1.0, params.initial_cash)
        info["margin_closeout_percent"] = broker.margin_closeout_percent(
            state, price, params, cfg.margin_model
        ).to(torch.float32)
        info["margin_available_norm"] = (params.initial_cash + state.equity_delta) / initial
    return info
