"""Observation / info assembly, batched over envs.

The port of ``gymfx_tpu/core/obs.py``: every obs block gets a leading
env axis (``features`` is (N, W, F), the agent-state scalars are
(N, 1)).  The feature window goes through kernel K1
(ops/window_zscore.step_obs) — on a CUDA tensor the kernel, on a CPU
tensor its plain version.
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


def _scaled_features(win, mean, std, neutral, cfg: EnvConfig):
    return window_zscore.step_obs(
        win, mean, std, neutral, binary_mask=cfg.binary_mask, clip=cfg.feature_clip
    )


def build_obs(state: EnvState, data: MarketData, cfg: EnvConfig,
              params: EnvParams) -> Dict[str, Any]:
    n = cfg.n_bars
    step = torch.clamp_max(state.t + 1, n).long()
    obs: Dict[str, Any] = {}
    if cfg.n_features > 0:
        obs["features"] = _scaled_features(
            state.feat_window, data.feat_mean[step], data.feat_std[step],
            data.feat_neutral[step], cfg,
        )
    price = data.close[state.t.long()]
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
    row = torch.clamp_max(step, n - 1)
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
    info: Dict[str, Any] = {
        "equity": params.initial_cash + state.equity_delta,
        "position": broker.sign(state.pos).to(torch.int32),
        "price": data.close[t],
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
    row = torch.clamp_max(torch.clamp_max(t + 1, n), n - 1)
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
            state, data.close[t], params, cfg.margin_model
        ).to(torch.float32)
        info["margin_available_norm"] = (params.initial_cash + state.equity_delta) / initial
    return info
