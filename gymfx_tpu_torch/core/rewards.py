"""Reward kernels with explicit carried state, batched over envs.

The port of ``gymfx_tpu/core/rewards.py`` for ``pnl_reward`` and
``dd_penalized_reward`` (the plain arithmetic of kernel K3), plus the
stage-B force-close penalty.  ``sharpe_reward`` comes with ROADMAP.md
Queue 1 item 7 (EnvConfig rejects it).
"""
from __future__ import annotations

import torch

from gymfx_tpu_torch.core.types import EnvConfig, EnvParams, EnvState


def compute_reward(state: EnvState, cfg: EnvConfig, params: EnvParams, active):
    """Return (new_state, base_reward); ``active`` masks carry updates."""
    initial = torch.where(params.initial_cash == 0, 1.0, params.initial_cash)
    r_norm = (state.equity_delta - state.prev_equity_delta) / initial
    if cfg.reward == "pnl_reward":
        return state, torch.where(active, r_norm * params.reward_scale, 0.0)
    # dd_penalized_reward: peak tracked in delta space from -inf
    peak = torch.where(
        active,
        torch.maximum(
            state.reward_peak,
            torch.maximum(state.equity_delta, state.prev_equity_delta),
        ),
        state.reward_peak,
    )
    peak_positive = (params.initial_cash + peak) > 0
    dd_norm = torch.where(peak_positive, (peak - state.equity_delta) / initial, 0.0)
    reward = r_norm - params.penalty_lambda * dd_norm
    return state._replace(reward_peak=peak), torch.where(active, reward, 0.0)


def force_close_penalty(state: EnvState, fc_features, cfg: EnvConfig,
                        params: EnvParams):
    """Stage-B late-Friday exposure penalty; ``fc_features`` is (N, 4)."""
    if not (cfg.stage_b_force_close_obs and cfg.stage_b_force_close_reward_penalty):
        return torch.zeros_like(state.equity_delta)
    hours_to_fc = fc_features[:, 1]
    in_zone = fc_features[:, 2] > 0
    in_window = (hours_to_fc >= 0.0) & (
        hours_to_fc <= torch.clamp_min(params.force_close_penalty_window_hours, 0.0)
    )
    applies = (params.force_close_penalty_coef > 0) & (state.pos != 0) & (in_zone | in_window)
    return torch.where(applies, params.force_close_penalty_coef, 0.0).to(
        state.equity_delta.dtype
    )
