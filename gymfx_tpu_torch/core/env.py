"""The environment step, batched over envs.

The port of ``gymfx_tpu/core/env.py`` (``reset_at``, ``step``,
``_event_overlay``, ``_record_action``).  Where the JAX package vmaps one
env, every function here takes EnvState fields with a leading env axis.
The step runs the kernel chain of the JAX package's ``rollout_env_kernel``
path: K2 (ops/env_dynamics.fill_brackets) at the open, the strategy at
the close, K3 (ops/env_dynamics.mark_reward) for the mark and the base
reward; K1 scales the feature window in build_obs.  On CUDA tensors the
three kernels run, on CPU tensors their plain versions — in JAX that
path is bitwise the plain-XLA step, so this is the same step either way.

Step/bar timing, termination and every documented divergence are the
JAX package's (see its module docstring).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from gymfx_tpu_torch.core import broker, rewards, strategy
from gymfx_tpu_torch.core.broker import add_count_
from gymfx_tpu_torch.core.obs import build_info, build_obs
from gymfx_tpu_torch.core.types import (
    ACTION_DIAG_INDEX,
    TERMINATION_BANKRUPT,
    TERMINATION_EXHAUSTED,
    EnvConfig,
    EnvParams,
    EnvState,
    initial_state,
)
from gymfx_tpu_torch.data.feed import MarketData
from gymfx_tpu_torch.ops import env_dynamics


def reset(cfg: EnvConfig, params: EnvParams, data: MarketData, n_envs: int = 1):
    """Start ``n_envs`` episodes at bar row 0; returns (state, obs)."""
    t0 = torch.zeros(n_envs, dtype=torch.int32, device=data.close.device)
    return reset_at(cfg, params, data, t0)


def reset_at(cfg: EnvConfig, params: EnvParams, data: MarketData,
             t0) -> Tuple[EnvState, Dict[str, Any]]:
    """Reset each env at its bar row ``t0[i]`` ((N,) int32)."""
    t0 = t0.to(torch.int32)
    n_envs = t0.shape[0]
    state = initial_state(cfg, n_envs, data.close.device)._replace(t=t0)
    state = broker.mark_to_market(state, data.close[t0.long()], params)
    rows = (t0.long() + 1)[:, None] + torch.arange(cfg.window_size, device=t0.device)
    state = state._replace(
        prev_equity_delta=state.equity_delta,
        price_window=data.padded_close[rows].to(state.price_window.dtype),
        feat_window=data.padded_features[rows],
    )
    return state, build_obs(state, data, cfg, params)


def step(cfg: EnvConfig, params: EnvParams, data: MarketData, state: EnvState,
         action) -> Tuple[EnvState, Dict[str, Any], Any, Any, Dict[str, Any]]:
    """One step of every env. ``action`` is (N,) (or (N, k), first entry
    used).  Returns (state, obs, reward, done, info)."""
    st, reward, done, parts = transition(cfg, params, data, state, action)
    obs = build_obs(st, data, cfg, params)
    info = build_info(st, data, cfg, params, parts["event_info"])
    info["reward"] = reward
    info["base_reward"] = parts["base_reward"]
    info["force_close_reward_penalty"] = parts["penalty"]
    info["pnl"] = st.equity_delta - st.prev_equity_delta
    info["trade_cost"] = st.last_trade_cost
    info["equity_delta"] = st.equity_delta
    info["pending_active"] = st.pending_active
    info["pending_target"] = st.pending_target
    info["pending_sl"] = st.pending_sl
    info["pending_tp"] = st.pending_tp
    info["bracket_sl"] = st.bracket_sl
    info["bracket_tp"] = st.bracket_tp
    info["position_units"] = st.pos
    info["termination_reason"] = st.termination_reason
    info["atr"] = torch.where(
        st.tr_len > 0,
        st.tr_buffer.sum(dim=1) / torch.clamp_min(st.tr_len, 1).to(st.tr_buffer.dtype),
        0.0,
    )
    return st, obs, reward, done, info


def transition(cfg: EnvConfig, params: EnvParams, data: MarketData,
               state: EnvState, action):
    """The state update of :func:`step` without the obs and info dicts
    (a trainer builds only the obs).  Returns (state, reward, done,
    parts) where parts holds event_info, base_reward and penalty."""
    n = cfg.n_bars
    n_envs = state.t.shape[0]
    was_terminated = state.terminated
    d = state.pos.dtype

    # the step's own copy of the counter block: the event overlay, K2, the
    # strategy and the margin checks add into it in place, so it is copied
    # once per step and the caller's state is left as it was
    state = state._replace(exec_diag=state.exec_diag.clone())

    flat_action = action.reshape(n_envs, -1)[:, 0]
    raw = flat_action.to(d)
    if cfg.action_space_mode == "continuous":
        thr = params.continuous_action_threshold
        a = torch.where(raw >= thr, 1, torch.where(raw <= -thr, 2, 0)).to(torch.int32)
    else:
        ai = flat_action.to(torch.int32)
        hi = 3 if cfg.allow_flat_action else 2
        a = torch.where((ai >= 0) & (ai <= hi), ai, 0).to(torch.int32)

    a, state, event_info = _event_overlay(state, a, data, cfg, params)
    state = _record_action(state, raw, a, cfg, ~was_terminated)

    live = ~was_terminated
    advance = live & state.started & (state.t < n - 1)
    exhausted = live & state.started & (state.t >= n - 1)
    act_strategy = live & ~exhausted

    t_new = torch.where(advance, state.t + 1, state.t)
    ti = t_new.long()
    o, h, l, c = data.open[ti], data.high[ti], data.low[ti], data.close[ti]
    mow = data.minute_of_week[ti]

    st = state._replace(t=t_new, last_trade_cost=torch.zeros_like(state.last_trade_cost))
    # 1 + 2 + 2b: fill at the open, brackets, financing (kernel K2)
    st = env_dynamics.fill_brackets(
        st, o, h, l, c,
        data.rollover_accrual[ti] if cfg.financing_enabled else None,
        advance, cfg, params,
    )
    # 3. the strategy applies the (post-overlay) action at the close
    st = strategy.apply_action(st, a, o, h, l, c, mow, cfg, params, act_strategy)
    # 3b. margin preflight
    if cfg.enforce_margin_preflight:
        opening = broker.opening_units(st.pos, st.pending_target)
        required = opening * c * params.margin_init
        if cfg.margin_model == "leveraged":
            required = required / torch.clamp_min(params.leverage, 1e-12)
        free = broker.realized_balance(st, params)
        denied = st.pending_active & (opening > 0) & (required > free)
        st = st._replace(
            pending_active=st.pending_active & ~denied,
            pending_target=torch.where(denied, 0.0, st.pending_target),
            pending_sl=torch.where(denied, 0.0, st.pending_sl),
            pending_tp=torch.where(denied, 0.0, st.pending_tp),
            exec_diag=add_count_(st.exec_diag, "preflight_denied", denied),
        )
    # 4. mark at the close and the base reward (kernel K3); nothing
    #    between here and the reward reads or writes the equity deltas
    #    or the reward carries
    st, base_reward = env_dynamics.mark_reward(
        st, c, advance | (live & ~state.started), live, cfg, params
    )
    # 4b. maintenance-margin closeout
    if cfg.enforce_margin_closeout:
        maint = broker.maintenance_margin(st.pos, c, params, cfg.margin_model)
        equity_now = params.initial_cash + st.equity_delta
        breach = advance & (st.pos != 0) & (equity_now < maint)
        st = st._replace(
            pending_active=st.pending_active | breach,
            pending_target=torch.where(breach, 0.0, st.pending_target),
            pending_sl=torch.where(breach, 0.0, st.pending_sl),
            pending_tp=torch.where(breach, 0.0, st.pending_tp),
            pending_forced=st.pending_forced | breach,
            exec_diag=add_count_(st.exec_diag, "margin_closeouts", breach),
        )

    # streaming obs windows: on advance, shift left and append the new bar
    adv = advance[:, None]
    if cfg.include_prices:
        shifted = torch.cat([st.price_window[:, 1:], c[:, None].to(st.price_window.dtype)], dim=1)
        st = st._replace(price_window=torch.where(adv, shifted, st.price_window))
    if cfg.n_features > 0:
        new_row = data.padded_features[ti + cfg.window_size]
        shifted = torch.cat([st.feat_window[:, 1:], new_row[:, None, :]], dim=1)
        st = st._replace(feat_window=torch.where(adv[:, :, None], shifted, st.feat_window))

    st = st._replace(started=state.started | live)

    fc_row = torch.clamp_max(st.t + 1, n - 1).long()
    penalty = rewards.force_close_penalty(st, data.force_close[fc_row], cfg, params)
    penalty = torch.where(live, penalty, 0.0)
    reward = base_reward - penalty

    equity = params.initial_cash + st.equity_delta
    broke = equity <= params.min_equity
    terminated = was_terminated | exhausted | (live & broke)
    reason_now = torch.where(
        live & broke,
        TERMINATION_BANKRUPT,
        torch.where(exhausted, TERMINATION_EXHAUSTED, 0),
    ).to(torch.int32)
    st = st._replace(
        terminated=terminated,
        termination_reason=torch.where(was_terminated, st.termination_reason, reason_now),
    )

    return st, reward, terminated, {
        "event_info": event_info, "base_reward": base_reward, "penalty": penalty,
    }


def _event_overlay(state: EnvState, a, data: MarketData, cfg: EnvConfig,
                   params: EnvParams):
    """Event-context action transform: block new entries / force-flat
    open positions while the no-trade column is active."""
    n = cfg.n_bars
    row = torch.clamp_max(torch.clamp_max(state.t + 1, n), n - 1).long()
    no_trade_value = data.ev_no_trade[row]
    active = no_trade_value >= params.event_no_trade_threshold
    pos_sign = broker.sign(state.pos).to(torch.int32)
    before = a
    live = ~state.terminated
    if cfg.event_context_execution_overlay:
        forced_flat = active & cfg.event_context_force_flat & (pos_sign != 0)
        blocked = (
            active & ~forced_flat & cfg.event_context_block_new_entries
            & (pos_sign == 0) & ((before == 1) | (before == 2))
        )
        after = torch.where(forced_flat, 3, torch.where(blocked, 0, before)).to(torch.int32)
        diag = add_count_(state.exec_diag, "event_context_no_trade_active_steps", active & live)
        diag = add_count_(diag, "event_context_action_overrides", (after != before) & live)
        diag = add_count_(diag, "event_context_blocked_entries", blocked & live)
        diag = add_count_(diag, "event_context_forced_flat_actions", forced_flat & live)
        state = state._replace(exec_diag=diag)
    else:
        forced_flat = torch.zeros_like(active)
        blocked = torch.zeros_like(active)
        after = before
    event_info = {
        "event_context_no_trade_value": no_trade_value,
        "event_context_no_trade_active": active.to(torch.float32),
        "event_context_spread_stress_multiplier": data.ev_spread_mult[row],
        "event_context_slippage_stress_multiplier": data.ev_slip_mult[row],
        "event_context_execution_overlay": torch.full_like(
            active, cfg.event_context_execution_overlay
        ),
        "event_context_action_before_overlay": before,
        "event_context_action_after_overlay": after,
        "event_context_action_overridden": after != before,
        "event_context_blocked_entry": blocked,
        "event_context_forced_flat": forced_flat,
        "event_context_position_before_overlay": pos_sign,
    }
    return after, state, event_info


def _record_action(state: EnvState, raw, a, cfg: EnvConfig, live) -> EnvState:
    """Per-episode action counters; inert where ``live`` is False."""
    is_long = (a == 1) & live
    is_short = (a == 2) & live
    is_hold = ~is_long & ~is_short & live
    diag = state.action_diag.clone()
    counts = {
        "steps": live,
        "long_actions": is_long,
        "short_actions": is_short,
        "non_hold_actions": is_long | is_short,
        "hold_actions": is_hold,
    }
    if cfg.action_space_mode == "continuous":
        counts["continuous_deadband_actions"] = is_hold
    for key, amount in counts.items():
        diag[:, ACTION_DIAG_INDEX[key]] += amount.to(torch.int32)
    return state._replace(
        action_diag=diag,
        raw_abs_sum=state.raw_abs_sum + torch.where(live, raw.abs(), 0.0),
        raw_min=torch.where(live, torch.minimum(state.raw_min, raw), state.raw_min),
        raw_max=torch.where(live, torch.maximum(state.raw_max, raw), state.raw_max),
        last_raw_action=torch.where(live, raw, state.last_raw_action),
        last_coerced_action=torch.where(live, a, state.last_coerced_action).to(torch.int32),
    )
