"""Strategy kernels: agent action -> pending orders, batched over envs.

The port of ``gymfx_tpu/core/strategy.py`` for the three built-ins:
``default`` (long/short/flip/close, no brackets), ``direct_fixed_sltp``
(brackets at fixed pips) and ``direct_atr_sltp`` (ATR brackets with the
true-range ring buffer, gating, risk modes, clamps, sizing and the
session filter).  Orders are pending: they fill at the next bar's open.
The hidden action 3 force-flattens.
"""
from __future__ import annotations

import torch

from gymfx_tpu_torch.core.broker import add_count_
from gymfx_tpu_torch.core.types import EnvConfig, EnvParams, EnvState


def apply_action(state: EnvState, action, o, h, l, c, minute_of_week,
                 cfg: EnvConfig, params: EnvParams, active) -> EnvState:
    """The strategy's pending orders.  Its counters add into
    ``state.exec_diag`` in place: the block is the step's own copy."""
    a = action.to(torch.int32)
    pos = state.pos
    force_flat = active & (a == 3) & (pos != 0)
    diag = add_count_(state.exec_diag, "default_orders_submitted", force_flat)
    if not cfg.allow_flat_action:
        diag = add_count_(diag, "event_context_forced_flat_orders", force_flat)

    acts = active & (a != 3)
    if cfg.strategy == "direct_atr_sltp":
        state, diag, pending = _atr_sltp(state, a, h, l, c, minute_of_week,
                                         cfg, params, diag, acts)
    elif cfg.strategy == "direct_fixed_sltp":
        pending = _fixed_sltp(state, a, c, params, acts)
    else:
        diag, pending = _default_flow(state, a, params, diag, acts)

    p_active, p_target, p_sl, p_tp = pending
    d = state.pos.dtype
    return state._replace(
        exec_diag=diag,
        pending_active=torch.where(force_flat, True, p_active),
        pending_target=torch.where(force_flat, 0.0, p_target).to(d),
        pending_sl=torch.where(force_flat, 0.0, p_sl).to(d),
        pending_tp=torch.where(force_flat, 0.0, p_tp).to(d),
    )


def _default_flow(state, a, params, diag, act):
    pos = state.pos
    size = params.position_size
    diag = add_count_(diag, "entry_actions_seen", act & ((a == 1) | (a == 2)))
    want_long = act & (a == 1)
    want_short = act & (a == 2)
    open_long = want_long & (pos <= 0)
    open_short = want_short & (pos >= 0)
    orders_long = torch.where(want_long & (pos < 0), 2, torch.where(open_long, 1, 0))
    orders_short = torch.where(want_short & (pos > 0), 2, torch.where(open_short, 1, 0))
    diag = add_count_(diag, "default_orders_submitted", orders_long + orders_short)
    submit = open_long | open_short
    target = torch.where(open_long, size, torch.where(open_short, -size, 0.0))
    zero = torch.zeros_like(state.pending_sl)
    return diag, (submit, target, zero, zero)


def _fixed_sltp(state, a, c, params, act):
    pos = state.pos
    size = params.position_size
    pip = params.pip_size
    sl_d = params.sl_pips * pip
    tp_d = params.tp_pips * pip
    open_long = act & (a == 1) & (pos <= 0)
    open_short = act & (a == 2) & (pos >= 0)
    submit = open_long | open_short
    target = torch.where(open_long, size, torch.where(open_short, -size, 0.0))
    sl = torch.where(open_long, c - sl_d, torch.where(open_short, c + sl_d, 0.0))
    tp = torch.where(open_long, c + tp_d, torch.where(open_short, c - tp_d, 0.0))
    return submit, target, sl, tp


def _atr_sltp(state, a, h, l, c, mow, cfg, params, diag, act):
    d = state.pos.dtype
    pos = state.pos

    # true-range ring buffer, updated on every acted bar (even on hold)
    has_prev = state.prev_close > 0
    tr = torch.where(
        has_prev,
        torch.maximum(
            h - l,
            torch.maximum((h - state.prev_close).abs(), (l - state.prev_close).abs()),
        ),
        h - l,
    )
    written = state.tr_buffer.clone()
    written.scatter_(1, state.tr_idx.long()[:, None], tr.to(d)[:, None])
    buf = torch.where(act[:, None], written, state.tr_buffer)
    tr_idx = torch.where(act, (state.tr_idx + 1) % cfg.atr_period, state.tr_idx)
    tr_len = torch.where(act, torch.clamp_max(state.tr_len + 1, cfg.atr_period), state.tr_len)
    prev_close = torch.where(act, c.to(d), state.prev_close)
    state = state._replace(tr_buffer=buf, tr_idx=tr_idx, tr_len=tr_len, prev_close=prev_close)

    if cfg.session_filter:
        mow_valid = mow >= 0
        in_entry = torch.where(
            mow_valid,
            (mow >= params.entry_start_mow) & (mow < params.force_close_mow),
            True,
        )
        in_close_zone = torch.where(mow_valid, ~in_entry, False)
    else:
        in_entry = torch.ones_like(act)
        in_close_zone = torch.zeros_like(act)

    session_close = act & in_close_zone & (pos != 0)
    is_entry_action = act & ((a == 1) | (a == 2)) & ~session_close
    diag = add_count_(diag, "entry_actions_seen", is_entry_action)
    if cfg.session_filter:
        blocked_session = is_entry_action & ~in_entry
    else:
        blocked_session = torch.zeros_like(is_entry_action)
    diag = add_count_(diag, "blocked_session_filter", blocked_session)

    ready = tr_len >= cfg.atr_period
    atr = torch.where(
        tr_len > 0, buf.sum(dim=1) / torch.clamp_min(tr_len, 1).to(d), 0.0
    )
    size = _compute_size(state, c, params, cfg)

    attempt = is_entry_action & ~blocked_session & in_entry
    diag = add_count_(diag, "blocked_atr_warmup", attempt & ~ready)
    diag = add_count_(diag, "blocked_non_positive_atr", attempt & ready & (atr <= 0.0))
    diag = add_count_(
        diag, "blocked_non_positive_size", attempt & ready & (atr > 0.0) & (size <= 0.0)
    )
    diag = add_count_(
        diag, "blocked_non_positive_price",
        attempt & ready & (atr > 0.0) & (size > 0.0) & (c <= 0.0),
    )
    can_trade = attempt & ready & (atr > 0.0) & (size > 0.0) & (c > 0.0)

    k_sl_eff, k_tp_eff = _effective_sltp_multiples(cfg, params)
    sl_dist = k_sl_eff * atr
    tp_dist = k_tp_eff * atr
    if cfg.sltp_risk_mode == "margin_aware_atr":
        rel = torch.clamp_min(params.rel_volume * params.use_rel_volume, 0.0)
        max_loss = params.max_planned_loss_fraction
        cap_on = (max_loss > 0.0) & (rel > 0.0)
        cap = c * torch.clamp_min(max_loss, 0.0) / torch.clamp_min(
            rel * torch.clamp_min(params.leverage, 1e-12), 1e-30
        )
        sl_dist = torch.where(cap_on, torch.minimum(sl_dist, cap), sl_dist)
    floor = params.min_sltp_frac * c
    use_floor = params.min_sltp_frac >= 0
    sl_dist = torch.where(use_floor, torch.maximum(sl_dist, floor), sl_dist)
    tp_dist = torch.where(use_floor, torch.maximum(tp_dist, floor), tp_dist)
    ceil = params.max_sltp_frac * c
    use_ceil = params.max_sltp_frac >= 0
    sl_dist = torch.where(use_ceil, torch.minimum(sl_dist, ceil), sl_dist)
    tp_dist = torch.where(use_ceil, torch.minimum(tp_dist, ceil), tp_dist)
    tp_dist = torch.where(tp_dist >= c, c * 0.5, tp_dist)

    open_long = can_trade & (a == 1) & (pos <= 0)
    open_short = can_trade & (a == 2) & (pos >= 0)
    diag = add_count_(diag, "entry_orders_submitted", open_long | open_short)

    submit = open_long | open_short | session_close
    target = torch.where(
        session_close,
        0.0,
        torch.where(open_long, size, torch.where(open_short, -size, 0.0)),
    )
    sl = torch.where(open_long, c - sl_dist, torch.where(open_short, c + sl_dist, 0.0))
    tp = torch.where(open_long, c + tp_dist, torch.where(open_short, c - tp_dist, 0.0))
    return state, diag, (submit, target, sl, tp)


def _compute_size(state, c, params, cfg):
    cash = params.initial_cash + state.cash_delta
    raw_fx = cash * params.rel_volume * params.leverage
    raw_notional = torch.where(c > 0, raw_fx / torch.clamp_min(c, 1e-30), 0.0)
    raw = raw_notional if cfg.size_mode == "notional" else raw_fx
    sized = torch.minimum(
        torch.maximum(raw, params.min_order_volume), params.max_order_volume
    )
    return torch.where(params.use_rel_volume > 0, sized, params.position_size)


def _effective_sltp_multiples(cfg: EnvConfig, params: EnvParams):
    k_sl = torch.clamp_min(params.k_sl, 0.0)
    k_tp = torch.clamp_min(params.k_tp, 0.0)
    if cfg.sltp_risk_mode not in ("rel_volume_aware_atr", "margin_aware_atr"):
        return k_sl, k_tp
    rel = torch.clamp_min(params.rel_volume * params.use_rel_volume, 0.0)
    baseline = torch.clamp_min(params.baseline_rel_volume, 0.0)
    max_rel = torch.maximum(baseline + 1e-12, params.max_risk_rel_volume)
    sl_alpha = torch.clamp(params.rel_volume_sl_shrink_alpha, 0.0, 0.95)
    tp_alpha = torch.clamp(params.rel_volume_tp_shrink_alpha, 0.0, 0.95)
    min_k_sl = torch.clamp_min(params.min_k_sl, 0.0)
    min_rr = torch.clamp_min(params.min_reward_risk_ratio, 0.0)
    progress = torch.clamp((rel - baseline) / (max_rel - baseline), 0.0, 1.0)
    shrink = rel > baseline
    k_sl_eff = torch.where(
        shrink, torch.maximum(min_k_sl, k_sl * (1.0 - sl_alpha * progress)), k_sl
    )
    k_tp_eff = torch.where(shrink, k_tp * (1.0 - tp_alpha * progress), k_tp)
    k_tp_eff = torch.maximum(k_tp_eff, k_sl_eff * min_rr)
    return k_sl_eff, k_tp_eff
