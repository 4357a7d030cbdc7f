"""Branch-free broker ledger, batched over envs.

The port of ``gymfx_tpu/core/broker.py``, op for op (same operations in
the same order, selects kept as selects), so the f32 ledger is bitwise
the JAX package's.  It is also the plain arithmetic of kernels K2 and
K3 (ops/env_dynamics.py): their plain versions call these functions.

Two helpers keep XLA's semantics where torch's differ: :func:`sign`
(XLA keeps NaN and -0.0, ``torch.sign`` maps both to 0) and
:func:`quantize` (f32 round-half-even; the JAX package's x64 branch does
not exist here because the port never runs its f32 ledger in f64).
"""
from __future__ import annotations

import torch

from gymfx_tpu_torch.core.types import EXEC_DIAG_INDEX, EnvConfig, EnvParams, EnvState


def sign(x):
    """XLA's ``sign``: -1, +1, and x itself for ±0 and NaN."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x)).to(x.dtype)


def add_count(diag, key: str, amount):
    """``diag.at[:, key].add(amount)`` on a copy (the input is left as it was)."""
    return add_count_(diag.clone(), key, amount)


def add_count_(diag, key: str, amount):
    """``diag.at[:, key].add(amount)`` in place, for a counter block the
    caller owns (core/env.transition copies it once per step)."""
    diag[:, EXEC_DIAG_INDEX[key]] += amount.to(torch.int32)
    return diag


def quantize(x, tick):
    """Round ``x`` to the nearest multiple of ``tick`` (half-even);
    identity when tick == 0."""
    safe = torch.where(tick > 0, tick, 1.0)
    return torch.where(tick > 0, torch.round(x / safe) * safe, x)


def snap_in_bar(price, low, high, tick):
    """Clip into [low, high], then snap to the nearest in-bar tick."""
    p = torch.minimum(torch.maximum(price, low), high)
    q = quantize(p, tick)
    down, up = q - tick, q + tick
    q = torch.where((q > high) & (down >= low), down, q)
    q = torch.where((q < low) & (up <= high), up, q)
    return q


def opening_units(pos, target):
    """Units newly opened by moving ``pos`` -> ``target``."""
    same_sign = pos * target > 0
    opening = torch.clamp_min(target.abs() - pos.abs(), 0.0)
    return torch.where(
        (~same_sign) & (target != 0) & (pos != 0), target.abs(), opening
    )


def maintenance_margin(pos, price, params: EnvParams, margin_model: str):
    m = pos.abs() * price * params.margin_maint
    if margin_model == "leveraged":
        m = m / torch.clamp_min(params.leverage, 1e-12)
    return m


def margin_closeout_percent(state: EnvState, price, params: EnvParams,
                            margin_model: str, cap: float = 100.0):
    maint = maintenance_margin(state.pos, price, params, margin_model)
    eq = params.initial_cash + state.equity_delta
    pct = torch.where(eq > 0, maint / torch.clamp_min(eq, 1e-30), cap)
    pct = torch.where(state.pos == 0, 0.0, pct)
    return torch.clamp(pct, 0.0, cap)


def realized_balance(state: EnvState, params: EnvParams):
    return params.initial_cash + state.cash_delta + state.pos * state.entry_price


def apply_fill(state: EnvState, fill_price, target_units, params: EnvParams) -> EnvState:
    """Move the position to ``target_units`` at ``fill_price``
    (pre-slippage): open/add/reduce/close/flip with average entry price,
    commission and closed-trade statistics."""
    pos = state.pos
    target = target_units.to(pos.dtype)
    delta = target - pos
    direction = sign(delta)
    fill = quantize(fill_price * (1.0 + params.slippage * direction), params.price_tick)

    abs_pos = pos.abs()
    abs_target = target.abs()
    same_sign = pos * target > 0
    closed = torch.where(same_sign, torch.clamp_min(abs_pos - abs_target, 0.0), abs_pos)
    closed = torch.where(delta == 0, 0.0, closed)

    realized = closed * (fill - state.entry_price) * sign(pos)
    commission = params.commission * fill * delta.abs()
    comm_close = params.commission * fill * closed
    comm_open = commission - comm_close

    cash_delta = state.cash_delta - delta * fill - commission

    new_abs = target.abs()
    adding = same_sign & (abs_target > abs_pos)
    flipping = (~same_sign) & (target != 0) & (pos != 0)
    opening = (pos == 0) & (target != 0)
    entry = torch.where(
        adding,
        (state.entry_price * abs_pos + fill * (new_abs - abs_pos))
        / torch.clamp_min(new_abs, 1e-30),
        state.entry_price,
    )
    entry = torch.where(flipping | opening, fill, entry)
    entry = torch.where(target == 0, 0.0, entry)

    trade_closed = (pos != 0) & ((target == 0) | flipping)
    trade_net = realized - (state.open_trade_commission + comm_close)
    trade_pnl_sum = state.trade_pnl_sum + torch.where(trade_closed, trade_net, 0.0)
    trade_pnl_sumsq = state.trade_pnl_sumsq + torch.where(
        trade_closed, trade_net * trade_net, 0.0
    )
    open_trade_commission = torch.where(
        trade_closed, comm_open, state.open_trade_commission + comm_open
    )
    open_trade_commission = torch.where(target == 0, 0.0, open_trade_commission)
    i32 = torch.int32
    return state._replace(
        pos=target,
        entry_price=entry,
        cash_delta=cash_delta,
        commission_paid=state.commission_paid + commission,
        last_trade_cost=state.last_trade_cost + commission,
        trade_count=state.trade_count + trade_closed.to(i32),
        trade_pnl_sum=trade_pnl_sum,
        trade_pnl_sumsq=trade_pnl_sumsq,
        trades_won=state.trades_won + (trade_closed & (trade_net > 0)).to(i32),
        trades_lost=state.trades_lost + (trade_closed & (trade_net < 0)).to(i32),
        open_trade_commission=open_trade_commission,
    )


def fill_pending(state: EnvState, open_price, params: EnvParams,
                 cfg: EnvConfig, high, low) -> EnvState:
    """Execute the pending market order at the new bar's open (size-step
    rounding and min-quantity denial, slip_open / slip_match switches)."""
    raw_target = torch.where(state.pending_active, state.pending_target, state.pos)
    delta = raw_target - state.pos
    qty = quantize(delta.abs(), params.size_step)
    forced = state.pending_active & state.pending_forced
    qty = torch.where(forced, delta.abs(), qty)
    denied = (
        state.pending_active
        & ~forced
        & (delta != 0)
        & ((qty < params.min_qty) | ((params.size_step > 0) & (qty <= 0)))
    )
    target = torch.where(denied, state.pos, state.pos + sign(delta) * qty)
    state = state._replace(
        exec_diag=add_count(state.exec_diag, "order_denied_min_quantity", denied)
    )
    fill_price = open_price
    if (not cfg.slip_open) or cfg.slip_match:
        direction = sign(target - state.pos)
        final = open_price * (
            1.0 + params.slippage * (1.0 if cfg.slip_open else 0.0) * direction
        )
        if cfg.slip_match:
            final = snap_in_bar(final, low, high, params.price_tick)
        denom = 1.0 + params.slippage * direction
        fill_price = final / torch.where(denom == 0, 1.0, denom)
    new_state = apply_fill(state, fill_price, target, params)
    entered = (
        state.pending_active
        & (new_state.pos != 0)
        & (opening_units(state.pos, target) > 0)
    )
    bracket_sl = torch.where(
        entered, quantize(state.pending_sl, params.price_tick), state.bracket_sl
    )
    bracket_tp = torch.where(
        entered, quantize(state.pending_tp, params.price_tick), state.bracket_tp
    )
    flat = new_state.pos == 0
    return new_state._replace(
        pending_active=torch.zeros_like(state.pending_active),
        pending_target=torch.zeros_like(state.pending_target),
        pending_sl=torch.zeros_like(state.pending_sl),
        pending_tp=torch.zeros_like(state.pending_tp),
        pending_forced=torch.zeros_like(state.pending_forced),
        bracket_sl=torch.where(flat, 0.0, bracket_sl),
        bracket_tp=torch.where(flat, 0.0, bracket_tp),
    )


def check_brackets(state: EnvState, open_price, high, low, cfg: EnvConfig,
                   params: EnvParams) -> EnvState:
    """Resolve SL/TP exits intrabar against the bar's H/L (collision and
    limit-fill policies, slip_open / slip_limit / slip_match)."""
    pos = state.pos
    has_pos = pos != 0
    long = pos > 0
    sl = state.bracket_sl
    tp = state.bracket_tp
    has_sl = sl > 0
    has_tp = tp > 0

    sl_trig = has_pos & has_sl & torch.where(long, low <= sl, high >= sl)
    strict = cfg.limit_fill_policy == "conservative"
    if strict:
        tp_trig = has_pos & has_tp & torch.where(long, high > tp, low < tp)
    else:
        tp_trig = has_pos & has_tp & torch.where(long, high >= tp, low <= tp)
    sl_fill = torch.where(
        long,
        torch.where(open_price <= sl, open_price, sl),
        torch.where(open_price >= sl, open_price, sl),
    )
    if cfg.limit_fill_policy == "cross":
        tp_fill = torch.where(
            long,
            torch.where(open_price >= tp, open_price, tp),
            torch.where(open_price <= tp, open_price, tp),
        )
    else:
        tp_fill = tp

    if cfg.intrabar_collision_policy == "ohlc":
        gap_sl = has_pos & has_sl & torch.where(long, open_price <= sl, open_price >= sl)
        if strict:
            gap_tp = has_pos & has_tp & torch.where(long, open_price > tp, open_price < tp)
        else:
            gap_tp = has_pos & has_tp & torch.where(long, open_price >= tp, open_price <= tp)
        exit_sl = gap_sl | (sl_trig & ~gap_tp & torch.where(long, ~tp_trig, True))
        exit_tp = (gap_tp | tp_trig) & ~exit_sl
    else:
        exit_sl = sl_trig
        exit_tp = tp_trig & ~sl_trig

    exiting = exit_sl | exit_tp
    exit_dir = -sign(pos)
    denom = 1.0 + params.slippage * exit_dir
    safe_denom = torch.where(denom == 0, 1.0, denom)
    if cfg.slip_open and not cfg.slip_match:
        sl_adj = sl_fill
    else:
        sl_gap = has_pos & has_sl & torch.where(long, open_price <= sl, open_price >= sl)
        sl_scale = torch.where(sl_gap, 1.0 if cfg.slip_open else 0.0, 1.0).to(pos.dtype)
        sl_final = sl_fill * (1.0 + params.slippage * sl_scale * exit_dir)
        if cfg.slip_match:
            sl_final = snap_in_bar(sl_final, low, high, params.price_tick)
        sl_adj = sl_final / safe_denom
    if cfg.slip_limit:
        tp_final = tp_fill * (1.0 + params.slippage * exit_dir)
        if cfg.slip_match:
            tp_final = snap_in_bar(tp_final, low, high, params.price_tick)
        tp_final = torch.where(
            long, torch.maximum(tp_final, tp), torch.minimum(tp_final, tp)
        )
        tp_adj = tp_final / safe_denom
    else:
        tp_adj = tp_fill / safe_denom
    adj_price = torch.where(exit_sl, sl_adj, tp_adj)

    target = torch.where(exiting, 0.0, pos)
    new_state = apply_fill(
        state, torch.where(exiting, adj_price, open_price), target, params
    )
    return new_state._replace(
        bracket_sl=torch.where(exiting, 0.0, state.bracket_sl),
        bracket_tp=torch.where(exiting, 0.0, state.bracket_tp),
    )


def mark_to_market(state: EnvState, close_price, params: EnvParams) -> EnvState:
    """Mark equity at the bar close; update drawdown tracking."""
    equity_delta = state.cash_delta + state.pos * close_price
    peak = torch.maximum(state.peak_equity_delta, equity_delta)
    money_down = peak - equity_delta
    peak_equity = params.initial_cash + peak
    pct_down = torch.where(peak_equity > 0, money_down / peak_equity * 100.0, 0.0)
    return state._replace(
        prev_equity_delta=state.equity_delta,
        equity_delta=equity_delta,
        peak_equity_delta=peak,
        max_drawdown_money=torch.maximum(state.max_drawdown_money, money_down),
        max_drawdown_pct=torch.maximum(state.max_drawdown_pct, pct_down),
    )


def equity(state: EnvState, params: EnvParams):
    return params.initial_cash + state.equity_delta


def prev_equity(state: EnvState, params: EnvParams):
    return params.initial_cash + state.prev_equity_delta
