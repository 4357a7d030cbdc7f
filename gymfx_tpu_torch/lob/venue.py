"""LOB execution venue: one bar's agent execution through the book, per env.

The port of ``gymfx_tpu/lob/venue.py`` (see its module docstring for the
venue's semantics).  ``execute_bar`` replaces the bar venue's fill and
bracket steps (kernel K2) when ``cfg.venue == "lob"``; every env gets a
fresh book seeded at its bar open, the pending order walks it at the
open, the take-profit rests in it as an agent order, and the bar's
seeded flow runs through it with a stop triggered on prints.

Its three stages are functions of their own, so a profiler can range
them (``profile_rollout.py``):

  :func:`seed_book`  the fresh books, seeded through K5
                     (ops/lob_match.process_stream)
  :func:`open_walk`  the pending order's market walk at the open and its
                     ledger fill
  :func:`intrabar`   the gap stop, the resting take-profit and the scan
                     of ``lob_messages_per_bar`` flow messages through
                     ``book.process_message``, then the exit fill

Where the JAX package's ``lax.cond`` on the stop trigger computes both
branches and selects, the port runs the fire branch for every env with a
zero cancel target and a zero walk where the stop did not fire: bitwise
no-ops on the book (lob/book.py), and an exit value of 0, as the other
branch gives.  Prices divide by the tick as a 0-d tensor on the env's
device (CUDA divides by a host scalar through its reciprocal).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from gymfx_tpu_torch.core import broker
from gymfx_tpu_torch.core.types import EnvConfig, EnvParams, EnvState
from gymfx_tpu_torch.lob.book import (
    AGENT_OID,
    BookState,
    Messages,
    add_limit,
    cancel,
    empty_book,
    match_market,
    process_message,
)
from gymfx_tpu_torch.lob.flow import bar_key, bar_messages, price_to_ticks, seed_messages
from gymfx_tpu_torch.lob.scenarios import scenario_flow_params
from gymfx_tpu_torch.ops import lob_match

I32 = torch.int32


def lot_size(cfg: EnvConfig, params: EnvParams):
    """Units per lot: the static config override, else position_size."""
    if cfg.lob_lot_units > 0:
        return torch.full((), cfg.lob_lot_units, dtype=params.position_size.dtype,
                          device=params.position_size.device)
    return params.position_size


def to_lots(units, lot_units):
    """|units| -> integer lots (round-half-even)."""
    return torch.round(units.abs() / lot_units).to(I32)


def bracket_ticks(price, tick):
    """Bracket prices -> the tick grid (0 stays 0 = disarmed)."""
    return torch.round(price / tick).to(I32)


def _vwap_price(value, lots, tick, dtype):
    """Integer (tick * lots) fill values -> per-unit float prices."""
    lots_f = torch.clamp_min(lots, 1).to(dtype)
    return value.to(dtype) / lots_f * tick


def _walk_with_backstop(book: BookState, is_buy, lots, backstop_ticks):
    """Market-walk ``lots`` against the books; the unfilled remainder is
    priced at the worst touched level (else ``backstop_ticks``).
    Returns (books, total value in tick-lots, worst touched)."""
    book, fill = match_market(book, is_buy, lots)
    worst = torch.where(
        fill.filled_qty > 0,
        torch.where(is_buy, fill.price_max, fill.price_min),
        backstop_ticks,
    )
    value = fill.filled_value + (lots - fill.filled_qty) * worst
    return book, value, worst


def seed_book(o_t, cfg: EnvConfig) -> BookState:
    """Fresh books seeded with the scenario's baseline depth at each env's
    open tick ``o_t``: the seed stream runs through K5."""
    fp = scenario_flow_params(cfg.lob_scenario)
    book = empty_book(o_t.shape[0], cfg.lob_depth_levels, cfg.lob_queue_slots, o_t.device)
    book, _ = lob_match.process_stream(book, seed_messages(o_t, cfg.lob_seed_levels, fp))
    return book


def open_walk(state: EnvState, book: BookState, o, o_t, tick, cfg: EnvConfig,
              params: EnvParams):
    """Step 1: the pending order executes as a market walk at the open.
    Returns (state after the entry fill and bracket arming, books)."""
    d = state.pos.dtype
    lot_units = lot_size(cfg, params)
    raw_target = torch.where(state.pending_active, state.pending_target, state.pos)
    delta = raw_target - state.pos
    lots_raw = to_lots(delta, lot_units)
    forced = state.pending_active & state.pending_forced
    # a forced liquidation always trades (>= 1 lot for pricing) and the
    # ledger lands exactly on its target
    lots = torch.where(forced & (delta != 0), torch.clamp_min(lots_raw, 1), lots_raw)
    denied = state.pending_active & ~forced & (delta != 0) & (lots < 1)
    exec_lots = torch.where(state.pending_active & ~denied, lots, 0)
    is_buy = delta > 0
    book, open_value, _ = _walk_with_backstop(book, is_buy, exec_lots, o_t)
    open_price = _vwap_price(open_value, exec_lots, tick, d)

    signed_lots = broker.sign(delta) * exec_lots.to(d) * lot_units
    ledger_target = torch.where(denied, state.pos, state.pos + signed_lots)
    ledger_target = torch.where(forced, raw_target, ledger_target)

    state = state._replace(
        exec_diag=broker.add_count(state.exec_diag, "order_denied_min_quantity", denied)
    )
    st = broker.apply_fill(
        state, torch.where(exec_lots > 0, open_price, o), ledger_target, params
    )
    # brackets arm when the fill opened units, quantized to the tick grid
    entered = (
        state.pending_active
        & (st.pos != 0)
        & (broker.opening_units(state.pos, ledger_target) > 0)
    )
    sl_armed = bracket_ticks(state.pending_sl, tick).to(d) * tick
    tp_armed = bracket_ticks(state.pending_tp, tick).to(d) * tick
    flat = st.pos == 0
    st = st._replace(
        pending_active=torch.zeros_like(state.pending_active),
        pending_target=torch.zeros_like(state.pending_target),
        pending_sl=torch.zeros_like(state.pending_sl),
        pending_tp=torch.zeros_like(state.pending_tp),
        pending_forced=torch.zeros_like(state.pending_forced),
        bracket_sl=torch.where(flat, 0.0, torch.where(entered, sl_armed, st.bracket_sl)),
        bracket_tp=torch.where(flat, 0.0, torch.where(entered, tp_armed, st.bracket_tp)),
    )
    return st, book


def intrabar(st: EnvState, book: BookState, o, o_t, h_t, l_t, c_t, t_global, tick,
             cfg: EnvConfig, params: EnvParams) -> EnvState:
    """Step 2 and 3: the take-profit rests in the book, the stop triggers
    on prints of the bar's flow, and the exits book as one ledger fill."""
    d = st.pos.dtype
    lot_units = lot_size(cfg, params)
    pos_lots = to_lots(st.pos, lot_units)
    long = st.pos > 0
    exit_is_buy = ~long  # exiting a short buys
    sl = bracket_ticks(st.bracket_sl, tick)
    tp = bracket_ticks(st.bracket_tp, tick)
    has_sl = (sl > 0) & (pos_lots > 0)
    has_tp = (tp > 0) & (pos_lots > 0)

    # a bar that gaps open through the stop exits at the open walk
    gap_sl = has_sl & torch.where(long, o_t <= sl, o_t >= sl)
    gap_lots = torch.where(gap_sl, pos_lots, 0)
    book, gap_value, _ = _walk_with_backstop(book, exit_is_buy, gap_lots, o_t)

    # rest the TP (skipped when the gap stop already flattened the bar);
    # its marketable part fills immediately at maker prices
    tp_rest = torch.where(has_tp & ~gap_sl, pos_lots, 0)
    agent = torch.full_like(tp_rest, AGENT_OID)
    book, tp_fill0 = add_limit(book, exit_is_buy, torch.clamp_min(tp, 1), tp_rest, agent)

    rem = pos_lots - gap_lots - tp_fill0.filled_qty
    fired = gap_sl
    tp_lots, tp_value = tp_fill0.filled_qty, tp_fill0.filled_value
    sl_lots, sl_value = gap_lots, gap_value
    flow = bar_messages(
        bar_key(cfg.lob_flow_seed, t_global), o_t, h_t, l_t, c_t,
        cfg.lob_messages_per_bar, scenario_flow_params(cfg.lob_scenario),
    )
    for m in range(cfg.lob_messages_per_bar):
        book, fill = process_message(book, Messages(*(x[:, m] for x in flow)))
        # flow takers reaching our resting TP (maker fills)
        rem = rem - fill.agent_qty
        tp_lots = tp_lots + fill.agent_qty
        tp_value = tp_value + fill.agent_value
        # stop trigger: the first print at/through the stop level
        printed = torch.where(long, fill.price_min <= sl, fill.price_max >= sl)
        trig = has_sl & ~fired & (rem > 0) & printed
        # fire: pull the TP, walk the remaining lots (no-ops where ~trig)
        book, _ = cancel(book, exit_is_buy, torch.where(trig, agent, 0))
        book, xvalue, _ = _walk_with_backstop(book, exit_is_buy, torch.where(trig, rem, 0), sl)
        sl_lots = sl_lots + torch.where(trig, rem, 0)
        sl_value = sl_value + torch.where(trig, xvalue, 0)
        rem = torch.where(trig, 0, rem)
        fired = fired | trig

    # aggregate exit fill (lots-weighted vwap; exact: realized PnL and
    # commission are linear in price at fixed lots)
    exit_lots = tp_lots + sl_lots
    exit_value = tp_value + sl_value
    full_exit = (exit_lots >= pos_lots) & (pos_lots > 0)
    exit_target = torch.where(
        full_exit,
        torch.zeros_like(st.pos),
        st.pos - broker.sign(st.pos) * exit_lots.to(d) * lot_units,
    )
    exit_price = _vwap_price(exit_value, exit_lots, tick, d)
    st = broker.apply_fill(
        st,
        torch.where(exit_lots > 0, exit_price, o),
        torch.where(exit_lots > 0, exit_target, st.pos),
        params,
    )
    # brackets survive a partial TP (re-rested with the remaining lots
    # next bar); a full exit or fired stop clears them
    cleared = (st.pos == 0) | fired
    return st._replace(
        bracket_sl=torch.where(cleared, 0.0, st.bracket_sl),
        bracket_tp=torch.where(cleared, 0.0, st.bracket_tp),
    )


def execute_bar(state: EnvState, o, h, l, c, t_global, cfg: EnvConfig,
                params: EnvParams) -> EnvState:
    """One advancing bar of every env through the LOB venue (replaces the
    fill and bracket steps; the caller selects by its ``advance`` mask).
    ``o, h, l, c`` are (N,) bar prices, ``t_global`` the (N,) bar rows
    that key the flow."""
    tick = torch.full((), cfg.lob_tick_size, dtype=state.pos.dtype, device=state.pos.device)
    o_t = price_to_ticks(o, tick)
    c_t = price_to_ticks(c, tick)
    h_t = torch.maximum(price_to_ticks(h, tick), torch.maximum(o_t, c_t))
    l_t = torch.minimum(price_to_ticks(l, tick), torch.minimum(o_t, c_t))
    book = seed_book(o_t, cfg)
    st, book = open_walk(state, book, o, o_t, tick, cfg, params)
    return intrabar(st, book, o, o_t, h_t, l_t, c_t, t_global, tick, cfg, params)


def validate_lob_venue(cfg: EnvConfig, config: Dict[str, Any]) -> None:
    """Honor-or-reject at Environment construction: every config knob is
    either honored by the LOB venue or rejected loudly."""
    if cfg.venue != "lob":
        return
    problems = []
    if cfg.session_filter:
        problems.append(
            "session_filter=True: the calendar force-close strategy "
            "semantics are not implemented on the LOB venue yet"
        )
    if config.get("venue_quantization"):
        problems.append(
            "venue_quantization=True: the LOB venue quotes on its own "
            "lob_tick_size grid; the bar engine's tick/size-step "
            "quantization cannot be honored on top of it"
        )
    slippage = float(config.get("slippage_perc", config.get("slippage", 0.0)) or 0.0)
    if slippage != 0.0:
        problems.append(
            f"slippage={slippage}: the LOB venue derives slippage from "
            "book depth; fractional price slippage cannot be honored"
        )
    if config.get("execution_cost_profile"):
        problems.append(
            "execution_cost_profile: profiles drive spread/slippage "
            "displacement and fill policies the LOB venue replaces with "
            "book matching"
        )
    if str(config.get("limit_fill_policy", "cross")) != "cross":
        problems.append(
            f"limit_fill_policy={config['limit_fill_policy']!r}: the LOB "
            "take-profit is a resting limit order; only the default "
            "'cross' is honored"
        )
    if "intrabar_collision_policy" in config:
        problems.append(
            "intrabar_collision_policy: the LOB venue resolves SL/TP by "
            "actual print order along the flow path; collision policies "
            "are a bar-engine concept"
        )
    if problems:
        raise ValueError(
            "venue=lob cannot honor this configuration:\n  - "
            + "\n  - ".join(problems)
        )
