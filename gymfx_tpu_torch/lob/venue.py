"""LOB execution venue: one bar's agent execution through the book, per env.

The port of ``gymfx_tpu/lob/venue.py`` (see its module docstring for the
venue's semantics).  ``execute_bar`` replaces the bar venue's fill and
bracket steps (kernel K2) when ``cfg.venue == "lob"``; every env gets a
fresh book seeded at its bar open, the pending order walks it at the
open, the take-profit rests in it as an agent order, and the bar's
seeded flow runs through it with a stop triggered on prints.

Its stages are functions of their own, so a profiler can range them
(``profile_rollout.py``):

  :func:`seed_book`   ``lob_seed``: the fresh books, seeded through K5
                      (ops/lob_match.process_stream)
  :func:`bar_flow`    ``lob_flow``: the bar's seeded flow messages, K9
                      (ops/lob_flow.bar_flow)
  :func:`bar_orders`  ``lob_orders``: the agent's int32 inputs of the
                      bar's book work (ops/lob_bar.BarOrders), from the
                      state alone
  ``lob_bar.run_bar`` ``lob_bar``: every book operation of the bar, K8
                      (the open walk, the gap stop, the resting
                      take-profit, the flow with the stop's trigger,
                      cancel and walk)
  :func:`bar_fills`   ``lob_fills``: the open fill, the exit fill and the
                      brackets

The reference interleaves the open fill with the book work; here every
book input is computed first, which the ledger allows: ``apply_fill``
lands the position exactly on its target, and it leaves the brackets
alone, so the position after the open fill and the armed brackets are
known before the book runs, and the book's results are needed only by
the two fills after it.  Every float op is the reference's, on the same
values.  Prices divide by the tick as a 0-d tensor on the env's device
(CUDA divides by a host scalar through its reciprocal).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from gymfx_tpu_torch.core import broker
from gymfx_tpu_torch.core.types import EnvConfig, EnvParams, EnvState
from gymfx_tpu_torch.lob.book import BookState, Messages, empty_book
from gymfx_tpu_torch.lob.flow import price_to_ticks, seed_messages
from gymfx_tpu_torch.lob.scenarios import regime_flow_sets, regime_kind, scenario_flow_params
from gymfx_tpu_torch.ops import lob_bar, lob_flow, lob_match
from gymfx_tpu_torch.ops.lob_bar import BarFills, BarOrders

I32 = torch.int32


class Entry(NamedTuple):
    """The open fill's inputs that are not the book's, (N,) each."""

    denied: Any         # bool: the pending order was below one lot
    ledger_target: Any  # float: the position after the open fill
    bracket_sl: Any     # float: the brackets after the open fill
    bracket_tp: Any


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


def seed_book(o_t, cfg: EnvConfig, scen_flags=None) -> BookState:
    """Fresh books seeded with the scenario's baseline depth at each env's
    open tick ``o_t``: the seed stream runs through K5.  With
    ``scen_flags`` each env's depth is its bar's blend's ``seed_qty``."""
    fp = scenario_flow_params(cfg.lob_scenario)
    if scen_flags is not None:
        # the blend's seed depth follows the drought bit alone (a select of
        # two host numbers: nothing is copied, so a CUDA graph captures it)
        sets = regime_flow_sets(fp, cfg.lob_messages_per_bar)
        drought = (regime_kind(scen_flags) & 1) != 0
        fp = fp._replace(seed_qty=torch.where(drought, sets[1].seed_qty, sets[0].seed_qty))
    book = empty_book(o_t.shape[0], cfg.lob_depth_levels, cfg.lob_queue_slots, o_t.device)
    book, _ = lob_match.process_stream(book, seed_messages(o_t, cfg.lob_seed_levels, fp))
    return book


def bar_flow(o_t, h_t, l_t, c_t, t_global, cfg: EnvConfig, scen_flags=None) -> Messages:
    """The bar's ``lob_messages_per_bar`` flow messages per env, keyed by
    its bar row ``t_global``: (N, M), through K9 (its flag route with
    ``scen_flags``)."""
    return lob_flow.bar_flow(cfg.lob_flow_seed, t_global, o_t, h_t, l_t, c_t,
                             cfg.lob_messages_per_bar, scenario_flow_params(cfg.lob_scenario),
                             scen_flags)


def bar_orders(state: EnvState, o_t, tick, cfg: EnvConfig, params: EnvParams):
    """The agent's inputs of the bar's book work, from the state before
    it: the pending order's lots and side at the open (a forced
    liquidation always trades >= 1 lot and lands the ledger on its target;
    a sub-lot order is denied), the position after the open fill in lots,
    its exit side and the brackets armed after the fill in ticks.
    Returns (BarOrders, Entry)."""
    d = state.pos.dtype
    lot_units = lot_size(cfg, params)
    raw_target = torch.where(state.pending_active, state.pending_target, state.pos)
    delta = raw_target - state.pos
    lots_raw = to_lots(delta, lot_units)
    forced = state.pending_active & state.pending_forced
    lots = torch.where(forced & (delta != 0), torch.clamp_min(lots_raw, 1), lots_raw)
    denied = state.pending_active & ~forced & (delta != 0) & (lots < 1)
    exec_lots = torch.where(state.pending_active & ~denied, lots, 0)
    signed_lots = broker.sign(delta) * exec_lots.to(d) * lot_units
    ledger_target = torch.where(denied, state.pos, state.pos + signed_lots)
    ledger_target = torch.where(forced, raw_target, ledger_target)
    # brackets arm when the fill opens units, quantized to the tick grid;
    # apply_fill lands the position on ledger_target exactly
    entered = (
        state.pending_active
        & (ledger_target != 0)
        & (broker.opening_units(state.pos, ledger_target) > 0)
    )
    sl_armed = bracket_ticks(state.pending_sl, tick).to(d) * tick
    tp_armed = bracket_ticks(state.pending_tp, tick).to(d) * tick
    flat = ledger_target == 0
    bracket_sl = torch.where(flat, 0.0, torch.where(entered, sl_armed, state.bracket_sl))
    bracket_tp = torch.where(flat, 0.0, torch.where(entered, tp_armed, state.bracket_tp))
    orders = BarOrders(
        open_lots=exec_lots,
        open_buy=(delta > 0).to(I32),
        open_tick=o_t,
        pos_lots=to_lots(ledger_target, lot_units),
        exit_buy=(~(ledger_target > 0)).to(I32),  # exiting a short buys
        stop=bracket_ticks(bracket_sl, tick),
        take_profit=bracket_ticks(bracket_tp, tick),
    )
    return orders, Entry(denied, ledger_target, bracket_sl, bracket_tp)


def bar_fills(state: EnvState, entry: Entry, orders: BarOrders, fills: BarFills, o, tick,
              cfg: EnvConfig, params: EnvParams) -> EnvState:
    """The ledger after the bar: the open walk's fill, then the exits as
    one fill at their lots-weighted vwap (exact: realized PnL and
    commission are linear in price at fixed lots); brackets survive a
    partial take-profit, a full exit or a fired stop clears them."""
    d = state.pos.dtype
    lot_units = lot_size(cfg, params)
    state = state._replace(
        exec_diag=broker.add_count(state.exec_diag, "order_denied_min_quantity", entry.denied)
    )
    open_price = _vwap_price(fills.open_value, orders.open_lots, tick, d)
    st = broker.apply_fill(
        state, torch.where(orders.open_lots > 0, open_price, o), entry.ledger_target, params
    )
    st = st._replace(
        pending_active=torch.zeros_like(state.pending_active),
        pending_target=torch.zeros_like(state.pending_target),
        pending_sl=torch.zeros_like(state.pending_sl),
        pending_tp=torch.zeros_like(state.pending_tp),
        pending_forced=torch.zeros_like(state.pending_forced),
        bracket_sl=entry.bracket_sl,
        bracket_tp=entry.bracket_tp,
    )

    pos_lots = orders.pos_lots
    exit_lots = fills.tp_lots + fills.sl_lots
    exit_value = fills.tp_value + fills.sl_value
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
    cleared = (st.pos == 0) | (fills.fired != 0)
    return st._replace(
        bracket_sl=torch.where(cleared, 0.0, st.bracket_sl),
        bracket_tp=torch.where(cleared, 0.0, st.bracket_tp),
    )


def execute_bar(state: EnvState, o, h, l, c, t_global, cfg: EnvConfig,
                params: EnvParams, scen_flags=None) -> EnvState:
    """One advancing bar of every env through the LOB venue (replaces the
    fill and bracket steps; the caller selects by its ``advance`` mask).
    ``o, h, l, c`` are (N,) bar prices, ``t_global`` the (N,) bar rows
    that key the flow.  ``scen_flags`` (feed=scengen only): each env's
    bar's scenario bits, which blend its flow and seed depth per bar
    (``lob/scenarios.flow_params_from_regime``)."""
    tick = torch.full((), cfg.lob_tick_size, dtype=state.pos.dtype, device=state.pos.device)
    o_t = price_to_ticks(o, tick)
    c_t = price_to_ticks(c, tick)
    h_t = torch.maximum(price_to_ticks(h, tick), torch.maximum(o_t, c_t))
    l_t = torch.minimum(price_to_ticks(l, tick), torch.minimum(o_t, c_t))
    book = seed_book(o_t, cfg, scen_flags)
    flow = bar_flow(o_t, h_t, l_t, c_t, t_global, cfg, scen_flags)
    orders, entry = bar_orders(state, o_t, tick, cfg, params)
    _, fills = lob_bar.run_bar(book, flow, orders)
    return bar_fills(state, entry, orders, fills, o, tick, cfg, params)


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
