"""Deterministic multi-asset target-position replay engine.

The port's copy of ``gymfx_tpu/simulation/replay.py``, line for line
the same float64 host arithmetic, so the same scripts give the same
events and the same sha256 hashes.  Counterpart of the reference's
NautilusTrader adapter (reference simulation_engines/nautilus_adapter.py:
315-458): run a scripted list of target-position actions through an
execution engine under a versioned ExecutionCostProfile and export
immutable event facts with sha256 event/result hashes.

The throughput engine is the batched env step (core/broker.py and K2 /
K3 on the card); this replay engine is its verification twin: an
explicit float64 event machine that walks quote paths tick by tick.  It
proves execution semantics (netting, partial close, reversal, intrabar
bracket ordering, margin preflight with cross-currency conversion,
overnight financing) with bit-stable, content-hashable outputs, the role
the external Nautilus engine plays for the reference.

Execution model:
  * each MarketFrame expands to quote ticks along its execution_path
    (default: just the close), bid/ask displaced from mid by the
    profile's quote_adverse_rate_per_side (contracts.py:44-47);
  * a target action at a frame's timestamp nets against the current
    position; with latency_ms == 0, market orders fill at the current
    top-of-book (ask for buys, bid for sells) of that frame's LAST path
    tick; with latency_ms > 0, the order (a fixed delta computed at
    submission) is queued and fills at the FIRST path tick of the
    earliest same-instrument frame at/after submission + latency — the
    deterministic counterpart of the reference's LatencyModel
    (reference simulation_engines/nautilus_adapter.py:415-417);
  * fills pass through a seeded ``FillModel`` (counterpart of Nautilus'
    FillModel(random_seed), reference nautilus_adapter.py:413): with the
    default probabilities (limit 1.0 / stop 1.0 / slippage 0.0) it is a
    deterministic pass-through, matching the reference's own defaults;
  * brackets (SL/TP on a flat->open action) are evaluated against every
    subsequent quote tick in path order, so intrabar collision ordering
    is defined by the data's execution_path, not by a heuristic; the
    take-profit honors the profile's limit_fill_policy — conservative
    (must trade strictly through; fills at the limit), touch (an exact
    touch fills at the limit), cross (a touch fills at the touching
    tick's market price — price improvement);
  * venue order validation: book prices and SL/TP triggers are
    quantized to the instrument's price_precision, order quantities to
    its size_precision, and orders below min_quantity are denied
    (order_denied event) — the reference venue's make_price/make_qty/
    RiskEngine behavior (nautilus_adapter.py:57-72,111-113,190);
  * margin preflight: opening units require margin_init * notional
    (standard model) or margin_init * notional / leverage (leveraged
    model), converted to the account currency at the current mid;
    insufficient free balance -> preflight_denied, no order;
  * financing (when enabled): positions held across the 22:00 UTC
    rollover accrue interest from the annualized short-rate differential
    of the pair, month-aware (shared semantics: data/financing.py; rate
    table rows LOCATION/TIME/Value — reference fixture schema
    examples/data/fx_rollover_rates_smoke.csv).
"""
from __future__ import annotations

import hashlib
import json
import random
from dataclasses import asdict
from typing import Any, Dict, List, Optional, Tuple

from gymfx_tpu_torch.contracts import (
    ExecutionCostProfile,
    InstrumentSpec,
    MarketFrame,
    TargetAction,
)
from gymfx_tpu_torch.data.financing import (
    ROLLOVER_UTC_SECONDS,
    daily_differential,
    parse_rate_table,
)

# the engine's identity in every result hash: the JAX package's name, so
# that both packages hash the same replay alike
ENGINE_NAME = "gymfx_tpu.scan_replay"
ENGINE_VERSION = "1.1.0"


class FillModel:
    """Seeded fill-probability model (Nautilus FillModel equivalent).

    ``prob_fill_on_limit`` — chance a touched limit (TP) order fills on
    that tick (an unfilled touch stays resting and re-rolls on the next
    touch); ``prob_fill_on_stop`` — same for stop (SL) triggers;
    ``prob_slippage`` — chance a market-order fill slips one tick
    (10^-price_precision) further in the adverse direction.  The RNG is
    seeded from ``profile.random_seed`` and consumed in event order, so
    results are reproducible run-to-run and across processes (the
    determinism contract the bake-off hashes assert).
    """

    def __init__(
        self,
        prob_fill_on_limit: float = 1.0,
        prob_fill_on_stop: float = 1.0,
        prob_slippage: float = 0.0,
        random_seed: int = 0,
    ) -> None:
        for name, p in (
            ("prob_fill_on_limit", prob_fill_on_limit),
            ("prob_fill_on_stop", prob_fill_on_stop),
            ("prob_slippage", prob_slippage),
        ):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be within [0, 1]")
        self.prob_fill_on_limit = float(prob_fill_on_limit)
        self.prob_fill_on_stop = float(prob_fill_on_stop)
        self.prob_slippage = float(prob_slippage)
        self.random_seed = int(random_seed)
        self._rng = random.Random(self.random_seed)

    def _roll(self, p: float) -> bool:
        if p >= 1.0:
            return True
        if p <= 0.0:
            return False
        return self._rng.random() < p

    def limit_fills(self) -> bool:
        return self._roll(self.prob_fill_on_limit)

    def stop_fills(self) -> bool:
        return self._roll(self.prob_fill_on_stop)

    def slips(self) -> bool:
        return self._roll(self.prob_slippage)


def stable_hash(value: Any) -> str:
    payload = json.dumps(value, sort_keys=True, separators=(",", ":"), default=str)
    return "sha256:" + hashlib.sha256(payload.encode("utf-8")).hexdigest()


def _fmt(x: float, precision: int = 10) -> str:
    """Canonical decimal formatting so hashes are platform-stable."""
    return f"{x:.{precision}f}".rstrip("0").rstrip(".") or "0"


def make_price(spec: InstrumentSpec, value: float) -> float:
    """Quantize a price to the instrument's price precision — the venue
    book holds Price objects at ``price_precision``, exactly as the
    reference builds QuoteTicks through ``instrument.make_price``
    (reference simulation_engines/nautilus_adapter.py:111-112)."""
    return round(float(value), spec.price_precision)


def make_qty(spec: InstrumentSpec, value: float) -> float:
    """Quantize an order quantity to the instrument's size precision
    (reference ``instrument.make_qty``, nautilus_adapter.py:190)."""
    return round(float(value), spec.size_precision)


def snap_price_in_bar(
    spec: InstrumentSpec, price: float, low: float, high: float
) -> float:
    """Clip ``price`` into the bar's [low, high], then snap to the
    nearest IN-BAR book price — the float64 twin of the scan engine's
    ``broker.snap_in_bar`` (slip_match's in-range guarantee under venue
    quantization).  A bar narrower than one tick keeps the nearest
    tick instead of oscillating."""
    p = min(max(float(price), float(low)), float(high))
    q = make_price(spec, p)
    tick = 10.0 ** (-spec.price_precision)
    if q > high and q - tick >= low:
        q = make_price(spec, q - tick)
    elif q < low and q + tick <= high:
        q = make_price(spec, q + tick)
    return q


class _Position:
    __slots__ = ("units", "avg_price")

    def __init__(self) -> None:
        self.units = 0.0
        self.avg_price = 0.0


class ReplayAdapter:
    """Run deterministic target-position scripts through the replay engine."""

    def __init__(
        self,
        profile: ExecutionCostProfile,
        *,
        prob_fill_on_limit: float = 1.0,
        prob_fill_on_stop: float = 1.0,
        prob_slippage: float = 0.0,
    ) -> None:
        self.profile = profile
        # Probabilities are stored, not a FillModel instance: a FRESH
        # seeded model is built per run() so repeated runs consume the
        # same RNG sequence (the determinism-hash contract).
        self._fill_probs = (
            float(prob_fill_on_limit),
            float(prob_fill_on_stop),
            float(prob_slippage),
        )

    def make_fill_model(self) -> FillModel:
        limit_p, stop_p, slip_p = self._fill_probs
        return FillModel(
            prob_fill_on_limit=limit_p,
            prob_fill_on_stop=stop_p,
            prob_slippage=slip_p,
            random_seed=self.profile.random_seed,
        )

    # ------------------------------------------------------------------
    def run(
        self,
        *,
        instrument_specs: List[InstrumentSpec],
        frames: List[MarketFrame],
        actions: List[TargetAction],
        initial_cash: float = 100_000.0,
        base_currency: str = "USD",
        default_leverage: float = 20.0,
        financing_rate_data: Any = None,
        enforce_margin_closeout: Optional[bool] = None,
        slip_open: bool = True,
        slip_limit: bool = False,
        slip_match: bool = False,
    ) -> Dict[str, Any]:
        """``slip_open`` / ``slip_limit`` / ``slip_match`` mirror the
        scan engine's per-fill-type slippage switches (the reference
        broker's backtrader ``set_slippage_perc`` configuration,
        reference broker_plugins/default_broker.py:52) as venue
        behavior, so the crosscheck can bound non-default switch
        semantics (VERDICT r4 item #7):

          * ``slip_open`` off — market-order fills and GAP stop fills
            (a frame opening through the stop) execute at the raw first
            tick instead of the adverse-displaced book side; intrabar
            stop fills always pay the book (the scan's ``sl_scale``).
          * ``slip_limit`` on — take-profit limit exits pay the
            adverse-displaced book, capped never-worse-than-the-limit.
          * ``slip_match`` on — every fill price is clipped into the
            frame's [low, high] and snapped to the nearest in-bar book
            price (``snap_price_in_bar``).

        Defaults preserve the historical venue behavior bit-for-bit
        (committed determinism hashes depend on it)."""
        profile = self.profile
        if profile.financing_enabled and financing_rate_data is None:
            raise ValueError(
                "financing_rate_data is required when financing_enabled is true"
            )
        # maintenance enforcement follows the preflight flag by default
        # (one venue either runs a margin account or does not), same rule
        # as the scan engine (core/types.py make_env_config)
        enforce_closeout = (
            bool(profile.enforce_margin_preflight)
            if enforce_margin_closeout is None
            else bool(enforce_margin_closeout)
        )
        venues = {spec.venue for spec in instrument_specs}
        if len(venues) != 1:
            raise ValueError(
                "one replay currently requires a single shared-account venue"
            )

        specs = {spec.instrument_id: spec for spec in instrument_specs}
        adverse = profile.quote_adverse_rate_per_side
        events: List[Dict[str, Any]] = []
        positions: Dict[str, _Position] = {k: _Position() for k in specs}
        brackets: Dict[str, Dict[str, float]] = {}
        active_action: Dict[str, str] = {}
        balance = float(initial_cash)
        order_seq = 0
        order_count = 0
        rates = parse_rate_table(financing_rate_data)
        fill_model = self.make_fill_model()
        latency_ns = int(profile.latency_ms) * 1_000_000
        limit_policy = profile.limit_fill_policy
        # latency-delayed market orders waiting for their execution tick,
        # plus the signed units they will move the book by — target
        # deltas must net against position AND in-flight orders, or a
        # target repeated across the latency window double-fills
        pending_orders: List[Dict[str, Any]] = []
        inflight_units: Dict[str, float] = {k: 0.0 for k in specs}

        # Timeline: all frames sorted by timestamp; ticks expanded per frame.
        frames_sorted = sorted(frames, key=lambda f: (f.ts_event_ns, f.instrument_id))
        action_by_key = {(a.instrument_id, a.ts_event_ns): a for a in actions}

        def mid_of(instrument_id: str, default: float) -> float:
            return last_mid.get(instrument_id, default)

        last_mid: Dict[str, float] = {}
        last_rollover_day: Optional[int] = None

        def conversion(spec: InstrumentSpec, mid: float) -> float:
            """quote currency -> account currency at current mid."""
            if spec.quote_currency == base_currency:
                return 1.0
            if spec.base_currency == base_currency:
                return 1.0 / mid
            raise ValueError(
                f"cannot convert {spec.quote_currency} to {base_currency} "
                f"using {spec.instrument_id}"
            )

        def emit(event: Dict[str, Any]) -> None:
            events.append(event)

        def fill(
            instrument_id: str,
            side: str,
            qty: float,
            price: float,
            mid: float,
            ts: int,
            order_id: str,
            action_id: str,
        ) -> None:
            nonlocal balance
            spec = specs[instrument_id]
            pos = positions[instrument_id]
            conv = conversion(spec, mid)
            signed = qty if side == "BUY" else -qty
            units_before = pos.units

            if pos.units == 0 or pos.units * signed > 0:
                new_units = pos.units + signed
                if pos.units == 0:
                    pos.avg_price = price
                else:
                    pos.avg_price = (
                        abs(pos.units) * pos.avg_price + abs(signed) * price
                    ) / abs(new_units)
                pos.units = new_units
            else:
                closing = min(abs(pos.units), abs(signed))
                quote_pnl = (
                    closing * (price - pos.avg_price)
                    if pos.units > 0
                    else closing * (pos.avg_price - price)
                )
                balance += quote_pnl * conv
                new_units = pos.units + signed
                if pos.units * new_units < 0:
                    pos.avg_price = price
                elif new_units == 0:
                    pos.avg_price = 0.0
                pos.units = new_units

            commission = float(profile.commission_rate_per_side) * qty * price
            balance -= commission * conv
            emit(
                {
                    "event_type": "order_filled",
                    "ts_event_ns": int(ts),
                    "instrument_id": instrument_id,
                    "action_id": action_id,
                    "client_order_id": order_id,
                    "side": side,
                    "quantity": _fmt(qty),
                    "price": _fmt(price),
                    "commission": _fmt(commission),
                    "commission_currency": spec.quote_currency,
                    "position_units_after": _fmt(pos.units),
                    "reference_mid": _fmt(mid),
                }
            )
            if pos.units == 0:
                active_action.pop(instrument_id, None)
            # a fill that closed or flipped the position invalidates any
            # brackets protecting the OLD position (the scan engine's
            # fill_pending clears brackets the same way); fresh brackets,
            # if any, are armed by the caller after this returns
            if pos.units == 0 or pos.units * units_before < 0:
                brackets.pop(instrument_id, None)

        def market_price(
            spec: InstrumentSpec, mid: float, side: str,
            frame: Optional[MarketFrame] = None,
        ) -> float:
            """Top-of-book fill price for a market order, with the fill
            model's one-tick probabilistic slippage.  ``slip_open`` off
            fills at the raw tick; ``slip_match`` (with a frame) snaps
            the price into the frame's range."""
            if slip_open:
                raw = mid * (1.0 + adverse) if side == "BUY" else mid * (1.0 - adverse)
            else:
                raw = mid
            price = make_price(spec, raw)
            if fill_model.slips():
                tick = 10.0 ** (-spec.price_precision)
                price = price + tick if side == "BUY" else price - tick
            if slip_match and frame is not None:
                price = snap_price_in_bar(spec, price, frame.low, frame.high)
            return price

        def check_brackets(
            instrument_id: str, bid: float, ask: float, mid: float, ts: int,
            frame: Optional[MarketFrame] = None, first_tick: bool = False,
        ) -> None:
            nonlocal order_seq, order_count
            br = brackets.get(instrument_id)
            pos = positions[instrument_id]
            if not br or pos.units == 0:
                return
            long = pos.units > 0
            exit_qty = abs(pos.units)
            sl, tp = br["sl"], br["tp"]
            # SL is a stop: triggers on a touch of the adverse book side.
            # TP is a limit: its trigger follows the profile's
            # limit_fill_policy — conservative requires trading strictly
            # THROUGH the limit; touch/cross fill on an exact touch.
            if long:
                sl_hit = bid <= sl
                tp_hit = bid > tp if limit_policy == "conservative" else bid >= tp
            else:
                sl_hit = ask >= sl
                tp_hit = ask < tp if limit_policy == "conservative" else ask <= tp
            if not (sl_hit or tp_hit):
                return
            # path order decides: this tick triggered one (or both — SL
            # priority within a single tick, the conservative read).
            # An unfilled probabilistic trigger leaves the bracket armed
            # for the next tick.
            if sl_hit:
                if not fill_model.stop_fills():
                    return
                # a triggered stop becomes a market order at the current
                # book: when the market gapped through the stop (e.g. a
                # bar opening beyond it), the fill is the gapped book
                # price, not the stop price — Nautilus stop->market
                # semantics and the scan engine's gap-fill-at-open
                # (core/broker.py check_brackets).  slip_open off: the
                # GAP fill pays the raw open instead of the book (the
                # scan's sl_scale gating); intrabar stops always pay
                # the book.
                gap = first_tick and (mid <= sl if long else mid >= sl)
                if gap and not slip_open:
                    book = make_price(specs[instrument_id], mid)
                else:
                    book = bid if long else ask
                exit_price = min(sl, book) if long else max(sl, book)
                if slip_match and frame is not None:
                    exit_price = snap_price_in_bar(
                        specs[instrument_id], exit_price, frame.low, frame.high
                    )
            else:
                if not fill_model.limit_fills():
                    return
                if slip_limit:
                    # the limit exit pays the adverse-displaced book —
                    # under cross that is the trigger tick's book side;
                    # other policies slip the limit price itself — then
                    # slip_match clips into the bar, and the cap applies
                    # LAST: a limit never fills worse than its price
                    # (the scan's check_brackets order of operations)
                    if limit_policy == "cross":
                        slipped = bid if long else ask
                    else:
                        slipped = make_price(
                            specs[instrument_id],
                            tp * (1.0 - adverse) if long else tp * (1.0 + adverse),
                        )
                    if slip_match and frame is not None:
                        slipped = snap_price_in_bar(
                            specs[instrument_id], slipped, frame.low, frame.high
                        )
                    exit_price = max(slipped, tp) if long else min(slipped, tp)
                elif limit_policy == "cross":
                    # price improvement: fill at the touching tick's book
                    exit_price = bid if long else ask
                else:
                    exit_price = tp
            order_seq += 1
            order_count += 1
            fill(
                instrument_id,
                "SELL" if long else "BUY",
                exit_qty,
                exit_price,
                mid,
                ts,
                f"O-{order_seq}",
                active_action.get(instrument_id, "bracket-exit"),
            )
            brackets.pop(instrument_id, None)

        def flush_pending(frame: MarketFrame, first_mid: float) -> None:
            """Fill latency-delayed orders due at/before this frame, at
            its first path tick."""
            nonlocal order_seq, order_count
            due = [
                po
                for po in pending_orders
                if po["instrument_id"] == frame.instrument_id
                and frame.ts_event_ns >= po["execute_at_ns"]
            ]
            for po in due:
                pending_orders.remove(po)
                signed = po["qty"] if po["side"] == "BUY" else -po["qty"]
                inflight_units[frame.instrument_id] -= signed
                spec = specs[frame.instrument_id]
                price = market_price(spec, first_mid, po["side"], frame)
                fill(
                    frame.instrument_id,
                    po["side"],
                    po["qty"],
                    price,
                    first_mid,
                    frame.ts_event_ns,
                    po["order_id"],
                    po["action_id"],
                )
                if po["arm_brackets"] and positions[frame.instrument_id].units != 0:
                    brackets[frame.instrument_id] = {"sl": po["sl"], "tp": po["tp"]}

        def apply_rollover(ts: int) -> None:
            nonlocal balance, last_rollover_day
            if not profile.financing_enabled:
                return
            day = int(ts // 86_400_000_000_000)
            second_of_day = int(ts // 1_000_000_000) % 86_400
            if second_of_day < ROLLOVER_UTC_SECONDS:
                return
            if last_rollover_day == day:
                return
            last_rollover_day = day
            for instrument_id, pos in positions.items():
                if pos.units == 0:
                    continue
                spec = specs[instrument_id]
                mid = mid_of(instrument_id, pos.avg_price)
                # long base earns base rate, pays quote rate (annualized %,
                # month-aware lookup shared with the scan precompute —
                # data/financing.py)
                differential = daily_differential(
                    rates, spec.base_currency, spec.quote_currency, ts
                )
                interest_quote = pos.units * mid * differential
                conv = conversion(spec, mid)
                amount = interest_quote * conv
                balance += amount
                emit(
                    {
                        "event_type": "financing_applied",
                        "ts_event_ns": int(ts),
                        "instrument_id": instrument_id,
                        "position_units": _fmt(pos.units),
                        "rate_differential_annual_pct": _fmt(differential * 365.0 * 100.0),
                        "amount": _fmt(amount),
                        "currency": base_currency,
                    }
                )

        def check_margin_closeout(ts: int) -> None:
            """Account-level maintenance check at the end of a frame
            (its last path tick == the bar close): equity below the
            maintenance requirement liquidates EVERY open position via a
            forced market order that fills at the next frame's first
            path tick — the scan engine's breach-at-close /
            fill-at-next-open timing (core/env.py step 4b).  Forced
            closes bypass min_quantity (a venue never strands a
            liquidation on a size rule)."""
            nonlocal order_seq, order_count
            if not enforce_closeout:
                return
            if any(po["action_id"] == "margin-closeout" for po in pending_orders):
                return  # liquidation already in flight
            equity = balance
            maint = 0.0
            any_pos = False
            for instrument_id, pos in positions.items():
                if pos.units == 0:
                    continue
                any_pos = True
                spec = specs[instrument_id]
                mid = mid_of(instrument_id, pos.avg_price)
                conv = conversion(spec, mid)
                equity += pos.units * (mid - pos.avg_price) * conv
                m = abs(pos.units) * mid * float(spec.margin_maint)
                if profile.margin_model == "leveraged":
                    m /= max(float(default_leverage), 1e-12)
                maint += m * conv
            if not any_pos or equity >= maint:
                return
            emit(
                {
                    "event_type": "margin_closeout",
                    "ts_event_ns": int(ts),
                    "equity": _fmt(equity),
                    "maintenance_margin": _fmt(maint),
                    "currency": base_currency,
                }
            )
            # cancel resting brackets and in-flight orders: the venue is
            # flattening the book (the scan closeout likewise REPLACES
            # the pending order and its brackets).  Every cancelled
            # order gets a terminal event so the audit log never holds
            # a dangling order_submitted.
            brackets.clear()
            for po in list(pending_orders):
                signed = po["qty"] if po["side"] == "BUY" else -po["qty"]
                inflight_units[po["instrument_id"]] -= signed
                pending_orders.remove(po)
                emit(
                    {
                        "event_type": "order_canceled",
                        "ts_event_ns": int(ts),
                        "instrument_id": po["instrument_id"],
                        "action_id": po["action_id"],
                        "client_order_id": po["order_id"],
                        "reason": "MARGIN_CLOSEOUT",
                    }
                )
            for instrument_id, pos in positions.items():
                if pos.units == 0:
                    continue
                order_seq += 1
                order_count += 1
                side = "SELL" if pos.units > 0 else "BUY"
                qty = abs(pos.units)
                inflight_units[instrument_id] += -pos.units
                pending_orders.append(
                    {
                        "instrument_id": instrument_id,
                        "execute_at_ns": int(ts) + 1,
                        "side": side,
                        "qty": qty,
                        "order_id": f"O-{order_seq}",
                        "action_id": "margin-closeout",
                        "arm_brackets": False,
                        "sl": 0.0,
                        "tp": 0.0,
                    }
                )
                emit(
                    {
                        "event_type": "order_submitted",
                        "ts_event_ns": int(ts),
                        "instrument_id": instrument_id,
                        "action_id": "margin-closeout",
                        "client_order_id": f"O-{order_seq}",
                        "side": side,
                        "quantity": _fmt(qty),
                        "execute_at_ns": int(ts) + 1,
                    }
                )

        def process_action(frame: MarketFrame, spec: InstrumentSpec) -> None:
            nonlocal order_seq, order_count
            action = action_by_key.get((frame.instrument_id, frame.ts_event_ns))
            if action is None:
                return
            pos = positions[frame.instrument_id]
            # net the target against position AND in-flight (latency-
            # delayed) orders so targets stay honored across the window
            current = pos.units + inflight_units[frame.instrument_id]
            delta = float(action.target_units) - current
            emit(
                {
                    "event_type": "target_requested",
                    "ts_event_ns": int(frame.ts_event_ns),
                    "instrument_id": frame.instrument_id,
                    "action_id": action.action_id,
                    "target_units": _fmt(float(action.target_units)),
                    "current_units": _fmt(current),
                    "delta_units": _fmt(delta),
                }
            )
            active_action[frame.instrument_id] = action.action_id
            if delta == 0:
                return

            mid = last_mid[frame.instrument_id]
            side = "BUY" if delta > 0 else "SELL"
            # venue-side order validation: quantity quantized to the
            # instrument's size increment, orders below min_quantity
            # denied (the reference's RiskEngine/venue behavior around
            # instrument.make_qty / min_quantity,
            # nautilus_adapter.py:57-72,190)
            qty = make_qty(spec, abs(delta))
            if qty <= 0.0 or qty < float(spec.min_quantity):
                emit(
                    {
                        "event_type": "order_denied",
                        "ts_event_ns": int(frame.ts_event_ns),
                        "instrument_id": frame.instrument_id,
                        "action_id": action.action_id,
                        "reason": "ORDER_BELOW_MIN_QUANTITY",
                        "quantity": _fmt(qty),
                        "min_quantity": _fmt(float(spec.min_quantity)),
                    }
                )
                return

            # units this order would OPEN (fresh entry, add, or the
            # opening leg of a flip) — drives both the margin preflight
            # and bracket arming
            opening = 0.0
            if current == 0 or current * delta > 0:
                opening = qty
            elif qty > abs(current):
                opening = qty - abs(current)

            if profile.enforce_margin_preflight:
                if opening > 0:
                    notional_quote = opening * mid
                    required_quote = notional_quote * float(spec.margin_init)
                    if self.profile.margin_model == "leveraged":
                        required_quote /= max(float(default_leverage), 1e-12)
                    required = required_quote * conversion(spec, mid)
                    if required > balance:
                        emit(
                            {
                                "event_type": "preflight_denied",
                                "ts_event_ns": int(frame.ts_event_ns),
                                "instrument_id": frame.instrument_id,
                                "action_id": action.action_id,
                                "reason": "CUM_MARGIN_EXCEEDS_FREE_BALANCE",
                                "required_margin_in_free_currency": _fmt(required),
                                "free_balance": _fmt(balance),
                            }
                        )
                        return

            order_seq += 1
            order_count += 1
            order_id = f"O-{order_seq}"
            # brackets arm whenever the fill OPENS units (fresh entry or
            # the opening leg of a flip) and both prices are present —
            # the scan kernel's `entered` semantics (core/broker.py
            # fill_pending); the reference's scripted strategy only
            # brackets from flat, a strict subset of this behavior
            wants_brackets = (
                opening > 0
                and action.stop_loss_price is not None
                and action.take_profit_price is not None
            )
            if latency_ns > 0:
                # the submit->venue trip delays EXECUTION of new orders;
                # resting brackets at the venue are unaffected
                execute_at = frame.ts_event_ns + latency_ns
                inflight_units[frame.instrument_id] += qty if delta > 0 else -qty
                pending_orders.append(
                    {
                        "instrument_id": frame.instrument_id,
                        "execute_at_ns": execute_at,
                        "side": side,
                        "qty": qty,
                        "order_id": order_id,
                        "action_id": action.action_id,
                        "arm_brackets": wants_brackets,
                        "sl": make_price(spec, float(action.stop_loss_price or 0.0)),
                        "tp": make_price(spec, float(action.take_profit_price or 0.0)),
                    }
                )
                emit(
                    {
                        "event_type": "order_submitted",
                        "ts_event_ns": int(frame.ts_event_ns),
                        "instrument_id": frame.instrument_id,
                        "action_id": action.action_id,
                        "client_order_id": order_id,
                        "side": side,
                        "quantity": _fmt(qty),
                        "execute_at_ns": int(execute_at),
                    }
                )
                return
            fill(
                frame.instrument_id,
                side,
                qty,
                market_price(spec, mid, side, frame),
                mid,
                frame.ts_event_ns,
                order_id,
                action.action_id,
            )
            if wants_brackets:
                brackets[frame.instrument_id] = {
                    "sl": make_price(spec, float(action.stop_loss_price)),
                    "tp": make_price(spec, float(action.take_profit_price)),
                }

        for frame in frames_sorted:
            spec = specs[frame.instrument_id]
            path: Tuple[float, ...] = tuple(frame.execution_path or (frame.close,))
            # latency-delayed orders due by now fill at this frame's
            # first path tick, before bracket evaluation
            flush_pending(frame, path[0])
            # walk intrabar ticks: brackets can exit mid-path (book
            # prices live at the instrument's price precision)
            for tick_i, mid in enumerate(path):
                bid = make_price(spec, mid * (1.0 - adverse))
                ask = make_price(spec, mid * (1.0 + adverse))
                last_mid[frame.instrument_id] = mid
                check_brackets(frame.instrument_id, bid, ask, mid,
                               frame.ts_event_ns, frame, tick_i == 0)
            apply_rollover(frame.ts_event_ns)
            process_action(frame, spec)
            # account maintenance check at the frame end (its last path
            # tick == the bar close), after any same-frame fills.  This
            # deliberately runs on the FINAL frame too: the scan engine
            # counts a breach detected at the final bar close (its
            # `advance` gate only suppresses the exhausted re-visit,
            # tests/test_margin_closeout.py final-bar test), so the
            # matching replay behavior is one margin_closeout event with
            # the forced order left pending-unexecuted — the twin of the
            # scan's never-filled pending_active order.
            check_margin_closeout(frame.ts_event_ns)

        open_positions = sum(1 for p in positions.values() if p.units != 0)
        event_facts = [
            {"sequence": sequence, **event} for sequence, event in enumerate(events)
        ]
        summary = {
            "final_balance": _fmt(balance),
            "currency": base_currency,
            "positions_open": open_positions,
            "total_orders": order_count,
        }
        deterministic_payload = {
            "engine": ENGINE_NAME,
            "engine_version": ENGINE_VERSION,
            "profile": asdict(self.profile),
            "events": event_facts,
            "summary": summary,
        }
        return {
            **deterministic_payload,
            "event_hash": stable_hash(event_facts),
            "result_hash": stable_hash(deterministic_payload),
            "native": {
                "iterations": len(frames_sorted),
                "total_events": len(event_facts),
                "total_orders": order_count,
                "orders_pending_unexecuted": len(pending_orders),
                "total_positions": len(
                    {e["instrument_id"] for e in event_facts if e["event_type"] == "order_filled"}
                ),
            },
        }


