"""Pure-Python reference book — the oracle half of the LOB parity
contract.

This mirrors ``lob/book.py`` operation-for-operation in plain Python
ints (no tensors, no floats on the matching path): same fixed capacity
(``depth_levels`` price levels per side, ``queue_slots`` FIFO slots per
level, overflow drops the order), same price-time priority, same
partial-fill walk, same cancel-by-oid semantics.  The crosscheck
(simulation/crosscheck.py) and the 4096-stream parity test
(tests/test_lob.py) replay identical message streams through both and
require every fill record to match EXACTLY — integer ticks and lots,
no epsilon.

Capacity semantics that MUST stay in lockstep with the array engine:
  * a resting order at a new price claims a level only while fewer than
    ``depth_levels`` prices are active on that side; otherwise it is
    dropped (``rested_qty`` 0);
  * within a level, a full FIFO queue drops the incoming order;
  * the array engine assigns the lowest-index free level, which never
    affects matching order (matching sorts by price) — the oracle just
    tracks the set of active prices.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .book import (
    AGENT_OID,
    MSG_ADD,
    MSG_CANCEL,
    MSG_MARKET,
    MSG_NOOP,
    PRICE_CAP,
)


class OracleFill:
    """Mirror of book.FillRecord (plain ints)."""

    __slots__ = (
        "filled_qty", "filled_value", "fill_events", "agent_qty",
        "agent_value", "price_min", "price_max", "rested_qty",
        "cancelled_qty",
    )

    def __init__(self):
        self.filled_qty = 0
        self.filled_value = 0
        self.fill_events = 0
        self.agent_qty = 0
        self.agent_value = 0
        self.price_min = PRICE_CAP
        self.price_max = 0
        self.rested_qty = 0
        self.cancelled_qty = 0

    def astuple(self) -> Tuple[int, ...]:
        return (
            self.filled_qty, self.filled_value, self.fill_events,
            self.agent_qty, self.agent_value, self.price_min,
            self.price_max, self.rested_qty, self.cancelled_qty,
        )


class OracleBook:
    """Two-sided book: per side a dict price -> FIFO list of
    ``[qty, oid]`` entries (live orders only)."""

    def __init__(self, depth_levels: int, queue_slots: int):
        self.depth_levels = int(depth_levels)
        self.queue_slots = int(queue_slots)
        self.bids: Dict[int, List[List[int]]] = {}
        self.asks: Dict[int, List[List[int]]] = {}

    # -- views -----------------------------------------------------------
    def best_bid(self) -> int:
        return max(self.bids) if self.bids else 0

    def best_ask(self) -> int:
        return min(self.asks) if self.asks else PRICE_CAP

    def depth(self, is_bid: bool) -> int:
        side = self.bids if is_bid else self.asks
        return sum(q for lvl in side.values() for q, _ in lvl)

    def canonical(self):
        """Sorted (price, [(qty, oid), ...]) per side — for comparing a
        final book state against the array engine's."""
        return (
            sorted((p, [tuple(e) for e in lvl]) for p, lvl in self.bids.items()),
            sorted((p, [tuple(e) for e in lvl]) for p, lvl in self.asks.items()),
        )

    # -- primitives ------------------------------------------------------
    def _match(self, taker_is_buy: bool, qty: int, limit: int,
               fill: OracleFill) -> int:
        """Walk the opposing side best-price-first; returns unfilled."""
        side = self.asks if taker_is_buy else self.bids
        prices = sorted(side) if taker_is_buy else sorted(side, reverse=True)
        remaining = qty
        for p in prices:
            if remaining <= 0:
                break
            if taker_is_buy and p > limit:
                break
            if not taker_is_buy and p < limit:
                break
            level = side[p]
            for entry in level:
                if remaining <= 0:
                    break
                take = min(remaining, entry[0])
                if take <= 0:
                    continue
                entry[0] -= take
                remaining -= take
                fill.filled_qty += take
                fill.filled_value += take * p
                fill.fill_events += 1
                if entry[1] == AGENT_OID:
                    fill.agent_qty += take
                    fill.agent_value += take * p
                fill.price_min = min(fill.price_min, p)
                fill.price_max = max(fill.price_max, p)
            side[p] = [e for e in level if e[0] > 0]
            if not side[p]:
                del side[p]
        return remaining

    def _rest(self, is_buy: bool, price: int, qty: int, oid: int,
              fill: OracleFill) -> None:
        if qty <= 0:
            return
        side = self.bids if is_buy else self.asks
        if price not in side and len(side) >= self.depth_levels:
            return  # book full: drop (fixed capacity)
        level = side.setdefault(price, [])
        if len(level) >= self.queue_slots:
            if not level:
                del side[price]
            return  # queue full: drop
        level.append([qty, oid])
        fill.rested_qty = qty

    # -- message ops -----------------------------------------------------
    def market(self, is_buy: bool, qty: int) -> OracleFill:
        fill = OracleFill()
        limit = PRICE_CAP if is_buy else 0
        self._match(is_buy, qty, limit, fill)
        return fill

    def add(self, is_buy: bool, price: int, qty: int, oid: int) -> OracleFill:
        fill = OracleFill()
        remaining = self._match(is_buy, qty, price, fill)
        self._rest(is_buy, price, remaining, oid, fill)
        return fill

    def cancel(self, is_buy: bool, oid: int) -> OracleFill:
        fill = OracleFill()
        if oid == 0:
            return fill
        side = self.bids if is_buy else self.asks
        for p in list(side):
            level = side[p]
            removed = sum(q for q, o in level if o == oid)
            if removed:
                fill.cancelled_qty += removed
                side[p] = [e for e in level if e[1] != oid]
                if not side[p]:
                    del side[p]
        return fill

    def process(self, kind: int, side: int, price: int, qty: int,
                oid: int) -> OracleFill:
        kind = max(0, min(3, int(kind)))
        is_buy = int(side) > 0
        if kind == MSG_NOOP:
            return OracleFill()
        if kind == MSG_ADD:
            return self.add(is_buy, int(price), int(qty), int(oid))
        if kind == MSG_CANCEL:
            return self.cancel(is_buy, int(oid))
        assert kind == MSG_MARKET
        return self.market(is_buy, int(qty))


class OracleVenue:
    """Pure-Python float64 twin of ``venue.execute_bar`` — the third
    engine's oracle side in ``simulation/crosscheck.py``.

    Book matching runs through :class:`OracleBook` (exact integer
    parity with the array engine); the ledger mirrors
    ``broker.apply_fill``'s balance-relevant fields in float64.
    Discrete decisions that must match the f32 engine bit-for-bit
    (lots rounding, bracket tick snapping) are computed in
    ``np.float32`` arithmetic — the same IEEE ops the traced kernel
    runs — so oracle and engine always agree on WHAT traded and only
    the continuous ledger arithmetic carries dtype error.
    """

    def __init__(self, *, depth_levels: int, queue_slots: int,
                 seed_levels: int, tick: float, lot_units: float,
                 commission: float, initial_cash: float):
        self.depth_levels = int(depth_levels)
        self.queue_slots = int(queue_slots)
        self.seed_levels = int(seed_levels)
        self.tick = float(tick)
        self.lot_units = float(lot_units)
        self.commission = float(commission)
        self.initial_cash = float(initial_cash)
        # ledger (broker.apply_fill mirror: balance-relevant fields)
        self.pos = 0.0
        self.entry = 0.0
        self.cash_delta = 0.0
        self.commission_paid = 0.0
        self.fills_units = 0.0     # sum |delta| across fills (bound input)
        # brackets in ticks (0 = disarmed)
        self.sl = 0
        self.tp = 0
        self.denied = 0

    # -- f32-exact discrete helpers (mirror venue.to_lots/bracket_ticks) -
    def _to_lots(self, units: float) -> int:
        import numpy as np

        q = np.float32(abs(np.float32(units))) / np.float32(self.lot_units)
        return int(np.round(q))

    def _ticks(self, price: float) -> int:
        import numpy as np

        return int(np.round(np.float32(price) / np.float32(self.tick)))

    # -- ledger (broker.apply_fill, slippage/tick zero) ------------------
    def _apply_fill(self, price: float, target: float) -> None:
        delta = target - self.pos
        if delta == 0.0 and target != 0.0:
            return
        fill = float(price)
        commission = self.commission * fill * abs(delta)
        self.cash_delta -= delta * fill + commission
        self.commission_paid += commission
        self.fills_units += abs(delta)
        same_sign = self.pos * target > 0
        adding = same_sign and abs(target) > abs(self.pos)
        flipping = (not same_sign) and target != 0.0 and self.pos != 0.0
        opening = self.pos == 0.0 and target != 0.0
        if adding:
            self.entry = (
                self.entry * abs(self.pos) + fill * (abs(target) - abs(self.pos))
            ) / abs(target)
        if flipping or opening:
            self.entry = fill
        if target == 0.0:
            self.entry = 0.0
        self.pos = target

    def balance(self) -> float:
        return self.initial_cash + self.cash_delta + self.pos * self.entry

    # -- one advancing bar (venue.execute_bar mirror) --------------------
    def execute_bar(self, o_t: int, o_price: float, seed_msgs, flow_msgs,
                    pending) -> None:
        """``seed_msgs``/``flow_msgs``: concrete (kind, side, price, qty,
        oid) sequences regenerated from the SAME seeded flow process;
        ``pending``: (active, target, sl_price, tp_price) from the scan
        trace (forced liquidations are out of crosscheck scope)."""
        book = OracleBook(self.depth_levels, self.queue_slots)
        for m in zip(*seed_msgs):
            book.process(*(int(x) for x in m))

        p_active, p_target, p_sl, p_tp = pending
        raw_target = float(p_target) if p_active else self.pos
        delta = raw_target - self.pos
        lots = self._to_lots(delta)
        denied = p_active and delta != 0.0 and lots < 1
        exec_lots = lots if (p_active and not denied) else 0
        is_buy = delta > 0
        fill = book.market(is_buy, exec_lots)
        worst = (fill.price_max if is_buy else fill.price_min) \
            if fill.filled_qty > 0 else o_t
        value = fill.filled_value + (exec_lots - fill.filled_qty) * worst
        open_price = value / max(exec_lots, 1) * self.tick
        sign = 1.0 if delta > 0 else (-1.0 if delta < 0 else 0.0)
        ledger_target = self.pos if denied \
            else self.pos + sign * exec_lots * self.lot_units
        old_pos = self.pos
        self.denied += int(denied)
        self._apply_fill(open_price if exec_lots > 0 else o_price,
                         ledger_target)

        # bracket arming (broker.opening_units rule)
        same = old_pos * ledger_target > 0
        opening = max(abs(ledger_target) - abs(old_pos), 0.0) if same or \
            ledger_target == 0.0 or old_pos == 0.0 else abs(ledger_target)
        entered = p_active and self.pos != 0.0 and opening > 0.0
        if self.pos == 0.0:
            self.sl = self.tp = 0
        elif entered:
            self.sl = self._ticks(p_sl) if p_sl > 0 else 0
            self.tp = self._ticks(p_tp) if p_tp > 0 else 0

        # intrabar: TP rests, SL triggers on prints
        pos_lots = self._to_lots(self.pos)
        long = self.pos > 0
        exit_is_buy = not long
        has_sl = self.sl > 0 and pos_lots > 0
        has_tp = self.tp > 0 and pos_lots > 0

        gap_sl = has_sl and (o_t <= self.sl if long else o_t >= self.sl)
        sl_lots = sl_value = 0
        tp_lots = tp_value = 0
        rem = pos_lots
        if gap_sl:
            x = book.market(exit_is_buy, rem)
            worst = (x.price_max if exit_is_buy else x.price_min) \
                if x.filled_qty > 0 else o_t
            sl_value = x.filled_value + (rem - x.filled_qty) * worst
            sl_lots, rem = rem, 0
        elif has_tp:
            f0 = book.add(exit_is_buy, max(self.tp, 1), rem, AGENT_OID)
            tp_lots, tp_value = f0.filled_qty, f0.filled_value
            rem -= f0.filled_qty

        sl_fired = gap_sl
        for m in zip(*flow_msgs):
            f = book.process(*(int(x) for x in m))
            rem -= f.agent_qty
            tp_lots += f.agent_qty
            tp_value += f.agent_value
            printed = f.price_min <= self.sl if long else f.price_max >= self.sl
            if has_sl and not sl_fired and rem > 0 and printed:
                book.cancel(exit_is_buy, AGENT_OID)
                x = book.market(exit_is_buy, rem)
                worst = (x.price_max if exit_is_buy else x.price_min) \
                    if x.filled_qty > 0 else self.sl
                sl_value += x.filled_value + (rem - x.filled_qty) * worst
                sl_lots += rem
                rem = 0
                sl_fired = True

        exit_lots = tp_lots + sl_lots
        if exit_lots > 0:
            exit_value = tp_value + sl_value
            full = exit_lots >= pos_lots > 0
            sgn = 1.0 if self.pos > 0 else -1.0
            target2 = 0.0 if full else self.pos - sgn * exit_lots * self.lot_units
            self._apply_fill(exit_value / exit_lots * self.tick, target2)
        if self.pos == 0.0 or sl_fired:
            self.sl = self.tp = 0


def replay_messages(depth_levels: int, queue_slots: int,
                    msgs) -> Tuple[OracleBook, List[Tuple[int, ...]]]:
    """Replay a concrete (kind, side, price, qty, oid) stream (each a
    length-M sequence) and return the final book plus per-message fill
    tuples in ``FillRecord`` field order."""
    book = OracleBook(depth_levels, queue_slots)
    fills = []
    for k, s, p, q, o in zip(*msgs):
        fills.append(book.process(int(k), int(s), int(p), int(q), int(o)).astuple())
    return book, fills
