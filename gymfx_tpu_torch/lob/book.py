"""Branch-free limit-order-book matching engine, batched over books.

The port of ``gymfx_tpu/lob/book.py``: a fixed-capacity book per env
(``depth_levels`` price levels per side, each a ``queue_slots``-deep
FIFO), integer lots and tick prices in int32, price-time priority.  The
semantics are the JAX package's (see its module docstring); every
function here takes tensors with a leading book axis ``B`` where the JAX
package vmaps one book:

  BookState  bid/ask price (B, D), qty and oid (B, D, Q), int32
  Messages   kind, side, price, qty, oid, each (B,) for one message or
             (B, M) for a stream
  FillRecord nine int32 fields, (B,) per message or (B, M) per stream

The half-book primitives keep the argsort engine (the stable argsort of
the flattened price-time key, the cumsum walk, the stable argsort
compaction), op for op.  Where the JAX package dispatches on a traced
side or kind with ``lax.cond``/``lax.switch`` (under vmap: compute
every branch, select), the port computes both halves and gives the
branches that do not apply a zero take, a zero rest or a zero cancel
target.  On a book that holds the engine's invariants (front-compacted
queues, zero oid in empty slots, zero price on empty levels: every book
built from an empty one by these operations) each of those is a bitwise
no-op, so the results equal the JAX package's exactly, with half the
work of compute-and-select (``gymfx_tpu/ops/lob_match.py`` relies on the
same invariants).

Sums and cumsums are pinned to int32 (torch promotes int32 reductions to
int64 by default); bool masks are cast before ``argsort``/``argmax``;
``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

# tick-price ceiling: the price-time sort key is price * queue_slots +
# slot, kept exact in int32 (2**20 * 64 slots << 2**31)
PRICE_CAP = 1 << 20
# reserved owner id for the trading agent's resting orders (flow
# messages use 1..M, seed messages SEED_OID_BASE+; 0 = empty slot)
AGENT_OID = 1 << 29
SEED_OID_BASE = 1 << 24

MSG_NOOP = 0
MSG_ADD = 1     # limit order: match marketable part, rest the remainder
MSG_CANCEL = 2  # cancel by (side, oid)
MSG_MARKET = 3  # market order: walk the book, partial-fill on dry-up

I32 = torch.int32


class BookState(NamedTuple):
    """Fixed-capacity two-sided books (all int32)."""

    bid_price: Any  # (B, D)  tick price per level, 0 = unused
    bid_qty: Any    # (B, D, Q) FIFO slot quantities in lots, 0 = empty
    bid_oid: Any    # (B, D, Q) owner ids, 0 = empty
    ask_price: Any  # (B, D)
    ask_qty: Any    # (B, D, Q)
    ask_oid: Any    # (B, D, Q)


class Messages(NamedTuple):
    """Book messages, int32: (B,) for one message per book, (B, M) for
    a stream."""

    kind: Any   # MSG_*
    side: Any   # +1 buy / -1 sell
    price: Any  # ticks (ADD: limit price; MARKET: ignored)
    qty: Any    # lots
    oid: Any    # order id (ADD: the resting id; CANCEL: the target)


class FillRecord(NamedTuple):
    """Execution report per processed message (int32)."""

    filled_qty: Any    # lots matched by this message (taker side)
    filled_value: Any  # sum(maker price * lots) in tick-lots
    fill_events: Any   # number of maker slots touched
    agent_qty: Any     # lots filled against AGENT_OID resting orders
    agent_value: Any   # sum(price * lots) of those agent maker fills
    price_min: Any     # lowest traded price (PRICE_CAP when no fill)
    price_max: Any     # highest traded price (0 when no fill)
    rested_qty: Any    # lots rested by an ADD (0 when dropped/matched)
    cancelled_qty: Any # lots removed by a CANCEL


def empty_book(n_books: int, depth_levels: int, queue_slots: int, device=None) -> BookState:
    lvl = torch.zeros((n_books, depth_levels), dtype=I32, device=device)
    slots = torch.zeros((n_books, depth_levels, queue_slots), dtype=I32, device=device)
    return BookState(lvl, slots, slots.clone(), lvl.clone(), slots.clone(), slots.clone())


# ---------------------------------------------------------------------------
# half-book primitives (price, qty, oid), batched over books
# ---------------------------------------------------------------------------
def _compact(qty, oid):
    """Shift live slots to the queue front, preserving FIFO order."""
    order = torch.argsort((qty == 0).to(I32), dim=-1, stable=True)
    return qty.gather(-1, order), oid.gather(-1, order)


def _reset_empty_levels(price, qty):
    return torch.where(qty.sum(dim=-1, dtype=I32) > 0, price, 0)


def _match_half(price, qty, oid, take_qty, limit, against_asks: bool):
    """Match ``take_qty`` (B,) lots against one half book per book in
    price-time priority; returns the updated half and the taker's fill
    stats (seven (B,) tensors).

    ``against_asks``: the taker BUYS, eligible levels have
    price <= limit, walked ascending.  Otherwise the taker SELLS,
    eligible levels have price >= limit, walked descending."""
    b, d, q = qty.shape
    active = price > 0
    if against_asks:
        eligible = active & (price <= limit[:, None])
        level_key = torch.where(eligible, price, PRICE_CAP)
    else:
        eligible = active & (price >= limit[:, None])
        level_key = torch.where(eligible, PRICE_CAP - price, PRICE_CAP)
    slots = torch.arange(q, dtype=I32, device=qty.device)
    flat_key = (level_key[:, :, None] * q + slots).reshape(b, d * q)
    order = torch.argsort(flat_key, dim=-1, stable=True)
    avail = torch.where(eligible[:, :, None], qty, 0).reshape(b, d * q).gather(-1, order)
    cum = torch.cumsum(avail, dim=-1, dtype=I32)
    fill_sorted = torch.clamp(take_qty[:, None] - (cum - avail), min=torch.zeros_like(avail), max=avail)
    fill = torch.zeros_like(fill_sorted).scatter(-1, order, fill_sorted).reshape(b, d, q)

    filled = fill.sum(dim=(1, 2), dtype=I32)
    value = (fill * price[:, :, None]).sum(dim=(1, 2), dtype=I32)
    events = (fill > 0).sum(dim=(1, 2), dtype=I32)
    agent_fill = torch.where((oid == AGENT_OID) & (fill > 0), fill, 0)
    agent_qty = agent_fill.sum(dim=(1, 2), dtype=I32)
    agent_value = (agent_fill * price[:, :, None]).sum(dim=(1, 2), dtype=I32)
    touched = fill.sum(dim=-1, dtype=I32) > 0
    pmin = torch.where(touched, price, PRICE_CAP).amin(dim=-1)
    pmax = torch.where(touched, price, 0).amax(dim=-1)

    new_qty = qty - fill
    new_oid = torch.where(new_qty > 0, oid, 0)
    new_qty, new_oid = _compact(new_qty, new_oid)
    new_price = _reset_empty_levels(price, new_qty)
    stats = (filled, value, events, agent_qty, agent_value, pmin, pmax)
    return (new_price, new_qty, new_oid), stats


def _rest_half(price, qty, oid, p, q, o):
    """Rest ``q`` (B,) lots owned by ``o`` at price ``p`` on one half book
    per book.  Returns the updated half and the lots actually rested (0
    when the book/level is full: fixed capacity drops the order)."""
    rows = torch.arange(qty.shape[0], device=qty.device)
    has_level = (price == p[:, None]) & (price > 0)
    level_free = qty.sum(dim=-1, dtype=I32) == 0
    any_level, any_free = has_level.any(dim=-1), level_free.any(dim=-1)
    li = torch.where(any_level, torch.argmax(has_level.to(I32), dim=-1),
                     torch.argmax(level_free.to(I32), dim=-1))
    can = (q > 0) & (any_level | any_free)
    slot_free = qty[rows, li] == 0
    si = torch.argmax(slot_free.to(I32), dim=-1)
    can = can & slot_free.any(dim=-1)
    rested = torch.where(can, q, 0)
    qty, oid, price = qty.clone(), oid.clone(), price.clone()
    qty[rows, li, si] = torch.where(can, q, qty[rows, li, si])
    oid[rows, li, si] = torch.where(can, o, oid[rows, li, si])
    price[rows, li] = torch.where(can, p, price[rows, li])
    return (price, qty, oid), rested


def _cancel_half(price, qty, oid, target_oid):
    """Remove every live slot owned by ``target_oid`` (B,)."""
    target = target_oid[:, None, None]
    hit = (oid == target) & (qty > 0) & (target != 0)
    removed = torch.where(hit, qty, 0).sum(dim=(1, 2), dtype=I32)
    qty = torch.where(hit, 0, qty)
    oid = torch.where(hit, 0, oid)
    qty, oid = _compact(qty, oid)
    price = _reset_empty_levels(price, qty)
    return (price, qty, oid), removed


# ---------------------------------------------------------------------------
# book-level operations: ``is_buy`` (B,) bool picks the side per book
# ---------------------------------------------------------------------------
def _zeros(like):
    return torch.zeros_like(like, dtype=I32)


def _record(s_a, s_b, rested, cancelled) -> FillRecord:
    """One FillRecord from the ask-side and bid-side match stats, at most
    one of which saw a nonzero take."""
    return FillRecord(
        s_a[0] + s_b[0], s_a[1] + s_b[1], s_a[2] + s_b[2], s_a[3] + s_b[3],
        s_a[4] + s_b[4], torch.minimum(s_a[5], s_b[5]), torch.maximum(s_a[6], s_b[6]),
        rested, cancelled,
    )


def _match_both(book: BookState, ask_take, ask_limit, bid_take, bid_limit):
    asks, s_a = _match_half(book.ask_price, book.ask_qty, book.ask_oid, ask_take, ask_limit, True)
    bids, s_b = _match_half(book.bid_price, book.bid_qty, book.bid_oid, bid_take, bid_limit, False)
    return BookState(*bids, *asks), s_a, s_b


def match_market(book: BookState, is_buy, qty) -> Tuple[BookState, FillRecord]:
    """Market orders of ``qty`` (B,) lots; partial when the opposing side
    runs dry."""
    z = _zeros(qty)
    cap = torch.full_like(z, PRICE_CAP)
    book, s_a, s_b = _match_both(book, torch.where(is_buy, qty, 0), cap,
                                 torch.where(is_buy, 0, qty), z)
    return book, _record(s_a, s_b, z, z)


def add_limit(book: BookState, is_buy, price, qty, oid) -> Tuple[BookState, FillRecord]:
    """Limit orders: match the marketable part at maker prices, rest the
    remainder at ``price`` (dropped when the book is full)."""
    book, s_a, s_b = _match_both(book, torch.where(is_buy, qty, 0), price,
                                 torch.where(is_buy, 0, qty), price)
    return _rest_both(book, is_buy, price, qty, oid, s_a, s_b, _zeros(qty))


def _rest_both(book: BookState, is_buy, price, qty, oid, s_a, s_b, cancelled):
    bids, rest_b = _rest_half(book.bid_price, book.bid_qty, book.bid_oid, price,
                              torch.where(is_buy, qty - s_a[0], 0), oid)
    asks, rest_a = _rest_half(book.ask_price, book.ask_qty, book.ask_oid, price,
                              torch.where(is_buy, 0, qty - s_b[0]), oid)
    return BookState(*bids, *asks), _record(s_a, s_b, rest_b + rest_a, cancelled)


def _cancel_both(book: BookState, bid_target, ask_target):
    bids, rm_b = _cancel_half(book.bid_price, book.bid_qty, book.bid_oid, bid_target)
    asks, rm_a = _cancel_half(book.ask_price, book.ask_qty, book.ask_oid, ask_target)
    return BookState(*bids, *asks), rm_b + rm_a


def cancel(book: BookState, is_buy, oid) -> Tuple[BookState, FillRecord]:
    """Cancel ``oid`` (B,) on the bid side where ``is_buy``, else the ask side."""
    book, removed = _cancel_both(book, torch.where(is_buy, oid, 0), torch.where(is_buy, 0, oid))
    z = _zeros(oid)
    return book, FillRecord(z, z, z, z, z, torch.full_like(z, PRICE_CAP), z, z, removed)


def process_message(book: BookState, msg: Messages) -> Tuple[BookState, FillRecord]:
    """Dispatch one message per book (each field (B,))."""
    kind, side, price, qty, oid = msg
    k = torch.clamp(kind, 0, 3)
    is_buy = side > 0
    is_add = k == MSG_ADD
    is_cancel = k == MSG_CANCEL
    take = torch.where(is_add | (k == MSG_MARKET), qty, 0)
    book, s_a, s_b = _match_both(
        book,
        torch.where(is_buy, take, 0), torch.where(is_add, price, PRICE_CAP),
        torch.where(is_buy, 0, take), torch.where(is_add, price, 0),
    )
    target = torch.where(is_cancel, oid, 0)
    book, removed = _cancel_both(book, torch.where(is_buy, target, 0), torch.where(is_buy, 0, target))
    return _rest_both(book, is_buy, price, torch.where(is_add, qty, 0), oid, s_a, s_b, removed)


def process_stream(book: BookState, msgs: Messages) -> Tuple[BookState, FillRecord]:
    """Scan (B, M) message streams through the books; returns the final
    books and the (B, M) fill records."""
    records = []
    for m in range(msgs.kind.shape[-1]):
        book, fill = process_message(book, Messages(*(x[:, m] for x in msgs)))
        records.append(fill)
    return book, FillRecord(*(torch.stack(f, dim=-1) for f in zip(*records)))
