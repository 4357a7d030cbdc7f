"""K8: one bar of the LOB venue on the books K5 seeded.

The JAX package has no ``ops/lob_bar``: its reference is the venue's own
``lax.scan`` over a bar's flow inside the jitted step
(``gymfx_tpu/lob/venue.py:236-267``), which XLA compiles into one
program.  K8 is the port's counterpart of that compiled scan, as the
train step's CUDA graphs are the counterpart of the jitted phases; it
has no Pallas counterpart and adds nothing the JAX package lacks.

The kernel is ``lob_bar_kernel`` in ``csrc/lob_kernels.cu``, built from
K5's device functions: one warp per book, the whole book in registers
from the open walk to the last flow message (see the source for its
design).  It is instantiated for 1 or 2 levels a lane and 1-8 slots, as
K5 is.  Its plain version :func:`run_bar_plain` is the book work of
``lob/venue.py``'s open walk and intrabar stages as they were, op for op
through the argsort engine (``lob/book.py``); ``ops/cases.lob_bar_emulated``
models the kernel's algorithm on the CPU.

Every input is an int computed before any book work (``lob/venue.py``
``bar_orders``: the open walk's lots and side, the position after the
open fill, the armed brackets in ticks), and every output is an int the
ledger fills need after it.  On books whose lots exceed int32 the kernel
does what the plain version does (the CPU tests hold the emulation to the
plain version there; the card tests the kernel).

:func:`run_bar` dispatches by device: a CPU book runs the plain version;
a CUDA book launches the kernel or raises.  The kernel takes depths up to
64 levels and queues up to 8 slots (``NotImplementedError`` beyond).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from gymfx_tpu_torch.lob.book import (
    AGENT_OID,
    BookState,
    Messages,
    add_limit,
    cancel,
    match_market,
    process_message,
)
from gymfx_tpu_torch.ops import _build
from gymfx_tpu_torch.ops.lob_match import MAX_DEPTH, MAX_SLOTS


class BarOrders(NamedTuple):
    """The agent's side of one bar, (N,) int32 each."""

    open_lots: Any  # the pending order's lots walked at the open (0: none)
    open_buy: Any   # 1 where the open walk buys
    open_tick: Any  # the bar's open tick: the walks' backstop and the gap test
    pos_lots: Any   # the position after the open fill, in lots
    exit_buy: Any   # 1 where an exit buys (the position is not long)
    stop: Any       # the armed stop in ticks (0: none)
    take_profit: Any  # the armed take-profit in ticks (0: none)


class BarFills(NamedTuple):
    """One bar's results for the ledger, (N,) int32 each (values in
    tick-lots, mod 2^32 as torch's int32)."""

    open_value: Any  # the open walk's value, its remainder at the open tick
    gap_lots: Any    # lots exited by the gap stop at the open
    gap_value: Any
    tp_lots: Any     # lots exited by the take-profit (its immediate and maker fills)
    tp_value: Any
    sl_lots: Any     # lots exited by the stop (the gap's included)
    sl_value: Any
    fired: Any       # 1 where the stop fired (at the gap or on a print)


_FLOW_NAMES = tuple(f"run_bar: flow.{n}" for n in Messages._fields)
_ORDER_NAMES = tuple(f"run_bar: orders.{n}" for n in BarOrders._fields)


def _walk_with_backstop(book: BookState, is_buy, lots, backstop_ticks):
    """Market-walk ``lots`` against the books; the unfilled remainder is
    priced at the worst touched level (else ``backstop_ticks``).
    Returns (books, total value in tick-lots)."""
    book, fill = match_market(book, is_buy, lots)
    worst = torch.where(
        fill.filled_qty > 0,
        torch.where(is_buy, fill.price_max, fill.price_min),
        backstop_ticks,
    )
    return book, fill.filled_value + (lots - fill.filled_qty) * worst


def run_bar_plain(book: BookState, flow: Messages, orders: BarOrders) -> Tuple[BookState, BarFills]:
    """Plain version of K8: the venue's book work through the argsort
    engine.  Where the JAX package's ``lax.cond`` on the stop's trigger
    computes both branches and selects, the fire branch runs for every
    book with a zero cancel target and a zero walk where the stop did not
    fire: bitwise no-ops on the book, and an exit value of 0, as the other
    branch gives."""
    o_t, pos_lots, sl, tp = orders.open_tick, orders.pos_lots, orders.stop, orders.take_profit
    book, open_value = _walk_with_backstop(book, orders.open_buy != 0, orders.open_lots, o_t)

    exit_is_buy = orders.exit_buy != 0
    long = ~exit_is_buy
    has_sl = (sl > 0) & (pos_lots > 0)
    has_tp = (tp > 0) & (pos_lots > 0)
    # a bar that gaps open through the stop exits at the open walk
    gap_sl = has_sl & torch.where(long, o_t <= sl, o_t >= sl)
    gap_lots = torch.where(gap_sl, pos_lots, 0)
    book, gap_value = _walk_with_backstop(book, exit_is_buy, gap_lots, o_t)

    # rest the TP (skipped when the gap stop already flattened the bar);
    # its marketable part fills immediately at maker prices
    tp_rest = torch.where(has_tp & ~gap_sl, pos_lots, 0)
    agent = torch.full_like(tp_rest, AGENT_OID)
    book, tp_fill0 = add_limit(book, exit_is_buy, torch.clamp_min(tp, 1), tp_rest, agent)

    rem = pos_lots - gap_lots - tp_fill0.filled_qty
    fired = gap_sl
    tp_lots, tp_value = tp_fill0.filled_qty, tp_fill0.filled_value
    sl_lots, sl_value = gap_lots, gap_value
    for m in range(flow.kind.shape[-1]):
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
        book, xvalue = _walk_with_backstop(book, exit_is_buy, torch.where(trig, rem, 0), sl)
        sl_lots = sl_lots + torch.where(trig, rem, 0)
        sl_value = sl_value + torch.where(trig, xvalue, 0)
        rem = torch.where(trig, 0, rem)
        fired = fired | trig
    i32 = torch.int32
    return book, BarFills(open_value, gap_lots, gap_value, tp_lots, tp_value, sl_lots, sl_value,
                          fired.to(i32))


def run_bar(book: BookState, flow: Messages, orders: BarOrders) -> Tuple[BookState, BarFills]:
    """(B, D) / (B, D, Q) books, (B, M) flow and (B,) orders -> (final
    books, BarFills): the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    device = book.bid_qty.device
    if device.type == "cpu":
        return run_bar_plain(book, flow, orders)
    if device.type != "cuda":
        raise ValueError(f"run_bar: unsupported device {device}")
    b, d, q = book.bid_qty.shape
    m = flow.kind.shape[-1]
    if not (1 <= d <= MAX_DEPTH and 1 <= q <= MAX_SLOTS):
        raise NotImplementedError(
            f"run_bar: the K8 kernel takes depth 1-{MAX_DEPTH} and queue slots 1-{MAX_SLOTS}, "
            f"got depth {d} and {q} slots"
        )
    i32 = torch.int32
    for name, t in zip(BookState._fields, book):
        _build.require(t, f"run_bar: book.{name}", i32,
                       (b, d) if name.endswith("price") else (b, d, q), device)
    _build.require_all(flow, _FLOW_NAMES, i32, (b, m), device)
    _build.require_all(orders, _ORDER_NAMES, i32, (b,), device)
    out = BookState(*(torch.empty_like(t) for t in book))
    fills = torch.empty((len(BarFills._fields), b), dtype=i32, device=device)
    if b:
        lib = _build.load_library("lob")
        ptrs = _build.pointer_array([*book, *flow, *orders, *out, *fills])
        if len(ptrs) != lib.gymfx_lob_bar_pointer_count():
            raise RuntimeError("run_bar: pointer layout does not match the kernel source")
        _build.check_launch(lib.gymfx_lob_bar(ptrs, b, d, q, m, _build.stream_handle(device)),
                            "run_bar")
        run_bar.launches += 1
    return out, BarFills(*fills.unbind(0))


run_bar.launches = 0
