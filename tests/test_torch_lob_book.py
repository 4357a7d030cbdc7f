"""The port's LOB matching engine and K5's plain version against the JAX package.

All EXACT (integer lots and tick prices, int32).  K5's plain version
(``gymfx_tpu_torch/ops/lob_match.process_stream`` on CPU tensors, the
batched argsort engine of ``lob/book.py``) equals the JAX package's
``book.process_stream`` under ``jax.vmap`` and its Pallas kernel
``fused_process_stream`` in interpret mode, message for message, on the
cases of the JAX package's tests/test_lob_match_kernel.py (shared with
the card through ``gymfx_tpu_torch/ops/cases.py``): the flow mix of every
scenario, a hand-built adversarial stream, capacity overflow and agent
maker fills.  On streams whose lots wrap int32 it equals the Pallas
kernel, which K5 replaces; the argsort engine differs there (see
``WRAP_SHAPES``).  The book-level operations ``match_market``, ``add_limit``
and ``cancel``, batched over books with a per-book side, equal
``jax.vmap`` of the JAX functions on books built by a random stream.
The CPU model of the K5 kernel's algorithm (``cases.lob_stream_emulated``)
equals the plain version on every flow mix at six book shapes, every
hand-built stream, the seed streams, streams whose lots wrap int32 and
the streams of one message kind each that split K5's time on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.lob import book as jbook
from gymfx_tpu.ops.lob_match import fused_process_stream

from gymfx_tpu_torch.lob import book
from gymfx_tpu_torch.lob.book import AGENT_OID, BookState, Messages
from gymfx_tpu_torch.ops import cases, lob_match

from test_torch_parity import x64_off


def _jax_msgs(msgs):
    return jbook.Messages(*(jnp.asarray(x.numpy()) for x in msgs))


def _assert_same(ref, got, label):
    for name, r, g in zip((*BookState._fields, *book.FillRecord._fields),
                          (*ref[0], *ref[1]), (*got[0], *got[1])):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(), err_msg=f"{label}: {name}")


def _check_case(msgs, depth, slots, interpret=True, argsort=True):
    with x64_off():
        jm = _jax_msgs(msgs)
        empty = jbook.empty_book(depth, slots)
        ref = jax.vmap(lambda m: jbook.process_stream(empty, m))(jm) if argsort else None
        ker = jax.vmap(lambda m: fused_process_stream(empty, m, interpret=True))(jm) \
            if interpret else None
    before = lob_match.process_stream.launches
    ours = lob_match.process_stream(book.empty_book(msgs.kind.shape[0], depth, slots), msgs)
    assert lob_match.process_stream.launches == before  # the CPU runs the plain version
    if ref is not None:
        _assert_same(ref, ours, "argsort engine")
    if ker is not None:
        _assert_same(ker, ours, "pallas interpret")
    return ours


@pytest.mark.parametrize("scenario", cases.LOB_SCENARIOS)
def test_flow_streams_match_process_stream_and_pallas(scenario):
    _check_case(cases.lob_flow_streams(scenario, n_books=8, n_msgs=48), 16, 4)


@pytest.mark.parametrize("name", sorted(cases.LOB_STREAMS))
def test_hand_built_streams_match_process_stream_and_pallas(name):
    msgs, depth, slots = cases.lob_stream(name)
    ours = _check_case(msgs, depth, slots)
    if name == "overflow":
        assert int(ours[1].rested_qty.sum()) < msgs.kind.shape[1]  # drops happened
    if name == "agent_maker":
        assert int(ours[1].agent_qty.sum()) == 4


def test_deep_book_and_seed_stream_match_process_stream():
    # the widest book the kernel takes (64 levels x 8 slots), and the
    # venue's per-bar seed stream
    _check_case(cases.lob_flow_streams("lob_calm", n_books=4, n_msgs=64), 64, 8, interpret=False)
    _check_case(cases.lob_seed_streams(n_books=6), 24, 4, interpret=False)


# Lots near 2^31, where int32 level sums and the cumsum walk wrap.  There
# the JAX package's two engines part: the Pallas kernel dispatches densely,
# so it also matches the half a message does not take from, with a take of
# 0, and cancels on both halves with a target of 0; with wrapped sums that
# take of 0 fills (a NOOP trades) and zeroes the price of a level whose
# int32 sum is <= 0 (before an ADD rests), while the argsort engine's
# lax.switch leaves that half alone.  The dense form equals the switch only
# on books where no sum wraps, as its docstring says.  K5 replaces the
# Pallas kernel, so there the plain version is held to the Pallas kernel.
WRAP_SHAPES = [(4, 3), (2, 2), (33, 1), (40, 8)]


@pytest.mark.parametrize("depth,slots", WRAP_SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wrap_streams_match_pallas(seed, depth, slots):
    _check_case(cases.lob_wrap_streams(5, 60, seed=seed), depth, slots, argsort=False)


def _random_books(n=12, depth=8, slots=3):
    msgs = cases.lob_flow_streams("lob_volatile", n_books=n, n_msgs=40)
    ours, _ = lob_match.process_stream(book.empty_book(n, depth, slots), msgs)
    return ours, jbook.BookState(*(jnp.asarray(x.numpy()) for x in ours))


def test_book_operations_match_vmapped_jax():
    ours, ref_book = _random_books()
    n = ours.bid_price.shape[0]
    rng = np.random.default_rng(3)
    is_buy = rng.random(n) < 0.5
    qty = rng.integers(0, 40, n).astype(np.int32)
    price = np.full(n, 100, np.int32) + rng.integers(-6, 7, n).astype(np.int32)
    live_oids = np.where(ours.bid_oid.numpy() > 0, ours.bid_oid.numpy(), ours.ask_oid.numpy())
    oid = np.array([rng.choice(r[r > 0]) if (r > 0).any() else 0 for r in live_oids.reshape(n, -1)],
                   np.int32)
    oid[::4] = AGENT_OID  # a dead target
    kinds = rng.integers(-1, 5, n).astype(np.int32)  # out-of-range kinds clip
    side = np.where(is_buy, 1, -1).astype(np.int32)
    arrays = dict(is_buy=is_buy, qty=qty, price=price, oid=oid, kinds=kinds, side=side)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    with x64_off():
        j = {k: jnp.asarray(v) for k, v in arrays.items()}
        refs = {
            "match_market": jax.vmap(jbook.match_market)(ref_book, j["is_buy"], j["qty"]),
            "add_limit": jax.vmap(jbook.add_limit)(ref_book, j["is_buy"], j["price"], j["qty"],
                                                   j["oid"]),
            "cancel": jax.vmap(jbook.cancel)(ref_book, j["is_buy"], j["oid"]),
            "process_message": jax.vmap(jbook.process_message)(
                ref_book, (j["kinds"], j["side"], j["price"], j["qty"], j["oid"])),
        }
    ours_out = {
        "match_market": book.match_market(ours, t["is_buy"], t["qty"]),
        "add_limit": book.add_limit(ours, t["is_buy"], t["price"], t["qty"], t["oid"]),
        "cancel": book.cancel(ours, t["is_buy"], t["oid"]),
        "process_message": book.process_message(
            ours, Messages(t["kinds"], t["side"], t["price"], t["qty"], t["oid"])),
    }
    for name, ref in refs.items():
        _assert_same(ref, ours_out[name], name)
    assert int(ours_out["cancel"][1].cancelled_qty.sum()) > 0
    assert int(ours_out["match_market"][1].filled_qty.sum()) > 0


# K5's algorithm on the card, modelled in plain Python (ops/cases.py
# lob_stream_emulated: the best-first walk, the kept level sums, the
# popcount slot index, compaction of the touched levels only), against
# the plain version: torch.equal on books and all nine fill fields
LOB_SHAPES = [(8, 4), (16, 4), (24, 4), (48, 4), (33, 1), (64, 8)]


def _emulation_equals_plain(msgs, depth, slots):
    start = book.empty_book(msgs.kind.shape[0], depth, slots)
    ours = cases.lob_stream_emulated(start, msgs)
    ref = lob_match.process_stream_plain(start, msgs)
    for name, a, b in zip((*BookState._fields, *book.FillRecord._fields),
                          (*ours[0], *ours[1]), (*ref[0], *ref[1])):
        assert torch.equal(a, b), name
    return ours


@pytest.mark.parametrize("depth,slots", LOB_SHAPES)
@pytest.mark.parametrize("scenario", cases.LOB_SCENARIOS)
def test_k5_emulation_equals_plain_on_flow(scenario, depth, slots):
    _emulation_equals_plain(cases.lob_flow_streams(scenario, n_books=8, n_msgs=48), depth, slots)


@pytest.mark.parametrize("name", sorted(cases.LOB_STREAMS))
def test_k5_emulation_equals_plain_on_hand_built_streams(name):
    msgs, depth, slots = cases.lob_stream(name)
    ours = _emulation_equals_plain(msgs, depth, slots)
    fills = ours[1]
    if name == "agent_sweep":  # each side swept past half its lots, agent slots filled
        assert int(fills.filled_qty[0, 12]) == 17 and int(fills.fill_events[0, 12]) == 6
        assert int(fills.agent_qty.sum()) == 12
    if name == "cancel_reuse":  # the emptied middle level holds the later rest
        assert int(fills.rested_qty[0, 6]) == 5 and int(ours[0].bid_price[0, 1]) == 95
        assert int(fills.rested_qty[0, 7]) == 0  # no level holds 99 and none is free


@pytest.mark.parametrize("kind", cases.LOB_KINDS)
def test_kind_streams_match_process_stream_pallas_and_emulation(kind):
    # the streams that split K5's time by message kind, after the ADDs
    # that build their books: each does what its name says
    start, streams = cases.lob_kind_streams(4, 40)
    msgs = Messages(*(torch.cat([a, b], dim=1) for a, b in zip(start, streams[kind])))
    ours = _check_case(msgs, 24, 4)
    _emulation_equals_plain(msgs, 24, 4)
    fills = book.FillRecord(*(f[:, start.kind.shape[1]:] for f in ours[1]))
    tail = Messages(*(m[:, start.kind.shape[1]:] for m in msgs))
    if kind in ("take", "market"):
        assert torch.equal(fills.filled_qty, tail.qty) and int(fills.rested_qty.sum()) == 0
    else:
        assert int(fills.filled_qty.abs().sum()) == 0
    if kind == "rest":
        assert 0 < int((fills.rested_qty > 0).sum()) < fills.rested_qty.numel()  # rests and drops
    assert (int(fills.cancelled_qty.sum()) > 0) == (kind == "cancel")


def test_k5_emulation_equals_plain_on_seed_streams():
    _emulation_equals_plain(cases.lob_seed_streams(n_books=6), 24, 4)


@pytest.mark.parametrize("depth,slots", WRAP_SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k5_emulation_equals_plain_where_int32_sums_wrap(seed, depth, slots):
    _emulation_equals_plain(cases.lob_wrap_streams(5, 60, seed=seed), depth, slots)
