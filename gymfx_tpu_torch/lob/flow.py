"""Seeded order flow: bars -> per-bar LOB message streams, batched over envs.

The port of ``gymfx_tpu/lob/flow.py`` (see its module docstring for the
flow's determinism contract).  Each env's stream for bar ``t`` depends
only on ``bar_key(lob_flow_seed, t)`` and the bar's OHLC ticks, and
equals the JAX package's bit for bit: the threefry draws come from
``lob/prng.py`` and the float32 path is computed op by op, divisions by
device tensors (CUDA divides by a host scalar through its reciprocal).

Every function takes (N,) tensors of per-env values and returns (N, M)
messages.  ``bar_messages`` makes its 15 threefry draws in three batched
calls: the six stream keys, the three ``randint`` key splits, then the
nine 32-bit draws.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from gymfx_tpu_torch.lob import prng
from gymfx_tpu_torch.lob.book import (
    MSG_ADD,
    MSG_CANCEL,
    MSG_MARKET,
    MSG_NOOP,
    PRICE_CAP,
    SEED_OID_BASE,
    Messages,
)

# per-order lot cap: 2**10 lots * PRICE_CAP ticks * queue depth stays
# far inside int32 for the engine's value accumulators
QTY_CAP = 1 << 10
I32 = torch.int32


class FlowParams(NamedTuple):
    """Numeric knobs of the order-flow process (Python numbers)."""

    p_add: Any = 0.55      # P(message is a limit add)
    p_cancel: Any = 0.15   # P(message is a cancel); rest are markets
    p_noop: Any = 0.0      # P(message is a no-op) — thins activity
    base_qty: Any = 8      # mean order size in lots
    qty_jitter: Any = 6    # uniform size jitter [0, qty_jitter]
    band_ticks: Any = 6    # adds rest within this band off the path
    market_qty: Any = 4    # mean market-order size in lots
    seed_qty: Any = 16     # lots per seeded level at bar open
    crash_at: Any = -1     # message index where a sell burst starts (<0: off)
    crash_len: Any = 0     # burst length in messages
    crash_qty: Any = 32    # lots per burst market sell


def _f32(x: float) -> float:
    """A Python threshold as the float32 value JAX compares against."""
    return float(np.float32(x))


def price_to_ticks(price, tick):
    """Float prices -> int32 tick grid, clipped to [1, PRICE_CAP - 1].
    ``tick`` is a 0-d tensor on the prices' device."""
    return torch.clamp(torch.round(price / tick).to(I32), 1, PRICE_CAP - 1)


def reference_path(o, h, l, c, n_msgs: int):
    """Deterministic intrabar tick paths visiting O, H, L, C: (N,) int32
    ticks -> (N, n_msgs).  Bull bars (c >= o) sweep O -> L -> H -> C,
    bear bars O -> H -> L -> C."""
    dev = o.device
    # jnp.linspace(0.0, 3.0, n) in float32: 3 * (i / (n - 1)), then 3
    div = n_msgs - 1
    if div > 0:
        step = torch.arange(div, dtype=torch.float32, device=dev) \
            / torch.full((), div, dtype=torch.float32, device=dev)
        t = torch.cat([0.0 * (1.0 - step) + 3.0 * step,
                       torch.full((1,), 3.0, dtype=torch.float32, device=dev)])
    else:
        t = torch.zeros(n_msgs, dtype=torch.float32, device=dev)
    bull = (c >= o)[:, None]
    of, cf = o.to(torch.float32)[:, None], c.to(torch.float32)[:, None]
    w0 = torch.where(bull, l[:, None], h[:, None]).to(torch.float32)
    w1 = torch.where(bull, h[:, None], l[:, None]).to(torch.float32)
    seg0 = of + (w0 - of) * torch.clamp(t, 0.0, 1.0)
    seg1 = w0 + (w1 - w0) * torch.clamp(t - 1.0, 0.0, 1.0)
    seg2 = w1 + (cf - w1) * torch.clamp(t - 2.0, 0.0, 1.0)
    path = torch.where(t <= 1.0, seg0, torch.where(t <= 2.0, seg1, seg2))
    return torch.clamp(torch.round(path).to(I32), 1, PRICE_CAP - 1)


def seed_messages(o_tick, n_levels: int, fp: FlowParams) -> Messages:
    """Deterministic book seed at each env's bar open: ``n_levels`` bid
    levels at ``o - 1 - i`` and ask levels at ``o + 1 + i`` ticks,
    ``seed_qty`` lots each (a number, or an (N,) int32 tensor: each env's,
    the scenario generator's blend).  (N,) -> (N, 2 n_levels)."""
    n, dev = o_tick.shape[0], o_tick.device
    off = 1 + torch.arange(n_levels, dtype=I32, device=dev)
    kind = torch.full((n, 2 * n_levels), MSG_ADD, dtype=I32, device=dev)
    side = torch.cat([torch.ones_like(off), -torch.ones_like(off)]).expand(n, -1)
    price = torch.clamp(torch.cat([o_tick[:, None] - off, o_tick[:, None] + off], dim=1),
                        1, PRICE_CAP - 1)
    if isinstance(fp.seed_qty, torch.Tensor):
        qty = torch.clamp(fp.seed_qty, 1, QTY_CAP).to(I32)[:, None].expand(n, 2 * n_levels)
        qty = qty.contiguous()
    else:
        qty = torch.full_like(kind, min(max(int(fp.seed_qty), 1), QTY_CAP))
    oid = (SEED_OID_BASE + torch.arange(2 * n_levels, dtype=I32, device=dev)).expand(n, -1)
    return Messages(kind, side.contiguous(), price, qty, oid.contiguous())


def kind_thresholds(fp: FlowParams, f32_sums: bool = False) -> Tuple[float, float, float]:
    """The three kind thresholds ``p_noop``, ``p_noop + p_add`` and ``p_noop
    + p_add + p_cancel`` as the float32 values JAX compares against: the
    float64 sums of Python numbers rounded once, or, with ``f32_sums``
    (the scenario generator's blend, whose fields are float32 arrays),
    float32 sums of the float32 values."""
    if not f32_sums:
        return _f32(fp.p_noop), _f32(fp.p_noop + fp.p_add), _f32(fp.p_noop + fp.p_add + fp.p_cancel)
    noop = _f32(fp.p_noop)
    two = _f32(noop + _f32(fp.p_add))  # a sum of two float32 values is exact in float64
    return noop, two, _f32(two + _f32(fp.p_cancel))


def bar_messages(key, o_tick, h_tick, l_tick, c_tick, n_msgs: int,
                 fp: FlowParams, f32_sums: bool = False) -> Messages:
    """Each env's seeded message stream for one bar: (N, 2) keys and (N,)
    OHLC ticks -> (N, n_msgs).  Flow oids are ``1 + message_index``;
    cancels target a uniformly drawn earlier oid.  ``f32_sums`` as in
    :func:`kind_thresholds`."""
    n, dev = key.shape[0], key.device
    keys = prng.split(key, 6)  # kind, side, jitter, qty, band, cancel
    sub = prng.split(keys[:, 2:5], 2).reshape(n, 6, 2)  # randint's halves
    bits = prng.random_bits(torch.cat([keys[:, :2], keys[:, 5:], sub], dim=1), n_msgs)
    u_kind, u_side, u_cxl = (prng.bits_to_uniform(bits[:, i]) for i in range(3))

    def draw(i, lo, hi):
        return prng.bits_to_randint(bits[:, 3 + 2 * i], bits[:, 4 + 2 * i], lo, hi)

    idx = torch.arange(n_msgs, dtype=I32, device=dev)
    path = reference_path(o_tick, h_tick, l_tick, c_tick, n_msgs)
    mid = torch.clamp(path + draw(0, -2, 3), l_tick[:, None], h_tick[:, None])
    mid = torch.clamp(mid, 1, PRICE_CAP - 1)

    thr = kind_thresholds(fp, f32_sums)
    kind = torch.where(
        u_kind < thr[0], MSG_NOOP,
        torch.where(u_kind < thr[1], MSG_ADD, torch.where(u_kind < thr[2], MSG_CANCEL, MSG_MARKET)),
    ).to(I32)
    side = torch.where(u_side < 0.5, 1, -1).to(I32)

    band = 1 + draw(2, 0, max(int(fp.band_ticks), 1))
    add_price = torch.clamp(mid - side * band, 1, PRICE_CAP - 1)
    jitter = draw(1, 0, max(int(fp.qty_jitter), 1))  # one draw for both sizes
    qty = torch.where(kind == MSG_MARKET, int(fp.market_qty) + jitter, int(fp.base_qty) + jitter)

    oid = (1 + idx).expand(n, -1)
    cxl_target = 1 + torch.floor(u_cxl * torch.clamp_min(idx, 1).to(torch.float32)).to(I32)
    oid = torch.where(kind == MSG_CANCEL, torch.minimum(cxl_target, idx), oid)

    # flash-crash burst: a contiguous window of forced market sells
    crash_at, crash_len = int(fp.crash_at), int(fp.crash_len)
    in_crash = (idx >= crash_at) & (idx < crash_at + crash_len) & (crash_at >= 0)
    kind = torch.where(in_crash, MSG_MARKET, kind).to(I32)
    side = torch.where(in_crash, -1, side).to(I32)
    qty = torch.where(in_crash, int(fp.crash_qty), qty)

    qty = torch.clamp(qty, 1, QTY_CAP).to(I32)
    price = torch.where(kind == MSG_ADD, add_price, mid)
    return Messages(kind, side, price, qty, oid.to(I32))


def bar_key(flow_seed: int, t_global):
    """The per-bar stream keys, (N,) bar rows -> (N, 2): ``fold_in(
    PRNGKey(flow_seed), t)``, the only randomness the venue uses."""
    return prng.fold_in(prng.PRNGKey(flow_seed, t_global.device), t_global)


def random_message_streams(key, n_streams: int, n_msgs: int,
                           fp: FlowParams, o_tick: int = 100):
    """``n_streams`` seeded streams around a flat reference price, from
    ``split(key, n_streams)``: the parity tests' and the fills/s
    measurement's message mix.  ``key`` is one (2,) key."""
    keys = prng.split(key, n_streams)
    ot = torch.full((n_streams,), int(o_tick), dtype=I32, device=key.device)
    span = max(4, n_msgs // 8)
    return bar_messages(keys, ot, ot + span, ot - span, ot, n_msgs, fp)
