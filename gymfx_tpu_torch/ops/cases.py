"""Seeded inputs for the kernels K1-K3 and K5-K7, drawn with numpy, and
K4's bf16 cases with an emulation of its tensor-core kernels.

One source of cases for everything that holds a kernel to its plain
version or to the JAX package: chip_smoke.py on the card, and the tests
(tests/test_torch_kernels.py on the CPU, tests/test_torch_cuda.py on the
card).  K1 gets windows with NaN, ±inf, 1e30, 0/0 and neutral envs; K2
and K3 get open, flat, flipping and (with ``big``) huge ledgers, pending
and forced orders, brackets at, inside and across the bar, and -inf
reward peaks, over the grid of K2's static flags.  K5 gets the venue's
seed streams, every scenario's flow mix, five hand-built streams,
streams whose lots wrap int32 sums and streams of one message kind each,
and :func:`lob_stream_emulated` models the algorithm of its kernel on
the CPU; K8 gets the venue's bars and books whose lots wrap int32
(:func:`lob_bar_emulated`), K9 bars at int32 and int64 rows
(:func:`lob_flow_bars`) and :func:`bar_flow_emulated`, a model of its
lanes in numpy uint32.
K6 gets int16 deltas at both ends of their range, divisors 1, 60, 1440
and f32(1e5), and a ragged row count; K7 neutral rows, NaN and +-inf
inputs, clip 0 and 10, steps at 0 and at n, the export's steps and
clamped ones, and :func:`scaled_windows_tiling` /
:func:`scaled_windows_emulated` model its kernel's tiling on the CPU.  K4's bf16 cases (:data:`ATTENTION_BF16_CASES`)
come with :func:`attention_forward_emulated` and
:func:`attention_backward_emulated`, the tensor-core kernels' arithmetic
with their rounding points in plain torch.  :func:`tick_walk_columns`
and :func:`write_bar_csv` make the on-grid M1 tapes of the data path.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from gymfx_tpu_torch.core.types import EnvConfig, EnvParams, EnvState, initial_state

# every combination of K2's static flags: (slip_open, slip_limit,
# slip_match, financing_enabled, limit_fill_policy,
# intrabar_collision_policy)
FLAG_GRID = list(itertools.product(
    (True, False), (False, True), (False, True), (False, True),
    ("cross", "touch", "conservative"), ("worst_case", "ohlc"),
))
REWARDS = ("pnl_reward", "dd_penalized_reward")
# K2's edge sizes: one env, counts that no CTA of 64 divides; at the
# flagship's flags and with slip_match, financing and the ohlc policy on
# (the three flags its kernel specialises at compile time)
K2_EDGE_SIZES = (1, 63, 8193)
K2_EDGE_FLAGS = (FLAG_GRID[0], (False, True, True, True, "touch", "ohlc"))
PARAM_SETS = {
    "plain": dict(slippage=1e-4, commission=2e-5, price_tick=0.0, size_step=0.0, min_qty=0.0),
    "quantized": dict(slippage=2e-4, commission=3e-5, price_tick=1e-5, size_step=0.01, min_qty=0.5),
}
MARK_PARAMS = dict(initial_cash=10000.0, reward_scale=2.0, penalty_lambda=0.5)
# K3's flag patterns: (mark_pred, live), each all true, all false or mixed
K3_FLAG_PATTERNS = tuple(itertools.product(("all", "none", "mixed"), repeat=2))
_INT_PARAMS = ("entry_start_mow", "force_close_mow")


def obs_case(seed=0, n=64, w=8, f=3):
    """(win, mean, std, neutral) arrays for K1.  The special cells wrap
    into small shapes (modulo n, w, f); a single env is not neutral."""
    rng = np.random.default_rng(seed)
    win = rng.normal(0, 3, (n, w, f)).astype(np.float32)
    win[0, 0, 0] = np.nan
    win[1 % n, 2 % w, 1 % f] = np.inf
    win[2 % n, 3 % w, 2 % f] = -np.inf
    win[3 % n, 1 % w, 1 % f] = 1e30
    mean = rng.normal(0, 1, (n, f)).astype(np.float32)
    std = (rng.random((n, f)) + 0.1).astype(np.float32)
    std[4 % n, 0] = 0.0  # 0/0 and x/0
    win[4 % n, :2, 0] = mean[4 % n, 0]
    neutral = rng.random(n) < 0.2
    neutral[0] = n > 1
    return win, mean, std, neutral


# K1's edge shapes: the flagship's (8192, 32, 5); one env (the episode
# and stream phases); env counts that no env block divides; faces of
# 9 x 3 floats, 108 bytes, not a multiple of 16
K1_EDGE_SHAPES = ((8192, 32, 5), (1, 32, 5), (63, 32, 5), (8193, 32, 5), (63, 9, 3))


def step_obs_tiling(n, w, f, env_block, grid, threads, vectors, out_offset=0, in_offset=0):
    """A CPU model of K1's tiling (csrc/env_kernels.cu step_obs_kernel):
    which CTA, thread and vector covers each element of an (n, w, f)
    window, and the env and feature it derives by the kernel's magic
    numbers.  ``out_offset`` / ``in_offset`` are the output's and input's
    data pointers in floats past a 16-byte boundary.

    Returns int64 arrays, one entry per element covered: ``index`` (the
    element, row-major), ``env``, ``feature``, ``cta``, ``thread``,
    ``vector`` (the vector's number within its env block, -1 on the
    scalar path), ``pass_`` and ``slot`` (which of the thread's
    ``vectors`` registers in which pass), ``float4_in`` (whether the
    input is read as a float4); and ``staged_*`` for the moments each CTA
    stages (``staged_index`` into the (n, f) moments, with its env,
    feature and thread)."""
    from gymfx_tpu_torch.ops.window_zscore import magic, magic_div

    wf = w * f
    div_wf, div_f = magic(wf), magic(f)
    blocks = np.arange(-(-n // env_block), dtype=np.int64)
    env0 = blocks * env_block
    envs = np.minimum(env_block, n - env0)
    count = envs * wf
    base = env0 * wf
    head = np.minimum((4 - (out_offset + base) % 4) % 4, count)
    n_vec = (count - head) // 4
    tail0 = head + 4 * n_vec
    float4_in = (in_offset + base + head) % 4 == 0

    # the vectors: block b's vector v covers j = head + 4v .. + 3
    vb = np.repeat(blocks, n_vec)
    v = np.arange(vb.size, dtype=np.int64) - np.repeat(np.cumsum(n_vec) - n_vec, n_vec)
    lane = np.tile(np.arange(4, dtype=np.int64), vb.size)
    vb4, v4 = np.repeat(vb, 4), np.repeat(v, 4)
    j_vec = head[vb4] + 4 * v4 + lane
    # the scalar path: thread t takes head element t and tail element t
    sb = np.concatenate([np.repeat(blocks, head), np.repeat(blocks, count - tail0)])
    st = np.concatenate([np.arange(k) for k in head] + [np.arange(k) for k in count - tail0]
                        ).astype(np.int64) if sb.size else np.zeros(0, np.int64)
    j_scalar = np.where(np.arange(sb.size) < head.sum(), st, tail0[sb] + st)

    b = np.concatenate([vb4, sb])
    j = np.concatenate([j_vec, j_scalar])
    vector = np.concatenate([v4, np.full(sb.size, -1, np.int64)])
    thread = np.concatenate([v4 % threads, st])
    q = magic_div(j, *div_f)
    out = dict(
        index=base[b] + j,
        env=env0[b] + magic_div(j, *div_wf),
        feature=j - q * f,
        cta=b % grid,
        thread=thread,
        vector=vector,
        pass_=np.where(vector >= 0, vector // (threads * vectors), -1),
        slot=np.where(vector >= 0, (vector // threads) % vectors, -1),
        float4_in=np.where(vector >= 0, float4_in[b], False),
    )
    kb = np.repeat(blocks, envs * f)
    k = np.arange(kb.size, dtype=np.int64) - np.repeat(np.cumsum(envs * f) - envs * f, envs * f)
    ke = magic_div(k, *div_f)
    out.update(staged_index=env0[kb] * f + k, staged_env=env0[kb] + ke,
               staged_feature=k - ke * f, staged_thread=k % threads)
    return out


def step_obs_row_tiling(n, w, f, grid, threads, group):
    """The CPU model of K1's row-group path: group g (the ``group`` rows
    of one env at elements g * group * f onward, group * f / 4 float4s)
    belongs to lane g % 32 of warp g // 32; warp i is warp i % (threads
    / 32) of CTA (i // (threads / 32)) % grid in pass i // (grid *
    threads / 32).  The warp's lanes move its groups' float4s coalesced
    (lane l the l-th of each 32, in ``slot`` order) through shared
    memory; the lane that owns a group computes it.  The env comes from
    g / (w / group) by the kernel's magic numbers; the feature of element
    k of a group is k % f, a constant the kernel compiles in.  Keys as
    :func:`step_obs_tiling` (no ``staged_*``), plus ``mover``, the thread
    that loads and stores the element's float4."""
    from gymfx_tpu_torch.ops.window_zscore import magic, magic_div

    per, v = group * f, group * f // 4
    groups = n * w // group
    g = np.repeat(np.arange(groups, dtype=np.int64), per)
    k = np.tile(np.arange(per, dtype=np.int64), groups)
    warps_per_cta = threads // 32
    warp = g // 32
    vector = g * v + k // 4
    within = vector - warp * 32 * v  # the float4's place in its warp's span
    return dict(
        index=g * per + k,
        env=magic_div(g, *magic(w // group)),
        feature=k % f,
        cta=(warp // warps_per_cta) % grid,
        thread=(warp % warps_per_cta) * 32 + g % 32,
        vector=vector,
        pass_=warp // (grid * warps_per_cta),
        slot=within // 32,
        mover=(warp % warps_per_cta) * 32 + within % 32,
        float4_in=np.ones(g.size, bool),
    )


def step_obs_emulated(win, mean, std, neutral, binary_mask, clip, tiling):
    """K1's arithmetic in numpy f32 over ``tiling`` (:func:`step_obs_tiling`
    of win's shape): each element scaled by the moments of the env and
    feature the tiling derives for it."""
    n, w, f = win.shape
    e, feat = tiling["env"], tiling["feature"]
    x = win.reshape(-1)[tiling["index"]]
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (x - mean[e, feat]) / std[e, feat]
    v = np.where(neutral[e], np.float32(0), z)
    if any(binary_mask):
        v = np.where(np.asarray(binary_mask, bool)[feat], x, v)
    if clip > 0:
        v = np.minimum(np.maximum(v, np.float32(-clip)), np.float32(clip))
    v = np.nan_to_num(v, nan=0.0, posinf=np.float32(clip), neginf=np.float32(-clip))
    out = np.full(n * w * f, np.nan, np.float32)
    out[tiling["index"]] = v.astype(np.float32)
    return out.reshape(n, w, f)


def ledger_case(seed, n=64, big=True):
    """Random per-env ledgers, pending orders, brackets and one bar each
    (``big`` adds a 200k-unit position to the choices).  Returns
    (K2 fields, K3 fields, bars, advance, rng); draw K3's mark and live
    flags from ``rng``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    price = (1.1 + rng.normal(0, 0.01, n)).astype(f32)
    sizes = [0.0, 1.0, -1.0, 2.5, -2.5, 0.3] + ([-200000.0] if big else [])
    pos = rng.choice(sizes, n).astype(f32)
    spread = np.abs(rng.normal(0, 5e-4, n)).astype(f32) + f32(1e-4)
    o = (price + rng.normal(0, 3e-4, n)).astype(f32)
    c = (price + rng.normal(0, 3e-4, n)).astype(f32)
    h = (np.maximum(o, c) + spread).astype(f32)
    l = (np.minimum(o, c) - spread).astype(f32)
    sign = np.sign(pos)
    dist = rng.choice([2e-4, 5e-4, 2e-3], n).astype(f32)
    bracket_sl = np.where(pos != 0, price - sign * dist, 0).astype(f32)
    bracket_tp = np.where(pos != 0, price + sign * dist * 2, 0).astype(f32)
    bracket_sl[rng.random(n) < 0.2] = 0
    bracket_tp[rng.random(n) < 0.2] = 0
    bracket_sl[:4] = o[:4]  # brackets exactly at the open
    pend_target = rng.choice([0.0, 1.0, -1.0, 2.0, -0.004, 0.37], n).astype(f32)
    fields = dict(
        pos=pos,
        entry_price=np.where(pos != 0, price + rng.normal(0, 1e-3, n), 0).astype(f32),
        cash_delta=(rng.normal(0, 50, n) - pos * price).astype(f32),
        commission_paid=np.abs(rng.normal(0, 1, n)).astype(f32),
        last_trade_cost=np.zeros(n, f32),
        trade_pnl_sum=rng.normal(0, 5, n).astype(f32),
        trade_pnl_sumsq=np.abs(rng.normal(0, 20, n)).astype(f32),
        open_trade_commission=np.abs(rng.normal(0, 1e-3, n)).astype(f32),
        pending_target=pend_target,
        pending_sl=(price - np.sign(pend_target) * 1e-3).astype(f32),
        pending_tp=(price + np.sign(pend_target) * 2e-3).astype(f32),
        bracket_sl=bracket_sl,
        bracket_tp=bracket_tp,
        pending_active=rng.random(n) < 0.6,
        pending_forced=rng.random(n) < 0.2,
        trade_count=rng.integers(0, 9, n).astype(np.int32),
        trades_won=rng.integers(0, 5, n).astype(np.int32),
        trades_lost=rng.integers(0, 5, n).astype(np.int32),
    )
    mark = dict(
        equity_delta=rng.normal(0, 30, n).astype(f32),
        prev_equity_delta=rng.normal(0, 30, n).astype(f32),
        peak_equity_delta=np.abs(rng.normal(0, 30, n)).astype(f32),
        max_drawdown_money=np.abs(rng.normal(0, 10, n)).astype(f32),
        max_drawdown_pct=np.abs(rng.normal(0, 1, n)).astype(f32),
        reward_peak=np.where(rng.random(n) < 0.3, -np.inf, rng.normal(0, 30, n)).astype(f32),
    )
    bars = dict(o=o, h=h, l=l, c=c, accrual=rng.normal(0, 1e-4, n).astype(f32))
    advance = rng.random(n) < 0.85
    return fields, mark, bars, advance, rng


def flag_pattern(kind, n, rng):
    """(n,) bool flags: "all" true, "none", or "mixed" (drawn from ``rng``)."""
    if kind == "all":
        return np.ones(n, bool)
    if kind == "none":
        return np.zeros(n, bool)
    return rng.random(n) < 0.5


def exec_diag_case(n, width, seed=1):
    """Random (n, width) int32 counters, so an add lands on nonzero values."""
    return np.random.default_rng(seed).integers(0, 3, (n, width)).astype(np.int32)


def flag_config(flags, reward="pnl_reward", window_size=8) -> EnvConfig:
    """The EnvConfig of one FLAG_GRID entry."""
    slip_open, slip_limit, slip_match, financing, limit_fill, collision = flags
    return EnvConfig(slip_open=slip_open, slip_limit=slip_limit, slip_match=slip_match,
                     financing_enabled=financing, limit_fill_policy=limit_fill,
                     intrabar_collision_policy=collision, reward=reward,
                     window_size=window_size)


def env_params(values, device) -> EnvParams:
    """EnvParams holding ``values`` (f32 scalars) and 0 everywhere else."""
    return EnvParams(*(
        torch.tensor(0, dtype=torch.int32, device=device) if k in _INT_PARAMS
        else torch.tensor(values.get(k, 0.0), dtype=torch.float32, device=device)
        for k in EnvParams._fields
    ))


def ledger_state(cfg: EnvConfig, fields, device) -> EnvState:
    """A fresh batched EnvState with ``fields`` (arrays of one length)
    and :func:`exec_diag_case` counters."""
    n = len(next(iter(fields.values())))
    st = initial_state(cfg, n, device)
    return st._replace(
        exec_diag=torch.from_numpy(exec_diag_case(n, st.exec_diag.shape[1])).to(device),
        **{k: torch.from_numpy(v).to(device) for k, v in fields.items()},
    )


# ---------------------------------------------------------------------------
# K5: LOB message streams (the cases of the JAX package's
# tests/test_lob_match_kernel.py), as (B, M) int32 Messages
# ---------------------------------------------------------------------------
LOB_SCENARIOS = ("lob_calm", "lob_trend", "lob_volatile", "lob_thin", "lob_flash_crash")
# kind, side, price, qty, oid rows; (depth, slots) of the book they run through
LOB_STREAMS = {
    # crossing adds (price improvement), partial fills, cancels of live,
    # dead and zero oids, a market order past the book, noops and
    # out-of-range kinds (clipped to MARKET and NOOP), a zero-qty add
    "adversarial": ([
        (1, -1, 105, 5, 1), (1, -1, 103, 3, 2), (1, -1, 103, 2, 3),
        (1, +1, 100, 4, 4), (1, +1, 98, 6, 5), (0, +1, 0, 0, 0),
        (1, +1, 104, 4, 6), (3, -1, 0, 3, 0), (2, -1, 0, 5, 1),
        (2, -1, 0, 5, 1), (2, +1, 0, 0, 0), (3, +1, 0, 50, 0),
        (7, +1, 0, 2, 0), (-2, -1, 99, 9, 9), (1, +1, 101, 0, 7),
    ], (6, 2)),
    # more price levels than the book holds, deeper queues than its slots
    "overflow": ([(1, +1, 90 + i, 1, 10 + i) for i in range(8)]
                 + [(1, +1, 90, 1, 30 + i) for i in range(5)], (3, 2)),
    # an agent take-profit resting ahead of flow, filled by flow takers
    "agent_maker": ([
        (1, -1, 110, 4, 1 << 29), (1, -1, 110, 2, 41), (3, +1, 0, 3, 0), (3, +1, 0, 5, 0),
    ], (4, 3)),
    # market orders sweeping more than half of each side through levels
    # that hold agent slots (the first ends exactly on a level's last
    # lot), then crossing limits that sweep the rest and rest beyond it
    "agent_sweep": ([
        (1, -1, 101, 3, 1), (1, -1, 101, 2, 1 << 29), (1, -1, 102, 4, 2), (1, -1, 103, 1, 1 << 29),
        (1, -1, 103, 5, 3), (1, -1, 104, 2, 4), (1, -1, 105, 6, 1 << 29), (1, -1, 106, 3, 5),
        (1, +1, 99, 2, 6), (1, +1, 98, 3, 1 << 29), (1, +1, 97, 4, 7), (1, +1, 96, 1, 8),
        (3, +1, 0, 17, 0), (3, +1, 0, 4, 0), (3, -1, 0, 8, 0),
        (1, +1, 106, 10, 9), (1, -1, 95, 20, 10), (3, +1, 0, 50, 0),
    ], (8, 3)),
    # a cancel empties a middle level of a full book; a later rest at a
    # new price must take that level as the first free one (its kept lot
    # sum back at 0), a rest at the cancelled price finds no level, and a
    # partial cancel compacts a queue
    "cancel_reuse": ([
        (1, +1, 100, 2, 1), (1, +1, 99, 3, 2), (1, +1, 98, 4, 3), (1, +1, 97, 5, 4),
        (1, +1, 96, 1, 11), (2, +1, 0, 0, 2), (1, +1, 95, 5, 5), (1, +1, 99, 1, 6),
        (1, +1, 95, 2, 7), (1, +1, 95, 1, 8), (2, +1, 0, 0, 5), (1, +1, 95, 3, 12),
        (3, -1, 0, 3, 0), (2, +1, 0, 0, 3), (1, -1, 94, 2, 13), (1, +1, 93, 1, 14),
    ], (4, 2)),
}


def _messages(columns, device):
    from gymfx_tpu_torch.lob.book import Messages

    return Messages(*(torch.as_tensor(c, dtype=torch.int32, device=device).contiguous()
                      for c in columns))


def lob_stream(name: str, device=None):
    """One of LOB_STREAMS as a one-book (1, M) stream: (msgs, depth, slots)."""
    rows, (depth, slots) = LOB_STREAMS[name]
    cols = np.array(rows, np.int32).T[:, None, :]
    return _messages(cols, device), depth, slots


def lob_flow_streams(scenario: str, n_books: int, n_msgs: int, device=None):
    """``random_message_streams(PRNGKey(17), ...)`` of a scenario: the flow
    mix of the JAX package's parity test and ``bench.py --lob``."""
    from gymfx_tpu_torch.lob import prng
    from gymfx_tpu_torch.lob.flow import random_message_streams
    from gymfx_tpu_torch.lob.scenarios import scenario_flow_params

    msgs = random_message_streams(prng.PRNGKey(17, device), n_books, n_msgs,
                                  scenario_flow_params(scenario))
    return _messages(msgs, device)


def lob_seed_streams(n_books: int, seed: int = 0, device=None):
    """The venue's per-bar seed streams (8 levels a side, lob_volatile's
    16 lots) at ``n_books`` EUR/USD-like open ticks (~1.1 at a 1e-5
    tick): (B, 16)."""
    from gymfx_tpu_torch.lob.flow import seed_messages
    from gymfx_tpu_torch.lob.scenarios import scenario_flow_params

    o = np.random.default_rng(seed).integers(105_000, 115_000, n_books).astype(np.int32)
    return _messages(seed_messages(torch.from_numpy(o), 8, scenario_flow_params("lob_volatile")),
                     device)


def lob_wrap_streams(n_books: int, n_msgs: int, seed: int = 0, device=None):
    """(B, M) streams of every kind, out-of-range kinds included, around
    100 ticks with lots up to 2^31 - 1 and down to -2^31: level sums and
    the cumsum walk wrap mod 2^32, and negative and zero takes come."""
    rng = np.random.default_rng(seed)
    shape = (n_books, n_msgs)
    lots = np.array([1, 3, 7, 1 << 29, 1 << 30, (1 << 31) - 1, 0, -5, -(1 << 31) + 1, -(1 << 31)])
    qty = rng.choice(lots, shape, p=[.2, .2, .1, .1, .1, .1, .05, .05, .05, .05])
    cols = np.stack([rng.integers(-1, 5, shape), rng.choice([-1, 1], shape),
                     rng.integers(97, 104, shape), qty, rng.integers(0, 12, shape)])
    return _messages(cols.astype(np.int32), device)


# One kind of message at a time, to split K5's time per message by kind:
# each stream runs through the book that LOB_KIND_START leaves (12 levels
# a side, bids 100 down, asks 101 up, 3 slots of 10 lots each, oids 1-36
# on the bids and 37-72 on the asks).  A "rest" is a non-crossing ADD at 0-15
# ticks behind its best price (a free slot, a new level or a drop); a "take"
# is an ADD priced through the whole opposite side, of 1-2 lots, so it
# fills at the best level and rests nothing; a "market" order takes 1-2
# lots; a "cancel" names one of the 72 oids on either side, so about half
# hit the first time.
LOB_KINDS = ("noop", "rest", "take", "market", "cancel")


def lob_kind_streams(n_books: int, n_msgs: int, seed: int = 0, device=None):
    """(start, streams): the (B, 72) ADD stream that builds the books, and
    for each of LOB_KINDS a (B, ``n_msgs``) stream of that kind alone."""
    rng = np.random.default_rng(seed)
    d, s = np.meshgrid(np.arange(12), np.arange(3), indexing="ij")
    bids = [np.ones(36), np.ones(36), 100 - d.ravel(), np.full(36, 10), np.arange(1, 37)]
    asks = [np.ones(36), -np.ones(36), 101 + d.ravel(), np.full(36, 10), np.arange(37, 73)]
    start = np.concatenate([np.stack(bids), np.stack(asks)], axis=1)
    start = np.broadcast_to(start[:, None, :], (5, n_books, 72))
    shape = (n_books, n_msgs)
    side = rng.choice([-1, 1], shape)
    buy = side > 0
    lots = rng.integers(1, 3, shape)
    kinds = {
        "noop": (0, side, np.full(shape, 100), lots, np.zeros(shape)),
        "rest": (1, side, np.where(buy, 100, 101) - side * rng.integers(0, 16, shape), lots,
                 rng.integers(73, 1 << 20, shape)),
        "take": (1, side, np.where(buy, 112, 89), lots, rng.integers(73, 1 << 20, shape)),
        "market": (3, side, np.zeros(shape), lots, np.zeros(shape)),
        "cancel": (2, side, np.zeros(shape), np.zeros(shape), rng.integers(1, 73, shape)),
    }
    streams = {k: _messages([np.broadcast_to(c, shape).astype(np.int32) for c in cols], device)
               for k, cols in kinds.items()}
    return _messages(start.astype(np.int32), device), streams


# K5's algorithm on the card (csrc/lob_kernels.cu), one book at a time in
# plain Python: a model of the kernel's arithmetic, not of its lanes.  A
# level's lots are kept as an int32 sum mod 2^32 and a half's exact total
# as a Python int; matching walks the eligible levels best first, fills
# only the levels it visited and compacts only those; a rest goes to the
# level holding its price, else the first free one, at the slot after its
# live ones.  Nothing on a path calls it: the CPU tests hold it to the
# plain version, so the kernel's design is checked where there is no nvcc.
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_NONE = 1 << 32  # above every level key


def _i32(x: int) -> int:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


class _EmuHalf:
    """One half of one book as a warp holds it: per level the price, the
    queue and the level's lot sum mod 2^32; the half's exact lot total
    and ``best``, a priority key no worse than the best priced level's
    (exact after a match, a cancel or the load; a rest can only better
    it; a level losing its price leaves it better than the truth, which
    costs a walk at most one step that finds no level)."""

    def __init__(self, price, qty, oid, asks: bool):
        self.price, self.qty, self.oid = list(price), [list(q) for q in qty], [list(o) for o in oid]
        self.asks = asks
        self.sum = [sum(q) & 0xFFFFFFFF for q in self.qty]
        self.total = sum(map(sum, self.qty))
        self.best = min(map(self._key, self.price))

    def _key(self, p: int) -> int:
        """Priority on this half, lower first; _NONE without a price."""
        return (p if self.asks else _I32_MAX - p) if p > 0 else _NONE

    def _eligible(self, key: int, limit: int) -> bool:
        if key == _NONE:
            return False
        return key <= limit if self.asks else _I32_MAX - key >= limit

    def match(self, take: int, limit: int):
        """book.py::_match_half.  With the half's exact total within
        int32 (and no take so negative that take - total wraps), no
        prefix sum wraps: a take <= 0 fills nothing, nothing fills when
        the best level is not eligible, and the walk stops once it has
        reached the take.  Otherwise it visits every eligible level, with
        the sums wrapping as the argsort engine's."""
        from gymfx_tpu_torch.lob.book import AGENT_OID, PRICE_CAP

        stats = [0, 0, 0, 0, 0, PRICE_CAP, 0]
        fast = self.total <= _I32_MAX and take - self.total >= _I32_MIN
        if fast and (take <= 0 or not self._eligible(self.best, limit)):
            return stats
        keys = [self._key(p) for p in self.price]  # eligible levels come first in key order
        best = self.best if fast else min(keys)
        ahead, visited, last = 0, {}, _NONE  # lots ahead of `best` (mod 2^32); level -> lots ahead of it
        while self._eligible(best, limit):
            if best in keys:  # live prices are distinct: one level, or none if `best` was stale
                d = keys.index(best)
                visited[d], keys[d] = ahead, _NONE
                ahead = (ahead + self.sum[d]) & 0xFFFFFFFF
            last, best = best, min(keys)
            if fast and ahead >= take:
                break
        if fast:
            self.best = last if ahead > take else best
        for d, before in visited.items():
            p, qty, oid = self.price[d], self.qty[d], self.oid[d]
            level_fill = 0
            for s, a in enumerate(qty):
                f = min(max(_i32(take - before), 0), a)
                before += a
                level_fill += f
                stats[0] += f
                stats[1] += f * p
                stats[2] += f > 0
                if oid[s] == AGENT_OID and f > 0:
                    stats[3] += f
                    stats[4] += f * p
                qty[s] = a - f
                if qty[s] <= 0:
                    oid[s] = 0
            if _i32(level_fill) > 0:
                stats[5], stats[6] = min(stats[5], p), max(stats[6], p)
            self._compact(d)
            self.sum[d] = (self.sum[d] - level_fill) & 0xFFFFFFFF
            if fast and self.sum[d] == 0:
                self.price[d] = 0  # the walk zeroes the price of a level it empties
        stats[:5] = map(_i32, stats[:5])
        self._retotal(stats[0])
        if not fast:
            self.reset()
        return stats

    def reset(self):
        """Zero the price of every level whose int32 lot sum is <= 0: at
        the end of a wrapped match only (book.py resets both halves at
        every match, but within int32 a level's sum is 0 exactly when it
        is empty, and the walk and the cancel zero the price of a level
        they empty; a half beyond int32 always matches wrapped)."""
        self.price = [p if _i32(s) > 0 else 0 for p, s in zip(self.price, self.sum)]

    def cancel(self, target: int) -> int:
        """book.py::_cancel_half: only the levels hit are compacted."""
        if target == 0:
            return 0
        removed = 0
        for d, (qty, oid) in enumerate(zip(self.qty, self.oid)):
            hits = [s for s in range(len(qty)) if oid[s] == target and qty[s] > 0]
            if not hits:
                continue
            level = sum(qty[s] for s in hits)
            for s in hits:
                qty[s] = oid[s] = 0
            self._compact(d)
            self.sum[d] = (self.sum[d] - level) & 0xFFFFFFFF
            if _i32(self.sum[d]) <= 0:
                self.price[d] = 0
            removed += level
        self.best = min(map(self._key, self.price))
        removed = _i32(removed)
        self._retotal(removed)
        return removed

    def rest(self, p: int, q: int, o: int) -> int:
        """book.py::_rest_half: the level holding p, else the first level
        whose lot sum is 0; its queue is full when its last slot is live
        (queues are front-compacted), and the new slot is the count of
        its live slots."""
        if q <= 0:
            return 0
        has = [d for d, x in enumerate(self.price) if x == p and x > 0]
        free = [d for d, s in enumerate(self.sum) if s == 0]
        if not (has or free):
            return 0
        d = (has or free)[0]
        qty = self.qty[d]
        if qty[-1] != 0:
            return 0
        slot = sum(x != 0 for x in qty)
        qty[slot], self.oid[d][slot] = q, o
        self.price[d] = p
        self.sum[d] = (self.sum[d] + q) & 0xFFFFFFFF
        self.total += q
        self.best = min(self.best, self._key(p))
        return q

    def _compact(self, d):
        live = [s for s, x in enumerate(self.qty[d]) if x != 0]
        n = len(self.qty[d])
        self.qty[d] = [self.qty[d][s] for s in live] + [0] * (n - len(live))
        self.oid[d] = [self.oid[d][s] for s in live] + [0] * (n - len(live))

    def _retotal(self, removed: int):
        """Within int32 the half's total drops by what left it, exactly;
        beyond, it is counted again (the kernel's rare path)."""
        if self.total <= _I32_MAX:
            self.total -= removed
        else:
            self.total = sum(map(sum, self.qty))


def _emu_both(s_a, s_b):
    """book.py::_record's first seven fields from the two halves' stats."""
    return [_i32(x + y) for x, y in zip(s_a[:5], s_b[:5])] + [min(s_a[5], s_b[5]),
                                                              max(s_a[6], s_b[6])]


def _emu_process(bids, asks, kind, side, p, q, o):
    """K5's process on one book's two _EmuHalf: the nine-field record."""
    from gymfx_tpu_torch.lob.book import MSG_ADD, MSG_CANCEL, MSG_MARKET, PRICE_CAP

    kind, is_buy = min(max(kind, 0), 3), side > 0
    is_add = kind == MSG_ADD
    take = q if kind in (MSG_ADD, MSG_MARKET) else 0
    s_a = asks.match(take if is_buy else 0, p if is_add else PRICE_CAP)
    s_b = bids.match(0 if is_buy else take, p if is_add else 0)
    target = o if kind == MSG_CANCEL else 0
    removed = bids.cancel(target) if is_buy else asks.cancel(target)
    q_add = q if is_add else 0
    rested = (bids.rest(p, _i32(q_add - s_a[0]), o) if is_buy
              else asks.rest(p, _i32(q_add - s_b[0]), o))
    return _emu_both(s_a, s_b) + [rested, removed]


def _emu_books(book):
    """Each book of ``book`` as (bids, asks) _EmuHalf pairs."""
    rows = [x.tolist() for x in book]
    return [(_EmuHalf(rows[0][b], rows[1][b], rows[2][b], asks=False),
             _EmuHalf(rows[3][b], rows[4][b], rows[5][b], asks=True)) for b in range(len(rows[0]))]


def _emu_final(halves, book):
    """The final books of (bids, asks) _EmuHalf pairs, shaped as ``book``."""
    from gymfx_tpu_torch.lob.book import BookState

    out = [[] for _ in BookState._fields]
    for bids, asks in halves:
        for i, half in enumerate((bids, asks)):
            out[3 * i].append(half.price)
            out[3 * i + 1].append(half.qty)
            out[3 * i + 2].append(half.oid)
    dev = book.bid_qty.device
    return BookState(*(torch.tensor(x, dtype=torch.int32, device=dev).reshape(t.shape)
                       for x, t in zip(out, book)))


def lob_stream_emulated(book, msgs):
    """K5's algorithm (csrc/lob_kernels.cu) on CPU tensors: (final books,
    (B, M) fill records), to equal ``lob/book.py::process_stream`` on
    books that hold the engine's invariants."""
    from gymfx_tpu_torch.lob.book import FillRecord

    halves = _emu_books(book)
    streams = [x.tolist() for x in msgs]
    records = [[_emu_process(bids, asks, *m) for m in zip(*(s[b] for s in streams))]
               for b, (bids, asks) in enumerate(halves)]
    fills = torch.tensor(records, dtype=torch.int32, device=book.bid_qty.device)
    return _emu_final(halves, book), FillRecord(*fills.reshape(*msgs.kind.shape, 9).unbind(-1))


# ---------------------------------------------------------------------------
# K8: one bar of the LOB venue (ops/lob_bar.py)
# ---------------------------------------------------------------------------
def _emu_walk(bids, asks, is_buy, lots, backstop):
    """K8's walk: book.py::match_market on both halves, the remainder
    priced at the worst level touched, else at ``backstop`` (int32)."""
    from gymfx_tpu_torch.lob.book import PRICE_CAP

    s = _emu_both(asks.match(lots if is_buy else 0, PRICE_CAP), bids.match(0 if is_buy else lots, 0))
    worst = (s[6] if is_buy else s[5]) if s[0] > 0 else backstop
    return _i32(s[1] + (lots - s[0]) * worst)


def lob_bar_emulated(book, flow, orders):
    """K8's algorithm (csrc/lob_kernels.cu lob_bar_kernel) on CPU
    tensors, one book at a time on K5's _EmuHalf model: (final books,
    BarFills), to equal ``ops/lob_bar.run_bar_plain``.  After each cancel
    every level of both halves whose int32 lot sum is <= 0 loses its price,
    as book.py's cancel resets them (a no-op within int32).  A NOOP skips
    process, and a message after which the stop does not fire skips the
    cancel, the resets and the walk, where both halves are within int32."""
    from gymfx_tpu_torch.lob.book import AGENT_OID, MSG_ADD, MSG_NOOP, PRICE_CAP
    from gymfx_tpu_torch.ops.lob_bar import BarFills

    halves = _emu_books(book)
    streams = [x.tolist() for x in flow]
    cols = [x.tolist() for x in orders]
    results = []
    for b, (bids, asks) in enumerate(halves):
        open_lots, open_buy, o_t, pos_lots, exit_buy, sl, tp = (c[b] for c in cols)
        open_value = _emu_walk(bids, asks, open_buy != 0, open_lots, o_t)
        exit_buy = exit_buy != 0
        has_sl, has_tp = sl > 0 and pos_lots > 0, tp > 0 and pos_lots > 0
        gap_sl = has_sl and (o_t >= sl if exit_buy else o_t <= sl)
        gap_lots = pos_lots if gap_sl else 0
        gap_value = _emu_walk(bids, asks, exit_buy, gap_lots, o_t)
        tp_rest = pos_lots if has_tp and not gap_sl else 0
        tp0 = _emu_process(bids, asks, MSG_ADD, 1 if exit_buy else -1, max(tp, 1), tp_rest,
                           AGENT_OID)
        rem = _i32(pos_lots - gap_lots - tp0[0])
        tp_lots, tp_value, sl_lots, sl_value, fired = tp0[0], tp0[1], gap_lots, gap_value, gap_sl
        for m in zip(*(s[b] for s in streams)):
            narrow = bids.total <= _I32_MAX and asks.total <= _I32_MAX
            # a NOOP on two halves within int32 changes nothing
            r = (_emu_process(bids, asks, *m) if min(max(m[0], 0), 3) != MSG_NOOP or not narrow
                 else [0, 0, 0, 0, 0, PRICE_CAP, 0, 0, 0])
            rem, tp_lots, tp_value = _i32(rem - r[3]), _i32(tp_lots + r[3]), _i32(tp_value + r[4])
            printed = r[6] >= sl if exit_buy else r[5] <= sl
            trig = has_sl and not fired and rem > 0 and printed
            if not (trig or bids.total > _I32_MAX or asks.total > _I32_MAX):
                continue  # fire would change nothing
            target, take = (AGENT_OID, rem) if trig else (0, 0)
            if exit_buy:
                bids.cancel(target)
            else:
                asks.cancel(target)
            bids.reset()
            asks.reset()
            xvalue = _emu_walk(bids, asks, exit_buy, take, sl)
            if trig:
                sl_lots, sl_value, rem = _i32(sl_lots + rem), _i32(sl_value + xvalue), 0
            fired = fired or trig
        results.append([open_value, gap_lots, gap_value, tp_lots, tp_value, sl_lots, sl_value,
                        int(fired)])
    out = torch.tensor(results, dtype=torch.int32, device=book.bid_qty.device).reshape(-1, 8)
    return _emu_final(halves, book), BarFills(*out.T.contiguous().unbind(0))


# The K8 cases: each book's orders follow one of LOB_BAR_PATHS (cycled
# over the books) at offsets drawn per book.  "long" / "short" hold 40 lots
# with brackets 1-12 ticks off the open (the flow decides what fills and
# fires); "scripted" paths replace the book's flow by NOOPs and a few
# messages written to force the path: a take-profit partly filled by a
# market order and then pulled by the stop a later print fires
# ("tp_then_stop"), a stop that fires on the last message ("stop_last").
LOB_BAR_PATHS = ("open_buy", "open_sell", "forced", "denied", "gap_long", "gap_short", "long",
                 "short", "tp_then_stop", "stop_last", "no_brackets")


def lob_bar_case(n_books, depth=24, slots=4, n_msgs=64, seed=0, scenario="lob_volatile",
                 device=None):
    """(books, flow, orders, paths) for K8: books seeded at EUR/USD-like
    open ticks (min(8, depth) levels a side, the venue's seed stream through
    K5's plain version), each book's bar flow from ``bar_messages`` under
    ``scenario`` (bar rows 0..n_books-1 of flow seed ``seed``) and its
    orders from LOB_BAR_PATHS; ``paths`` (B,) numpy names each book's path.
    Every tensor int32 on ``device``."""
    from gymfx_tpu_torch.lob import book as book_mod
    from gymfx_tpu_torch.lob.book import MSG_MARKET, MSG_NOOP, Messages
    from gymfx_tpu_torch.lob.flow import bar_key, bar_messages, seed_messages
    from gymfx_tpu_torch.lob.scenarios import scenario_flow_params
    from gymfx_tpu_torch.ops.lob_bar import BarOrders

    rng = np.random.default_rng(seed)
    fp = scenario_flow_params(scenario)
    o = rng.integers(105_000, 115_000, n_books).astype(np.int32)
    c = o + rng.integers(-20, 21, n_books).astype(np.int32)
    h = np.maximum(o, c) + rng.integers(0, 15, n_books).astype(np.int32)
    lo = np.minimum(o, c) - rng.integers(0, 15, n_books).astype(np.int32)
    o_t, h_t, l_t, c_t = (torch.from_numpy(x) for x in (o, h, lo, c))
    book = book_mod.empty_book(n_books, depth, slots)
    book, _ = book_mod.process_stream(book, seed_messages(o_t, min(8, depth), fp))
    rows = torch.arange(n_books, dtype=torch.int32)
    flow = [x.numpy().copy() for x in bar_messages(bar_key(seed, rows), o_t, h_t, l_t, c_t,
                                                       n_msgs, fp)]

    paths = np.array([LOB_BAR_PATHS[i % len(LOB_BAR_PATHS)] for i in range(n_books)])
    cols = np.zeros((7, n_books), np.int64)  # BarOrders' fields
    cols[2] = o
    off = rng.integers(1, 13, (2, n_books))
    for i, path in enumerate(paths):
        lots, sl, tp = 40, 0, 0
        exit_buy = path in ("open_sell", "gap_short", "short") or (path == "no_brackets" and i % 2)
        if path in ("open_buy", "open_sell"):
            cols[0, i], cols[1, i] = 40, not exit_buy
            sl, tp = (o[i] + off[0, i], o[i] - off[1, i]) if exit_buy else (o[i] - off[0, i],
                                                                            o[i] + off[1, i])
        elif path == "forced":  # a sub-lot position closed: one lot walks, the ledger lands flat
            cols[0, i], cols[1, i], lots, exit_buy = 1, i % 2, 0, True
        elif path == "denied":  # the order is below a lot: nothing walks
            lots, exit_buy = 0, True
        elif path in ("gap_long", "gap_short"):
            sl = o[i] + (-off[0, i] if exit_buy else off[0, i])
            tp = o[i] + (-50 if exit_buy else 50)
        elif path in ("long", "short"):
            sl = o[i] + (off[0, i] if exit_buy else -off[0, i])
            tp = o[i] + (-off[1, i] if exit_buy else off[1, i])
        elif path == "tp_then_stop":
            # long: the TP rests at o + 1 behind the seed's 16 lots (given a
            # second slot), a market buy fills 4 of its lots, a market sell
            # prints at o - 2 and fires the stop at o - 1
            sl, tp = o[i] - 1, o[i] + 1
            script = [(MSG_MARKET, 1, 0, 20), (MSG_MARKET, -1, 0, 20)]
        elif path == "stop_last":  # long: only the last message prints through the stop
            sl, tp = o[i] - 3, o[i] + 500
            script = [(MSG_MARKET, -1, 0, 60)]
        cols[3, i], cols[4, i], cols[5, i], cols[6, i] = lots, exit_buy, sl, tp
        if path in ("tp_then_stop", "stop_last"):
            flow[0][i], flow[3][i] = MSG_NOOP, 1
            at = n_msgs - len(script) if path == "stop_last" else n_msgs // 2
            for k, (kind, side, price, qty) in enumerate(script):
                flow[0][i, at + k], flow[1][i, at + k] = kind, side
                flow[2][i, at + k], flow[3][i, at + k] = price, qty
    to = (lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int32, device=device))
    return (book_mod.BookState(*(x.to(device) for x in book)), Messages(*map(to, flow)),
            BarOrders(*map(to, cols)), paths)


def lob_bar_paths(book, flow, orders, fills, paths):
    """{path: whether it did what it was built for} for a
    :func:`lob_bar_case` bar and its results ``fills``.  The flow decides
    the free-running brackets ("long" and "short", judged together); a
    take-profit rests in a seeded book only where it has room (a second
    slot, or levels beyond the 8 seeded), and "tp_then_stop"'s slot behind
    the seed's needs a second slot.  "stop_last" reruns the plain version
    without the last message, where the stop must not fire."""
    from gymfx_tpu_torch.lob.book import Messages
    from gymfx_tpu_torch.ops.lob_bar import run_bar_plain

    f = {k: v.cpu().numpy() for k, v in fills._asdict().items()}
    o = {k: v.cpu().numpy() for k, v in orders._asdict().items()}
    depth, slots = book.bid_qty.shape[1:]

    def on(path):
        return paths == path

    def every(x):
        return bool(np.all(x))

    walked = o["open_lots"] > 0
    free = on("long") | on("short")
    free_ok = bool((f["fired"][free] == 1).any()) and (
        slots == 1 and depth <= 8 or bool((f["tp_lots"][free] > 0).any()))
    scripted, last, none = on("tp_then_stop"), on("stop_last"), on("no_brackets")
    _, cut = run_bar_plain(book, Messages(*(x[:, :-1].contiguous() for x in flow)), orders)
    gap = {path: every(f["gap_lots"][on(path)] == 40) and every(f["fired"][on(path)] == 1)
           for path in ("gap_long", "gap_short")}
    return {
        "open_buy": bool((walked & (o["open_buy"] == 1) & on("open_buy")).any())
        and every(f["open_value"][on("open_buy")] > 0),
        "open_sell": bool((walked & (o["open_buy"] == 0) & on("open_sell")).any())
        and every(f["open_value"][on("open_sell")] > 0),
        "forced": every(((o["open_lots"] == 1) & (o["pos_lots"] == 0))[on("forced")]),
        "denied": every(f["open_value"][on("denied")] == 0),
        **gap,
        "long": free_ok,
        "short": free_ok,
        "tp_then_stop": every(f["fired"][scripted] == 1) and (
            slots == 1 or every(f["tp_lots"][scripted] == 4)
            and every(f["sl_lots"][scripted] == 36)),
        "stop_last": every(f["fired"][last] == 1) and every(f["sl_lots"][last] == 40)
        and every(cut.fired.cpu().numpy()[last] == 0),
        "no_brackets": every(f["tp_lots"][none] == 0) and every(f["sl_lots"][none] == 0)
        and every(f["fired"][none] == 0),
    }


def lob_bar_wrap_case(n_books, n_msgs, depth, slots, seed=0, device=None):
    """(books, flow, orders) for K8 where lot sums wrap int32: books built
    from lob_wrap_streams (through K5's plain version), a flow of the same
    kind, and orders of 0 to 2^31 - 1 lots, either side, with brackets
    among the streams' 97-103 ticks."""
    from gymfx_tpu_torch.lob import book as book_mod
    from gymfx_tpu_torch.ops.lob_bar import BarOrders

    book = book_mod.empty_book(n_books, depth, slots)
    book, _ = book_mod.process_stream(book, lob_wrap_streams(n_books, 24, seed=seed))
    flow = lob_wrap_streams(n_books, n_msgs, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    lots = np.array([0, 1, 5, 40, 1 << 29, 1 << 30, (1 << 31) - 1])
    ticks = rng.integers(96, 105, (3, n_books))
    cols = np.stack([rng.choice(lots, n_books), rng.integers(0, 2, n_books), ticks[0],
                     rng.choice(lots, n_books), rng.integers(0, 2, n_books),
                     np.where(rng.random(n_books) < 0.8, ticks[1], 0),
                     np.where(rng.random(n_books) < 0.8, ticks[2], 0)])
    to = (lambda x: torch.as_tensor(x, dtype=torch.int32, device=device).contiguous())
    return (book_mod.BookState(*(x.to(device) for x in book)),
            type(flow)(*(x.to(device) for x in flow)), BarOrders(*map(to, cols)))


# ---------------------------------------------------------------------------
# K9: one bar's flow messages (ops/lob_flow.py)
# ---------------------------------------------------------------------------
# K9's algorithm on the card (csrc/flow_kernels.cu bar_flow_kernel), in
# numpy uint32 and float32: a model of its lanes.  One warp an env; the
# arrays below are (N, 32), one column a lane.  Nothing on a path calls it:
# the CPU tests hold it to the plain version, so the kernel's key sharing,
# its lane-to-message map and its float path are checked where there is
# no nvcc.
FLOW_LANES = 32
# a scenario's flow with one message kind alone: FlowParams overrides
FLOW_ONE_KIND = {
    "noop": dict(p_noop=1.0, p_add=0.0, p_cancel=0.0),
    "add": dict(p_noop=0.0, p_add=1.0, p_cancel=0.0),
    "cancel": dict(p_noop=0.0, p_add=0.0, p_cancel=1.0),
    "market": dict(p_noop=0.0, p_add=0.0, p_cancel=0.0),
}
_FLOW_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def lob_flow_bars(n: int, rows: str = "int32", seed: int = 0, device=None):
    """(t, o, h, l, c): ``n`` envs' bar rows and EUR/USD-like OHLC ticks
    for K9, (N,) each.  ``rows`` "int32": int32 rows over the whole range
    (0, 1 and 2^31 - 1 among them, negative ones too); "int64": int64 rows
    from 2^31 up (2^31 and 2^32 among them), whose low 32 bits key the
    flow."""
    rng = np.random.default_rng(seed)
    o = rng.integers(105_000, 115_000, n).astype(np.int32)
    c = (o + rng.integers(-40, 41, n)).astype(np.int32)
    h = (np.maximum(o, c) + rng.integers(0, 20, n)).astype(np.int32)
    lo = (np.minimum(o, c) - rng.integers(0, 20, n)).astype(np.int32)
    if rows == "int32":
        t = rng.integers(-(2 ** 31), 2 ** 31, n).astype(np.int32)
        t[:3] = (0, 1, 2 ** 31 - 1)[:n]
    else:
        t = rng.integers(2 ** 31, 2 ** 40, n).astype(np.int64)
        t[:2] = (2 ** 31, 2 ** 32)[:n]
    return tuple(torch.from_numpy(x).to(device) for x in (t, o, h, lo, c))


def _threefry_u32(k0, k1, x1):
    """bar_flow_kernel's threefry: the block of the count (0, x1) under
    the key (k0, k1), broadcast numpy uint32 arrays."""
    k0, k1, x1 = (np.asarray(x, np.uint32) for x in (k0, k1, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    a, b = np.broadcast_arrays(k0, x1 + k1)
    a, b = a.copy(), b.copy()
    for i in range(5):
        for r in _FLOW_ROTATIONS[i % 2]:
            a = a + b
            b = ((b << np.uint32(r)) | (b >> np.uint32(32 - r))) ^ a
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def _shfl(words, src):
    """__shfl_sync of a (k0, k1) pair of (N, 32) words: each lane reads
    lane ``src`` (one lane for all, or a (32,) lane index a lane)."""
    src = np.broadcast_to(src, (FLOW_LANES,))
    return tuple(w[:, src] for w in words)


def bar_flow_emulated(flow_seed, t_global, o_t, h_t, l_t, c_t, n_msgs: int, fp):
    """K9's algorithm on CPU tensors: (N, ``n_msgs``) int32 Messages, to
    equal ``ops/lob_flow.bar_flow_plain``.  The kernel's constants come
    from ``ops/lob_flow.flow_constants``, as the wrapper passes them."""
    from gymfx_tpu_torch.lob.book import PRICE_CAP, Messages
    from gymfx_tpu_torch.lob.flow import QTY_CAP
    from gymfx_tpu_torch.ops.lob_flow import flow_constants

    words = np.array(flow_constants(fp, flow_seed), np.int32)
    seed = words[0].view(np.uint32)
    thr = words[1:4].view(np.float32)
    span, mult = words[4:7].view(np.uint32), words[7:10].view(np.uint32)
    lo = words[10:13]
    base_qty, market_qty, crash_at, crash_len, crash_qty = (int(x) for x in words[13:18])
    t = t_global.numpy().astype(np.int64).astype(np.uint32)  # the low 32-bit word
    o, h, l, c = (x.numpy().astype(np.int32)[:, None] for x in (o_t, h_t, l_t, c_t))
    n = t.shape[0]
    lane = np.arange(FLOW_LANES)
    j = np.minimum(lane, 5)

    # the keys: every lane the fold_in, lane j < 6 split key j, then half j % 2
    # of split key 2 + j / 2 shuffled from its lane
    key = _threefry_u32(np.uint32(0), seed, t[:, None] + np.zeros(FLOW_LANES, np.uint32))
    split = _threefry_u32(key[0], key[1], j.astype(np.uint32))
    parent = _shfl(split, 2 + j // 2)
    half = _threefry_u32(parent[0], parent[1], (j & 1).astype(np.uint32))
    k_kind, k_side, k_cxl = (_shfl(split, s) for s in (0, 1, 5))
    k_jit, k_qty, k_band = ((_shfl(half, 2 * d), _shfl(half, 2 * d + 1)) for d in range(3))

    def draw(k, i):
        y = _threefry_u32(k[0], k[1], np.uint32(i))
        return y[0] ^ y[1]

    def uniform(bits):
        return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)

    def randint(halves, i, d):
        offset = (draw(halves[0], i) % span[d]) * mult[d] + draw(halves[1], i) % span[d]
        return (lo[d].view(np.uint32) + offset % span[d]).view(np.int32)

    def clamp_tick(x):
        return np.minimum(np.maximum(x, 1), PRICE_CAP - 1)

    f32 = np.float32
    bull = c >= o
    of, cf = o.astype(f32), c.astype(f32)
    w0, w1 = np.where(bull, l, h).astype(f32), np.where(bull, h, l).astype(f32)
    d0, d1, d2 = w0 - of, w1 - w0, cf - w1
    div = n_msgs - 1
    out = np.zeros((5, n, n_msgs), np.int32)
    for ln in range(FLOW_LANES):  # lane ln draws messages ln, ln + 32, ...
        for i in range(ln, n_msgs, FLOW_LANES):
            tt = f32(0)
            if div > 0:
                step = f32(i) / f32(div)
                tt = f32(0) * (f32(1) - step) + f32(3) * step if i < div else f32(3)
            seg0 = of + d0 * np.clip(tt, f32(0), f32(1))
            seg1 = w0 + d1 * np.clip(tt - f32(1), f32(0), f32(1))
            seg2 = w1 + d2 * np.clip(tt - f32(2), f32(0), f32(1))
            seg = seg0 if tt <= 1 else (seg1 if tt <= 2 else seg2)
            path = clamp_tick(np.rint(seg).astype(np.int32))
            def key_at(k, ln=ln):  # this lane's copy of a broadcast key
                return tuple(w[:, ln] for w in k)

            jitter = randint([key_at(k) for k in k_jit], i, 0)[:, None]
            mid = clamp_tick(np.minimum(np.maximum(path + jitter, l), h))
            u_kind = uniform(draw(key_at(k_kind), i))[:, None]
            kind = np.where(u_kind < thr[0], 0, np.where(u_kind < thr[1], 1,
                                                         np.where(u_kind < thr[2], 2, 3)))
            side = np.where(uniform(draw(key_at(k_side), i))[:, None] < f32(0.5), 1, -1)
            band = 1 + randint([key_at(k) for k in k_band], i, 2)[:, None]
            add_price = clamp_tick(mid - side * band)
            qty = np.where(kind == 3, market_qty, base_qty) + randint(
                [key_at(k) for k in k_qty], i, 1)[:, None]
            u_cxl = uniform(draw(key_at(k_cxl), i))[:, None]
            cxl = np.minimum(1 + np.floor(u_cxl * f32(max(i, 1))).astype(np.int32), i)
            oid = np.where(kind == 2, cxl, 1 + i)
            if crash_at >= 0 and crash_at <= i < crash_at + crash_len:
                kind, side = np.full_like(kind, 3), np.full_like(side, -1)
                qty = np.full_like(qty, crash_qty)
            qty = np.minimum(np.maximum(qty, 1), QTY_CAP)
            price = np.where(kind == 1, add_price, mid)
            for s, col in enumerate((kind, side, price, qty, oid)):
                out[s, :, i] = col[:, 0]
    dev = o_t.device
    return Messages(*(torch.from_numpy(x).to(dev) for x in out))

# ---------------------------------------------------------------------------
# K6: q16 tape decode blocks; K7: batched scaled windows
# ---------------------------------------------------------------------------
Q16_INVS = (1.0, 60.0, 1440.0, float(np.float32(1e5)))


def q16_case(seed=0, rows=1003, invs=Q16_INVS):
    """(delta (C, rows) int16, base (C,) int32, inv (C,) f32) with the
    int16 extremes in every column."""
    rng = np.random.default_rng(seed)
    c = len(invs)
    delta = rng.integers(-32768, 32768, (c, rows)).astype(np.int16)
    delta[:, 0], delta[:, -1] = -32768, 32767
    base = rng.integers(-2**20, 2**20, c).astype(np.int32)
    base[-1] = 110_000  # an EUR/USD-like price in ticks
    return delta, base, np.asarray(invs, np.float32)


# K7's step patterns: "random" (steps drawn in [0, n], with 0 and n);
# "export" (1..n, the export's: every tile's window starts run
# consecutively but the last tile's is ragged); "clamped" (consecutive
# runs across both ends of the clamp, then steps drawn in [-50, n + 50])
K7_STEP_PATTERNS = ("random", "export", "clamped")


def scaled_windows_case(seed=0, n=300, window=8, f=3, batch=64, steps="random"):
    """(padded_features (n + W, F), mean (n + 1, F), std, neutral (n + 1,),
    steps (B,)) for K7, with NaN / +-inf features, zero stds, neutral
    rows and, by ``steps`` (:data:`K7_STEP_PATTERNS`), B = ``batch``
    steps with 0 and n, the export's steps 1..n (B = n), or steps
    clamped below 0 and above n (B = 170 + ``batch``)."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 3, (n + window, f)).astype(np.float32)
    feats[5, 0], feats[6, 1 % f], feats[7, 2 % f] = np.nan, np.inf, -np.inf
    feats[9, 1 % f] = 1e30
    mean = rng.normal(0, 1, (n + 1, f)).astype(np.float32)
    std = (rng.random((n + 1, f)) + 0.1).astype(np.float32)
    std[3, 0] = 0.0
    neutral = rng.random(n + 1) < 0.2
    neutral[:2] = True
    neutral[3:5] = False  # steps 3 and 4 scale the NaN / inf rows
    if steps == "random":
        drawn = rng.integers(0, n + 1, batch).astype(np.int32)
        drawn[:5] = (0, n, 1, 4, 3)
    elif steps == "export":
        drawn = np.arange(1, n + 1, dtype=np.int32)
    elif steps == "clamped":
        drawn = np.concatenate([np.arange(-70, 10), np.arange(n - 70, n + 20),
                                rng.integers(-50, n + 51, batch)]).astype(np.int32)
    else:
        raise ValueError(f"scaled_windows_case: steps {steps!r}")
    return feats, mean, std, neutral, drawn


def scaled_windows_turn_steps(n, tile, grid, seed=0):
    """The export's steps 1..n with the tiles of every odd turn of a K7
    launch (``tile`` entries a tile, tile k CTA k % ``grid``'s
    (k // grid)-th) scattered in [-50, n + 50]: each CTA walks a staged
    tile, then one that reads device memory, then a staged one again."""
    rng = np.random.default_rng(seed)
    steps = np.arange(1, n + 1, dtype=np.int32)
    odd = (np.arange(n) // tile // grid) % 2 == 1
    steps[odd] = rng.integers(-50, n + 51, int(odd.sum()))
    return steps


def scaled_windows_tiling(steps, rows, m, w, f, tile, grid, threads, span_floats, in_offset=0):
    """A CPU model of K7's tiling (csrc/data_kernels.cu
    scaled_windows_kernel) for a batch ``steps`` over ``rows`` feature
    rows and ``m`` moment rows: tile k (entries k * tile ..) belongs to
    CTA k % grid as its (k // grid)-th; its steps' window starts and
    moment rows clamp as XLA's; when the starts run consecutively (and
    ``span_floats`` > 0) the tile stages its window span, from a source
    ``in_offset`` floats past a 16-byte boundary.  Thread q % threads
    takes quad q of the tile's output; the quad's step comes by the
    kernel's magic numbers, its first feature by a modulus (F = 5) or
    magic numbers, the next three by a wrapping increment.

    Returns int64 arrays, one entry per element covered: ``index`` (the
    output element, row-major), ``quad`` and ``lane`` (the float4 of the
    output that stores it, and its place there), ``step`` (its batch
    entry), ``feature``,
    ``src`` (the padded_features element it scales, flat), ``moment``
    (the flat (mean, std) element), ``flag`` (the neutral row), ``cta``,
    ``thread``, ``turn`` (the tile's place in its CTA's walk) and
    ``span`` (its place in the staged spans, tile k's span at k *
    span_floats, or -1 where the tile reads device memory); and, for the
    staged copies, ``copy_dst`` / ``copy_src`` (each float copied: its
    place in the spans and in padded_features, flat) with ``copy_bytes``
    (4 or 16: the size of the cp.async that moves it)."""
    from gymfx_tpu_torch.ops.window_zscore import K7_TEMPLATE_F, magic, magic_div

    steps = np.asarray(steps, np.int64)
    b = steps.size
    fq = w * f // 4
    div_fq, div_f = magic(fq), magic(f)
    start = np.clip(steps, 0, rows - w)
    row = np.clip(steps, 0, m - 1)
    keys = ("index", "step", "feature", "src", "moment", "flag", "cta", "thread", "turn", "span",
            "quad", "lane")
    out = {k: [] for k in keys + ("copy_dst", "copy_src", "copy_bytes")}
    for tl in range(-(-b // tile)):
        b0 = tl * tile
        tv = min(tile, b - b0)
        s0 = start[b0]
        staged = span_floats > 0 and bool((start[b0:b0 + tv] == s0 + np.arange(tv)).all())
        lead = (in_offset + s0 * f) % 4 if staged else 0
        if staged:
            length = (tv + w - 1) * f
            head = min((4 - lead) % 4, length)
            quads = (length - head) // 4
            k = np.arange(length, dtype=np.int64)
            out["copy_dst"].append(tl * span_floats + lead + k)
            out["copy_src"].append(s0 * f + k)
            out["copy_bytes"].append(np.where((k >= head) & (k < head + 4 * quads), 16, 4))
        q = np.arange(tv * fq, dtype=np.int64)
        t = magic_div(q, *div_fq)
        e0 = (q - t * fq) * 4
        feat = e0 % K7_TEMPLATE_F if f == K7_TEMPLATE_F else e0 - magic_div(e0, *div_f) * f
        for k in range(4):
            e = e0 + k
            out["index"].append((b0 + t) * w * f + e)
            out["step"].append(b0 + t)
            out["feature"].append(feat)
            out["moment"].append(row[b0 + t] * f + feat)
            out["flag"].append(row[b0 + t])
            out["src"].append((s0 + t) * f + e if staged else start[b0 + t] * f + e)
            out["span"].append(tl * span_floats + lead + t * f + e if staged
                               else np.full(q.size, -1, np.int64))
            out["cta"].append(np.full(q.size, tl % grid, np.int64))
            out["turn"].append(np.full(q.size, tl // grid, np.int64))
            out["thread"].append(q % threads)
            out["quad"].append(b0 * fq + q)
            out["lane"].append(np.full(q.size, k, np.int64))
            feat = np.where(feat + 1 == f, 0, feat + 1)
    return {k: np.concatenate(v).astype(np.int64) if v else np.zeros(0, np.int64)
            for k, v in out.items()}


def scaled_windows_emulated(feats, mean, std, neutral, clip, tiling, b, w, span_floats):
    """K7's arithmetic in numpy f32 over ``tiling``
    (:func:`scaled_windows_tiling` of a batch of ``b`` steps): staged
    tiles read their windows from the spans the model's copies fill
    (every other float of a span NaN), the others from padded_features;
    each element z-scored by the (mean, std) pair and neutral flag the
    tiling derives for it, then clipped when clip > 0."""
    n_f = feats.shape[1]
    flat = feats.reshape(-1)
    tiles = int(tiling["span"].max()) // span_floats + 1 if (tiling["span"] >= 0).any() else 0
    spans = np.full(max(tiles * span_floats, 1), np.nan, np.float32)
    spans[tiling["copy_dst"]] = flat[tiling["copy_src"]]
    x = np.where(tiling["span"] >= 0, spans[np.maximum(tiling["span"], 0)], flat[tiling["src"]])
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (x - mean.reshape(-1)[tiling["moment"]]) / std.reshape(-1)[tiling["moment"]]
    v = np.where(neutral[tiling["flag"]], np.float32(0), z)
    if clip > 0:
        v = np.where(np.isnan(v), v, np.minimum(np.maximum(v, np.float32(-clip)), np.float32(clip)))
    out = np.full(b * w * n_f, np.nan, np.float32)
    out[tiling["index"]] = v.astype(np.float32)
    return out.reshape(b, w, n_f)


def tick_walk_columns(n, seed=0, level=1.1, vol_ticks=5.0, tick=1e-5):
    """OHLCV float64 columns of a random walk in whole ticks (every price
    on the ``tick`` grid): closes step by N(0, vol_ticks) ticks, opens are
    the previous close, wicks reach 0-3 ticks beyond the body, volumes are
    whole units."""
    rng = np.random.default_rng(seed)
    close = int(round(level / tick)) + np.cumsum(np.rint(rng.normal(0, vol_ticks, n))).astype(np.int64)
    open_ = np.concatenate([close[:1], close[:-1]])
    high = np.maximum(open_, close) + rng.integers(0, 4, n)
    low = np.minimum(open_, close) - rng.integers(0, 4, n)
    cols = {k: v * tick for k, v in
            (("OPEN", open_), ("HIGH", high), ("LOW", low), ("CLOSE", close))}
    cols = {k: np.round(v, 5) for k, v in cols.items()}
    cols["VOLUME"] = rng.integers(1, 500, n).astype(np.float64)
    return cols


def m1_week_grid(n, start="2024-01-01T00:00"):
    """``n`` M1 timestamps (datetime64[m]) on an FX trading week's grid:
    every minute Monday to Friday UTC, from Monday ``start``."""
    weeks = n // 7200 + 1
    minutes = np.arange(np.datetime64(start, "m"), np.datetime64(start, "m")
                        + np.timedelta64(weeks * 7 * 1440, "m"))
    weekday = (minutes.astype("datetime64[D]").astype(np.int64) - 4) % 7  # 0 = Monday
    return minutes[weekday < 5][:n]


def write_bar_csv(path, columns, timestamps) -> None:
    """A DATE_TIME,OPEN,HIGH,LOW,CLOSE,VOLUME file, prices with 5 decimals."""
    stamps = np.datetime_as_string(timestamps, unit="s")
    o, h, l, c, v = (columns[k] for k in ("OPEN", "HIGH", "LOW", "CLOSE", "VOLUME"))
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("DATE_TIME,OPEN,HIGH,LOW,CLOSE,VOLUME\n")
        fh.writelines(f"{t},{a:.5f},{b:.5f},{d:.5f},{e:.5f},{int(x)}\n"
                      for t, a, b, d, e, x in zip(stamps, o, h, l, c, v))


# ---------------------------------------------------------------------------
# K4: bf16 attention cases and the tensor-core kernels' arithmetic
# ---------------------------------------------------------------------------
# (B, S, H, D), causal: the bf16 cases of the card tests and of
# chip_smoke.py's kernel phase (the CPU tests run them at B <= 2): the
# policies' width, a 1024 window, the smallest head dim, a ragged window
# at the widest head dim, head dims the wrapper pads (24 -> 32, 40 -> 48,
# 72 -> 80), so that every head dim the kernel library instantiates (16,
# 32, ..., 128) runs, and a non-causal window of eight key tiles
ATTENTION_BF16_CASES = [
    ((64, 256, 4, 32), False),
    ((2, 1024, 2, 64), True),
    ((5, 50, 2, 16), True),
    ((4, 77, 3, 128), False),
    ((3, 40, 2, 24), True),
    ((3, 100, 2, 40), False),
    ((2, 130, 2, 72), True),
    ((2, 200, 3, 96), False),
    ((3, 65, 2, 112), True),
    ((4, 512, 2, 32), False),
]
ATTENTION_TILE = 64  # keys per online-softmax step of the forward kernel
_LOG2E = 1.4426950408889634


def _log2_scores(q, k, causal, scale):
    """(B, H, S, S) f32 scores in the kernels' log2 domain: q·k (f32 sums
    of exact bf16 products) times scale·log2 e rounded to f32 once, as
    the wrapper passes it; ``-inf`` above the diagonal when causal."""
    qf, kf = (x.to(torch.float32) for x in (q, k))
    sl2 = torch.tensor(scale * _LOG2E, dtype=torch.float32)
    x = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sl2
    if causal:
        s = x.shape[-1]
        keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        x = torch.where(keep, x, -math.inf)
    return x


def _bf16_round(x):
    return x.to(torch.bfloat16).to(torch.float32)


def attention_forward_emulated(q, k, v, causal=False, scale=None):
    """The tensor-core forward (``attn_fwd_tc``) in plain torch: per
    64-key tile, the running max m, p = exp2(x - m) in f32 summed into l,
    O rescaled by exp2(m_old - m_new) plus bf16(p)·V (f32 sums), then O / l
    rounded to q's dtype.  Only the order of the f32 sums differs from
    the kernel.  ``scale`` defaults to 1/√D."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    x = _log2_scores(q, k, causal, scale)
    vf = v.to(torch.float32)
    m = torch.full(x.shape[:-1], -math.inf, device=x.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, s, d), device=x.device)
    for k0 in range(0, s, ATTENTION_TILE):
        xt = x[..., k0:k0 + ATTENTION_TILE]
        mx = torch.maximum(m, xt.amax(dim=-1))
        mu = torch.where(mx == -math.inf, torch.zeros_like(mx), mx)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(xt - mu[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", _bf16_round(p), vf[:, k0:k0 + ATTENTION_TILE])
        acc = acc * alpha[..., None] + pv
        m = mx
    return (acc / l[..., None]).transpose(1, 2).to(q.dtype)


def attention_backward_emulated(q, k, v, g, causal=False, scale=None):
    """The tensor-core backward (``attn_bwd_dq_tc`` + ``attn_bwd_dkdv_tc``)
    in plain torch: m, l = sum exp2(x - m), delta = sum exp2(x - m)·dP / l
    and lse = m + log2 l in f32; p = exp2(x - lse) (P normalised first);
    dS = p (dP - delta) scale in f32; dV = bf16(p)ᵀ dO, dQ = bf16(dS) K,
    dK = bf16(dS)ᵀ Q with f32 sums; each rounded to q's dtype once."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf, kf, vf, gf = (t.to(torch.float32) for t in (q, k, v, g))
    x = _log2_scores(q, k, causal, scale)
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp2(x - m)
    l = e.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (e * dp).sum(dim=-1, keepdim=True) / l
    del e
    p = torch.exp2(x - (m + torch.log2(l)))
    del x
    ds = _bf16_round(p * (dp - delta) * scale)
    del dp
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16_round(p), gf)
    del p
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
