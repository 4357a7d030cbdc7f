"""Seeded inputs for the env kernels K1-K3, drawn with numpy.

One source of cases for everything that holds a kernel to its plain
version or to the JAX package: chip_smoke.py on the card, and the tests
(tests/test_torch_kernels.py on the CPU, tests/test_torch_cuda.py on the
card).  K1 gets windows with NaN, ±inf, 1e30, 0/0 and neutral envs; K2
and K3 get open, flat, flipping and (with ``big``) huge ledgers, pending
and forced orders, brackets at, inside and across the bar, and -inf
reward peaks, over the grid of K2's static flags.
"""
from __future__ import annotations

import itertools

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
PARAM_SETS = {
    "plain": dict(slippage=1e-4, commission=2e-5, price_tick=0.0, size_step=0.0, min_qty=0.0),
    "quantized": dict(slippage=2e-4, commission=3e-5, price_tick=1e-5, size_step=0.01, min_qty=0.5),
}
MARK_PARAMS = dict(initial_cash=10000.0, reward_scale=2.0, penalty_lambda=0.5)
_INT_PARAMS = ("entry_start_mow", "force_close_mow")


def obs_case(seed=0, n=64, w=8, f=3):
    """(win, mean, std, neutral) arrays for K1."""
    rng = np.random.default_rng(seed)
    win = rng.normal(0, 3, (n, w, f)).astype(np.float32)
    win[0, 0, 0] = np.nan
    win[1, 2, 1] = np.inf
    win[2, 3, 2] = -np.inf
    win[3, 1, 1] = 1e30
    mean = rng.normal(0, 1, (n, f)).astype(np.float32)
    std = (rng.random((n, f)) + 0.1).astype(np.float32)
    std[4, 0] = 0.0  # 0/0 and x/0
    win[4, :2, 0] = mean[4, 0]
    neutral = rng.random(n) < 0.2
    neutral[0] = True
    return win, mean, std, neutral


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
