"""The port's episode metrics (gymfx_tpu_torch/metrics.py) against the JAX
package's (gymfx_tpu/metrics.py) on the same inputs.

Seeded equity series with trade statistics, with timestamps that cross
calendar days (so the Sharpe analyzer groups by day), NaT timestamps
among them (pandas reads NaT as the int64 minimum, the port's numpy day
floor as well), a run that terminates early, no timestamps at all, and
the degenerate series (one step, a flat curve).  Every analyzer and
every summary key must be equal: both compute in float64 numpy in the
same order, so the tolerance is 0.
"""
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from gymfx_tpu import metrics as jax_metrics
from gymfx_tpu_torch import metrics


def _state(seed):
    rng = np.random.default_rng(seed)
    total = int(rng.integers(0, 30))
    won = int(rng.integers(0, total + 1))
    pnl = rng.normal(0.0, 5.0, total)
    return SimpleNamespace(
        trade_count=np.int32(total), trades_won=np.int32(won), trades_lost=np.int32(total - won),
        trade_pnl_sum=np.float32(pnl.sum()), trade_pnl_sumsq=np.float32((pnl ** 2).sum()),
        max_drawdown_pct=np.float32(rng.uniform(0, 20)),
        max_drawdown_money=np.float32(rng.uniform(0, 500)),
    )


def _case(kind, seed):
    rng = np.random.default_rng(seed)
    n = 3000
    equity = 10000.0 * np.exp(np.cumsum(rng.normal(0, 1e-3, n)))
    done = np.zeros(n, bool)
    # M1 bars from a Sunday evening: ~2 days of bars, the day boundary
    # crossed at midnight (and before the epoch in one case)
    start = np.datetime64("1969-12-30T22:00" if kind == "pre_epoch" else "2024-03-03T21:00", "us")
    ts = start + np.arange(n + 1) * np.timedelta64(60, "s")
    if kind == "nat":
        ts[rng.choice(n, 200, replace=False)] = np.datetime64("NaT")
        ts[1500:1600] = np.datetime64("NaT")
    elif kind == "all_nat":
        ts[:] = np.datetime64("NaT")
    elif kind == "done":
        done[1234:] = True
    elif kind == "none":
        ts = None
    elif kind == "one_step":
        equity, done, ts = equity[:1], done[:1], ts[:2]
    elif kind == "flat":
        equity = np.full(n, 10000.0)
    return equity, done, ts


KINDS = ["days", "pre_epoch", "nat", "all_nat", "done", "none", "one_step", "flat"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_analyzers_and_summaries_equal_the_jax_package(kind, seed):
    equity, done, ts = _case(kind, seed)
    state = _state(seed)
    # the JAX package takes the pandas Series the env keeps, from bar 1 on
    jax_ts = None if ts is None else pd.Series(ts[1:])
    ref = jax_metrics.compute_analyzers(equity=equity, done=done, state=state, timestamps=jax_ts)
    ours = metrics.compute_analyzers(equity=equity, done=done, state=state,
                                     timestamps=None if ts is None else ts[1:])
    assert ours == ref
    if kind in ("days", "nat"):
        assert len(ref["time_return"]) >= 2 and ref["sharpe"]["sharperatio"] is not None
    config = {"risk_lambda": 0.5, "evaluation_years": 2.0}
    for name in ("summarize_default", "summarize_trading"):
        kw = dict(initial_cash=10000.0, final_equity=float(equity[-1]), analyzers=ours,
                  config=config)
        assert getattr(metrics, name)(**kw) == getattr(jax_metrics, name)(**kw)


def test_nat_rows_group_as_pandas_groups_them():
    # NaT between two days: pandas normalises NaT to the int64 minimum, so
    # the run of NaT rows is a "day" of its own on both sides
    ts = np.array(["2024-01-01T10:00", "NaT", "NaT", "2024-01-01T11:00", "2024-01-02T00:00"],
                  dtype="datetime64[us]")
    equity = np.array([100.0, 101.0, 102.0, 103.0, 104.0])
    ours = metrics._periodic_returns(equity, ts)
    ref = jax_metrics._periodic_returns(equity, pd.Series(ts))
    np.testing.assert_array_equal(ours, ref)
    assert ours.size == 3
