"""Episode metrics: analyzer equivalents + summary plugins.

The port's copy of ``gymfx_tpu/metrics.py`` (:24-206) in numpy alone:
the Sharpe analyzer's calendar-day grouping floors ``datetime64``
timestamps to days where the JAX package normalises them with pandas;
both read a NaT as the int64 minimum, so a run of NaT rows is one "day"
of its own.

Replaces the five backtrader analyzers the reference wires into cerebro
(TradeAnalyzer, SharpeRatio(Days), DrawDown, SQN, TimeReturn —
reference app/bt_bridge.py:277-281) with host-side computation over the
scanned equity stream and the trade statistics carried in ``EnvState``.
The summarize functions reproduce the reference metric plugins key for
key (reference metrics_plugins/default_metrics.py:22-60,
trading_metrics.py:24-62).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np

# backtrader SharpeRatio defaults: riskfreerate=0.01 (annual),
# timeframe=Days, factor=252, annualize=False, convertrate=True.
_SHARPE_ANNUAL_RF = 0.01
_SHARPE_FACTOR = 252.0


def compute_analyzers(
    *,
    equity: np.ndarray,
    done: Optional[np.ndarray],
    state,
    timestamps=None,
) -> Dict[str, Any]:
    """Build backtrader-shaped analyzer dicts from rollout outputs.

    ``equity`` is the per-step equity curve (f64), ``done`` the per-step
    termination flags; post-termination steps are excluded.  ``state``
    is the final EnvState (trade statistics, drawdown extrema).
    ``timestamps`` (optional, aligned with bars) drives the daily
    grouping of the Sharpe analyzer; without it, each step counts as
    one return sample.
    """
    equity = np.asarray(equity, dtype=np.float64)
    if done is not None:
        done = np.asarray(done, dtype=bool)
        if done.any():
            equity = equity[: int(np.argmax(done)) + 1]

    # --- trades (reference TradeAnalyzer surface) ----------------------
    total = int(state.trade_count)
    won = int(state.trades_won)
    lost = int(state.trades_lost)
    pnl_sum = float(state.trade_pnl_sum)
    avg = pnl_sum / total if total else None
    trades = {
        "total": {"total": total},
        "won": {"total": won},
        "lost": {"total": lost},
        "pnl": {"net": {"average": avg, "total": pnl_sum}},
    }

    # --- sharpe (daily returns, rf-adjusted, ddof=1, not annualized) ---
    returns = _periodic_returns(equity, timestamps)
    sharpe = None
    if returns.size >= 2:
        daily_rf = (1.0 + _SHARPE_ANNUAL_RF) ** (1.0 / _SHARPE_FACTOR) - 1.0
        excess = returns - daily_rf
        std = excess.std(ddof=1)
        if std > 0:
            sharpe = float(excess.mean() / std)

    # --- drawdown ------------------------------------------------------
    drawdown = {
        "max": {
            "drawdown": float(state.max_drawdown_pct),
            "moneydown": float(state.max_drawdown_money),
        }
    }

    # --- SQN (sqrt(n) * mean(trade pnl) / std(trade pnl), ddof=1) ------
    sqn = None
    if total >= 2:
        mean = pnl_sum / total
        var = (float(state.trade_pnl_sumsq) - total * mean**2) / (total - 1)
        std = math.sqrt(max(var, 0.0))
        if std > 0:
            sqn = float(math.sqrt(total) * mean / std)

    # --- time_return (per-period returns keyed by period index) --------
    time_return = {int(i): float(r) for i, r in enumerate(returns)}

    return {
        "trades": trades,
        "sharpe": {"sharperatio": sharpe},
        "drawdown": drawdown,
        "sqn": {"sqn": sqn},
        "time_return": time_return,
    }


def _periodic_returns(equity: np.ndarray, timestamps) -> np.ndarray:
    """Equity -> per-day returns when timestamps are supplied, else
    per-step returns (reference analyzer runs on the Days timeframe)."""
    if equity.size < 2:
        return np.empty(0)
    if timestamps is not None:
        ts = np.asarray(timestamps, dtype="datetime64[us]")[: equity.size]
        # days since the epoch (floored, as pandas' normalize); NaT reads
        # as the int64 minimum on both sides
        day = ts.astype("datetime64[D]").astype(np.int64)
        # last equity of each day
        boundaries = np.nonzero(np.diff(day) != 0)[0]
        idx = np.concatenate([boundaries, [equity.size - 1]])
        series = equity[idx]
    else:
        series = equity
    if series.size < 2:
        return np.empty(0)
    prev = series[:-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        rets = np.where(prev != 0, series[1:] / prev - 1.0, 0.0)
    return rets


def _get(d: Any, *path: str, default: Any = None) -> Any:
    cur: Any = d
    for k in path:
        if cur is None:
            return default
        if hasattr(cur, "get"):
            cur = cur.get(k, None)
        else:
            return default
    return cur if cur is not None else default


def summarize_default(
    *,
    initial_cash: float,
    final_equity: float,
    analyzers: Dict[str, Any],
    config: Dict[str, Any],
) -> Dict[str, Any]:
    trades = analyzers.get("trades") or {}
    sharpe = analyzers.get("sharpe") or {}
    drawdown = analyzers.get("drawdown") or {}
    sqn = analyzers.get("sqn") or {}
    total_return = (
        (float(final_equity) / float(initial_cash) - 1.0) if initial_cash else 0.0
    )
    return {
        "initial_cash": float(initial_cash),
        "final_equity": float(final_equity),
        "total_return": float(total_return),
        "max_drawdown_pct": _get(drawdown, "max", "drawdown"),
        "max_drawdown_money": _get(drawdown, "max", "moneydown"),
        "sharpe_ratio": _get(sharpe, "sharperatio"),
        "sqn": _get(sqn, "sqn"),
        "trades_total": _get(trades, "total", "total", default=0),
        "trades_won": _get(trades, "won", "total", default=0),
        "trades_lost": _get(trades, "lost", "total", default=0),
        "avg_trade_pnl": _get(trades, "pnl", "net", "average"),
    }


def _finite_or_zero(value: Any) -> float:
    try:
        result = float(value)
    except (TypeError, ValueError):
        return 0.0
    return result if math.isfinite(result) else 0.0


def summarize_trading(
    *,
    initial_cash: float,
    final_equity: float,
    analyzers: Dict[str, Any],
    config: Dict[str, Any],
) -> Dict[str, Any]:
    """Risk-adjusted extension (rap, annualization) of the default summary."""
    summary = summarize_default(
        initial_cash=initial_cash,
        final_equity=final_equity,
        analyzers=analyzers,
        config=config,
    )
    drawdown_pct = _finite_or_zero(summary.get("max_drawdown_pct"))
    total_return = _finite_or_zero(summary.get("total_return"))
    risk_lambda = float(
        config.get("risk_lambda", config.get("risk_penalty_lambda", 1.0))
    )
    drawdown_fraction = max(0.0, drawdown_pct / 100.0)
    rap = total_return - risk_lambda * drawdown_fraction
    summary.update(
        {
            "metric_schema": str(config.get("metric_schema", "trading.metrics.v1")),
            "max_drawdown_fraction": drawdown_fraction,
            "risk_penalty_lambda": risk_lambda,
            "risk_adjusted_total_return": rap,
            "rap": rap,
        }
    )
    years = config.get("evaluation_years")
    if years is not None and float(years) > 0:
        summary["annual_return"] = (1.0 + total_return) ** (1.0 / float(years)) - 1.0
        summary["annual_rap"] = rap / float(years)
    return summary
