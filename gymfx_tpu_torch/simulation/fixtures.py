"""Deterministic hand-built replay fixtures.

Scenario coverage mirrors the reference bake-off suite (reference
simulation_engines/bakeoff.py:26-210): multi-asset netting with partial
close and reversal across EUR/USD + USD/JPY, intrabar SL/TP collision
with an explicit worst-case execution path, margin rejection, and an
overnight financing boundary.  Values are this framework's own (float,
not Decimal) but exercise the same execution semantics.  The port's copy
of ``gymfx_tpu/simulation/fixtures.py``, with integer nanoseconds in
place of pandas timestamps.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gymfx_tpu_torch.contracts import InstrumentSpec, MarketFrame, TargetAction

NANOSECONDS_PER_MINUTE = 60_000_000_000
# 2024-03-05T09:30:00Z — an arbitrary deterministic Tuesday open
FIXTURE_START_NS = 1_709_631_000_000_000_000


def _ts(minutes: int) -> int:
    return FIXTURE_START_NS + minutes * NANOSECONDS_PER_MINUTE


def _eurusd() -> InstrumentSpec:
    return InstrumentSpec(
        symbol="EUR/USD",
        venue="SIM",
        base_currency="EUR",
        quote_currency="USD",
        price_precision=5,
        size_precision=0,
        margin_init=0.04,
        margin_maint=0.02,
        min_quantity=1000.0,
        lot_size=1000.0,
    )


def _usdjpy() -> InstrumentSpec:
    return InstrumentSpec(
        symbol="USD/JPY",
        venue="SIM",
        base_currency="USD",
        quote_currency="JPY",
        price_precision=3,
        size_precision=0,
        margin_init=0.04,
        margin_maint=0.02,
        min_quantity=1000.0,
        lot_size=1000.0,
    )


def _bar(instrument_id: str, tf: int, ts: int, close: float, spread: float,
         path: Tuple[float, ...] | None = None) -> MarketFrame:
    return MarketFrame(
        instrument_id=instrument_id,
        timeframe_minutes=tf,
        ts_event_ns=ts,
        open=close,
        high=close + spread,
        low=close - spread,
        close=close,
        volume=2_000_000.0,
        execution_path=path,
    )


def build_multi_asset_fixture() -> Tuple[
    List[InstrumentSpec], List[MarketFrame], List[TargetAction]
]:
    """Asynchronous two-pair replay: open/add? no — open, partial close,
    reversal, flatten on EUR/USD; open + flatten on USD/JPY (tests
    netting and JPY->USD conversion of realized pnl)."""
    instruments = [_eurusd(), _usdjpy()]
    frames: List[MarketFrame] = []
    eur_closes = (1.08400, 1.08520, 1.08610, 1.08550, 1.08700, 1.08660)
    for minute, close in enumerate(eur_closes, start=1):
        frames.append(_bar("EUR/USD.SIM", 1, _ts(minute), close, 0.00040))
    for minute, close in ((1, 151.200), (6, 151.950)):
        frames.append(_bar("USD/JPY.SIM", 5, _ts(minute), close, 0.060))

    actions = [
        TargetAction("EUR/USD.SIM", _ts(1), 3000.0, "eur-open-long"),
        TargetAction("EUR/USD.SIM", _ts(3), 1000.0, "eur-partial-close"),
        TargetAction("EUR/USD.SIM", _ts(4), -2000.0, "eur-reverse-short"),
        TargetAction("EUR/USD.SIM", _ts(6), 0.0, "eur-flatten"),
        TargetAction("USD/JPY.SIM", _ts(1), 2000.0, "jpy-open-long"),
        TargetAction("USD/JPY.SIM", _ts(6), 0.0, "jpy-flatten"),
    ]
    return instruments, frames, actions


def build_intrabar_collision_fixture() -> Tuple[
    List[InstrumentSpec], List[MarketFrame], List[TargetAction]
]:
    """Bar 2 touches both SL and TP; its execution_path visits the LOW
    first, so the stop must fill and the take-profit must not."""
    eurusd = [_eurusd()]
    base = 1.08400
    frames = [
        _bar("EUR/USD.SIM", 1, _ts(1), base, 0.00015),
        _bar(
            "EUR/USD.SIM",
            1,
            _ts(2),
            1.08600,
            0.00015,
            path=(base, 1.08050, 1.08900, 1.08600),  # O -> L -> H -> C
        ),
    ]
    actions = [
        TargetAction(
            "EUR/USD.SIM",
            _ts(1),
            1000.0,
            "long-bracket",
            stop_loss_price=1.08200,
            take_profit_price=1.08800,
        )
    ]
    return eurusd, frames, actions


def build_margin_rejection_fixture() -> Tuple[
    List[InstrumentSpec], List[MarketFrame], List[TargetAction]
]:
    """An order whose initial margin dwarfs the account must be denied
    at preflight and produce no fills."""
    instruments, frames, _ = build_multi_asset_fixture()
    return (
        [instruments[0]],
        [f for f in frames if f.instrument_id == "EUR/USD.SIM"][:2],
        [TargetAction("EUR/USD.SIM", _ts(1), 50_000_000.0, "oversized")],
    )


def build_financing_fixture() -> Tuple[
    List[InstrumentSpec], List[MarketFrame], List[TargetAction]
]:
    """A position held across the 22:00 UTC rollover accrues interest."""
    eurusd = [_eurusd()]
    times = tuple(
        int(np.datetime64(t, "ns").astype(np.int64))
        for t in ("2024-03-05T21:57:00", "2024-03-05T22:02:00", "2024-03-05T22:03:00")
    )
    frames = [_bar("EUR/USD.SIM", 1, ts, 1.08400, 0.00015) for ts in times]
    actions = [
        TargetAction("EUR/USD.SIM", times[0], 1000.0, "overnight-open"),
        TargetAction("EUR/USD.SIM", times[2], 0.0, "overnight-close"),
    ]
    return eurusd, frames, actions


def build_limit_policy_fixture(*, exact_touch: bool) -> Tuple[
    List[InstrumentSpec], List[MarketFrame], List[TargetAction]
]:
    """Long bracket whose TP (1.08800) is reached by bar 2's path.

    ``exact_touch=True``: the path tick lands ON the limit — fills under
    touch/cross, not under conservative (which needs a trade-through).
    ``exact_touch=False``: the path tick JUMPS through to 1.08900 —
    fills under every policy, at 1.08800 for conservative/touch and at
    the (better) touching tick price under cross.  Meant to run with a
    zero-spread/zero-slippage profile so tick prices equal mids.
    """
    eurusd = [_eurusd()]
    touch_mid = 1.08800 if exact_touch else 1.08900
    frames = [
        _bar("EUR/USD.SIM", 1, _ts(1), 1.08400, 0.00015),
        _bar(
            "EUR/USD.SIM",
            1,
            _ts(2),
            1.08600,
            0.00015,
            path=(1.08450, touch_mid, 1.08600),
        ),
    ]
    actions = [
        TargetAction(
            "EUR/USD.SIM",
            _ts(1),
            1000.0,
            "long-bracket",
            stop_loss_price=1.08000,
            take_profit_price=1.08800,
        )
    ]
    return eurusd, frames, actions


def build_latency_fixture() -> Tuple[
    List[InstrumentSpec], List[MarketFrame], List[TargetAction]
]:
    """Three one-minute frames with distinct prices; an open at frame 1
    demonstrates latency: with latency_ms=0 it fills at frame 1's close
    (1.08400); with 0 < latency_ms <= 60_000 it fills at frame 2's first
    path tick (1.08500)."""
    eurusd = [_eurusd()]
    frames = [
        _bar("EUR/USD.SIM", 1, _ts(1), 1.08400, 0.00015),
        _bar("EUR/USD.SIM", 1, _ts(2), 1.08500, 0.00015),
        _bar("EUR/USD.SIM", 1, _ts(3), 1.08450, 0.00015),
    ]
    actions = [
        TargetAction("EUR/USD.SIM", _ts(1), 1000.0, "delayed-open"),
        TargetAction("EUR/USD.SIM", _ts(3), 0.0, "flatten"),
    ]
    return eurusd, frames, actions


def build_margin_closeout_fixture() -> Tuple[
    List[InstrumentSpec], List[MarketFrame], List[TargetAction]
]:
    """Adverse drift liquidates a leveraged long mid-replay: a 1,000 USD
    account holds 100,000 EUR/USD from ~1.0 under the leveraged model
    (leverage 20 -> init margin 250, maintenance 125*price); equity
    crosses below maintenance at the 0.99100 close, forcing a whole-book
    closeout that fills at the NEXT frame's tick (reference margin
    models: simulation_engines/nautilus_adapter.py:397-427)."""
    spec = InstrumentSpec(
        symbol="EUR/USD",
        venue="SIM",
        base_currency="EUR",
        quote_currency="USD",
        price_precision=5,
        size_precision=0,
        margin_init=0.05,
        margin_maint=0.025,
        min_quantity=1000.0,
        lot_size=1000.0,
    )
    closes = (1.00000, 0.99800, 0.99500, 0.99250, 0.99100, 0.99050)
    frames = [
        _bar("EUR/USD.SIM", 1, _ts(minute), close, 0.00015)
        for minute, close in enumerate(closes, start=1)
    ]
    actions = [TargetAction("EUR/USD.SIM", _ts(1), 100_000.0, "doomed-long")]
    return [spec], frames, actions


def build_rollover_rate_fixture() -> List[dict]:
    """Monthly short-rate rows for the fixture currencies (schema of
    examples/data/fx_rollover_rates_smoke.csv), as the rows
    ``data/financing.parse_rate_table`` reads."""
    return [
        {"LOCATION": "EA19", "TIME": "2024-03", "Value": 4.5},
        {"LOCATION": "USA", "TIME": "2024-03", "Value": 5.25},
        {"LOCATION": "JPN", "TIME": "2024-03", "Value": 0.1},
    ]


def default_profile(**overrides) -> "ExecutionCostProfile":
    from gymfx_tpu_torch.contracts import ExecutionCostProfile

    raw = {
        "schema_version": "execution_cost_profile.v1",
        "profile_id": "gymfx_tpu.bakeoff.v1",
        "commission_rate_per_side": 0.00002,
        "full_spread_rate": 0.00008,
        "slippage_bps_per_side": 0.2,
        "latency_ms": 0,
        "financing_enabled": False,
        "intrabar_collision_policy": "worst_case",
        "limit_fill_policy": "conservative",
        "margin_model": "leveraged",
        "enforce_margin_preflight": True,
        "random_seed": 11,
    }
    raw.update(overrides)
    return ExecutionCostProfile.from_dict(raw)
