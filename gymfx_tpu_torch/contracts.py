"""Engine-neutral contracts for deterministic replays.

The port's copy of ``gymfx_tpu/contracts.py``: the same schema surface,
validation rules and error strings (reference
simulation_engines/contracts.py:22-147).  Money fields are ``float``
rather than ``Decimal``: the scan engine computes in f32/f64, and the
replay engine (``simulation/replay.py``) reconciles against it within a
stated tolerance (the reference accepts |native - oracle| <= $0.02 on
$100k, reference tests/test_nautilus_bakeoff.py:56).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional, Tuple

SCHEMA_VERSION = "execution_cost_profile.v1"

_COLLISION_POLICIES = {"worst_case", "adaptive", "ohlc"}
_LIMIT_FILL_POLICIES = {"conservative", "touch", "cross"}
_MARGIN_MODELS = {"standard", "leveraged"}


def _finite(value: Any, field: str) -> float:
    try:
        result = float(value)
    except (TypeError, ValueError) as exc:
        raise ValueError(f"{field} must be numeric") from exc
    if not math.isfinite(result):
        raise ValueError(f"{field} must be finite")
    return result


@dataclass(frozen=True)
class ExecutionCostProfile:
    """Versioned execution assumptions shared by all simulation engines."""

    schema_version: str
    profile_id: str
    commission_rate_per_side: float
    full_spread_rate: float
    slippage_bps_per_side: float
    latency_ms: int
    financing_enabled: bool
    intrabar_collision_policy: str
    limit_fill_policy: str
    margin_model: str
    enforce_margin_preflight: bool
    random_seed: int

    @property
    def slippage_rate_per_side(self) -> float:
        return self.slippage_bps_per_side / 10_000.0

    @property
    def quote_adverse_rate_per_side(self) -> float:
        """Synthetic quote displacement from mid for OHLC-only inputs."""
        return self.full_spread_rate / 2.0 + self.slippage_rate_per_side

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "ExecutionCostProfile":
        missing = sorted(set(_PROFILE_SCHEMA) - raw.keys())
        if missing:
            raise ValueError(f"execution cost profile missing fields: {missing}")
        if raw["schema_version"] != SCHEMA_VERSION:
            raise ValueError("unsupported execution cost profile schema_version")
        return cls(**{
            name: spec(name, raw[name]) for name, spec in _PROFILE_SCHEMA.items()
        })


# ---------------------------------------------------------------------------
# Declarative profile schema: field name -> (convert + validate) rule.
# The field NAMES, value domains and error strings are the cross-engine
# compatibility contract (reference simulation_engines/contracts.py);
# the table itself is this module's shape.
# ---------------------------------------------------------------------------
def _nonneg_rate(name: str, value: Any) -> float:
    v = _finite(value, name)
    if v < 0:
        raise ValueError(f"{name} cannot be negative")
    return v


def _spread_rate(name: str, value: Any) -> float:
    v = _nonneg_rate(name, value)
    if v >= 1:
        raise ValueError("full_spread_rate must be below 1")
    return v


def _nonneg_int(name: str, value: Any) -> int:
    v = int(value)
    if v < 0:
        raise ValueError(f"{name} cannot be negative")
    return v


def _choice(domain) -> Any:
    def rule(name: str, value: Any) -> str:
        v = str(value)
        if v not in domain:
            raise ValueError(f"unsupported {name}")
        return v

    return rule


_PROFILE_SCHEMA = {
    "schema_version": lambda _n, v: str(v),
    "profile_id": lambda _n, v: str(v),
    "commission_rate_per_side": _nonneg_rate,
    "full_spread_rate": _spread_rate,
    "slippage_bps_per_side": _nonneg_rate,
    "latency_ms": _nonneg_int,
    "financing_enabled": lambda _n, v: bool(v),
    "intrabar_collision_policy": _choice(_COLLISION_POLICIES),
    "limit_fill_policy": _choice(_LIMIT_FILL_POLICIES),
    "margin_model": _choice(_MARGIN_MODELS),
    "enforce_margin_preflight": lambda _n, v: bool(v),
    "random_seed": lambda _n, v: int(v),
}


@dataclass(frozen=True)
class InstrumentSpec:
    symbol: str
    venue: str
    base_currency: str
    quote_currency: str
    price_precision: int
    size_precision: int
    margin_init: float
    margin_maint: float
    min_quantity: float = 1.0
    lot_size: Optional[float] = None

    @property
    def instrument_id(self) -> str:
        return f"{self.symbol}.{self.venue}"


@dataclass(frozen=True)
class MarketFrame:
    instrument_id: str
    timeframe_minutes: int
    ts_event_ns: int
    open: float
    high: float
    low: float
    close: float
    volume: float
    execution_path: Optional[Tuple[float, ...]] = None


@dataclass(frozen=True)
class TargetAction:
    instrument_id: str
    ts_event_ns: int
    target_units: float
    action_id: str
    stop_loss_price: Optional[float] = None
    take_profit_price: Optional[float] = None


def instrument_spec_from_config(config: dict) -> InstrumentSpec:
    """Resolve an :class:`InstrumentSpec` from the layered config.

    Same key surface and defaults as the reference's env-side resolver
    (reference simulation_engines/nautilus_gym.py:34-51): ``instrument``
    names base/quote as ``EUR_USD`` or ``EUR/USD``; ``price_precision``
    defaults to 3 for JPY-quoted pairs and 5 otherwise; venue comes from
    ``simulation_venue``; margin/lot fields from their config keys.
    """
    raw = str(config.get("instrument", "EUR_USD")).replace("_", "/")
    if "/" not in raw:
        raise ValueError("FX instrument must identify base and quote currencies")
    base, quote = raw.split("/", 1)
    lot_size = config.get("lot_size", 1)
    return InstrumentSpec(
        symbol=f"{base}/{quote}",
        venue=str(config.get("simulation_venue", "SIM")),
        base_currency=base,
        quote_currency=quote,
        price_precision=int(
            config.get("price_precision", 3 if quote == "JPY" else 5)
        ),
        size_precision=int(config.get("size_precision", 0)),
        margin_init=float(config.get("margin_init", 0.05)),
        margin_maint=float(config.get("margin_maint", 0.025)),
        min_quantity=float(config.get("min_quantity", 1)),
        lot_size=None if lot_size is None else float(lot_size),
    )


def load_execution_cost_profile(path: str | Path) -> ExecutionCostProfile:
    source = Path(path)
    with source.open("r", encoding="utf-8") as handle:
        raw = json.load(handle)
    if not isinstance(raw, dict):
        raise ValueError("execution cost profile must contain a JSON object")
    return ExecutionCostProfile.from_dict(raw)
