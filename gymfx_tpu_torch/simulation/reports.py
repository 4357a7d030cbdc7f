"""Canonical execution-report export.

The reference serializes fill facts into an external
``trading_contracts.ExecutionReport`` schema when that optional package
is installed (reference simulation_engines/bakeoff.py:306-374).  This
framework ships the schema as a self-contained dataclass with the same
field surface, so report export needs no external dependency; the
``to_dict`` output is shape-compatible with the reference's
``model_dump(mode="json")`` payloads.
"""
from __future__ import annotations

import dataclasses
from datetime import datetime, timezone
from typing import Any, Dict, List

from gymfx_tpu_torch.contracts import ExecutionCostProfile, InstrumentSpec
from gymfx_tpu_torch.simulation.replay import ENGINE_VERSION


@dataclasses.dataclass(frozen=True)
class ProducerIdentity:
    name: str
    version: str


@dataclasses.dataclass(frozen=True)
class ExecutionReport:
    object_id: str
    as_of: datetime
    producer: ProducerIdentity
    trace_id: str
    order_intent_id: str
    state: str
    requested_units: float
    filled_units: float
    requested_price: float
    filled_price: float
    spread_cost: float
    slippage_cost: float
    commission: float
    financing: float
    conversion_cost: float
    broker_ids: Dict[str, str]
    latency_ms: float

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["as_of"] = self.as_of.isoformat()
        return out


def _conversion_rate(spec: InstrumentSpec, mid: float, base_currency: str) -> float:
    if spec.quote_currency == base_currency:
        return 1.0
    if spec.base_currency == base_currency:
        return 1.0 / mid
    raise ValueError(
        f"cannot convert {spec.quote_currency} to {base_currency} "
        f"using {spec.instrument_id}"
    )


def export_execution_reports(
    result: Dict[str, Any],
    instrument_specs: List[InstrumentSpec],
    profile: ExecutionCostProfile,
    *,
    base_currency: str = "USD",
) -> List[Dict[str, Any]]:
    """Fill facts -> canonical report dicts (one per order_filled)."""
    specs = {spec.instrument_id: spec for spec in instrument_specs}
    requested = {
        event["action_id"]: abs(float(event["delta_units"]))
        for event in result["events"]
        if event["event_type"] == "target_requested"
    }
    reports: List[Dict[str, Any]] = []
    for fill in result["events"]:
        if fill["event_type"] != "order_filled":
            continue
        spec = specs[fill["instrument_id"]]
        mid = float(fill["reference_mid"])
        conversion = _conversion_rate(spec, mid, base_currency)
        quantity = float(fill["quantity"])
        commission = float(fill["commission"]) * conversion
        spread_cost = quantity * mid * float(profile.full_spread_rate) / 2.0 * conversion
        slippage_cost = quantity * mid * profile.slippage_rate_per_side * conversion
        signed = quantity if fill["side"] in {"BUY", "1"} else -quantity
        action_id = fill["action_id"]
        report = ExecutionReport(
            object_id=f"scan-fill:{fill['client_order_id']}:{fill['sequence']}",
            as_of=datetime.fromtimestamp(
                fill["ts_event_ns"] / 1_000_000_000, tz=timezone.utc
            ),
            producer=ProducerIdentity(
                name="gymfx-tpu-replay-adapter", version=ENGINE_VERSION
            ),
            trace_id=result["result_hash"],
            order_intent_id=action_id,
            state="filled",
            requested_units=float(requested.get(action_id, quantity)),
            filled_units=float(signed),
            requested_price=float(mid),
            filled_price=float(fill["price"]),
            spread_cost=float(spread_cost),
            slippage_cost=float(slippage_cost),
            commission=float(commission),
            financing=0.0,
            conversion_cost=0.0,
            broker_ids={
                "client_order_id": fill["client_order_id"],
                "instrument_id": fill["instrument_id"],
                "cost_currency": base_currency,
            },
            latency_ms=float(profile.latency_ms),
        )
        reports.append(report.to_dict())
    return reports
