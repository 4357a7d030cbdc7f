"""Independent fill-reconciliation oracle.

Recomputes the expected final account balance from the immutable fill
facts with a separate average-price ledger (reference
simulation_engines/bakeoff.py:228-303).  Test-oracle arithmetic only —
never a production ledger; its entire value is being an INDEPENDENT
second implementation that must agree with the engine within a stated
tolerance (reference accepts $0.02 on $100k,
tests/test_nautilus_bakeoff.py:56).
"""
from __future__ import annotations

from typing import Any, Dict, List

from gymfx_tpu_torch.contracts import ExecutionCostProfile, InstrumentSpec


def _conversion_rate(spec: InstrumentSpec, mid: float, base_currency: str) -> float:
    if spec.quote_currency == base_currency:
        return 1.0
    if spec.base_currency == base_currency:
        return 1.0 / mid
    raise ValueError(
        f"oracle cannot convert {spec.quote_currency} to {base_currency} "
        f"using {spec.instrument_id}"
    )


def reconcile_fills(
    result: Dict[str, Any],
    instrument_specs: List[InstrumentSpec],
    profile: ExecutionCostProfile,
    *,
    initial_cash: float,
    base_currency: str = "USD",
) -> Dict[str, Any]:
    specs = {spec.instrument_id: spec for spec in instrument_specs}
    positions: Dict[str, tuple] = {}
    realized_base = 0.0
    commission_base = 0.0
    spread_drag_base = 0.0
    slippage_drag_base = 0.0
    financing_base = 0.0

    for event in result["events"]:
        if event["event_type"] == "financing_applied":
            financing_base += float(event["amount"])
            continue
        if event["event_type"] != "order_filled":
            continue
        fill = event
        spec = specs[fill["instrument_id"]]
        mid = float(fill["reference_mid"])
        conversion = _conversion_rate(spec, mid, base_currency)
        price = float(fill["price"])
        quantity = float(fill["quantity"])
        signed = quantity if fill["side"] in {"BUY", "1"} else -quantity
        units, avg = positions.get(fill["instrument_id"], (0.0, 0.0))

        if units == 0 or units * signed > 0:
            new_units = units + signed
            avg = price if units == 0 else (
                abs(units) * avg + abs(signed) * price
            ) / abs(new_units)
        else:
            closing = min(abs(units), abs(signed))
            quote_pnl = (
                closing * (price - avg) if units > 0 else closing * (avg - price)
            )
            realized_base += quote_pnl * conversion
            new_units = units + signed
            if units * new_units < 0:
                avg = price
            elif new_units == 0:
                avg = 0.0
        positions[fill["instrument_id"]] = (new_units, avg)

        commission_base += float(fill["commission"]) * conversion
        spread_drag_base += (
            quantity * mid * float(profile.full_spread_rate) / 2.0 * conversion
        )
        slippage_drag_base += (
            quantity * mid * profile.slippage_rate_per_side * conversion
        )

    expected_final = initial_cash + realized_base - commission_base + financing_base
    return {
        "initial_cash": initial_cash,
        "realized_pnl_before_commission": realized_base,
        "commission": commission_base,
        "financing": financing_base,
        "modeled_half_spread_fill_drag": spread_drag_base,
        "modeled_slippage_fill_drag": slippage_drag_base,
        "expected_final_balance": expected_final,
        "all_positions_flat": all(u == 0 for u, _ in positions.values()),
        "fill_count": sum(
            1 for e in result["events"] if e["event_type"] == "order_filled"
        ),
    }
