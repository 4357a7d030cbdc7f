"""FX rollover financing: rate table parsing and the per-bar accrual column.

The port's copy of ``gymfx_tpu/data/financing.py`` in numpy and the
standard library.  The rate table is monthly short rates in
LOCATION/TIME/Value rows (reference simulation_engines/nautilus_gym.py:
276-290, schema examples/data/fx_rollover_rates_smoke.csv).  Both engines
read their rates here:

  * the replay engine (``simulation/replay.py``) looks a rate up per
    event timestamp while it walks the frames;
  * the env precomputes one accrual column (:func:`precompute_rollover_accrual`):
    zero except on the first bar at or after 22:00 UTC of each calendar
    day, where it holds the pair's daily rate differential.  K2 then
    applies financing as ``cash + pos * close * rate`` on that bar.

Accrual model: a position held across the 22:00 UTC rollover earns or
pays  units * mid * (base_rate - quote_rate) / 100 / 365  in quote
currency, at the annualized rates of the latest table month at or before
the bar (bars before the first table month take the earliest entry).
Timestamps are ``datetime64`` values (naive ones are UTC); the column is
float64, as the JAX package's.
"""
from __future__ import annotations

import bisect
import csv
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

ROLLOVER_UTC_SECONDS = 22 * 3600  # 17:00 New York standard time

# OECD-style location codes used by the reference's rate fixtures.
CURRENCY_LOCATION = {"EUR": "EA19", "USD": "USA", "JPY": "JPN", "GBP": "GBR"}
_LOCATION_CURRENCY = {v: k for k, v in CURRENCY_LOCATION.items()}

_NS_PER_DAY = 86_400_000_000_000

RateTable = Dict[str, List[Tuple[int, float]]]


def _label_ns(label: Any) -> Optional[int]:
    """A TIME label ("2024-01", "2024-01-15", ...) as UTC nanoseconds, or
    None when it does not parse."""
    text = str(label).strip()
    if text.endswith("Z"):
        text = text[:-1]
    try:
        value = np.datetime64(text, "ns")
    except ValueError:
        return None
    if np.isnat(value):
        return None
    return int(value.astype(np.int64))


def parse_rate_table(rate_data: Any) -> RateTable:
    """LOCATION/TIME/Value rows -> currency -> sorted [(month_start_ns, pct)].

    ``rate_data`` is an iterable of row dicts (or a table with
    ``to_dict("records")``).  ``TIME`` is a month label (YYYY-MM).  Rows
    with unknown locations or unparseable months are skipped.
    """
    if rate_data is None:
        return {}
    try:
        rows = rate_data.to_dict("records")
    except AttributeError:
        rows = list(rate_data)
    table: RateTable = {}
    for row in rows:
        ccy = _LOCATION_CURRENCY.get(str(row.get("LOCATION")))
        if not ccy:
            continue
        ns = _label_ns(row.get("TIME"))
        if ns is None:
            continue
        table.setdefault(ccy, []).append((ns, float(row.get("Value", 0.0))))
    for entries in table.values():
        entries.sort()
    return table


def rate_at(table: RateTable, currency: str, ts_ns: int) -> float:
    """Annualized short rate (%) applicable at ``ts_ns``: the latest table
    month at or before the timestamp; the earliest entry for timestamps
    before the table starts; 0.0 for unknown currencies."""
    entries = table.get(currency)
    if not entries:
        return 0.0
    idx = bisect.bisect_right(entries, (int(ts_ns), float("inf"))) - 1
    return entries[max(idx, 0)][1]


def daily_differential(
    table: RateTable, base_currency: str, quote_currency: str, ts_ns: int
) -> float:
    """Per-day accrual rate for one unit-notional of the pair: long base
    earns the base rate and pays the quote rate (annualized %)."""
    base = rate_at(table, base_currency, ts_ns)
    quote = rate_at(table, quote_currency, ts_ns)
    return (base - quote) / 100.0 / 365.0


def _to_utc_ns(timestamps: Any) -> Tuple[np.ndarray, np.ndarray]:
    """(valid_mask, ns_since_epoch) of ``datetime64`` timestamps."""
    ts = np.asarray(timestamps).astype("datetime64[ns]")
    return ~np.isnat(ts), ts.astype(np.int64)


def rollover_mask(timestamps: Any) -> np.ndarray:
    """(n,) bool: True on the FIRST bar at/after 22:00 UTC of each
    calendar day.  Invalid timestamps never roll over."""
    valid, ns = _to_utc_ns(timestamps)
    day = ns // _NS_PER_DAY
    second_of_day = (ns // 1_000_000_000) % 86_400
    eligible = np.flatnonzero(valid & (second_of_day >= ROLLOVER_UTC_SECONDS))
    mask = np.zeros(len(ns), dtype=bool)
    # np.unique's return_index is each day's first occurrence in order
    _, first = np.unique(day[eligible], return_index=True)
    mask[eligible[first]] = True
    return mask


def precompute_rollover_accrual(
    timestamps: Any,
    rate_data: Any,
    base_currency: str,
    quote_currency: str,
) -> np.ndarray:
    """(n,) float64: the pair's daily differential on rollover bars, 0
    elsewhere.  The step's financing credit is  pos * close * accrual[t]
    in quote currency (K2), the replay engine's units * mid *
    differential."""
    table = parse_rate_table(rate_data)
    mask = rollover_mask(timestamps)
    out = np.zeros(len(mask), dtype=np.float64)
    if not table:
        return out
    _, ns = _to_utc_ns(timestamps)
    for i in np.flatnonzero(mask):
        out[i] = daily_differential(table, base_currency, quote_currency, int(ns[i]))
    return out


def split_pair(instrument: str) -> Tuple[str, str]:
    """'EUR_USD' / 'EUR/USD' / 'EURUSD' -> ('EUR', 'USD')."""
    raw = str(instrument).upper().replace("/", "").replace("_", "").replace("-", "")
    if len(raw) != 6 or not raw.isalpha():
        raise ValueError(
            f"cannot derive base/quote currencies from instrument {instrument!r}"
        )
    return raw[:3], raw[3:]


def read_rate_table(path: str) -> List[Dict[str, Any]]:
    """The rows of a LOCATION/TIME/Value CSV, ``Value`` as float (NaN
    where empty), as :func:`parse_rate_table` takes them."""
    with open(path, "r", encoding="utf-8", newline="") as fh:
        rows = list(csv.DictReader(fh))
    for row in rows:
        value = row.get("Value")
        row["Value"] = float(value) if value not in (None, "") else float("nan")
    return rows
