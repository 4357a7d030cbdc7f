"""Market data pipeline: CSV -> host dataset -> columnar tensors.

The port's copy of ``gymfx_tpu/data/feed.py`` (MarketData, the CSV
load, ``MarketDataset.build_market_data`` and ``_build_feature_tensors``)
in numpy and the standard library.  Load semantics are the JAX
package's: rows whose date does not parse are dropped, missing OHLC
columns are backfilled from ``price_column``, VOLUME defaults to 0.
Every host computation keeps the JAX package's f64 op order, and the
cast to the final dtype happens in numpy before ``torch.from_numpy``, so
each field is bitwise the JAX package's ``build_market_data(device=False)``
(tests/test_torch_data.py).
"""
from __future__ import annotations

import csv
import datetime as _dt
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gymfx_tpu_torch.data import calendar as fxcal

OHLC_COLUMNS = ("OPEN", "HIGH", "LOW", "CLOSE")

_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class MarketData(NamedTuple):
    """Per-dataset tensors the env step reads, time-major over ``n``
    bars (field meanings as in the JAX package's MarketData)."""

    open: Any          # (n,) compute dtype
    high: Any
    low: Any
    close: Any
    volume: Any
    padded_close: Any  # (n + window_size,)
    minute_of_week: Any  # (n,) int32, -1 when timestamp invalid
    calendar: Any      # (n, 10) float32 — fxcal.CALENDAR_FEATURE_KEYS order
    force_close: Any   # (n, 4) float32 — fxcal.FORCE_CLOSE_FEATURE_KEYS order
    ev_no_trade: Any   # (n,) float32
    ev_spread_mult: Any
    ev_slip_mult: Any
    rollover_accrual: Any  # (n,) compute dtype (zeros: financing not ported)
    padded_features: Any   # (n + window_size, F) float32
    feat_mean: Any     # (n + 1, F) float32
    feat_std: Any      # (n + 1, F) float32
    feat_neutral: Any  # (n + 1,) bool
    row0: Any = 0      # always 0: the port keeps the whole history resident
    scen_flags: Any = 0

    @property
    def n_bars(self) -> int:
        return int(self.close.shape[0])


class Frame(NamedTuple):
    """A loaded CSV: float64 columns by name plus ``datetime64[us]``
    timestamps (NaT where absent)."""

    columns: Dict[str, np.ndarray]
    timestamps: np.ndarray

    def __len__(self) -> int:
        return len(self.timestamps)


def _infer_timeframe_hours(config: Dict[str, Any]) -> float:
    """Timeframe label ('M1', 'h4', 'xx_15m', ...) -> hours."""
    raw = str(
        config.get("timeframe")
        or config.get("timeframe_label")
        or config.get("bar_timeframe")
        or ""
    ).strip().lower()
    if "_" in raw:
        raw = raw.rsplit("_", 1)[-1]
    if raw.endswith("m") and raw[:-1].isdigit():
        return max(0.0, int(raw[:-1]) / 60.0)
    if raw.endswith("h") and raw[:-1].isdigit():
        return float(int(raw[:-1]))
    if raw.endswith("d") and raw[:-1].isdigit():
        return float(int(raw[:-1]) * 24)
    if raw[:1] == "m" and raw[1:].isdigit():
        return max(0.0, int(raw[1:]) / 60.0)
    if raw[:1] == "h" and raw[1:].isdigit():
        return float(int(raw[1:]))
    if raw[:1] == "d" and raw[1:].isdigit():
        return float(int(raw[1:]) * 24)
    return 0.0


class MarketDataset:
    """Host-side dataset: the loaded frame and its tensor build."""

    def __init__(self, frame: Frame, config: Dict[str, Any]):
        self.frame = frame
        self.config = dict(config)
        self.price_column = str(config.get("price_column", "CLOSE"))
        self.timeframe_hours = _infer_timeframe_hours(config)
        self.timestamps = frame.timestamps

    def __len__(self) -> int:
        return len(self.frame)

    def build_market_data(
        self,
        *,
        window_size: int,
        device: torch.device,
        feature_columns: Sequence[str] = (),
        feature_scaling: str = "rolling_zscore",
        feature_scaling_window: int = 256,
        dtype: torch.dtype = torch.float32,
        event_context_no_trade_column: str = "event_no_trade_window_active",
        event_context_spread_stress_column: str = "event_spread_stress_multiplier",
        event_context_slippage_stress_column: str = "event_slippage_stress_multiplier",
        force_close_dow: int = 4,
        force_close_hour: int = 20,
        force_close_window_hours: int = 4,
        monday_entry_window_hours: int = 4,
        financing_rate_data: Any = None,
    ) -> MarketData:
        if financing_rate_data is not None:
            raise NotImplementedError(
                "FX financing rates (data/financing.py) come with "
                "ROADMAP.md Queue 1 item 8"
            )
        columns = self.frame.columns
        n = len(self.frame)
        if n < window_size + 2:
            raise ValueError("input data is empty or too short for the configured window")
        close = columns[self.price_column]

        def col(name: str, fallback) -> np.ndarray:
            if name in columns:
                return columns[name]
            if np.isscalar(fallback):
                return np.full(n, float(fallback), dtype=np.float64)
            return fallback

        o = col("OPEN", close)
        h = col("HIGH", close)
        l = col("LOW", close)
        c = col("CLOSE", close)
        v = col("VOLUME", 0.0)
        padded_close = np.concatenate([np.full(window_size, close[0]), close])

        cal = fxcal.precompute_fx_calendar_features(
            self.timestamps, timeframe_hours=self.timeframe_hours or 1.0
        )
        fcz = fxcal.precompute_force_close_features(
            self.timestamps,
            timeframe_hours=self.timeframe_hours,
            force_close_dow=force_close_dow,
            force_close_hour=force_close_hour,
            force_close_window_hours=force_close_window_hours,
            monday_entry_window_hours=monday_entry_window_hours,
        )
        mow = fxcal.precompute_minute_of_week(self.timestamps)
        ev_no_trade = col(event_context_no_trade_column, 0.0).astype(np.float32)
        ev_spread = col(event_context_spread_stress_column, 1.0).astype(np.float32)
        ev_slip = col(event_context_slippage_stress_column, 1.0).astype(np.float32)
        accrual = np.zeros(n, dtype=np.float64)

        padded_features, feat_mean, feat_std, feat_neutral = _build_feature_tensors(
            columns,
            n,
            feature_columns=tuple(feature_columns),
            window_size=window_size,
            scaling=feature_scaling,
            scaling_window=feature_scaling_window,
        )
        if dtype not in _NUMPY_DTYPES:
            raise NotImplementedError(
                f"compute dtype {dtype} is not ported (float32 and float64 "
                "are); see ROADMAP.md Queue 1 item 7"
            )
        npd = _NUMPY_DTYPES[dtype]

        def T(x, dt):
            # cast on the host first (the JAX package's np.asarray(x, dt)),
            # so the device tensor holds exactly those bits
            return torch.from_numpy(np.ascontiguousarray(x, dtype=dt)).to(device)

        f32 = np.float32
        return MarketData(
            open=T(o, npd),
            high=T(h, npd),
            low=T(l, npd),
            close=T(c, npd),
            volume=T(v, npd),
            padded_close=T(padded_close, npd),
            minute_of_week=T(mow, np.int32),
            calendar=T(cal, f32),
            force_close=T(fcz, f32),
            ev_no_trade=T(ev_no_trade, f32),
            ev_spread_mult=T(ev_spread, f32),
            ev_slip_mult=T(ev_slip, f32),
            rollover_accrual=T(accrual, npd),
            padded_features=T(padded_features, f32),
            feat_mean=T(feat_mean, f32),
            feat_std=T(feat_std, f32),
            feat_neutral=T(feat_neutral, bool),
            row0=0,
            scen_flags=T(np.zeros(n, np.int32), np.int32),
        )


def _build_feature_tensors(
    columns: Dict[str, np.ndarray],
    n: int,
    *,
    feature_columns: Tuple[str, ...],
    window_size: int,
    scaling: str,
    scaling_window: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Feature matrix + per-step leakage-safe scaler moments from f64
    cumulative sums (windows with < 2 history rows are neutral)."""
    f = len(feature_columns)
    if f == 0:
        return (
            np.zeros((n + window_size, 0), np.float32),
            np.zeros((n + 1, 0), np.float32),
            np.ones((n + 1, 0), np.float32),
            np.zeros((n + 1,), bool),
        )
    missing = [cname for cname in feature_columns if cname not in columns]
    if missing:
        raise ValueError(
            "feature_window preprocessor: configured feature_columns "
            f"missing from dataframe: {missing[:5]}{'...' if len(missing) > 5 else ''}"
        )
    values = np.stack([columns[cname] for cname in feature_columns], axis=1)
    padded = np.concatenate([np.tile(values[0], (window_size, 1)), values], axis=0)

    if scaling == "none":
        mean = np.zeros((n + 1, f), np.float64)
        std = np.ones((n + 1, f), np.float64)
        neutral = np.zeros((n + 1,), bool)
        return padded.astype(np.float32), mean.astype(np.float32), std.astype(np.float32), neutral

    s1 = np.concatenate([np.zeros((1, f)), np.cumsum(values, axis=0)], axis=0)
    s2 = np.concatenate([np.zeros((1, f)), np.cumsum(values**2, axis=0)], axis=0)
    t = np.arange(n + 1)
    if scaling == "rolling_zscore":
        lo = np.maximum(0, t - int(scaling_window))
    elif scaling == "expanding_zscore":
        lo = np.zeros(n + 1, dtype=np.int64)
    else:
        raise ValueError(
            "feature_scaling must be one of ('none', 'rolling_zscore', "
            f"'expanding_zscore'); got {scaling!r}"
        )
    count = (t - lo).astype(np.float64)
    safe_count = np.maximum(count, 1.0)[:, None]
    mean = (s1[t] - s1[lo]) / safe_count
    var = (s2[t] - s2[lo]) / safe_count - mean**2
    std = np.sqrt(np.maximum(var, 0.0))
    std = np.where(std < 1e-8, 1.0, std)
    neutral = count < 2
    mean = np.where(neutral[:, None], 0.0, mean)
    std = np.where(neutral[:, None], 1.0, std)
    return (
        padded.astype(np.float32),
        mean.astype(np.float32),
        std.astype(np.float32),
        neutral,
    )


def _parse_timestamp(text: str) -> Optional[np.datetime64]:
    """ISO 8601 -> datetime64[us]; None when it does not parse.  Aware
    values are converted to UTC."""
    try:
        dt = _dt.datetime.fromisoformat(text.strip())
    except ValueError:
        return None
    if dt.tzinfo is not None:
        dt = dt.astimezone(_dt.timezone.utc).replace(tzinfo=None)
    return np.datetime64(dt, "us")


def _parse_float(text: str) -> float:
    text = text.strip()
    return float(text) if text else math.nan  # an empty cell is NaN, as pandas reads it


def load_dataframe(config: Dict[str, Any]) -> Frame:
    """CSV -> Frame with OHLCV backfill.  Rows whose ``date_column``
    does not parse are dropped; a file without that column keeps every
    row and has NaT timestamps (neutral calendar features)."""
    file_path = config.get("input_data_file")
    if not file_path:
        raise ValueError("config key 'input_data_file' is required")
    headers = bool(config.get("headers", True))
    max_rows = config.get("max_rows")
    with open(file_path, "r", encoding="utf-8", newline="") as fh:
        rows = list(csv.reader(fh))
    if headers:
        names, rows = [c.strip() for c in rows[0]], rows[1:]
    else:
        names = [str(i) for i in range(len(rows[0]) if rows else 0)]
    rows = [r for r in rows if r]
    if max_rows is not None:
        rows = rows[: int(max_rows)]

    date_col = str(config.get("date_column", "DATE_TIME"))
    if date_col in names:
        di = names.index(date_col)
        stamps = [_parse_timestamp(r[di]) for r in rows]
        keep = [i for i, s in enumerate(stamps) if s is not None]
        rows = [rows[i] for i in keep]
        timestamps = np.array([stamps[i] for i in keep], dtype="datetime64[us]")
    else:
        di = None
        timestamps = np.full(len(rows), np.datetime64("NaT"), dtype="datetime64[us]")
    columns = {}
    for j, name in enumerate(names):
        if j == di:
            continue
        try:
            columns[name] = np.array(
                [_parse_float(r[j] if j < len(r) else "") for r in rows], dtype=np.float64
            )
        except ValueError:
            # a text column: left out, so naming it as a price or
            # feature column fails loudly where it is read
            continue

    price_col = str(config.get("price_column", "CLOSE"))
    if price_col not in columns:
        raise ValueError(f"price_column '{price_col}' not found in data")
    for column in OHLC_COLUMNS:
        if column not in columns:
            columns[column] = columns[price_col]
    if "VOLUME" not in columns:
        columns["VOLUME"] = np.zeros(len(rows), np.float64)
    return Frame(columns, timestamps)


def load_market_dataset(config: Dict[str, Any]) -> MarketDataset:
    return MarketDataset(load_dataframe(config), config)
