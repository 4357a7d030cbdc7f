"""OANDA FX calendar: per-bar NY-calendar columns, in numpy and the
standard library.

The port's copy of ``gymfx_tpu/data/calendar.py``'s vectorized
precompute.  Timestamps arrive as a ``datetime64[us]`` array (``NaT``
where unparseable); naive values are UTC, as in the JAX package.

America/New_York is an explicit US daylight-saving rule rather than a
tz database lookup, so the columns do not depend on the host's zoneinfo:
EDT (UTC-4) from the second Sunday of March, 02:00 local, to the first
Sunday of November, 02:00 local; EST (UTC-5) otherwise.  The rule holds
from 2007 (Energy Policy Act of 2005); earlier years raise.
"""
from __future__ import annotations

import numpy as np

# Policy times (New York local). Mon=0 .. Sun=6.
WEEKLY_OPEN_DOW = 6          # Sunday
WEEKLY_OPEN_HM = (17, 5)
WEEKLY_CLOSE_DOW = 4         # Friday
WEEKLY_CLOSE_HM = (16, 59)
DAILY_BREAK_START_HM = (16, 59)
DAILY_BREAK_END_HM = (17, 5)
NO_TRADE_WINDOW_START_HM = (16, 50)
NO_TRADE_WINDOW_END_HM = (17, 10)
FRIDAY_NO_NEW_POSITION_HM = (14, 0)
FRIDAY_RISK_REDUCTION_HM = (15, 0)
FRIDAY_FORCE_FLAT_HM = (15, 45)
BROKER_DAILY_BREAK_NEAR_MINUTES = 30

CALENDAR_FEATURE_KEYS = (
    "hours_to_fx_daily_break",
    "bars_to_fx_daily_break",
    "hours_to_friday_close",
    "bars_to_friday_close",
    "is_friday_risk_reduction_window",
    "is_no_new_position_window",
    "is_force_flat_window",
    "is_broker_daily_break_near",
    "broker_market_open",
    "is_no_trade_window",
)

FORCE_CLOSE_FEATURE_KEYS = (
    "bars_to_force_close",
    "hours_to_force_close",
    "is_force_close_zone",
    "is_monday_entry_window",
)

FIRST_DST_RULE_YEAR = 2007
_MINUTE = np.timedelta64(1, "m")
_HOUR = np.timedelta64(1, "h")
_DAY = np.timedelta64(1, "D")
_US_PER_SECOND = 1e6


def _hm_minutes(hm) -> int:
    return hm[0] * 60 + hm[1]


def _nth_sunday(year: int, month: int, n: int) -> np.datetime64:
    first = np.datetime64(f"{year:04d}-{month:02d}-01", "D")
    # 1970-01-01 was a Thursday: weekday (Mon=0) = (days + 3) % 7
    dow = (int(first.astype(np.int64)) + 3) % 7
    return first + np.timedelta64((6 - dow) % 7 + 7 * (n - 1), "D")


def ny_dst_bounds_utc(year: int):
    """[start, end) of New York daylight time in ``year``, as UTC
    ``datetime64[us]``: 02:00 EST (07:00 UTC) on the second Sunday of
    March to 02:00 EDT (06:00 UTC) on the first Sunday of November."""
    if year < FIRST_DST_RULE_YEAR:
        raise ValueError(
            f"timestamp year {year} predates the US daylight-saving rule "
            f"this calendar implements (years >= {FIRST_DST_RULE_YEAR})"
        )
    start = _nth_sunday(year, 3, 2) + 7 * _HOUR
    end = _nth_sunday(year, 11, 1) + 6 * _HOUR
    return start.astype("datetime64[us]"), end.astype("datetime64[us]")


def utc_to_ny_local(ts: np.ndarray) -> np.ndarray:
    """UTC ``datetime64[us]`` -> New York wall-clock ``datetime64[us]``
    (NaT stays NaT)."""
    ts = np.asarray(ts, dtype="datetime64[us]")
    out = np.full(ts.shape, np.datetime64("NaT"), dtype="datetime64[us]")
    valid = ~np.isnat(ts)
    if not valid.any():
        return out
    v = ts[valid]
    years = v.astype("datetime64[Y]").astype(np.int64) + 1970
    dst = np.zeros(v.shape, bool)
    for year in np.unique(years):
        start, end = ny_dst_bounds_utc(int(year))
        sel = years == year
        dst[sel] = (v[sel] >= start) & (v[sel] < end)
    offset = np.where(dst, -4, -5).astype(np.int64) * _HOUR
    out[valid] = v + offset.astype("timedelta64[us]")
    return out


def _weekday(day: np.ndarray) -> np.ndarray:
    return (day.astype("datetime64[D]").astype(np.int64) + 3) % 7


def _minute_of_day(ts: np.ndarray) -> np.ndarray:
    day = ts.astype("datetime64[D]")
    return ((ts - day) // _MINUTE).astype(np.int64)


def _hours(delta: np.ndarray) -> np.ndarray:
    """Timedelta -> float hours, as pandas' ``total_seconds() / 3600``."""
    seconds = delta.astype("timedelta64[us]").astype(np.int64) / _US_PER_SECOND
    return seconds / 3600.0


def precompute_fx_calendar_features(
    timestamps, *, timeframe_hours: float = 4.0
) -> np.ndarray:
    """Calendar features: (n, 10) float32 in CALENDAR_FEATURE_KEYS order.

    Hours-to-X are NY wall-clock differences (the reference subtracts
    two datetimes sharing one zone, which Python defines as naive
    wall-clock subtraction).  Unparseable timestamps give a zero row."""
    tf_h = max(float(timeframe_hours or 0.0), 1e-9)
    ts = np.asarray(timestamps, dtype="datetime64[us]")
    n = len(ts)
    out = np.zeros((n, len(CALENDAR_FEATURE_KEYS)), dtype=np.float32)
    valid = ~np.isnat(ts)
    if not valid.any():
        return out
    naive = utc_to_ny_local(ts[valid])
    dow = _weekday(naive)
    mod = _minute_of_day(naive)
    floor_day = naive.astype("datetime64[D]").astype("datetime64[us]")

    break_minutes = _hm_minutes(DAILY_BREAK_START_HM)
    today_break = floor_day + break_minutes * _MINUTE
    next_break = today_break + np.where(today_break <= naive, 1, 0) * _DAY
    hours_to_break = _hours(next_break - naive)

    close_minutes = _hm_minutes(WEEKLY_CLOSE_HM)
    days_ahead = (WEEKLY_CLOSE_DOW - dow) % 7
    candidate = floor_day + days_ahead * _DAY + close_minutes * _MINUTE
    candidate = candidate + np.where(candidate < naive, 7, 0) * _DAY
    hours_to_close = _hours(candidate - naive)

    is_friday = dow == WEEKLY_CLOSE_DOW
    before_close = mod < close_minutes
    risk_red = is_friday & (mod >= _hm_minutes(FRIDAY_RISK_REDUCTION_HM)) & before_close
    no_new = is_friday & (mod >= _hm_minutes(FRIDAY_NO_NEW_POSITION_HM)) & before_close
    force_flat = is_friday & (mod >= _hm_minutes(FRIDAY_FORCE_FLAT_HM)) & before_close

    brk_start = _hm_minutes(DAILY_BREAK_START_HM)
    brk_end = _hm_minutes(DAILY_BREAK_END_HM)
    in_break = (mod >= brk_start) & (mod < brk_end)
    break_near = in_break | (
        (mod > brk_start - BROKER_DAILY_BREAK_NEAR_MINUTES) & (mod < brk_start)
    )
    no_trade = (mod >= _hm_minutes(NO_TRADE_WINDOW_START_HM)) & (
        mod < _hm_minutes(NO_TRADE_WINDOW_END_HM)
    )

    sunday = dow == WEEKLY_OPEN_DOW
    open_mask = dow != 5  # Saturday closed
    open_mask &= ~sunday | (mod >= _hm_minutes(WEEKLY_OPEN_HM))
    open_mask &= ~(is_friday & (mod >= close_minutes))
    open_mask &= ~(~sunday & in_break)

    block = np.stack(
        [
            np.maximum(hours_to_break, 0.0),
            np.maximum(hours_to_break, 0.0) / tf_h,
            np.maximum(hours_to_close, 0.0),
            np.maximum(hours_to_close, 0.0) / tf_h,
            risk_red.astype(np.float64),
            no_new.astype(np.float64),
            force_flat.astype(np.float64),
            break_near.astype(np.float64),
            open_mask.astype(np.float64),
            no_trade.astype(np.float64),
        ],
        axis=1,
    ).astype(np.float32)
    out[valid] = block
    return out


def precompute_force_close_features(
    timestamps,
    *,
    timeframe_hours: float,
    force_close_dow: int = 4,
    force_close_hour: int = 20,
    force_close_window_hours: int = 4,
    monday_entry_window_hours: int = 4,
) -> np.ndarray:
    """Stage-B force-close features: (n, 4) float32 in
    FORCE_CLOSE_FEATURE_KEYS order, from raw (naive) weekday and hour —
    no timezone conversion; unparseable timestamps give zeros."""
    tf_hours = float(timeframe_hours) or 1.0
    ts = np.asarray(timestamps, dtype="datetime64[us]")
    out = np.zeros((len(ts), 4), dtype=np.float32)
    valid = ~np.isnat(ts)
    if not valid.any():
        return out
    v = ts[valid]
    dow = _weekday(v)
    hour = _minute_of_day(v) // 60

    days_ahead = (force_close_dow - dow) % 7
    target_hours = days_ahead * 24 + (force_close_hour - hour)
    target_hours = np.where(target_hours < 0, target_hours + 7 * 24, target_hours)
    hours_to_fc = target_hours.astype(np.float64)
    bars_to_fc = hours_to_fc / max(tf_hours, 1e-9)
    in_zone = (dow == force_close_dow) & (hour >= force_close_hour) & (
        hour < force_close_hour + force_close_window_hours
    )
    in_monday = (dow == 0) & (hour < monday_entry_window_hours)
    out[valid] = np.stack(
        [
            bars_to_fc,
            hours_to_fc,
            in_zone.astype(np.float64),
            in_monday.astype(np.float64),
        ],
        axis=1,
    ).astype(np.float32)
    return out


def precompute_minute_of_week(timestamps) -> np.ndarray:
    """Raw-timestamp minute-of-week (Mon 00:00 = 0), int32; -1 when
    invalid (the session/weekend filter's clock)."""
    ts = np.asarray(timestamps, dtype="datetime64[us]")
    out = np.full(len(ts), -1, dtype=np.int32)
    valid = ~np.isnat(ts)
    if valid.any():
        v = ts[valid]
        out[valid] = (_weekday(v) * 24 * 60 + _minute_of_day(v)).astype(np.int32)
    return out
