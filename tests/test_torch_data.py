"""The port's data path against the JAX package's, and its DST rule.

* Every MarketData field built by the port (csv-module loader, numpy
  build) is BITWISE the JAX package's ``build_market_data(device=False)``
  for each bar CSV in examples/data, with and without the OHLCV feature
  columns, under rolling and expanding z-scores.
* The calendar columns are bitwise the JAX package's (pandas + zoneinfo)
  over hourly bars that cross both 2023 DST transitions.
* The loader drops rows whose date does not parse and backfills missing
  OHLC/VOLUME columns, as the JAX package's pandas path does.
* A hypothesis sweep holds the explicit US DST rule against zoneinfo for
  UTC timestamps from 2007 to 2035, plus the minutes around every
  transition of those years.
"""
import datetime as dt
import pathlib
from zoneinfo import ZoneInfo

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.data import calendar as jcal
from gymfx_tpu.data.feed import load_market_dataset as jax_load

from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.data import calendar as tcal
from gymfx_tpu_torch.data.feed import load_market_dataset

from test_torch_parity import assert_bitwise

REPO = pathlib.Path(__file__).resolve().parent.parent
BAR_FILES = sorted(p for p in (REPO / "examples" / "data").glob("*.csv")
                   if "rollover" not in p.name)
OHLCV = ["OPEN", "HIGH", "LOW", "CLOSE", "VOLUME"]
NY = ZoneInfo("America/New_York")


def _build_both(path, features, scaling, **over):
    config = dict(JAX_DEFAULTS)
    config.update(input_data_file=str(path), **over)
    kw = dict(window_size=32, feature_columns=features, feature_scaling=scaling,
              feature_scaling_window=64)
    ref = jax_load(config).build_market_data(device=False, **kw)
    tconfig = dict(DEFAULT_VALUES)
    tconfig.update(input_data_file=str(path), **over)
    ours = load_market_dataset(tconfig).build_market_data(device="cpu", **kw)
    return ref, ours


@pytest.mark.parametrize("scaling", ["rolling_zscore", "expanding_zscore"])
@pytest.mark.parametrize("features", [[], OHLCV], ids=["no_features", "ohlcv"])
@pytest.mark.parametrize("path", BAR_FILES, ids=lambda p: p.stem)
def test_market_data_bitwise_matches_jax(path, features, scaling):
    ref, ours = _build_both(path, features, scaling)
    for name in ours._fields:
        if name == "row0":
            assert ref.row0 == ours.row0 == 0
            continue
        assert_bitwise(getattr(ref, name), getattr(ours, name), f"{path.name} {name}")


def test_bar_files_are_found():
    assert len(BAR_FILES) == 4


def test_loader_drops_bad_dates_and_backfills_like_pandas(tmp_path):
    csv = tmp_path / "bars.csv"
    rows = ["DATE_TIME,CLOSE,EXTRA"]
    t0 = dt.datetime(2024, 3, 8, 18, 0)
    for i in range(60):
        stamp = "not a date" if i in (5, 17) else (t0 + dt.timedelta(hours=i)).isoformat(sep=" ")
        rows.append(f"{stamp},{float(1.1 + 0.001 * np.sin(i))!r},{i % 7}")
    csv.write_text("\n".join(rows) + "\n")
    ref, ours = _build_both(csv, ["CLOSE", "EXTRA"], "rolling_zscore", timeframe="H1")
    assert ours.close.shape[0] == 58
    for name in ours._fields:
        if name != "row0":
            assert_bitwise(getattr(ref, name), getattr(ours, name), name)


def test_calendar_columns_bitwise_across_dst_transitions():
    stamps = pd.date_range("2023-03-01", "2023-11-30", freq="37min")
    ours_ts = stamps.to_numpy().astype("datetime64[us]")
    for tf in (1.0, 4.0, 1 / 60):
        assert_bitwise(
            jcal.precompute_fx_calendar_features(pd.Series(stamps), timeframe_hours=tf),
            tcal.precompute_fx_calendar_features(ours_ts, timeframe_hours=tf),
            f"calendar tf={tf}",
        )
    assert_bitwise(
        jcal.precompute_force_close_features(pd.Series(stamps), timeframe_hours=1.0),
        tcal.precompute_force_close_features(ours_ts, timeframe_hours=1.0),
        "force close",
    )
    assert_bitwise(jcal.precompute_minute_of_week(pd.Series(stamps)),
                   tcal.precompute_minute_of_week(ours_ts), "minute of week")


def _zoneinfo_local(ts: dt.datetime) -> np.datetime64:
    local = ts.replace(tzinfo=dt.timezone.utc).astimezone(NY).replace(tzinfo=None)
    return np.datetime64(local, "us")


def _transition_minutes():
    out = []
    for year in range(2007, 2036):
        for start_end in tcal.ny_dst_bounds_utc(year):
            edge = start_end.astype(dt.datetime)
            out += [edge + dt.timedelta(minutes=m) for m in (-61, -1, 0, 1, 59, 60)]
    return out


def test_dst_rule_matches_zoneinfo_at_every_transition_2007_2035():
    stamps = _transition_minutes()
    ours = tcal.utc_to_ny_local(np.array(stamps, dtype="datetime64[us]"))
    ref = np.array([_zoneinfo_local(s) for s in stamps], dtype="datetime64[us]")
    np.testing.assert_array_equal(ours, ref)


@settings(max_examples=300, deadline=None, database=None)
@given(st.datetimes(min_value=dt.datetime(2007, 1, 1), max_value=dt.datetime(2035, 12, 31, 23, 59)))
def test_dst_rule_matches_zoneinfo(ts):
    ts = ts.replace(microsecond=0)
    ours = tcal.utc_to_ny_local(np.array([ts], dtype="datetime64[us]"))[0]
    assert ours == _zoneinfo_local(ts)


def test_dst_rule_refuses_years_before_2007():
    with pytest.raises(ValueError, match="2007"):
        tcal.utc_to_ny_local(np.array(["2006-07-01T00:00"], dtype="datetime64[us]"))
