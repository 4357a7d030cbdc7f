"""Market data pipeline: CSV -> host dataset -> columnar tensors, and
the streaming of a long history in shards.

The port's copy of ``gymfx_tpu/data/feed.py`` (MarketData, the CSV
load, ``MarketDataset.build_market_data`` and ``_build_feature_tensors``)
in numpy and the standard library.  Load semantics are the JAX
package's: rows whose date does not parse are dropped, missing OHLC
columns are backfilled from ``price_column``, VOLUME defaults to 0.
Every host computation keeps the JAX package's f64 op order, and the
cast to the final dtype happens in numpy before ``torch.from_numpy``, so
each field is bitwise the JAX package's ``build_market_data(device=False)``
(tests/test_torch_data.py).  ``build_market_data(device=None)`` keeps
the numpy arrays on the host, as the JAX package's ``device=False`` does.

``market_data_nbytes``, ``market_data_nbytes_report``,
``shard_market_data`` and :class:`BarStreamer` are the JAX package's
(:262-594): the streamer plans the same shards for the same budget, and
moves them to the card through pinned host memory on a side CUDA stream.
"""
from __future__ import annotations

import csv
import datetime as _dt
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gymfx_tpu_torch.data import calendar as fxcal
from gymfx_tpu_torch.data import financing as fxfin

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
    rollover_accrual: Any  # (n,) compute dtype: a rollover bar's rate, else 0
    padded_features: Any   # (n + window_size, F) float32
    feat_mean: Any     # (n + 1, F) float32
    feat_std: Any      # (n + 1, F) float32
    feat_neutral: Any  # (n + 1,) bool
    # global bar row of local index 0 (an int): 0 for a resident tape, the
    # shard's start for a streamed shard (shard_market_data), so the env
    # keeps global cursors and rebases every read
    row0: Any = 0
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
        if self.frame is None:
            return self._released_len
        return len(self.frame)

    def bar_interval_ms(self) -> Optional[float]:
        """Milliseconds per bar: from the timeframe label when present,
        else the median spacing of valid timestamps; None when neither
        is available (callers that need it must reject, not guess)."""
        if self.timeframe_hours:
            return self.timeframe_hours * 3_600_000.0
        ts = np.asarray(self.timestamps).astype("datetime64[ns]")
        ts = ts[~np.isnat(ts)]
        if len(ts) < 2:
            return None
        median = float(np.median(np.diff(ts.astype(np.int64)) / 1e9))
        return median * 1000.0 if median > 0 else None

    def release_frame(self) -> None:
        """Drop the loaded frame once the tape exists in another form (a
        compressed streamed tape); ``len()`` keeps working, building market
        data again raises."""
        if self.frame is not None:
            self._released_len = len(self.frame)
            self.frame = None

    def build_market_data(
        self,
        *,
        window_size: int,
        device: Optional[torch.device],
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
        instrument: str = "EUR_USD",
    ) -> MarketData:
        if self.frame is None:
            raise ValueError(
                "this dataset's frame was released (release_frame) after "
                "its device tensors were built — market data cannot be "
                "rebuilt from it"
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
        if financing_rate_data is not None:
            base_ccy, quote_ccy = fxfin.split_pair(instrument)
            accrual = fxfin.precompute_rollover_accrual(
                self.timestamps, financing_rate_data, base_ccy, quote_ccy
            )
        else:
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
            return np.ascontiguousarray(x, dtype=dt)

        f32 = np.float32
        host = MarketData(
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
        return host if device is None else market_data_to_device(host, device)


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
    row and has NaT timestamps (neutral calendar features).

    Canonical bar files (exactly the DATE_TIME, OHLCV schema, read with
    the default date and price columns, no ``max_rows``) go through the
    native C++ parser (``data/native_loader.py``) where it serves them;
    everything else takes the numpy path, with the same result."""
    file_path = config.get("input_data_file")
    if not file_path:
        raise ValueError("config key 'input_data_file' is required")
    headers = bool(config.get("headers", True))
    max_rows = config.get("max_rows")
    if (headers and max_rows is None
            and str(config.get("date_column", "DATE_TIME")) == "DATE_TIME"
            and str(config.get("price_column", "CLOSE")) == "CLOSE"):
        from gymfx_tpu_torch.data.native_loader import load_ohlcv_csv

        native = load_ohlcv_csv(str(file_path))
        if native is not None:
            return native
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


def market_data_to_device(data: MarketData, device, non_blocking: bool = False) -> MarketData:
    """``data``'s arrays (numpy or tensors) as tensors on ``device``;
    ``row0`` stays the int it is."""
    device = torch.device(device)

    def put(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device, non_blocking=non_blocking)

    return MarketData(*(x if name == "row0" else put(x)
                        for name, x in zip(MarketData._fields, data)))


def market_data_nbytes(data: MarketData) -> int:
    """Total array bytes of a MarketData (host or device).  ``row0``
    counts as the 4-byte int32 scalar the JAX package stores, so a
    budget plans the same shards here as there."""
    total = 0
    for name, leaf in zip(MarketData._fields, data):
        if name == "row0":
            total += 4
            continue
        nbytes = getattr(leaf, "nbytes", None)
        if nbytes is not None:
            total += int(nbytes)
    return total


def market_data_nbytes_report(data: Optional[MarketData], tape=None) -> Dict[str, Any]:
    """Decoded vs compressed byte accounting for one tape: ``decoded``
    the full-width footprint of ``data``, ``compressed`` that of its
    :class:`~gymfx_tpu_torch.data.compress.CompressedTape` (None when the
    tape is not compressed), ``ratio`` the tape's compression ratio."""
    decoded = market_data_nbytes(data) if data is not None else None
    if tape is None:
        return {"decoded": decoded, "compressed": None, "ratio": None}
    return {
        "decoded": decoded if decoded is not None
        else tape.decoded_shard_nbytes * tape.num_shards,
        "compressed": tape.nbytes,
        "ratio": tape.compression_ratio,
    }


def shard_market_data(data: MarketData, start: int, shard_bars: int,
                      window_size: int) -> MarketData:
    """Slice one streaming shard out of a MarketData (numpy arrays or
    tensors; slices are views).

    A shard anchored at global row ``start`` serves env steps whose bar
    cursor lands in ``[start, start + shard_bars)``; a step at cursor
    ``t`` also reads row ``t + 1``, so the bar arrays carry one row of
    lookahead, the front-padded window sources ``window_size`` more, and
    the (n + 1)-row scaler moments one more again.  ``row0 = start``.
    """
    n = int(data.close.shape[0])
    hi = start + int(shard_bars) + 1
    if hi > n:
        raise ValueError(f"shard [{start}, {hi}) exceeds dataset of {n} bars")
    bar = slice(start, hi)
    padded = slice(start, hi + int(window_size))
    feat = slice(start, hi + 1)
    return data._replace(
        open=data.open[bar],
        high=data.high[bar],
        low=data.low[bar],
        close=data.close[bar],
        volume=data.volume[bar],
        padded_close=data.padded_close[padded],
        minute_of_week=data.minute_of_week[bar],
        calendar=data.calendar[bar],
        force_close=data.force_close[bar],
        ev_no_trade=data.ev_no_trade[bar],
        ev_spread_mult=data.ev_spread_mult[bar],
        ev_slip_mult=data.ev_slip_mult[bar],
        rollover_accrual=data.rollover_accrual[bar],
        padded_features=data.padded_features[padded],
        feat_mean=data.feat_mean[feat],
        feat_std=data.feat_std[feat],
        feat_neutral=data.feat_neutral[feat],
        row0=int(start),
        scen_flags=data.scen_flags[bar],
    )


def _pinned(x):
    """A page-locked CPU tensor holding ``x`` (numpy array or tensor)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.contiguous().pin_memory()


class BarStreamer:
    """Double-buffered host-to-device streaming of a long bar history.

    The port of the JAX package's ``BarStreamer`` (the planner, ``starts``,
    the compressed ring, ``serve_ranges``, ``iter_shards``).  The history
    is cut into shards of one shape; shard ``k + 1``'s copy is issued
    before shard ``k`` is handed out for compute.  At most two decoded
    shards are resident, so each targets half the budget.

    ``compress != "off"`` stores the tape in the int16 tick-delta format
    (data/compress.py): the planner budgets on the compressed resident
    size plus two decoded shards; the whole compressed tape stays on the
    device when the ring holds it (``tape_resident``), else each
    compressed shard is copied over; K6 decodes each shard.  The host f32
    tape is dropped after encoding.

    On the card the double buffer is: the host source (the f32 tape, or
    the compressed one when it is not resident) pinned once, here; each
    shard's ``non_blocking`` copies issued on a side CUDA stream, with an
    event that the compute stream waits on before the shard's decode or
    first read; ``record_stream`` on the copies, so their memory is not
    reused while compute still reads it.  Nothing syncs the host per
    shard.  On the CPU a shard is plain slicing.
    """

    def __init__(self, host_data: MarketData, *, window_size: int, budget_mb: float,
                 min_shard_bars: int = 64, compress: str = "off", tick_size: float = 1e-5,
                 what: str = "", device=None):
        from gymfx_tpu_torch.data import compress as C

        self.compress = C.validate_compress_mode(compress)
        self.window_size = int(window_size)
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        n = int(host_data.close.shape[0])
        total = market_data_nbytes(host_data)
        per_bar = max(1.0, total / max(1, n))
        budget_bytes = float(budget_mb) * 2**20
        if self.compress == "off":
            shard_bars = int(budget_bytes / 2.0 / per_bar) - self.window_size - 1
        else:
            # two decoded f32 buffers take an eighth of the budget; the
            # rest holds the compressed resident ring (checked below)
            shard_bars = int(budget_bytes * 0.125 / 2.0 / per_bar) - self.window_size - 1
        shard_bars = max(int(min_shard_bars), shard_bars)
        if shard_bars >= n - 1:
            raise ValueError(
                f"dataset ({n} bars, {total / 2**20:.1f} MiB) fits the "
                f"{budget_mb} MiB streaming budget — streaming is not "
                "needed; unset stream_hbm_budget_mb"
            )
        self.n_bars = n
        self.shard_bars = shard_bars
        # regular starts every shard_bars; the final shard is anchored so
        # its lookahead row is the last bar (it overlaps the previous one)
        starts = list(range(0, n - shard_bars - 1, shard_bars))
        last = n - shard_bars - 1
        if not starts or starts[-1] != last:
            starts.append(last)
        self.starts = starts

        cuda = self.device.type == "cuda"
        self._side = torch.cuda.Stream(self.device) if cuda else None
        self.tape = None
        self._decoder = None
        self.ring_shards = 2  # uncompressed: the double buffer
        self.tape_resident = False
        if self.compress == "off":
            self.host_data = host_data
            # the shards' source: pinned on the card's host, else the host
            # arrays themselves as CPU tensors (no copy)
            self._source = MarketData(*(
                x if name == "row0" else (_pinned(x) if cuda else torch.as_tensor(x))
                for name, x in zip(MarketData._fields, host_data)
            ))
            return
        tape = C.encode_market_data(
            host_data, starts=starts, shard_bars=shard_bars,
            window_size=self.window_size, tick_size=tick_size, what=what,
        )
        ring_bytes = budget_bytes - 2.0 * tape.decoded_shard_nbytes
        ring = int(ring_bytes // max(1, tape.shard_nbytes))
        if ring < 2:
            raise ValueError(
                f"stream_hbm_budget_mb={budget_mb} cannot hold two "
                f"decoded shards ({2 * tape.decoded_shard_nbytes / 2**20:.1f}"
                " MiB) plus two compressed shards "
                f"({tape.shard_nbytes / 2**20:.2f} MiB each, "
                f"{tape.nbytes / 2**20:.1f} MiB total compressed) — raise "
                "the budget or set data_compress=off"
            )
        self.ring_shards = min(ring, len(starts))
        # the whole compressed tape fits the ring: park it on the device
        # once and decode shards from resident slabs; otherwise stream the
        # compressed shards from (pinned) host memory
        self.tape_resident = ring >= len(starts)
        if self.tape_resident:
            tape = C.device_tape(tape, self.device)
        elif cuda:
            tape = tape._replace(slabs=tuple(_pinned(s) for s in tape.slabs),
                                 bases=tuple(_pinned(b) for b in tape.bases),
                                 raws=tuple(_pinned(r) for r in tape.raws))
        self.tape = tape
        self._decoder = C.make_shard_decoder(tape, self.compress, self.device)
        # compressed mode never holds the full-width tape and its
        # compressed form at the same time
        self.host_data = None
        self._source = None

    @property
    def num_shards(self) -> int:
        return len(self.starts)

    @property
    def resident_bars(self) -> int:
        """Bar capacity resident on the device under the budget."""
        return self.ring_shards * self.shard_bars

    @property
    def compression_ratio(self) -> Optional[float]:
        return None if self.tape is None else self.tape.compression_ratio

    def nbytes_report(self) -> Dict[str, Any]:
        """Compressed vs decoded byte accounting (see
        :func:`market_data_nbytes_report`)."""
        return market_data_nbytes_report(self.host_data, self.tape)

    def serve_ranges(self):
        """[(lo, hi_or_None), ...]: shard k serves bar cursors in
        [lo, hi); the final shard serves to the end (hi=None)."""
        out = []
        for k, lo in enumerate(self.starts):
            hi = self.starts[k + 1] if k + 1 < len(self.starts) else None
            out.append((lo, hi))
        return out

    def _stage(self, k: int):
        """Issue shard ``k``'s copy: (its arrays, the copy's CUDA event or
        None when nothing was copied)."""
        from gymfx_tpu_torch.data import compress as C

        if self.tape is not None:
            arrs = C.shard_arrays(self.tape, k)
            if self.tape_resident or self._side is None:
                return arrs, None
            with torch.cuda.stream(self._side):
                arrs = dict(arrs, **{
                    key: tuple(x.to(self.device, non_blocking=True) for x in arrs[key])
                    for key in ("slabs", "bases", "raws")
                })
                event = torch.cuda.Event()
                event.record(self._side)
            return arrs, event
        shard = shard_market_data(self._source, self.starts[k], self.shard_bars,
                                  self.window_size)
        if self._side is None:
            return shard, None
        with torch.cuda.stream(self._side):
            shard = market_data_to_device(shard, self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._side)
        return shard, event

    def _materialize(self, staged) -> MarketData:
        """The compute stream waits for the staged copy, then the shard is
        decoded (compressed) or read as it is."""
        arrs, event = staged
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            copies = ([x for key in ("slabs", "bases", "raws") for x in arrs[key]]
                      if self.tape is not None else
                      [x for name, x in zip(MarketData._fields, arrs) if name != "row0"])
            for x in copies:
                x.record_stream(compute)
        if self.tape is not None:
            return self._decoder(arrs)
        return arrs

    def _device_shard(self, k: int) -> MarketData:
        return self._materialize(self._stage(k))

    def iter_shards(self):
        """Yield ``(serve_lo, serve_hi_or_None, shard)`` in order, with
        shard ``k + 1``'s copy already issued before shard ``k`` is
        handed to the caller for compute."""
        nxt = self._stage(0)
        for k in range(len(self.starts)):
            cur = self._materialize(nxt)
            if k + 1 < len(self.starts):
                nxt = self._stage(k + 1)
            hi = self.starts[k + 1] if k + 1 < len(self.starts) else None
            yield self.starts[k], hi, cur
