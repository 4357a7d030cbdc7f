"""Generated scenarios -> the replay feed's host and device formats.

The port of ``gymfx_tpu/scengen/feed.py`` without pandas: generated
paths land in the port's ``data/feed.Frame`` (float64 columns by name and
``datetime64[us]`` timestamps) on a weekend-skipping FX minute grid, and
``ScenGenDataset`` subclasses ``MarketDataset`` so every derived tensor —
calendar features, force-close windows, minute-of-week, scaler moments,
padded obs windows — comes from the same ``build_market_data`` as a
replayed CSV.  The only addition is the per-bar ``scen_flags`` channel
(params.FLAG_*), zero on replay feeds.  Spread blowouts ride the
event-context columns (``event_spread_stress_multiplier`` /
``event_slippage_stress_multiplier``), as in the JAX package.

The generation runs on the caller's device (the card unless ``device=
"cpu"``: K10 there); its paths come to the host once, for the frame.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from gymfx_tpu_torch.data.feed import Frame, MarketDataset, _infer_timeframe_hours, market_data_to_device
from gymfx_tpu_torch.scengen.params import scenario_params

DEFAULT_BARS = 2048
DEFAULT_PRESET = "regime_mix"
DEFAULT_PORTFOLIO_PAIRS = ("EUR_USD", "GBP_USD", "AUD_USD", "NZD_USD")

# representative initial price levels per pair (scenario tapes are
# synthetic — the level only matters for conversion/margin realism)
PAIR_S0 = {
    "EUR_USD": 1.10, "GBP_USD": 1.27, "AUD_USD": 0.66, "NZD_USD": 0.61,
    "USD_JPY": 148.0, "USD_CHF": 0.88, "USD_CAD": 1.36,
}

# quote-currency width of one unit of spread multiplier (the SPREAD
# column is informational; execution stress flows via the event columns)
BASE_SPREAD = 1.5e-5

_MINUTE = np.timedelta64(1, "m")


def fx_timestamp_grid(n_bars: int, timeframe_hours: float,
                      start: str = "2024-01-01") -> Tuple[np.ndarray, np.ndarray]:
    """(timestamps ``datetime64[us]``, monday_open mask): ``n_bars``
    sequential bars that skip the FX weekend close (Fri 22:00 -> Sun 22:00
    UTC); ``monday_open[t]`` marks the first bar after each skip.  The JAX
    package's ``pd.date_range`` grid, in numpy."""
    n = int(n_bars)
    step_min = max(1, int(round((timeframe_hours or 1 / 60) * 60)))
    total = int(n * 7 / 5) + 2 * 1440 // step_min + 8
    origin = np.datetime64(str(start), "us")
    while True:
        idx = origin + np.arange(total, dtype=np.int64) * (step_min * _MINUTE)
        minutes = idx.astype("datetime64[m]").astype(np.int64)
        mins = minutes % 1440
        dow = (minutes // 1440 + 3) % 7  # 1970-01-01 was a Thursday; Monday = 0
        closed = (((dow == 4) & (mins >= 22 * 60)) | (dow == 5)
                  | ((dow == 6) & (mins < 22 * 60)))
        open_idx = idx[~closed]
        if len(open_idx) >= n:
            break
        total *= 2
    open_idx = open_idx[:n]
    monday = np.zeros(n, bool)
    if n > 1:
        monday[1:] = np.diff(open_idx) > step_min * _MINUTE
    return open_idx, monday


def _paths_to_frame(timestamps, o, h, l, c, spread_mult, slip_mult) -> Frame:
    close = np.asarray(c, np.float64)
    high = np.asarray(h, np.float64)
    low = np.asarray(l, np.float64)
    return Frame({
        "OPEN": np.asarray(o, np.float64),
        "HIGH": high,
        "LOW": low,
        "CLOSE": close,
        # deterministic activity proxy: bar range in 1e-4 fractions
        "VOLUME": np.round((high - low) / np.maximum(close, 1e-9) / 1e-4),
        "SPREAD": BASE_SPREAD * np.asarray(spread_mult, np.float64),
        "event_spread_stress_multiplier": np.asarray(spread_mult, np.float64),
        "event_slippage_stress_multiplier": np.asarray(slip_mult, np.float64),
    }, np.asarray(timestamps, "datetime64[us]"))


def _snap_to_tick(frame: Frame, tick: float) -> Frame:
    """Snap generated OHLC onto the LOB's int-tick grid (float64 rounding,
    before the pipeline's float32 cast) so the tape satisfies the int16
    tick-delta wire format's on-grid requirement (data/compress.py); the
    hull is re-closed on the grid."""
    cols = dict(frame.columns)
    for col in ("OPEN", "HIGH", "LOW", "CLOSE"):
        cols[col] = np.round(cols[col] / tick) * tick
    o, c = cols["OPEN"], cols["CLOSE"]
    cols["HIGH"] = np.maximum.reduce([cols["HIGH"], o, c])
    cols["LOW"] = np.minimum.reduce([cols["LOW"], o, c])
    return Frame(cols, frame.timestamps)


def _maybe_snap(frame: Frame, config: Dict[str, Any]) -> Frame:
    if not config.get("scengen_snap_to_tick"):
        return frame
    tick = float(config.get("lob_tick_size", 1e-5) or 1e-5)
    return _snap_to_tick(frame, tick)


def _scengen_knobs(config: Dict[str, Any]) -> Tuple[str, int, int, float]:
    preset = str(config.get("scengen_preset") or DEFAULT_PRESET)
    n_bars = int(config.get("scengen_bars") or DEFAULT_BARS)
    seed = int(config.get("scengen_seed") or 0)
    tf_h = _infer_timeframe_hours(config) or 1 / 60
    return preset, n_bars, seed, tf_h


def _generate(config: Dict[str, Any], n_assets: int, s0, device):
    """One generation of the config's knobs on ``device``, on the host."""
    from gymfx_tpu_torch import resolve_device
    from gymfx_tpu_torch.lob import prng
    from gymfx_tpu_torch.scengen.engine import generate

    preset, n_bars, seed, tf_h = _scengen_knobs(config)
    p = scenario_params(preset)
    if s0 is not None:
        p = p._replace(s0=s0)
    stamps, monday = fx_timestamp_grid(
        n_bars, tf_h, start=str(config.get("scengen_start", "2024-01-01")))
    key = prng.PRNGKey(seed, resolve_device(device))
    paths = generate(p, key, n_bars, n_assets, monday)
    return stamps, type(paths)(*(x.cpu().numpy() for x in paths))


def synthesize_frame(config: Dict[str, Any], device=None) -> Tuple[Frame, np.ndarray]:
    """Single-asset generation: (Frame, scen_flags) for the config's
    ``scengen_*`` knobs.  Deterministic in (preset, bars, seed, timeframe,
    start)."""
    stamps, paths = _generate(config, 1, None, device)
    frame = _paths_to_frame(stamps, paths.open[:, 0], paths.high[:, 0], paths.low[:, 0],
                            paths.close[:, 0], paths.spread_mult, paths.slip_mult)
    return _maybe_snap(frame, config), np.asarray(paths.flags, np.int32)


def _parse_pairs(value: Any) -> List[str]:
    if value is None:
        return list(DEFAULT_PORTFOLIO_PAIRS)
    if isinstance(value, str):
        try:
            value = json.loads(value)
        except json.JSONDecodeError as e:
            raise ValueError(
                "scengen_pairs must be a JSON list of pair names "
                f"(e.g. '[\"EUR_USD\", \"GBP_USD\"]'), got {value!r}"
            ) from e
    if not isinstance(value, (list, tuple)) or not value:
        raise ValueError(f"scengen_pairs must be a non-empty list, got {value!r}")
    return [str(p) for p in value]


def synthesize_portfolio_frames(config: Dict[str, Any], device=None
                                ) -> Tuple[List[str], Dict[str, Frame], np.ndarray]:
    """Correlated multi-asset generation for the portfolio env: (pairs,
    per-pair frames on one shared grid, scen_flags).  Cross-asset
    correlation comes from the preset's Cholesky mix; per-pair levels
    from PAIR_S0."""
    pairs = _parse_pairs(config.get("scengen_pairs"))
    s0 = np.asarray([PAIR_S0.get(pair, 1.0) for pair in pairs], np.float32)
    stamps, paths = _generate(config, len(pairs), s0, device)
    aligned = {
        pair: _maybe_snap(
            _paths_to_frame(stamps, paths.open[:, i], paths.high[:, i], paths.low[:, i],
                            paths.close[:, i], paths.spread_mult, paths.slip_mult),
            config,
        )
        for i, pair in enumerate(pairs)
    }
    return pairs, aligned, np.asarray(paths.flags, np.int32)


class ScenGenDataset(MarketDataset):
    """A ``MarketDataset`` whose frame is generated instead of loaded;
    ``build_market_data`` carries the generator's per-bar flags into
    ``MarketData.scen_flags`` (zeros on every replay feed).  ``device`` is
    where the generation runs (the card unless ``"cpu"``)."""

    def __init__(self, config: Dict[str, Any], frame: Optional[Frame] = None,
                 scen_flags: Optional[Sequence[int]] = None, device=None):
        if frame is None:
            frame, scen_flags = synthesize_frame(config, device)
        super().__init__(frame, config)
        if scen_flags is None or len(scen_flags) != len(frame):
            raise ValueError(
                "ScenGenDataset needs scen_flags aligned with its frame "
                f"(got {None if scen_flags is None else len(scen_flags)} "
                f"flags for {len(frame)} bars)"
            )
        self.scen_flags = np.asarray(scen_flags, np.int32)

    def build_market_data(self, *, device, **kwargs):
        md = super().build_market_data(device=None, **kwargs)
        md = md._replace(scen_flags=np.ascontiguousarray(self.scen_flags, np.int32))
        return md if device is None else market_data_to_device(md, device)

    def sliced(self, sl: slice) -> "ScenGenDataset":
        """Row-slice (the chronological eval_split) keeping frame and flags
        aligned."""
        frame = Frame({k: v[sl] for k, v in self.frame.columns.items()},
                      self.frame.timestamps[sl])
        return ScenGenDataset(self.config, frame, self.scen_flags[sl])
