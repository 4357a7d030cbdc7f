"""Host-side runtime: merged config dict -> bound environment on a device.

The port of ``gymfx_tpu/core/runtime.py``'s ``Environment`` facade for
the replay, scengen and curriculum feeds: it loads (or, with
``feed="scengen"``, generates on its device) the dataset once, builds the
static EnvConfig, the EnvParams and the MarketData tensors on its
device, and exposes ``reset`` / ``step`` / ``rollout`` / ``make_driver``.
With ``stream_hbm_budget_mb`` a history larger than the budget is
streamed in shards (``streamer``, no resident ``data``); with
``feed="curriculum"`` a ``CurriculumSampler`` holds the other tapes
(``curriculum``), compressed when ``data_compress`` is on.  An execution
cost profile is bound here (its latency checked against the bar
interval), and with financing on the rate table's rollover accrual
becomes the tape's ``rollover_accrual`` column.

The device is CUDA unless the caller passes ``device="cpu"``; without
CUDA and without a device it raises.  On CUDA every configuration the
kernels cannot take raises ``NotImplementedError`` here, before any
step runs.
"""
from __future__ import annotations

import csv
import json
from typing import Any, Dict, Optional

import torch

from gymfx_tpu_torch import resolve_device
from gymfx_tpu_torch.core import env as env_core
from gymfx_tpu_torch.core import rollout as rollout_mod
from gymfx_tpu_torch.core.types import (
    EnvConfig,
    EnvParams,
    EnvState,
    _parse_profile,
    make_env_config,
    make_env_params,
    not_ported,
)
from gymfx_tpu_torch.data import tapes as tapes_mod
from gymfx_tpu_torch.data.compress import validate_compress_mode
from gymfx_tpu_torch.data.financing import read_rate_table
from gymfx_tpu_torch.data.feed import (
    BarStreamer,
    MarketData,
    MarketDataset,
    load_market_dataset,
    market_data_nbytes,
    market_data_to_device,
)
from gymfx_tpu_torch.lob.venue import validate_lob_venue
from gymfx_tpu_torch.scengen.feed import ScenGenDataset


def validate_profile_latency(profile, bar_ms: Optional[float]) -> None:
    """Honor-or-reject: the scan engine's timing model (orders submitted
    at a bar close fill at the next bar open) subsumes sub-bar latency
    only; anything it cannot honor fails here, at binding time.  Shared
    by the single-pair and portfolio bindings."""
    if profile is None or profile.latency_ms <= 0:
        return
    if bar_ms is None:
        raise ValueError(
            "cannot validate latency_ms: the dataset has neither a "
            "timeframe label nor enough timestamps to infer the bar "
            "interval; set the 'timeframe' config key"
        )
    if float(profile.latency_ms) > bar_ms:
        raise ValueError(
            f"latency_ms={profile.latency_ms} exceeds one bar "
            f"({bar_ms:.0f} ms): the scan engine's execution model "
            "(orders submitted at a bar close fill at the next bar "
            "open) subsumes sub-bar latency only; use the replay "
            "engine for multi-bar latency"
        )


def load_financing_rates(config: Dict[str, Any], financing_enabled: bool):
    """The rate table's rows for the rollover accrual
    (``data/financing.py``), required whenever the profile or config
    enables financing (the reference's error,
    simulation_engines/nautilus_gym.py:277-281)."""
    if not financing_enabled:
        return None
    rate_path = config.get("financing_rate_data_file")
    if not rate_path:
        raise ValueError(
            "financing_rate_data_file is required by the selected cost profile"
        )
    return read_rate_table(str(rate_path))


def _parse_column_list(value: Any, key: str) -> list:
    """Column lists arrive as lists from configs and as JSON strings
    from a command line."""
    if isinstance(value, str):
        try:
            value = json.loads(value)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"{key} must be a JSON list of column names (e.g. "
                f"'[\"CLOSE\", \"RET1\"]'), got {value!r}"
            ) from e
    if value is None:
        return []
    if not isinstance(value, (list, tuple)):
        raise ValueError(f"{key} must be a list of column names, got {value!r}")
    return [str(c) for c in value]


class Environment:
    def __init__(self, config: Dict[str, Any], dataset: Optional[MarketDataset] = None,
                 device=None):
        self.device = resolve_device(device)
        self.config = dict(config)
        # feed: "replay" loads the CSV; "curriculum" samples over a
        # registry of tapes (data/tapes.py) whose tape 0 is this
        # Environment's dataset; the sampler is built once the device data
        # exists (below)
        feed = str(config.get("feed") or "replay").lower()
        self.curriculum = None
        curriculum_specs = None
        if feed == "curriculum":
            curriculum_specs = tapes_mod.parse_tape_specs(self.config)
        elif feed not in ("replay", "scengen"):
            raise ValueError(f"feed must be replay|scengen|curriculum, got {feed!r}")
        if dataset is not None:
            self.dataset = dataset
        elif feed == "curriculum":
            self.dataset = tapes_mod.dataset_for_spec(self.config, curriculum_specs[0],
                                                      device=self.device)
        elif feed == "scengen":
            # a seed-deterministic generated tape (K10 on the card) through
            # the same MarketDataset pipeline
            self.dataset = ScenGenDataset(self.config, device=self.device)
        else:
            self.dataset = load_market_dataset(self.config)
        if len(self.dataset) < int(config.get("window_size", 32)) + 2:
            raise ValueError("input data is empty or too short for the configured window")

        feature_columns = _parse_column_list(config.get("feature_columns"), "feature_columns")
        binary_cols = set(_parse_column_list(
            config.get("feature_binary_columns"), "feature_binary_columns"
        ))
        self.config["feature_columns"] = feature_columns
        self.config["feature_binary_columns"] = sorted(binary_cols)
        profile = _parse_profile(self.config)
        self.cfg: EnvConfig = make_env_config(
            self.config,
            n_bars=len(self.dataset),
            n_features=len(feature_columns),
            binary_mask=tuple(c in binary_cols for c in feature_columns),
            profile=profile,
        )
        if self.device.type == "cuda" and self.cfg.dtype != torch.float32:
            raise not_ported(
                f"compute_dtype {self.cfg.dtype} on the card (the kernels are float32)", 7
            )
        self.params: EnvParams = make_env_params(self.config, self.cfg, self.device,
                                                 profile=profile)
        # honor-or-reject: every profile field drives the env or fails here
        validate_profile_latency(profile, self.dataset.bar_interval_ms())
        validate_lob_venue(self.cfg, self.config)
        financing_rate_data = load_financing_rates(self.config, self.cfg.financing_enabled)

        budget = config.get("stream_hbm_budget_mb")
        self.stream_budget_mb: Optional[float] = float(budget) if budget else None
        # the int16 tick-delta wire format of streamed shards and of the
        # curriculum's tape library (data/compress.py); "on" and
        # "interpret" both decode through K6 on the card
        self.data_compress = validate_compress_mode(config.get("data_compress", "off"))
        self.tick_size = float(config.get("lob_tick_size", 1e-5) or 1e-5)
        md_kwargs = dict(
            window_size=self.cfg.window_size,
            feature_columns=feature_columns,
            feature_scaling=str(config.get("feature_scaling", "rolling_zscore")),
            feature_scaling_window=int(config.get("feature_scaling_window", 256)),
            dtype=self.cfg.dtype,
            event_context_no_trade_column=str(
                config.get("event_context_no_trade_column", "event_no_trade_window_active")
            ),
            event_context_spread_stress_column=str(
                config.get("event_context_spread_stress_column", "event_spread_stress_multiplier")
            ),
            event_context_slippage_stress_column=str(
                config.get("event_context_slippage_stress_column", "event_slippage_stress_multiplier")
            ),
            force_close_dow=int(config.get("force_close_dow", 4)),
            force_close_hour=int(config.get("force_close_hour", 20)),
            force_close_window_hours=int(config.get("force_close_window_hours", 4)),
            monday_entry_window_hours=int(config.get("monday_entry_window_hours", 4)),
            financing_rate_data=financing_rate_data,
            instrument=str(config.get("instrument", "EUR_USD")),
        )
        self.md_kwargs = md_kwargs  # every tape of this Environment is built with these

        self.streamer: Optional[BarStreamer] = None
        self.host_data: Optional[MarketData] = None
        host = self.dataset.build_market_data(device=None, **md_kwargs)
        if (self.stream_budget_mb is not None
                and market_data_nbytes(host) > self.stream_budget_mb * 2**20):
            # streamed: shards go to the device on demand (the rollout
            # path); no resident copy exists
            self.streamer = BarStreamer(
                host, window_size=self.cfg.window_size, budget_mb=self.stream_budget_mb,
                compress=self.data_compress, tick_size=self.tick_size, device=self.device,
            )
            self.host_data = self.streamer.host_data
            if self.data_compress != "off":
                del host
                self.dataset.release_frame()
            self.data: Optional[MarketData] = None
        else:
            # resident (a budget the tape fits changes nothing)
            self.data = market_data_to_device(host, self.device)

        # the episode chunks' CUDA graphs (core/rollout.py), by signature
        self.episode_graphs = rollout_mod.EpisodeGraphs()

        if curriculum_specs is not None:
            if self.streamer is not None:
                raise ValueError(
                    "feed=curriculum cannot be combined with shard "
                    "streaming (stream_hbm_budget_mb="
                    f"{self.stream_budget_mb}): the sampler swaps whole "
                    "tapes at superstep boundaries; raise the budget or "
                    "compress the tape library with data_compress=on"
                )
            self.curriculum = tapes_mod.CurriculumSampler(
                self.config, curriculum_specs, base_data=self.data, md_kwargs=md_kwargs,
                device=self.device, compress=self.data_compress, tick_size=self.tick_size,
            )

    @property
    def n_bars(self) -> int:
        return self.cfg.n_bars

    @property
    def streaming(self) -> bool:
        return self.streamer is not None

    def require_resident_data(self, what: str) -> MarketData:
        """The resident device MarketData, or a loud error for paths that
        need random access to the whole history (trainers, the export,
        stepping) while the dataset is streamed in shards."""
        if self.data is None:
            raise ValueError(
                f"{what} requires the full bar history resident in "
                "device memory, but this Environment streams it in "
                f"shards (stream_hbm_budget_mb={self.stream_budget_mb}); "
                "unset stream_hbm_budget_mb or raise the budget"
            )
        return self.data

    def reset(self, n_envs: int = 1, params: Optional[EnvParams] = None):
        """(state, obs) of ``n_envs`` fresh episodes at bar row 0."""
        return env_core.reset(self.cfg, params or self.params,
                              self.require_resident_data("reset()"), n_envs)

    def step(self, state: EnvState, action, params: Optional[EnvParams] = None):
        """One step of every env in ``state``: (state, obs, reward, done, info)."""
        return env_core.step(self.cfg, params or self.params,
                             self.require_resident_data("step()"), state, action)

    def rollout(self, driver, steps: int, seed: int = 0, params=None,
                collect: bool = True, n_envs: int = 1, chunk_size: int = 64,
                eager: Optional[bool] = None):
        """Episode rollout of ``n_envs`` envs in chunks of ``chunk_size``
        steps, each replayed from its CUDA graph on the card (``eager`` as
        in ``rollout_chunked``); outputs are (steps, n_envs).  A streaming
        Environment runs one env through its shards
        (``rollout_streamed``)."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        if self.streamer is not None:
            if n_envs != 1:
                raise ValueError("a streamed episode is one env (n_envs=1)")
            return rollout_mod.rollout_streamed(
                self.cfg, params or self.params, self.streamer, driver, int(steps), gen,
                collect=collect, chunk_size=chunk_size, cache=self.episode_graphs, eager=eager,
            )
        return rollout_mod.rollout_chunked(
            self.cfg, params or self.params, self.data, driver, int(steps), gen,
            collect=collect, chunk_size=chunk_size, n_envs=n_envs, cache=self.episode_graphs,
            eager=eager,
        )

    def make_driver(self):
        """Driver from config['driver_mode']."""
        mode = str(self.config.get("driver_mode", "buy_hold"))
        if mode == "replay":
            path = self.config.get("replay_actions_file")
            if not path:
                raise ValueError("driver_mode=replay requires replay_actions_file")
            with open(path, "r", encoding="utf-8") as fh:
                actions = [int(row.get("action", 0)) for row in csv.DictReader(fh)]
            return rollout_mod.replay_driver(actions or [0], self.device)
        try:
            return rollout_mod.DRIVERS[mode]()
        except KeyError:
            raise ValueError(f"unknown driver_mode {mode!r}") from None
