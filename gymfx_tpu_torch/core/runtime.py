"""Host-side runtime: merged config dict -> bound environment on a device.

The port of ``gymfx_tpu/core/runtime.py``'s ``Environment`` facade for
the replay feed: it loads the dataset once, builds the static EnvConfig,
the EnvParams and the MarketData tensors on its device, and exposes
``reset`` / ``step`` / ``rollout`` / ``make_driver``.

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
    make_env_config,
    make_env_params,
    not_ported,
)
from gymfx_tpu_torch.data.feed import MarketData, MarketDataset, load_market_dataset


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
        feed = str(config.get("feed") or "replay").lower()
        if feed == "scengen":
            raise not_ported("the scengen feed", 14)
        if feed == "curriculum":
            raise not_ported("the curriculum feed", 15)
        if feed != "replay":
            raise ValueError(f"feed must be replay|scengen|curriculum, got {feed!r}")
        if config.get("stream_hbm_budget_mb"):
            raise not_ported("bar streaming (stream_hbm_budget_mb)", 15)
        if str(config.get("data_compress", "off")).lower() != "off":
            raise not_ported("compressed tapes (data_compress)", 15)
        self.dataset = dataset if dataset is not None else load_market_dataset(self.config)
        if len(self.dataset) < int(config.get("window_size", 32)) + 2:
            raise ValueError("input data is empty or too short for the configured window")

        feature_columns = _parse_column_list(config.get("feature_columns"), "feature_columns")
        binary_cols = set(_parse_column_list(
            config.get("feature_binary_columns"), "feature_binary_columns"
        ))
        self.config["feature_columns"] = feature_columns
        self.config["feature_binary_columns"] = sorted(binary_cols)
        self.cfg: EnvConfig = make_env_config(
            self.config,
            n_bars=len(self.dataset),
            n_features=len(feature_columns),
            binary_mask=tuple(c in binary_cols for c in feature_columns),
        )
        if self.device.type == "cuda" and self.cfg.dtype != torch.float32:
            raise not_ported(
                f"compute_dtype {self.cfg.dtype} on the card (the kernels are float32)", 7
            )
        if self.cfg.financing_enabled:
            raise not_ported("FX financing rates (data/financing.py)", 8)
        self.params: EnvParams = make_env_params(self.config, self.cfg, self.device)
        self.data: MarketData = self.dataset.build_market_data(
            window_size=self.cfg.window_size,
            device=self.device,
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
        )

    @property
    def n_bars(self) -> int:
        return self.cfg.n_bars

    def reset(self, n_envs: int = 1, params: Optional[EnvParams] = None):
        """(state, obs) of ``n_envs`` fresh episodes at bar row 0."""
        return env_core.reset(self.cfg, params or self.params, self.data, n_envs)

    def step(self, state: EnvState, action, params: Optional[EnvParams] = None):
        """One step of every env in ``state``: (state, obs, reward, done, info)."""
        return env_core.step(self.cfg, params or self.params, self.data, state, action)

    def rollout(self, driver, steps: int, seed: int = 0, params=None,
                collect: bool = True, n_envs: int = 1):
        """Episode rollout of ``n_envs`` envs; outputs are (steps, n_envs)."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return rollout_mod.rollout(
            self.cfg, params or self.params, self.data, driver, int(steps), gen,
            collect=collect, n_envs=n_envs,
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
            return rollout_mod.replay_driver(actions or [0])
        try:
            return rollout_mod.DRIVERS[mode]()
        except KeyError:
            raise ValueError(f"unknown driver_mode {mode!r}") from None
