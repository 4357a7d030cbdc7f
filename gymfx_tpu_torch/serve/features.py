"""Single-bar request featurization for serving — the O(1) scaler path:
the port of ``gymfx_tpu/serve/features.py`` (:38-270), numpy only.

A decide-action request arrives as ONE bar (close + raw feature row);
the engine needs the exact observation the policy trained on.  This
module maintains per-session streaming state (price/feature windows,
f64 scaler cumulants) so each bar is featurized in O(window) numpy with
no dataset, no pandas, no device round trip — and the result is
BIT-IDENTICAL to the training env's ``build_obs``:

  * windows mirror the env's front-pad + shift-append semantics
    (core/env.py reset_at / step): the first pushed bar seeds the whole
    window, each subsequent bar shifts it by one;
  * scaler moments mirror data/feed.py ``_build_feature_tensors``: f64
    running cumulants in the SAME accumulation order as ``np.cumsum``
    (a += is the same sequential f64 addition chain), rolling/expanding
    lo index, count<2 neutral flag, f32 cast — then the numpy twin of
    the scaling K1 computes (core/obs.py ``scale_feature_window_host``);
  * agent-state scalars use the same formulas/dtypes as build_obs, fed
    from broker state the caller supplies.

Honor-or-reject: obs blocks that need precomputed per-bar tables a
single-bar request does not carry (stage-B force-close, OANDA calendar,
registered obs kernels) raise at construction instead of silently
serving different observations than training saw.

The env's parameters are device tensors (core/types.EnvParams); the
featurizer reads the two it needs (initial cash, position size) to the
host once, at construction.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np

from gymfx_tpu_torch.core.obs import scale_feature_window_host
from gymfx_tpu_torch.core.types import EnvConfig, EnvParams
from gymfx_tpu_torch.train.policies import ObsSpec, is_token_policy


def _host_f32(x) -> np.float32:
    """A scalar env parameter (a 0-d tensor, or a number) as a host f32."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().reshape(-1)[0].item()
    return np.float32(x)


def flatten_obs_host(obs: Dict[str, Any], spec: ObsSpec) -> np.ndarray:
    """Numpy twin of train/policies.py ``flatten_obs`` for one
    (unbatched) obs dict: same spec key order, same ravel/f32/concat
    (pure data movement, so host and device encodes are bit-identical)."""
    parts = [np.ravel(obs[k]).astype(np.float32) for k in spec.keys]
    return np.concatenate(parts, axis=0)


def tokens_from_obs_host(
    obs: Dict[str, Any], window: int, spec: ObsSpec
) -> np.ndarray:
    """Numpy twin of train/policies.py ``tokens_from_obs`` for one
    (unbatched) obs dict."""
    cols = []
    for k in spec.keys:
        v = np.asarray(obs[k])
        if v.ndim >= 1 and v.shape[0] == window:
            cols.append(v.reshape(window, -1).astype(np.float32))
        else:
            flat = np.ravel(v).astype(np.float32)
            cols.append(np.broadcast_to(flat[None, :], (window, flat.shape[0])))
    return np.concatenate(cols, axis=-1)


def make_host_encoder(policy_name: str, window: int, spec: ObsSpec):
    """Host-side counterpart of train/policies.py ``make_obs_encoder``."""
    if is_token_policy(policy_name):
        return lambda obs: tokens_from_obs_host(obs, window, spec)
    return lambda obs: flatten_obs_host(obs, spec)


class BarFeaturizer:
    """Config-bound serving featurizer; spawn one :class:`BarSession`
    per concurrent decision stream (instrument/account)."""

    def __init__(
        self,
        cfg: EnvConfig,
        params: EnvParams,
        *,
        feature_scaling: str = "rolling_zscore",
        feature_scaling_window: int = 256,
    ):
        unsupported = []
        if cfg.stage_b_force_close_obs:
            unsupported.append("stage_b_force_close_obs")
        if cfg.oanda_fx_calendar_obs:
            unsupported.append("oanda_fx_calendar_obs")
        obs_kernels = tuple(getattr(cfg, "obs_kernels", ()) or ())
        if obs_kernels:
            unsupported.append(f"obs_kernels={list(obs_kernels)}")
        if unsupported:
            # these blocks read precomputed per-bar calendar/plugin
            # tables (data/feed.py) that a single-bar request does not
            # carry; serving an obs layout the policy never trained on
            # must fail at boot, not silently at the first decision
            raise ValueError(
                "BarFeaturizer cannot reproduce these configured obs "
                f"blocks from single-bar requests: {', '.join(unsupported)}"
            )
        if feature_scaling not in ("none", "rolling_zscore", "expanding_zscore"):
            raise ValueError(
                "feature_scaling must be one of ('none', 'rolling_zscore', "
                f"'expanding_zscore'); got {feature_scaling!r}"
            )
        self.cfg = cfg
        self.params = params
        self.initial_cash = _host_f32(params.initial_cash)
        self.position_size = _host_f32(params.position_size)
        self.scaling = feature_scaling
        self.scaling_window = int(feature_scaling_window)

    @classmethod
    def from_environment(cls, env) -> "BarFeaturizer":
        """Bind to a constructed core.runtime.Environment — the one
        config-resolution path, so serving scaling/window settings can
        never drift from what the env trained with."""
        return cls(
            env.cfg,
            env.params,
            feature_scaling=str(
                env.config.get("feature_scaling", "rolling_zscore")
            ),
            feature_scaling_window=int(
                env.config.get("feature_scaling_window", 256)
            ),
        )

    def new_session(self) -> "BarSession":
        return BarSession(self)


class BarSession:
    """Streaming state for one decision stream.

    ``push(close, features)`` consumes one bar; ``obs(...)`` then
    returns the observation dict at the current cursor — the dict the
    training env would publish at the same bar (bar cursor ``t`` =
    bars_seen - 1, bar_index = bars_seen)."""

    def __init__(self, featurizer: BarFeaturizer):
        self.f = featurizer
        cfg = featurizer.cfg
        w = cfg.window_size
        self._w = w
        self._nf = cfg.n_features
        self.bars_seen = 0
        self._price_win: deque = deque(maxlen=w)
        self._feat_win: deque = deque(maxlen=w)
        # f64 cumulants: a deque of the last (scaling_window + 1) cumsum
        # snapshots gives O(1) lookup of both s[step] (deque[-1]) and
        # the rolling s[lo] (deque[0]); expanding mode's lo snapshot is
        # the fixed s[0] = 0 instead (_zero).
        nsnap = (
            featurizer.scaling_window + 1
            if featurizer.scaling == "rolling_zscore"
            else 2  # only s[step] (and its predecessor) are ever read
        )
        self._zero = np.zeros(self._nf, np.float64)
        self._s1: deque = deque([self._zero], maxlen=nsnap)
        self._s2: deque = deque([self._zero], maxlen=nsnap)

    # ------------------------------------------------------------------
    def push(self, close: float, features: Optional[Any] = None) -> None:
        """Consume one bar: the close price plus the RAW (unscaled)
        feature row in the configured feature_columns order."""
        if self._nf > 0:
            if features is None:
                raise ValueError(
                    f"this config has {self._nf} feature columns; each "
                    "bar needs its raw feature row"
                )
            row = np.asarray(features, np.float64).reshape(-1)
            if row.shape[0] != self._nf:
                raise ValueError(
                    f"feature row has {row.shape[0]} values, expected {self._nf}"
                )
        else:
            row = np.zeros(0, np.float64)

        price = np.float32(close)
        row32 = row.astype(np.float32)
        if self.bars_seen == 0:
            # reset semantics (core/env.py reset_at): window sources are
            # front-padded with the first row, so the first observation's
            # window is w copies of bar 0
            self._price_win.extend([price] * self._w)
            self._feat_win.extend([row32] * self._w)
        else:
            self._price_win.append(price)  # step: shift-append one bar
            self._feat_win.append(row32)
        # same sequential f64 addition chain as np.cumsum in
        # data/feed.py _build_feature_tensors — bit-identical moments
        self._s1.append(self._s1[-1] + row)
        self._s2.append(self._s2[-1] + row * row)
        self.bars_seen += 1

    # ------------------------------------------------------------------
    def _scaler_moments(self) -> Tuple[np.ndarray, np.ndarray, Any]:
        """(mean_f32, std_f32, neutral) at scaler row ``step`` =
        bars_seen — exactly feed.py's table row min(t + 1, n) for the
        env's bar cursor t = bars_seen - 1 (t < n always holds for a
        bar that exists, so the clamp is the identity here)."""
        step = self.bars_seen
        if self.f.scaling == "none":
            return (
                np.zeros(self._nf, np.float32),
                np.ones(self._nf, np.float32),
                False,
            )
        if self.f.scaling == "rolling_zscore":
            # deque[-1] is s[step], deque[0] is s[max(0, step - W)]
            s1_lo, s2_lo = self._s1[0], self._s2[0]
            count = float(len(self._s1) - 1)
        else:  # expanding: lo is always row 0
            s1_lo = s2_lo = self._zero
            count = float(step)
        safe_count = max(count, 1.0)
        mean = (self._s1[-1] - s1_lo) / safe_count
        var = (self._s2[-1] - s2_lo) / safe_count - mean**2
        std = np.sqrt(np.maximum(var, 0.0))
        std = np.where(std < 1e-8, 1.0, std)
        neutral = count < 2
        mean = np.where(neutral, 0.0, mean)
        std = np.where(neutral, 1.0, std)
        assert step >= count  # step - count == lo >= 0
        return mean.astype(np.float32), std.astype(np.float32), neutral

    def obs(
        self,
        *,
        pos_sign: float = 0.0,
        equity_delta: float = 0.0,
        total_bars: int = 0,
    ) -> Dict[str, np.ndarray]:
        """Observation dict at the current cursor.

        ``pos_sign`` / ``equity_delta`` come from the caller's broker
        state (sign of the open position; equity minus initial cash);
        ``total_bars`` feeds steps_remaining_norm — 0 (no horizon, the
        default) makes it 0.0 like an exhausted episode.
        """
        if self.bars_seen == 0:
            raise ValueError("no bars pushed yet")
        cfg = self.f.cfg
        obs: Dict[str, np.ndarray] = {}

        if self._nf > 0:
            win = np.stack(self._feat_win)
            mean, std, neutral = self._scaler_moments()
            obs["features"] = scale_feature_window_host(
                win, mean, std, neutral, cfg
            )

        prices = np.asarray(self._price_win, np.float32)
        price = prices[-1]  # close of the bar at the cursor
        if cfg.include_prices:
            returns = prices - np.concatenate([prices[:1], prices[:-1]])
            obs["prices"] = prices
            obs["returns"] = returns.astype(np.float32)

        if cfg.include_agent_state:
            f32 = np.float32
            initial = f32(1.0) if self.f.initial_cash == 0 else self.f.initial_cash
            sign = f32(np.sign(pos_sign))
            unrealized = sign * (price - price) * self.f.position_size
            obs["position"] = np.asarray([sign], f32)
            obs["equity_norm"] = np.asarray([f32(equity_delta) / initial], f32)
            obs["unrealized_pnl_norm"] = np.asarray([unrealized / initial], f32)
            n = int(total_bars)
            t = self.bars_seen - 1
            # same explicit f32 reciprocal multiply as build_obs
            remaining = f32(max(0, n - (t + 1))) * (f32(1.0) / f32(max(1, n)))
            obs["steps_remaining_norm"] = np.asarray([remaining], f32)
        return obs
