"""Core state/config/param structures of the env, batched over envs.

The port's counterpart of ``gymfx_tpu/core/types.py``:
  EnvConfig  static python values (the JAX package's trace-time constants)
  EnvParams  numeric 0-d tensors on the env's device
  EnvState   per-episode carry; every field has a leading env axis
             (the JAX package vmaps one env, the port writes the axis out)

Built-in strategy and reward names only; configurations the port does
not take yet raise ``NotImplementedError`` naming the ROADMAP item that
brings them.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

EXEC_DIAG_KEYS = (
    "entry_actions_seen",
    "entry_orders_submitted",
    "blocked_session_filter",
    "blocked_atr_warmup",
    "blocked_non_positive_atr",
    "blocked_non_positive_size",
    "blocked_non_positive_price",
    "default_orders_submitted",
    "plugin_apply_errors",
    "event_context_no_trade_active_steps",
    "event_context_action_overrides",
    "event_context_blocked_entries",
    "event_context_forced_flat_actions",
    "event_context_forced_flat_orders",
    "preflight_denied",
    "margin_closeouts",
    "order_denied_min_quantity",
)
EXEC_DIAG_INDEX = {k: i for i, k in enumerate(EXEC_DIAG_KEYS)}

TERMINATION_RUNNING = 0
TERMINATION_BANKRUPT = 1
TERMINATION_EXHAUSTED = 2
TERMINATION_REASONS = ("running", "bankrupt", "exhausted")

ACTION_DIAG_KEYS = (
    "steps",
    "hold_actions",
    "long_actions",
    "short_actions",
    "non_hold_actions",
    "continuous_deadband_actions",
)
ACTION_DIAG_INDEX = {k: i for i, k in enumerate(ACTION_DIAG_KEYS)}

BUILTIN_STRATEGIES = ("default", "direct_fixed_sltp", "direct_atr_sltp")
PORTED_REWARDS = ("pnl_reward", "dd_penalized_reward")
_KERNEL_MODES = ("off", "on", "interpret")


def not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to gymfx_tpu_torch yet; it comes with "
        f"ROADMAP.md Queue 1 item {item}"
    )


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (the JAX package's fields that
    the ported bar venue reads)."""

    window_size: int = 32
    n_bars: int = 0
    n_features: int = 0
    binary_mask: Tuple[bool, ...] = ()
    feature_clip: float = 10.0

    action_space_mode: str = "discrete"
    allow_flat_action: bool = False
    include_prices: bool = True
    include_agent_state: bool = True
    stage_b_force_close_obs: bool = False
    oanda_fx_calendar_obs: bool = False

    event_context_execution_overlay: bool = False
    event_context_block_new_entries: bool = True
    event_context_force_flat: bool = False

    strategy: str = "default"
    session_filter: bool = False
    sltp_risk_mode: str = "fixed_atr"
    size_mode: str = "fx_units"
    atr_period: int = 14

    reward: str = "pnl_reward"
    # Accepted and validated as the JAX package does, for config
    # compatibility.  In the port they select nothing: the device
    # decides — on a CUDA tensor the kernels run, on a CPU tensor their
    # plain PyTorch versions.  (In JAX all three modes are bitwise
    # identical by construction.)
    rollout_obs_kernel: str = "off"
    rollout_env_kernel: str = "off"
    sharpe_window: int = 64
    stage_b_force_close_reward_penalty: bool = False

    venue: str = "bar"
    intrabar_collision_policy: str = "worst_case"
    limit_fill_policy: str = "cross"
    enforce_margin_preflight: bool = False
    enforce_margin_closeout: bool = False
    margin_model: str = "leveraged"
    financing_enabled: bool = False
    slip_open: bool = True
    slip_limit: bool = False
    slip_match: bool = False

    dtype: Any = torch.float32

    def __post_init__(self):
        if self.action_space_mode not in ("discrete", "continuous"):
            raise ValueError("action_space_mode must be discrete|continuous")
        if self.strategy not in BUILTIN_STRATEGIES:
            raise not_ported(f"registered strategy kernel {self.strategy!r}", 9)
        if self.reward == "sharpe_reward":
            raise not_ported("sharpe_reward (its per-env ring buffer)", 7)
        if self.reward not in PORTED_REWARDS:
            raise not_ported(f"registered reward kernel {self.reward!r}", 9)
        for knob in ("rollout_obs_kernel", "rollout_env_kernel"):
            if getattr(self, knob) not in _KERNEL_MODES:
                raise ValueError(
                    f"{knob} must be off|on|interpret, got {getattr(self, knob)!r}"
                )
        if self.rollout_env_kernel != "off" and self.dtype != torch.float32:
            raise ValueError(
                "rollout_env_kernel requires compute_dtype float32 "
                f"(got {self.dtype!r}); the f64 oracle mode stays on the "
                "plain path"
            )
        if self.venue == "lob":
            raise not_ported("the LOB venue (venue='lob')", 13)
        if self.venue != "bar":
            raise ValueError(f"venue must be bar|lob, got {self.venue!r}")
        if self.margin_model not in ("standard", "leveraged"):
            raise ValueError(f"unknown margin_model {self.margin_model!r}")
        if self.intrabar_collision_policy not in ("worst_case", "adaptive", "ohlc"):
            raise ValueError(
                f"unknown intrabar_collision_policy {self.intrabar_collision_policy!r}"
            )
        if self.limit_fill_policy not in ("conservative", "touch", "cross"):
            raise ValueError(f"unknown limit_fill_policy {self.limit_fill_policy!r}")
        if self.dtype not in (torch.float32, torch.float64):
            raise not_ported(f"compute dtype {self.dtype}", 7)


class EnvParams(NamedTuple):
    """Numeric environment parameters: 0-d tensors on the env's device."""

    initial_cash: Any
    position_size: Any
    commission: Any
    slippage: Any
    leverage: Any
    min_equity: Any
    continuous_action_threshold: Any
    reward_scale: Any
    penalty_lambda: Any
    sl_pips: Any
    tp_pips: Any
    pip_size: Any
    k_sl: Any
    k_tp: Any
    use_rel_volume: Any
    rel_volume: Any
    min_order_volume: Any
    max_order_volume: Any
    min_sltp_frac: Any
    max_sltp_frac: Any
    baseline_rel_volume: Any
    max_risk_rel_volume: Any
    rel_volume_sl_shrink_alpha: Any
    rel_volume_tp_shrink_alpha: Any
    min_k_sl: Any
    min_reward_risk_ratio: Any
    max_planned_loss_fraction: Any
    entry_start_mow: Any
    force_close_mow: Any
    event_no_trade_threshold: Any
    force_close_penalty_coef: Any
    force_close_penalty_window_hours: Any
    margin_init: Any
    margin_maint: Any
    price_tick: Any
    size_step: Any
    min_qty: Any


class EnvState(NamedTuple):
    """Per-episode carry, every field with a leading env axis ``N``."""

    t: Any                 # (N,) i32 current bar row
    started: Any           # (N,) bool
    terminated: Any        # (N,) bool
    termination_reason: Any  # (N,) i32
    pos: Any
    entry_price: Any
    cash_delta: Any
    equity_delta: Any
    prev_equity_delta: Any
    commission_paid: Any
    last_trade_cost: Any
    trade_count: Any       # (N,) i32
    pending_active: Any    # (N,) bool
    pending_target: Any
    pending_sl: Any
    pending_tp: Any
    pending_forced: Any    # (N,) bool
    bracket_sl: Any
    bracket_tp: Any
    trade_pnl_sum: Any
    trade_pnl_sumsq: Any
    trades_won: Any        # (N,) i32
    trades_lost: Any       # (N,) i32
    open_trade_commission: Any
    peak_equity_delta: Any
    max_drawdown_money: Any
    max_drawdown_pct: Any
    reward_buffer: Any     # (N, sharpe_window)
    reward_buffer_len: Any
    reward_buffer_idx: Any
    reward_peak: Any
    tr_buffer: Any         # (N, atr_period)
    tr_len: Any
    tr_idx: Any
    prev_close: Any
    price_window: Any      # (N, window_size)
    feat_window: Any       # (N, window_size, n_features) f32
    exec_diag: Any         # (N, len(EXEC_DIAG_KEYS)) i32
    action_diag: Any       # (N, len(ACTION_DIAG_KEYS)) i32
    raw_abs_sum: Any
    raw_min: Any
    raw_max: Any
    last_raw_action: Any
    last_coerced_action: Any  # (N,) i32


_DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def make_env_config(config: Dict[str, Any], *, n_bars: int, n_features: int = 0,
                    binary_mask: Tuple[bool, ...] = ()) -> EnvConfig:
    if config.get("execution_cost_profile"):
        raise not_ported("execution cost profiles (contracts.py)", 8)
    if config.get("obs_plugins"):
        raise not_ported("registered obs kernels (obs_plugins)", 9)
    feature_columns = list(config.get("feature_columns") or [])
    collision = str(config.get("intrabar_collision_policy", "worst_case"))
    if collision == "adaptive":
        warnings.warn(
            "intrabar_collision_policy 'adaptive' resolves to 'worst_case' in "
            "the scan engine (no per-bar path data to adapt on); see "
            "DIVERGENCES.md",
            stacklevel=2,
        )
    enforce_margin = bool(config.get("enforce_margin_preflight", False))
    return EnvConfig(
        window_size=int(config.get("window_size", 32)),
        n_bars=int(n_bars),
        n_features=int(n_features),
        binary_mask=tuple(binary_mask),
        feature_clip=float(config.get("feature_clip", 10.0)),
        action_space_mode=str(config.get("action_space_mode", "discrete")).lower(),
        include_prices=bool(config.get("include_price_window", not feature_columns)),
        include_agent_state=bool(config.get("include_agent_state", True)),
        stage_b_force_close_obs=bool(config.get("stage_b_force_close_obs", False)),
        oanda_fx_calendar_obs=bool(
            config.get("oanda_fx_calendar_obs", False)
            or str(config.get("broker_profile") or "").lower() == "oanda_us_fx"
        ),
        event_context_execution_overlay=bool(
            config.get("event_context_execution_overlay", False)
        ),
        event_context_block_new_entries=bool(
            config.get("event_context_block_new_entries", True)
        ),
        event_context_force_flat=bool(config.get("event_context_force_flat", False)),
        strategy=_strategy_kernel_name(config),
        session_filter=bool(config.get("session_filter", False)),
        sltp_risk_mode=str(config.get("sltp_risk_mode", "fixed_atr")).lower(),
        size_mode=str(config.get("size_mode", "fx_units")).lower(),
        atr_period=int(config.get("atr_period", 14)),
        reward=str(config.get("reward_plugin", "pnl_reward")),
        rollout_obs_kernel=str(config.get("rollout_obs_kernel", "off")).lower(),
        rollout_env_kernel=str(config.get("rollout_env_kernel", "off")).lower(),
        sharpe_window=int(config.get("window", config.get("sharpe_window", 64))),
        stage_b_force_close_reward_penalty=bool(
            config.get("stage_b_force_close_reward_penalty", False)
        ),
        venue=str(config.get("venue", "bar")).lower(),
        intrabar_collision_policy=collision,
        limit_fill_policy=str(config.get("limit_fill_policy", "cross")),
        slip_open=bool(config.get("slip_open", True)),
        slip_limit=bool(config.get("slip_limit", False)),
        slip_match=bool(config.get("slip_match", False)),
        enforce_margin_preflight=enforce_margin,
        enforce_margin_closeout=bool(config.get("enforce_margin_closeout", enforce_margin)),
        margin_model=str(config.get("margin_model", "leveraged")),
        financing_enabled=bool(config.get("financing_enabled", False)),
        dtype=_DTYPES[str(config.get("compute_dtype", "float32"))],
    )


def _strategy_kernel_name(config: Dict[str, Any]) -> str:
    name = str(config.get("strategy_plugin", "default_strategy"))
    if name in ("direct_fixed_sltp", "direct_atr_sltp"):
        return name
    if name in ("default", "default_strategy"):
        return "default"
    raise not_ported(f"registered strategy kernel {name!r}", 9)


def make_env_params(config: Dict[str, Any], cfg: EnvConfig,
                    device: torch.device) -> EnvParams:
    if config.get("venue_quantization"):
        raise not_ported("venue quantization (contracts.py instrument specs)", 8)
    d = cfg.dtype
    initial_cash = float(config.get("initial_cash", 10000.0))
    min_equity = config.get("min_equity")
    if min_equity is None:
        min_equity = initial_cash * 0.01
    rel_volume = config.get("rel_volume")
    use_rel = rel_volume is not None

    def f(x) -> torch.Tensor:
        return torch.tensor(float(x), dtype=d, device=device)

    def opt(x, disabled=-1.0) -> torch.Tensor:
        return f(disabled if x is None else x)

    def i32(x) -> torch.Tensor:
        return torch.tensor(int(x), dtype=torch.int32, device=device)

    slippage = config.get("slippage_perc", config.get("slippage", 0.0)) or 0.0
    threshold = config.get("continuous_action_threshold", 0.33)
    return EnvParams(
        initial_cash=f(initial_cash),
        position_size=f(config.get("position_size", 1.0)),
        commission=f(config.get("commission", 0.0)),
        slippage=f(slippage),
        leverage=f(config.get("leverage", 1.0)),
        min_equity=f(min_equity),
        continuous_action_threshold=f(0.33 if threshold is None else threshold),
        reward_scale=f(config.get("reward_scale", 1.0)),
        penalty_lambda=f(config.get("penalty_lambda", 1.0)),
        sl_pips=f(config.get("sl_pips", 20.0)),
        tp_pips=f(config.get("tp_pips", 40.0)),
        pip_size=f(config.get("pip_size", 0.0001)),
        k_sl=f(config.get("k_sl", 2.0)),
        k_tp=f(config.get("k_tp", 3.0)),
        use_rel_volume=f(1.0 if use_rel else 0.0),
        rel_volume=f(rel_volume if use_rel else 0.0),
        min_order_volume=f(config.get("min_order_volume", 0.0)),
        max_order_volume=f(config.get("max_order_volume", 1e12)),
        min_sltp_frac=opt(config.get("min_sltp_frac", 0.001)),
        max_sltp_frac=opt(config.get("max_sltp_frac", 0.20)),
        baseline_rel_volume=f(config.get("baseline_rel_volume", 0.05)),
        max_risk_rel_volume=f(config.get("max_risk_rel_volume", 0.50)),
        rel_volume_sl_shrink_alpha=f(config.get("rel_volume_sl_shrink_alpha", 0.35)),
        rel_volume_tp_shrink_alpha=f(config.get("rel_volume_tp_shrink_alpha", 0.20)),
        min_k_sl=f(config.get("min_k_sl", 1.0)),
        min_reward_risk_ratio=f(config.get("min_reward_risk_ratio", 1.0)),
        max_planned_loss_fraction=opt(config.get("max_planned_loss_fraction")),
        entry_start_mow=i32(
            int(config.get("entry_dow_start", 0)) * 24 * 60
            + int(config.get("entry_hour_start", 12)) * 60
        ),
        force_close_mow=i32(
            int(config.get("force_close_dow", 4)) * 24 * 60
            + int(config.get("force_close_hour", 20)) * 60
        ),
        event_no_trade_threshold=f(config.get("event_context_no_trade_threshold", 0.5)),
        force_close_penalty_coef=f(config.get("force_close_exposure_penalty_coef", 0.0)),
        force_close_penalty_window_hours=f(
            config.get(
                "force_close_exposure_penalty_window_hours",
                config.get("force_close_window_hours", 4),
            )
        ),
        margin_init=f(config.get("margin_init", 0.05)),
        margin_maint=f(config.get("margin_maint", 0.025)),
        price_tick=f(0.0),
        size_step=f(0.0),
        min_qty=f(0.0),
    )


def initial_state(cfg: EnvConfig, n_envs: int, device: torch.device) -> EnvState:
    """A fresh (n_envs,) batch of the JAX package's ``initial_state``."""
    d = cfg.dtype

    def z(*shape, dtype=d):
        return torch.zeros((n_envs, *shape), dtype=dtype, device=device)

    def full(value, dtype=d):
        return torch.full((n_envs,), value, dtype=dtype, device=device)

    zi = lambda: z(dtype=torch.int32)  # noqa: E731
    zb = lambda: z(dtype=torch.bool)  # noqa: E731
    return EnvState(
        t=zi(), started=zb(), terminated=zb(), termination_reason=zi(),
        pos=z(), entry_price=z(), cash_delta=z(), equity_delta=z(),
        prev_equity_delta=z(), commission_paid=z(), last_trade_cost=z(),
        trade_count=zi(), pending_active=zb(), pending_target=z(),
        pending_sl=z(), pending_tp=z(), pending_forced=zb(),
        bracket_sl=z(), bracket_tp=z(), trade_pnl_sum=z(),
        trade_pnl_sumsq=z(), trades_won=zi(), trades_lost=zi(),
        open_trade_commission=z(), peak_equity_delta=z(),
        max_drawdown_money=z(), max_drawdown_pct=z(),
        reward_buffer=z(cfg.sharpe_window), reward_buffer_len=zi(),
        reward_buffer_idx=zi(), reward_peak=full(-np.inf),
        tr_buffer=z(cfg.atr_period), tr_len=zi(), tr_idx=zi(),
        prev_close=full(-1.0),
        price_window=z(cfg.window_size),
        feat_window=z(cfg.window_size, cfg.n_features, dtype=torch.float32),
        exec_diag=z(len(EXEC_DIAG_KEYS), dtype=torch.int32),
        action_diag=z(len(ACTION_DIAG_KEYS), dtype=torch.int32),
        raw_abs_sum=z(), raw_min=full(np.inf), raw_max=full(-np.inf),
        last_raw_action=z(), last_coerced_action=zi(),
    )
