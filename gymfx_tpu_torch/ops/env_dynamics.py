"""K2 and K3: the bar venue's per-step ledger dynamics.

  K2 :func:`fill_brackets` replaces ``gymfx_tpu/ops/env_dynamics.py::
     fused_fill_brackets``: advance-gated ``broker.fill_pending`` ->
     ``broker.check_brackets`` -> financing accrual ``pos * close * rate``,
     plus the ``order_denied_min_quantity`` counter.
  K3 :func:`mark_reward` replaces ``fused_mark_reward``: gated
     ``broker.mark_to_market`` -> drawdown carries -> ``rewards.
     compute_reward`` (pnl or dd); returns the base reward.

The kernels are ``fill_brackets_kernel`` and ``mark_reward_kernel`` in
``csrc/env_kernels.cu``: one thread per env, reading the EnvState field
tensors as structure-of-arrays pointers and writing fresh output tensors
(the input state is left as it was, but for K2's counter column, which
it advances in place).  Beside each wrapper is its plain
version (:func:`fill_brackets_plain`, :func:`mark_reward_plain`): the
same chain of ``core/broker`` / ``core/rewards`` functions that
``core/env.step`` would run.  A CPU tensor runs the plain version; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from gymfx_tpu_torch.core import broker, rewards
from gymfx_tpu_torch.core.types import EXEC_DIAG_INDEX, EnvConfig, EnvParams, EnvState, not_ported
from gymfx_tpu_torch.ops import _build

# the kernels' pointer contract (csrc/env_kernels.cu FillArgs / MarkArgs)
FILL_FLOAT_FIELDS = (
    "pos", "entry_price", "cash_delta", "commission_paid",
    "last_trade_cost", "trade_pnl_sum", "trade_pnl_sumsq",
    "open_trade_commission", "pending_target", "pending_sl",
    "pending_tp", "bracket_sl", "bracket_tp",
)
FILL_BOOL_FIELDS = ("pending_active", "pending_forced")
FILL_INT_FIELDS = ("trade_count", "trades_won", "trades_lost")
FILL_PARAM_FIELDS = ("slippage", "commission", "price_tick", "size_step", "min_qty")
MARK_FLOAT_FIELDS = (
    "pos", "cash_delta", "equity_delta", "prev_equity_delta",
    "peak_equity_delta", "max_drawdown_money", "max_drawdown_pct",
    "reward_peak",
)
MARK_OUT_FIELDS = (
    "equity_delta", "prev_equity_delta", "peak_equity_delta",
    "max_drawdown_money", "max_drawdown_pct", "reward_peak",
)
MARK_PARAM_FIELDS = ("initial_cash", "reward_scale", "penalty_lambda")

_LIMIT_FILL_CODES = {"cross": 0, "touch": 1, "conservative": 2}
_REWARD_CODES = {"pnl_reward": 0, "dd_penalized_reward": 1}


def select(pred, a: EnvState, b: EnvState) -> EnvState:
    """Per env: ``a`` where ``pred`` else ``b``.  A field both states
    share is the same tensor and is passed through (selecting between two
    equal values returns that value)."""
    def one(x, y):
        if x is y:
            return x
        return torch.where(pred.view(-1, *([1] * (x.dim() - 1))), x, y)

    return EnvState(*(one(x, y) for x, y in zip(a, b)))


def fill_brackets_plain(st: EnvState, o, h, l, c, accrual, advance,
                        cfg: EnvConfig, params: EnvParams) -> EnvState:
    """Plain version of K2 (the JAX package's core/env.step steps 1, 2, 2b)."""
    st = select(advance, broker.fill_pending(st, o, params, cfg, h, l), st)
    st = select(advance, broker.check_brackets(st, o, h, l, cfg, params), st)
    if cfg.financing_enabled:
        accrued = st.pos * c * accrual
        st = st._replace(cash_delta=st.cash_delta + torch.where(advance, accrued, 0.0))
    return st


def mark_reward_plain(st: EnvState, c, mark_pred, live, cfg: EnvConfig,
                      params: EnvParams):
    """Plain version of K3 (core/env.step step 4 and the reward block).
    Returns (new_state, base_reward)."""
    st = select(mark_pred, broker.mark_to_market(st, c, params), st)
    return rewards.compute_reward(st, cfg, params, live)


def _cuda_device(st: EnvState, cfg: EnvConfig) -> torch.device:
    device = st.pos.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if cfg.dtype != torch.float32 or st.pos.dtype != torch.float32:
        raise not_ported("the env kernels in a compute dtype other than float32", 7)
    return device


def fill_brackets(st: EnvState, o, h, l, c, accrual, advance, cfg: EnvConfig,
                  params: EnvParams) -> EnvState:
    """K2 on a CUDA state, its plain version on a CPU state.  ``accrual``
    is the bar's financing rate (None unless ``cfg.financing_enabled``).

    The kernel adds the denials to ``st.exec_diag``'s
    ``order_denied_min_quantity`` column in place, so the (N, 17) counter
    block is neither copied nor moved: pass a block you own (core/env.
    transition passes the step's own copy).  The plain version leaves it
    as it was and returns a new block."""
    if st.pos.device.type == "cpu":
        return fill_brackets_plain(st, o, h, l, c, accrual, advance, cfg, params)
    device = _cuda_device(st, cfg)
    n = st.pos.shape[0]
    for name in FILL_FLOAT_FIELDS:
        _build.require(getattr(st, name), name, torch.float32, (n,), device)
    for name in FILL_BOOL_FIELDS:
        _build.require(getattr(st, name), name, torch.bool, (n,), device)
    for name in FILL_INT_FIELDS:
        _build.require(getattr(st, name), name, torch.int32, (n,), device)
    _build.require(advance, "advance", torch.bool, (n,), device)
    bars = [o, h, l, c, accrual if cfg.financing_enabled else None]
    for name, t in zip(("open", "high", "low", "close", "accrual"), bars):
        if t is not None:
            _build.require(t, name, torch.float32, (n,), device)
    for name in FILL_PARAM_FIELDS:
        _build.require(getattr(params, name), f"param {name}", torch.float32, (), device)
    diag = st.exec_diag
    _build.require(diag, "exec_diag", torch.int32, (n, diag.shape[-1]), device)

    outs = {name: torch.empty_like(getattr(st, name))
            for name in FILL_FLOAT_FIELDS + FILL_BOOL_FIELDS + FILL_INT_FIELDS}
    ptrs = _build.pointer_array(
        [getattr(st, k) for k in FILL_FLOAT_FIELDS]
        + [outs[k] for k in FILL_FLOAT_FIELDS]
        + [getattr(st, k) for k in FILL_BOOL_FIELDS]
        + [outs[k] for k in FILL_BOOL_FIELDS]
        + [getattr(st, k) for k in FILL_INT_FIELDS]
        + [outs[k] for k in FILL_INT_FIELDS]
        + [diag, advance] + bars
        + [getattr(params, k) for k in FILL_PARAM_FIELDS]
    )
    lib = _build.load_library()
    if len(ptrs) != lib.gymfx_fill_pointer_count():
        raise RuntimeError("fill_brackets: pointer layout does not match the kernel source")
    flags = (
        (1 if cfg.slip_open else 0)
        | (2 if cfg.slip_limit else 0)
        | (4 if cfg.slip_match else 0)
        | (8 if cfg.financing_enabled else 0)
        | (_LIMIT_FILL_CODES[cfg.limit_fill_policy] << 4)
        | (64 if cfg.intrabar_collision_policy == "ohlc" else 0)
    )
    if n:
        _build.check_launch(
            lib.gymfx_fill_brackets(
                ptrs, n, diag.shape[1], EXEC_DIAG_INDEX["order_denied_min_quantity"],
                flags, torch.cuda.current_stream(device).cuda_stream,
            ),
            "fill_brackets",
        )
        fill_brackets.launches += 1
    return st._replace(**outs)


def mark_reward(st: EnvState, c, mark_pred, live, cfg: EnvConfig,
                params: EnvParams):
    """K3 on a CUDA state, its plain version on a CPU state.  Returns
    (new_state, base_reward)."""
    if st.pos.device.type == "cpu":
        return mark_reward_plain(st, c, mark_pred, live, cfg, params)
    device = _cuda_device(st, cfg)
    n = st.pos.shape[0]
    for name in MARK_FLOAT_FIELDS:
        _build.require(getattr(st, name), name, torch.float32, (n,), device)
    _build.require(c, "close", torch.float32, (n,), device)
    _build.require(mark_pred, "mark_pred", torch.bool, (n,), device)
    _build.require(live, "live", torch.bool, (n,), device)
    for name in MARK_PARAM_FIELDS:
        _build.require(getattr(params, name), f"param {name}", torch.float32, (), device)
    outs = {name: torch.empty_like(getattr(st, name)) for name in MARK_OUT_FIELDS}
    reward = torch.empty_like(st.pos)
    ptrs = _build.pointer_array(
        [getattr(st, k) for k in MARK_FLOAT_FIELDS]
        + [c, mark_pred, live]
        + [outs[k] for k in MARK_OUT_FIELDS]
        + [reward]
        + [getattr(params, k) for k in MARK_PARAM_FIELDS]
    )
    lib = _build.load_library()
    if len(ptrs) != lib.gymfx_mark_pointer_count():
        raise RuntimeError("mark_reward: pointer layout does not match the kernel source")
    if n:
        _build.check_launch(
            lib.gymfx_mark_reward(
                ptrs, n, _REWARD_CODES[cfg.reward],
                torch.cuda.current_stream(device).cuda_stream,
            ),
            "mark_reward",
        )
        mark_reward.launches += 1
    return st._replace(**outs), reward


fill_brackets.launches = 0
mark_reward.launches = 0
