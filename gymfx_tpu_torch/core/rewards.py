"""Reward kernels with explicit carried state, batched over envs.

The port of ``gymfx_tpu/core/rewards.py`` (:26-98): ``pnl_reward``,
``dd_penalized_reward`` and ``sharpe_reward`` (the plain arithmetic of
kernel K3), plus the stage-B force-close penalty.

``sharpe_reward`` sums its (N, W) ring buffer in one fixed order, slot 0
to W - 1, one running float32 sum for x and one for x², so that K3's
sharpe path repeats it exactly (``jnp.sum`` and ``torch.sum`` each pick
an order of their own).  Where every partial sum is exact (returns on a
dyadic grid) the order does not matter and the JAX package agrees bit for
bit.  As in the JAX package, the buffer is not cleared on the terminal
exhausted step (``gymfx_tpu/core/env.py:27-29``); an auto-reset zeroes
it through ``initial_state``.
"""
from __future__ import annotations

import torch

from gymfx_tpu_torch.core.types import EnvConfig, EnvParams, EnvState


def compute_reward(state: EnvState, cfg: EnvConfig, params: EnvParams, active):
    """Return (new_state, base_reward); ``active`` masks carry updates."""
    initial = torch.where(params.initial_cash == 0, 1.0, params.initial_cash)
    r_norm = (state.equity_delta - state.prev_equity_delta) / initial
    if cfg.reward == "pnl_reward":
        return state, torch.where(active, r_norm * params.reward_scale, 0.0)
    if cfg.reward == "sharpe_reward":
        return _sharpe(state, cfg, params, active, r_norm)
    # dd_penalized_reward: peak tracked in delta space from -inf
    peak = torch.where(
        active,
        torch.maximum(
            state.reward_peak,
            torch.maximum(state.equity_delta, state.prev_equity_delta),
        ),
        state.reward_peak,
    )
    peak_positive = (params.initial_cash + peak) > 0
    dd_norm = torch.where(peak_positive, (peak - state.equity_delta) / initial, 0.0)
    reward = r_norm - params.penalty_lambda * dd_norm
    return state._replace(reward_peak=peak), torch.where(active, reward, 0.0)


def ordered_sums(buf):
    """(Σx, Σx²) over the last axis of ``buf``, slot 0 first, each a
    running float32 sum (K3's order)."""
    s = torch.zeros_like(buf[..., 0])
    ss = torch.zeros_like(s)
    for k in range(buf.shape[-1]):
        x = buf[..., k]
        s = s + x
        ss = ss + x * x
    return s, ss


def sqrt_rn(x):
    """The correctly rounded square root (IEEE, as XLA's and CUDA's
    ``sqrtf``): torch's float32 ``sqrt`` on the CPU can be an ulp off it,
    so a float32 input goes through the float64 root, whose rounding to
    float32 is the correctly rounded float32 root (53 >= 2 x 24 + 2)."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def _sharpe(state: EnvState, cfg: EnvConfig, params: EnvParams, active, r_norm):
    """The annualized rolling Sharpe of the normalized step returns: the
    ring write at ``reward_buffer_idx``, then the mean and the sample
    variance over the live slots (empty slots are 0); 0 below two
    samples or at zero spread."""
    w = cfg.sharpe_window
    idx0, n0 = state.reward_buffer_idx, state.reward_buffer_len
    slot = torch.arange(w, device=idx0.device) == idx0.to(torch.int64)[:, None]
    buf = torch.where(active[:, None] & slot, r_norm.to(state.reward_buffer.dtype)[:, None],
                      state.reward_buffer)
    idx = torch.where(active, (idx0 + 1) % w, idx0)
    n = torch.where(active, torch.clamp_max(n0 + 1, w), n0)
    nf = torch.clamp_min(n, 1).to(buf.dtype)
    total, total_sq = ordered_sums(buf)
    mean = total / nf
    var = (total_sq - nf * (mean * mean)) / torch.clamp_min(nf - 1, 1)
    std = sqrt_rn(torch.clamp_min(var, 0.0))
    sharpe = torch.where(
        (n >= 2) & (std > 0),
        mean / torch.where(std > 0, std, 1.0) * sqrt_rn(params.annualization_factor),
        0.0,
    )
    new_state = state._replace(reward_buffer=buf, reward_buffer_idx=idx.to(torch.int32),
                               reward_buffer_len=n.to(torch.int32))
    return new_state, torch.where(active, sharpe, 0.0)


def force_close_penalty(state: EnvState, fc_features, cfg: EnvConfig,
                        params: EnvParams):
    """Stage-B late-Friday exposure penalty; ``fc_features`` is (N, 4)."""
    if not (cfg.stage_b_force_close_obs and cfg.stage_b_force_close_reward_penalty):
        return torch.zeros_like(state.equity_delta)
    hours_to_fc = fc_features[:, 1]
    in_zone = fc_features[:, 2] > 0
    in_window = (hours_to_fc >= 0.0) & (
        hours_to_fc <= torch.clamp_min(params.force_close_penalty_window_hours, 0.0)
    )
    applies = (params.force_close_penalty_coef > 0) & (state.pos != 0) & (in_zone | in_window)
    return torch.where(applies, params.force_close_penalty_coef, 0.0).to(
        state.equity_delta.dtype
    )
