"""Episode rollout: the driver loop as a Python loop over batched steps.

The port of ``gymfx_tpu/core/rollout.py`` (lines 31-262).  The JAX
package scans one env's episode; here one loop iteration steps every
env of the batch.  Drivers are (init, act) pairs like the JAX package's,
with a ``torch.Generator`` in place of a PRNG key:

  buy_hold  long on the first step, hold after
  flat      always hold
  random    uniform over {0, 1, 2} per step (torch's stream, not JAX's)
  replay    actions from an array, 0 past its end
  policy    any callable (params, obs, generator) -> action
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from gymfx_tpu_torch.core import env as env_core
from gymfx_tpu_torch.core.broker import sign
from gymfx_tpu_torch.core.types import EXEC_DIAG_INDEX, EnvConfig, EnvParams, EnvState
from gymfx_tpu_torch.data.feed import MarketData


class Driver(NamedTuple):
    """An action source: act(carry, obs, step_index, generator) ->
    ((N,) int32 action, carry)."""

    init: Callable[[], Any]
    act: Callable[[Any, Dict[str, Any], int, torch.Generator], Tuple[Any, Any]]


def _n_and_device(obs):
    x = next(iter(obs.values()))
    return x.shape[0], x.device


def _const_action(value_at):
    def act(carry, obs, i, gen):
        n, device = _n_and_device(obs)
        return torch.full((n,), value_at(i), dtype=torch.int32, device=device), carry

    return act


_BUY_HOLD = Driver(init=lambda: (), act=_const_action(lambda i: 1 if i == 0 else 0))
_FLAT = Driver(init=lambda: (), act=_const_action(lambda i: 0))


def _random_act(carry, obs, i, gen):
    n, device = _n_and_device(obs)
    return torch.randint(0, 3, (n,), generator=gen, dtype=torch.int32,
                         device=gen.device).to(device), carry


_RANDOM = Driver(init=lambda: (), act=_random_act)


def buy_hold_driver() -> Driver:
    return _BUY_HOLD


def flat_driver() -> Driver:
    return _FLAT


def random_driver() -> Driver:
    return _RANDOM


def replay_driver(actions) -> Driver:
    """Replay a host-provided action sequence; 0 past its end."""
    seq = [int(a) for a in actions]
    return Driver(init=lambda: (), act=_const_action(lambda i: seq[i] if i < len(seq) else 0))


def policy_driver(apply_fn: Callable[..., Any], policy_params) -> Driver:
    """Wrap a policy: apply_fn(policy_params, obs, generator) -> action."""

    def act(carry, obs, i, gen):
        return apply_fn(policy_params, obs, gen), carry

    return Driver(init=lambda: (), act=act)


DRIVERS = {
    "buy_hold": buy_hold_driver,
    "flat": flat_driver,
    "random": random_driver,
}


def _collect(params: EnvParams, state: EnvState, reward, done, action) -> Dict[str, Any]:
    return {
        "equity_delta": state.equity_delta,
        "equity": params.initial_cash + state.equity_delta,
        "reward": reward,
        "done": done,
        "action": action.to(torch.int32),
        "position": sign(state.pos).to(torch.int32),
        "trade_count": state.trade_count,
        "bar_index": state.t + 1,
        "pending_active": state.pending_active,
        "pending_target": state.pending_target,
        "pending_sl": state.pending_sl,
        "pending_tp": state.pending_tp,
        "pos_units": state.pos,
        "bracket_sl": state.bracket_sl,
        "bracket_tp": state.bracket_tp,
        "order_denied": state.exec_diag[:, EXEC_DIAG_INDEX["order_denied_min_quantity"]],
    }


def rollout(cfg: EnvConfig, params: EnvParams, data: MarketData, driver: Driver,
            steps: int, generator: torch.Generator, collect: bool = True,
            driver_carry: Any = None, n_envs: int = 1):
    """Run ``n_envs`` episodes for ``steps`` env steps (frozen after
    termination).  Returns (final_state, outputs): outputs maps each
    collected stream to a (steps, n_envs) tensor when ``collect``, else
    is empty.  Event-context info streams are collected too when the
    overlay is on."""
    state, obs = env_core.reset(cfg, params, data, n_envs)
    dcarry = driver.init() if driver_carry is None else driver_carry
    pieces = []
    for i in range(int(steps)):
        action, dcarry = driver.act(dcarry, obs, i, generator)
        state, obs, reward, done, info = env_core.step(cfg, params, data, state, action)
        if collect:
            out = _collect(params, state, reward, done, action)
            if cfg.event_context_execution_overlay:
                out["event_context"] = {
                    k: v for k, v in info.items() if k.startswith("event_context_")
                }
            pieces.append(out)
    if not pieces:
        return state, {}
    return state, _stack(pieces)


def _stack(pieces):
    first = pieces[0]
    if isinstance(first, dict):
        return {k: _stack([p[k] for p in pieces]) for k in first}
    return torch.stack(pieces)


def rollout_chunked(cfg: EnvConfig, params: EnvParams, data: MarketData,
                    driver: Driver, steps: int, generator: torch.Generator,
                    collect: bool = True, driver_carry: Any = None,
                    chunk_size: int = 64, n_envs: int = 1):
    """The JAX package's chunked rollout bounds its compiled program
    length; eager PyTorch compiles nothing, so this is :func:`rollout`
    (``chunk_size`` is validated and kept for call-site compatibility)."""
    if chunk_size < 1:
        raise ValueError("chunk_size must be >= 1")
    return rollout(cfg, params, data, driver, steps, generator, collect,
                   driver_carry, n_envs)
