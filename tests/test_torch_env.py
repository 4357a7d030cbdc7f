"""The port's env step and episode rollout against the JAX package.

Per step, every EnvState field, every obs block, the reward and the done
flag of ``gymfx_tpu_torch.core.env.step`` (CPU, plain kernel versions)
are held against the jitted ``jax.vmap(gymfx_tpu.core.env.step)`` for
8 envs started at different bars, over 220 bars of seeded random
discrete actions (including the hidden action 3 and out-of-range
values), for the 3 built-in strategies x {pnl, dd} rewards.

Tolerance: BITWISE in f32 where the configuration keeps XLA's fused
multiply-adds exact (unit position sizes, zero commission, bracket
distances of 4 and 8 pips and k_sl = 2: every product a fused
multiply-add could absorb is exact).  With commission
and slippage on, XLA on the CPU contracts ``a - b * c`` inside the
jitted step while the port (and its CUDA kernels, -fmad=false) round
the product first, so the ledger there is pinned at rtol 1e-6 / atol
1e-5 instead (ROADMAP.md Queue 3).

Whole episodes (buy_hold, replay and policy drivers through ``rollout``,
and a replay through ``rollout_chunked``) are pinned BITWISE against the
JAX package's rollouts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.core import env as jenv
from gymfx_tpu.core.rollout import buy_hold_driver as jax_buy_hold
from gymfx_tpu.core.rollout import policy_driver as jax_policy_driver
from gymfx_tpu.core.rollout import replay_driver as jax_replay
from gymfx_tpu.core.rollout import rollout as jax_rollout
from gymfx_tpu.core.rollout import rollout_chunked as jax_rollout_chunked

from gymfx_tpu_torch.core import env as tenv
from gymfx_tpu_torch.core.rollout import (
    buy_hold_driver,
    policy_driver,
    replay_driver,
    rollout_chunked,
)

from test_torch_parity import (
    assert_bitwise,
    paired_envs,
    random_walk_columns,
    to_np,
    x64_off,
)

N_ENVS = 8
STEPS = 220
STRATEGIES = [
    ("default_strategy", {}),
    ("direct_fixed_sltp", {"sl_pips": 4.0, "tp_pips": 8.0}),
    ("direct_atr_sltp", {"atr_period": 5, "k_sl": 2.0, "k_tp": 3.0}),
]
REWARDS = ["pnl_reward", "dd_penalized_reward"]


def _compare(ref, ours, label, exact):
    if exact:
        assert_bitwise(ref, ours, label)
    else:
        np.testing.assert_allclose(to_np(ours), to_np(ref), rtol=1e-6, atol=1e-5, err_msg=label)


def _run(strategy, extra, reward, exact, **over):
    columns = random_walk_columns(n=260, seed=11)
    jax_env, torch_env = paired_envs(
        columns, window_size=8, strategy_plugin=strategy, reward_plugin=reward,
        feature_columns=["OPEN", "CLOSE", "VOLUME"], include_price_window=True,
        feature_scaling_window=32, **extra, **over,
    )
    rng = np.random.default_rng(5)
    t0 = rng.integers(0, 40, N_ENVS).astype(np.int32)
    actions = rng.choice([0, 1, 2, 1, 2, 0, 3, 7, -1], size=(STEPS, N_ENVS)).astype(np.int32)
    cfg, params, data = jax_env.cfg, jax_env.params, jax_env.data
    with x64_off():
        jst, jobs = jax.jit(jax.vmap(jenv.reset_at, in_axes=(None, None, None, 0)),
                            static_argnums=0)(cfg, params, data, jnp.asarray(t0))
        vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, None, None, 0, 0)), static_argnums=0)
        tst, tobs = tenv.reset_at(torch_env.cfg, torch_env.params, torch_env.data,
                                  torch.from_numpy(t0))
        for name in tobs:
            assert_bitwise(jobs[name], tobs[name], f"reset obs {name}")
        trades = 0
        for i in range(STEPS):
            jst, jobs, jr, jd, _ = vstep(cfg, params, data, jst, jnp.asarray(actions[i]))
            before, counters = tst, tst.exec_diag.clone()
            tst, tobs, tr, td, _ = tenv.step(torch_env.cfg, torch_env.params, torch_env.data,
                                             tst, torch.from_numpy(actions[i]))
            # the step adds into its own copy of the counter block
            assert torch.equal(before.exec_diag, counters)
            for name in tst._fields:
                _compare(getattr(jst, name), getattr(tst, name), f"step {i} {name}", exact)
            assert sorted(tobs) == sorted(jobs)
            for name in tobs:
                _compare(jobs[name], tobs[name], f"step {i} obs {name}", exact)
            _compare(jr, tr, f"step {i} reward", exact)
            assert_bitwise(jd, td, f"step {i} done")
        trades = int(tst.trade_count.sum())
    assert trades > N_ENVS  # the ledger really trades


@pytest.mark.parametrize("reward", REWARDS)
@pytest.mark.parametrize("strategy,extra", STRATEGIES, ids=[s for s, _ in STRATEGIES])
def test_step_bitwise_matches_jax_vmap_step(strategy, extra, reward):
    _run(strategy, extra, reward, exact=True)


@pytest.mark.parametrize("strategy", [s for s, _ in STRATEGIES])
def test_step_with_costs_matches_jax_vmap_step(strategy):
    _run(strategy, {}, "dd_penalized_reward", exact=False,
         commission=2e-5, slippage=1e-4, position_size=3.0)


def _episode(driver_pair, steps=300, chunk_size=None, **over):
    """One episode through ``rollout`` (or ``rollout_chunked`` when
    ``chunk_size`` is given) of both packages; outputs pinned bitwise."""
    jax_env, torch_env = paired_envs(random_walk_columns(n=320, seed=2), window_size=16,
                                     strategy_plugin="direct_fixed_sltp", **over)
    with x64_off():
        if chunk_size is None:
            _, ref = jax_rollout(jax_env.cfg, jax_env.params, jax_env.data, driver_pair[0],
                                 steps, jax.random.PRNGKey(0))
            _, ours = torch_env.rollout(driver_pair[1], steps)
        else:
            _, ref = jax_rollout_chunked(jax_env.cfg, jax_env.params, jax_env.data,
                                         driver_pair[0], steps, jax.random.PRNGKey(0),
                                         chunk_size=chunk_size)
            _, ours = rollout_chunked(torch_env.cfg, torch_env.params, torch_env.data,
                                      driver_pair[1], steps, torch.Generator().manual_seed(0),
                                      chunk_size=chunk_size)
    assert sorted(ours) == sorted(ref)
    for name in ours:
        assert_bitwise(ref[name], ours[name][:, 0], f"episode {name}")
    return ref


def test_buy_hold_episode_matches_jax_rollout():
    ref = _episode((jax_buy_hold(), buy_hold_driver()))
    assert int(np.asarray(ref["trade_count"])[-1]) >= 1


def test_replay_episode_matches_jax_rollout():
    actions = np.random.default_rng(4).integers(0, 3, 250)
    ref = _episode((jax_replay(actions), replay_driver(actions)))
    assert int(np.asarray(ref["trade_count"])[-1]) > 5


def test_chunked_episode_matches_jax_rollout_chunked():
    # 150 steps in chunks of 64: two full chunks and a remainder
    actions = np.random.default_rng(6).integers(0, 3, 150)
    ref = _episode((jax_replay(actions), replay_driver(actions)), steps=150, chunk_size=64)
    assert int(np.asarray(ref["trade_count"])[-1]) > 5


def test_policy_driver_episode_matches_jax_rollout():
    # a momentum rule on the last return: long after an up bar, else short
    jax_rule = jax_policy_driver(
        lambda p, obs, key: jnp.where(obs["returns"][-1] > p, 1, 2).astype(jnp.int32), 0.0
    )
    rule = policy_driver(
        lambda p, obs, gen: torch.where(obs["returns"][:, -1] > p, 1, 2).to(torch.int32), 0.0
    )
    ref = _episode((jax_rule, rule), steps=200)
    assert int(np.asarray(ref["trade_count"])[-1]) > 5
