"""The port's MLP policy and PPO rollout phase against the JAX package.

* Policy: flax MLPPolicy params carried across with
  ``gymfx_tpu_torch.convert.mlp_params_from_flax``; logits and value on
  the same seeded obs.  float32: rtol 1e-5 / atol 1e-5 (the two CPU
  GEMM libraries sum in different orders).  bfloat16: atol 4e-3 / rtol
  4e-3, one bf16 ulp at the outputs' unit scale (2^-8): the hidden layers
  round to bf16, and flax adds the bias after rounding the product while
  torch rounds once after the bias (observed: 3.9e-4 on the logits).
* Rollout phase: ``PPORollout.rollout_phase`` against
  ``PPOTrainer._rollout_phase`` at 8 envs, window 8, F=2, hidden
  (32, 32, 32), horizon 8, random episode starts, 4 phases on a
  24-bar tape (episodes end and auto-reset), with JAX's start
  offsets and sampled actions injected (the threefry and torch streams
  never match).  Env states, obs, rewards and dones: BITWISE (bracket
  distances of 4 and 8 pips keep the products XLA may fuse exact, see
  tests/test_torch_env.py); logp and value: rtol 1e-5 / atol 1e-5 (the
  float32 GEMMs, as above).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.train.policies import MLPPolicy as FlaxMLP
from gymfx_tpu.train.ppo import PPOTrainer
from gymfx_tpu.train.ppo import ppo_config_from as jax_ppo_config_from

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.train.policies import MLPPolicy
from gymfx_tpu_torch.train.ppo import PPORollout, RolloutState, ppo_config_from

from test_torch_parity import (
    assert_bitwise,
    assert_state_bitwise,
    paired_envs,
    random_walk_columns,
    to_np,
    x64_off,
)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 4e-3)])
def test_mlp_policy_matches_flax(dtype, tol):
    obs = np.random.default_rng(0).normal(0, 1, (64, 164)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    flax_policy = FlaxMLP(dtype=jdt)
    with x64_off():
        params = flax_policy.init(jax.random.PRNGKey(3), jnp.asarray(obs[:1]))
        ref_logits, ref_value = flax_policy.apply(params, jnp.asarray(obs))
    policy = MLPPolicy(164, dtype=getattr(torch, dtype))
    policy.load_state_dict(convert.mlp_params_from_flax(jax.tree.map(np.asarray, params), device="cpu"))
    with torch.no_grad():
        logits, value = policy(torch.from_numpy(obs))
    assert logits.dtype == torch.float32 and value.shape == (64,)
    np.testing.assert_allclose(to_np(logits), np.asarray(ref_logits), rtol=tol, atol=tol)
    np.testing.assert_allclose(to_np(value), np.asarray(ref_value), rtol=tol, atol=tol)


def _pair():
    # a short tape, so episodes end inside the test and auto-reset runs
    cols = random_walk_columns(n=24, seed=9)
    over = dict(
        window_size=8, num_envs=8, ppo_horizon=8, policy="mlp",
        policy_kwargs={"hidden": [32, 32, 32]}, random_episode_start=True,
        feature_columns=["CLOSE", "VOLUME"], strategy_plugin="direct_fixed_sltp",
        sl_pips=4.0, tp_pips=8.0,
    )
    jax_env, torch_env = paired_envs(cols, **over)
    return (PPOTrainer(jax_env, jax_ppo_config_from(jax_env.config)),
            PPORollout(torch_env, ppo_config_from(torch_env.config)))


def _jax_phase(trainer):
    """``trainer._rollout_phase`` jitted with the EnvParams as traced
    arguments.  The trainer closes over them, so XLA sees them as
    constants and rewrites ``x / initial_cash`` into ``x * (1 /
    initial_cash)``, one ulp off the division the env step (and the
    port) computes (ROADMAP.md Queue 3); as arguments they stay runtime
    values, as in tests/test_torch_env.py."""
    env = trainer.env
    fixed = env.params

    def phase(js, params):
        env.params = params
        try:
            return trainer._rollout_phase(js)
        finally:
            env.params = fixed

    jitted = jax.jit(phase)
    return lambda js: jitted(js, fixed)


def test_rollout_phase_matches_ppo_trainer_with_injected_draws():
    trainer, ro = _pair()
    n = trainer.pcfg.n_envs
    state = ro.init_state(0)
    with x64_off():
        js = trainer.init_state(0)
        ro.policy.load_state_dict(convert.mlp_params_from_flax(jax.tree.map(np.asarray, js.params),
                                                                  device="cpu"))
        # the draws _rollout makes: start offsets first, then actions
        _, k0 = jax.random.split(js.rng)
        t0s = jax.random.randint(k0, (n,), 0, max(1, trainer.env.cfg.n_bars - 2))
        total = {}
        jax_phase = _jax_phase(trainer)
        for phase in range(4):
            js, (traj, last_value) = jax_phase(js)
            if phase == 0:
                offsets = np.array(t0s)
            else:
                # later phases draw again from the carried key
                _, k0 = jax.random.split(prev_rng)
                offsets = np.array(jax.random.randint(k0, (n,), 0, max(1, trainer.env.cfg.n_bars - 2)))
            prev_rng = js.rng
            state, ttraj, tlast = ro.rollout_phase(
                state, actions=torch.from_numpy(np.array(traj["action"])),
                start_offsets=torch.from_numpy(offsets),
            )
            for key in ("obs", "reward", "done", "action"):
                assert_bitwise(traj[key], ttraj[key], f"phase {phase} traj {key}")
            for key in ("logp", "value"):
                np.testing.assert_allclose(to_np(ttraj[key]), np.asarray(traj[key]),
                                           rtol=1e-5, atol=1e-5, err_msg=key)
            np.testing.assert_allclose(to_np(tlast), np.asarray(last_value), rtol=1e-5, atol=1e-5)
            assert_state_bitwise(js.env_states, state.env_states, f"phase {phase}")
            assert_bitwise(js.obs_vec, state.obs_vec, f"phase {phase} obs_vec")
            total[phase] = int(np.asarray(traj["done"]).sum())
    assert isinstance(state, RolloutState)
    assert sum(total.values()) > 0  # auto-reset ran


def test_rollout_phase_sampling_is_seeded():
    _, ro = _pair()
    a = ro.rollout_phase(ro.init_state(1))[1]
    b = ro.rollout_phase(ro.init_state(1))[1]
    c = ro.rollout_phase(ro.init_state(2))[1]
    assert torch.equal(a["action"], b["action"]) and torch.equal(a["reward"], b["reward"])
    assert not torch.equal(a["action"], c["action"])
    assert set(a["action"].unique().tolist()) <= {0, 1, 2}
