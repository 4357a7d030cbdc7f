"""IMPALA in continuous mode and over a tape library
(gymfx_tpu_torch/train/impala.py) against the JAX package's
(gymfx_tpu/train/impala.py), on the CPU.

* Continuous mode, the MLP and the LSTM twins: the learner's loss on one
  seeded segment (float actions, the actors' Normal log-probs), its terms
  and ``mean_rho = mean(exp(pi_logp - mu_logp))`` within rtol 1e-4 (the
  discrete IMPALA tests' loss tolerance, tests/test_torch_impala.py: the
  jitted V-trace contracts a multiply-add), the gradients within rtol
  1e-4 / atol 1e-6 (float32, ROADMAP Queue 3) against ``jax.grad`` of the
  JAX ``_loss``.
* ``feed=curriculum`` over a two-tape library (compressed tick tapes, 24
  bars, so episodes end inside a phase): four supersteps, each one pick
  of both samplers (the same tape index), the rollout phase on the picked
  tape with the JAX actions injected (obs, actions, rewards, dones and env
  states bitwise; ``mu_logp`` within 1e-5) and the update phase on it
  (loss terms rtol 1e-4, learner params 1e-5, env states bitwise).  The
  last superstep's segment carries a NaN reward: the poisoned env restarts
  from the ACTIVE tape's fresh reset in both packages.
* ``train`` draws one pick a superstep (the JAX picker's sequence), each
  a ``curriculum_pick`` row of the run ledger, and
  ``train_many_with_data`` equals the same train steps one by one.
* A curriculum with ``superstep_overlap`` raises the JAX package's
  ValueError.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.core.runtime import Environment as JaxEnvironment
from gymfx_tpu.data import tapes as jax_tapes
from gymfx_tpu.train.impala import ImpalaTrainer as JaxImpala
from gymfx_tpu.train.impala import impala_config_from as jax_impala_config_from

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core import env as env_core
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.ops import cases
from gymfx_tpu_torch.train.impala import ImpalaTrainer, impala_config_from

from test_torch_parity import (
    assert_bitwise,
    assert_state_bitwise,
    paired_envs,
    random_walk_columns,
    to_np,
    x64_off,
)

HIDDEN = 16
SMALL = dict(window_size=8, num_envs=8, impala_unroll=8, impala_sync_every=2,
             feature_columns=["CLOSE", "VOLUME"], strategy_plugin="direct_fixed_sltp",
             sl_pips=4.0, tp_pips=8.0, reward_plugin="dd_penalized_reward", penalty_lambda=0.5)
KWARGS = {"mlp": {"hidden": [32, 32]}, "lstm": {"hidden": HIDDEN}}


def _params(name, tree):
    return convert.policy_params_from_flax(
        name, jax.tree.map(lambda x: np.asarray(x, np.float32), tree), device="cpu")


def _traced(fn, env):
    """``fn(state, *args)`` jitted with the EnvParams as traced arguments
    (tests/test_torch_impala.py's _traced)."""
    fixed = env.params

    def call(state, params, *args):
        env.params = params
        try:
            return fn(state, *args)
        finally:
            env.params = fixed

    jitted = jax.jit(call)
    return lambda state, *args: jitted(state, fixed, *args)


# ---- continuous mode -----------------------------------------------------------
@pytest.mark.parametrize("policy", ["mlp", "lstm"])
def test_continuous_loss_gradients_and_mean_rho_match_jax(policy):
    jax_env, torch_env = paired_envs(random_walk_columns(n=18, seed=9), policy=policy,
                                     policy_kwargs=KWARGS[policy],
                                     action_space_mode="continuous", **SMALL)
    jt = JaxImpala(jax_env, jax_impala_config_from(jax_env.config))
    tt = ImpalaTrainer(torch_env, impala_config_from(torch_env.config))
    assert tt._continuous
    t, n, d = tt.icfg.unroll, tt.icfg.n_envs, tt.obs_spec.total_size
    rng = np.random.default_rng(4)
    seg = {"obs": rng.normal(size=(t, n, d)).astype(np.float32),
           "action": rng.normal(0, 0.7, size=(t, n)).astype(np.float32),
           "mu_logp": rng.uniform(-1.5, -0.3, size=(t, n)).astype(np.float32),
           "reward": (0.1 * rng.normal(size=(t, n))).astype(np.float32),
           "done": rng.random((t, n)) < 0.15}
    final = rng.normal(size=(n, d)).astype(np.float32)
    init = (tuple((0.5 * rng.normal(size=(n, HIDDEN))).astype(np.float32) for _ in range(2))
            if policy == "lstm" else ())
    name = f"{policy}_continuous"
    with x64_off():
        jparams = jt.init_state(0).learner_params
        (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in seg.items()},
            tuple(jnp.asarray(c) for c in init), jnp.asarray(final))
    loss, aux, grads = tt.loss_and_grads(
        _params(name, jparams), {k: torch.from_numpy(v) for k, v in seg.items()},
        tuple(torch.from_numpy(c) for c in init), torch.from_numpy(final))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4, atol=1e-6)
    for key in ("policy_loss", "value_loss", "entropy", "mean_rho"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    assert float(aux["mean_rho"]) != 1.0
    ref = _params(name, jgrads)
    assert sorted(ref) == sorted(grads)
    for k in ref:
        np.testing.assert_allclose(to_np(grads[k]), to_np(ref[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# ---- feed=curriculum -------------------------------------------------------------
def _library(tmp_path, count=2, n=24):
    paths = []
    for i in range(count):
        path = tmp_path / f"tape{i}.csv"
        cases.write_bar_csv(path, cases.tick_walk_columns(n, seed=20 + i, vol_ticks=30.0),
                            cases.m1_week_grid(n))
        paths.append(path)
    return ",".join(f"file:{p}" for p in paths)


def _curriculum(tmp_path, **over):
    return dict(feed="curriculum", tapes=_library(tmp_path), data_compress="on",
                timeframe="M1", policy="lstm", policy_kwargs={"hidden": HIDDEN},
                curriculum_seed=3, **{**SMALL, **over})


def test_supersteps_over_a_two_tape_library_match_jax_with_injected_draws(tmp_path):
    over = _curriculum(tmp_path)
    with x64_off():
        jenv = JaxEnvironment(dict(JAX_DEFAULTS, **over))
        jt = JaxImpala(jenv, jax_impala_config_from(jenv.config))
    env = Environment(dict(DEFAULT_VALUES, **over), device="cpu")
    tt = ImpalaTrainer(env, impala_config_from(env.config))
    rollout, update = _traced(jt._rollout_phase, jenv), _traced(jt._update_phase, jenv)
    picked, dones = [], 0
    with x64_off():
        js = jt.init_state(0)
        state = tt.init_state(0)._replace(
            learner_params=_params("lstm", js.learner_params),
            actor_params=_params("lstm", js.actor_params))
        for it in range(4):
            ji, _, jtape = jenv.curriculum.pick(it)
            ti, _, tape = env.curriculum.pick(it)
            assert ti == ji
            picked.append(ti)
            js, (traj, init) = rollout(js, jtape)
            state, (ttraj, tinit) = tt.rollout_phase(
                state, tape, actions=torch.from_numpy(np.array(traj["action"])))
            for key in ("obs", "reward", "done", "action"):
                assert_bitwise(traj[key], ttraj[key], f"superstep {it} {key}")
            np.testing.assert_allclose(to_np(ttraj["mu_logp"]), np.asarray(traj["mu_logp"]),
                                       rtol=1e-5, atol=1e-5)
            assert_state_bitwise(js.env_states, state.env_states, f"superstep {it} rollout")
            dones += int(np.asarray(traj["done"]).sum())
            if it == 3:
                # a NaN reward poisons env 2: it restarts from the active tape
                traj = dict(traj, reward=traj["reward"].at[1, 2].set(jnp.nan))
                ttraj["reward"][1, 2] = float("nan")
            js, jm = update(js, (traj, init), jtape)
            state, tm = tt.update_phase(state, (ttraj, tinit), tape)
            for key in ("loss", "policy_loss", "value_loss", "entropy", "mean_rho"):
                np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                           atol=1e-6, err_msg=f"superstep {it} {key}")
            assert float(tm["poisoned_env_resets"]) == float(jm["poisoned_env_resets"])
            assert_state_bitwise(js.env_states, state.env_states, f"superstep {it} update")
            ref = _params("lstm", js.learner_params)
            for k in ref:
                np.testing.assert_allclose(to_np(state.learner_params[k]), to_np(ref[k]),
                                           rtol=0, atol=1e-5, err_msg=f"superstep {it} {k}")
    assert dones > 0 and set(picked) == {0, 1} and picked[3] == 1
    assert float(tm["poisoned_env_resets"]) == 1.0
    fresh, _ = env_core.reset(env.cfg, env.params, tape, 1)
    # tape 1's fresh reset is not the env's own (tape 0's)
    assert not torch.equal(fresh.price_window, tt._reset_state.price_window)
    for name in fresh._fields:
        assert torch.equal(getattr(state.env_states, name)[2], getattr(fresh, name)[0]), name
    assert not state.policy_carry[0][2].any()


def test_train_picks_a_tape_a_superstep_and_train_many_with_data_is_the_steps(tmp_path):
    from gymfx_tpu_torch.telemetry import telemetry_from_config
    from gymfx_tpu_torch.telemetry.ledger import read_ledger

    config = dict(DEFAULT_VALUES, **_curriculum(tmp_path, num_envs=4, impala_unroll=4),
                  telemetry_ledger=str(tmp_path / "ledger.jsonl"))
    trainer = ImpalaTrainer(Environment(config, device="cpu"), impala_config_from(config))
    telemetry = telemetry_from_config(config)
    try:
        _, metrics = trainer.train(5 * 16, seed=1, supersteps_per_dispatch=2, telemetry=telemetry)
    finally:
        telemetry.close()
    assert metrics["iterations"] == 5 and np.isfinite(metrics["loss"])
    picks = trainer.curriculum.picks
    assert [it for it, _ in picks] == [0, 2, 4]
    rows = [r for r in read_ledger(config["telemetry_ledger"]) if r["kind"] == "curriculum_pick"]
    assert [(r["it_start"], r["tape_index"]) for r in rows] == picks
    assert all(r["tape"] == trainer.curriculum.specs[i].label for r, (_, i) in zip(rows, picks))
    ref = jax_tapes._TapePickerBase()
    ref._init_picker(config, jax_tapes.parse_tape_specs(config))
    ref._tape_data = lambda i: None
    assert [i for _, i in picks] == [ref.pick(it)[0] for it, _ in picks]
    tape = trainer.curriculum._tape_data(1)
    s1, m1 = trainer.train_step(trainer.init_state(7), tape)
    s2, m2 = trainer.train_step(s1, tape)
    many, stacked = trainer.train_many_with_data(trainer.init_state(7), tape, 2)
    for key in m1:
        assert_bitwise(torch.stack([m1[key], m2[key]]), stacked[key], key)
    for k in s2.learner_params:
        assert torch.equal(s2.learner_params[k], many.learner_params[k])


def test_curriculum_with_overlap_raises_the_jax_value_error(tmp_path):
    over = _curriculum(tmp_path, superstep_overlap=True, supersteps_per_dispatch=2)
    match = "feed=curriculum cannot be combined with superstep_overlap"
    with x64_off(), pytest.raises(ValueError, match=match):
        jenv = JaxEnvironment(dict(JAX_DEFAULTS, **over))
        JaxImpala(jenv, jax_impala_config_from(jenv.config))
    env = Environment(dict(DEFAULT_VALUES, **over), device="cpu")
    with pytest.raises(ValueError, match=match):
        ImpalaTrainer(env, impala_config_from(env.config))
