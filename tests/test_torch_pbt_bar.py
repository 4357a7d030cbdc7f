"""Population-based training over the bar venue (gymfx_tpu_torch/train/
pbt.py's default core: train/ppo.PPOTrainer with ``members = P``) against
the JAX package's ``PBTTrainer`` (gymfx_tpu/train/pbt.py: the
``_PBTTrainerCore`` vmapped over stacked member states).

The JAX package's tests/test_pbt.py ``_pbt`` size: window 8, 4 envs,
horizon 8, hidden [16, 16], 1 epoch of 2 minibatches, a population of 4,
on one random-walk tape shared bitwise by both packages.

* ``init_population``'s learning rates and ``_exploit_explore``'s
  replaced members, donors and perturbed hyperparameters are the JAX
  package's, float32 BITWISE (numpy draws on both sides, the same calls
  in the same order); the donors' params and moments are copied exactly,
  in place.
* One population step from the JAX members' params, their learning
  rates and per-member clip and entropy coefficients, the JAX actions
  and permutations injected: the trajectory's obs, rewards, dones and
  actions bitwise, log-probs and values within 1e-5 (bfloat16: 4e-3,
  tests/test_torch_rollout.py's policy tolerance), and after the
  update the metrics, params and Adam moments within
  tests/test_torch_train.py's update-phase tolerances (float32: params
  atol 1e-5, mu 1e-6, nu 1e-9, loss terms rtol 1e-4; bfloat16: params
  within 8 lr and 98% within 1e-4, mu 5e-4, nu 1e-6, loss terms atol
  2e-3: the stored log-probs and values already differ by the bf16
  rollout's rounding, where tests/test_torch_train.py feeds both packages
  one trajectory).
* Each member of a 3-member step equals a single trainer (``members``
  unset) stepped alone on its own params, hyperparameters and env rows:
  for the MLP and the LSTM, every output within 1e-6 (one batched GEMM
  for the members against one plain GEMM).
* ``main --mode training --trainer pbt`` without ``portfolio_files``
  returns the JAX ``train_pbt_from_config``'s keys, and its best-member
  checkpoint runs in the policy mode.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.train import pbt as JPBT
from gymfx_tpu.train.ppo import ppo_config_from as jax_ppo_config_from

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.app.main import main
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.resilience.guards import tree_leaves
from gymfx_tpu_torch.train import pbt as TPBT
from gymfx_tpu_torch.train.ppo import PPOTrainer, eval_policy_from_config, ppo_config_from

from test_torch_parity import assert_bitwise, paired_envs, random_walk_columns, to_np, x64_off

SMALL = dict(window_size=8, num_envs=4, ppo_horizon=8, ppo_epochs=1, ppo_minibatches=2,
             policy_kwargs={"hidden": [16, 16]}, feature_columns=["CLOSE", "VOLUME"])
PBT = dict(population=4, interval=2)
LR = 3e-4


@functools.lru_cache(maxsize=None)
def _pair(dtype: str = "float32"):
    """(JAX PBTTrainer, port PBTTrainer) over one shared tape, with the
    policy in ``dtype``: built once a module (each keeps its compiled
    programs; the tests use the states they return, never the trainers'
    own)."""
    config = {**SMALL, "policy_dtype": dtype}
    jax_env, torch_env = paired_envs(random_walk_columns(n=80, seed=11), **config)
    with x64_off():
        jp = JPBT.PBTTrainer(jax_env, jax_ppo_config_from(jax_env.config),
                             JPBT.PBTConfig(**PBT))
    tp = TPBT.PBTTrainer(torch_env, ppo_config_from(torch_env.config), TPBT.PBTConfig(**PBT))
    return jp, tp


def test_init_population_draws_the_jax_learning_rates():
    jp, tp = _pair()
    for seed in (0, 7):
        with x64_off():
            jstates, jfit = jp.init_population(seed)
        tstate, tfit = tp.init_population(seed)
        for key in ("learning_rate", "clip_eps", "ent_coef"):
            np.testing.assert_array_equal(tp.get_hyper(tstate, key), jp.get_hyper(jstates, key))
        np.testing.assert_array_equal(tfit, jfit)
        assert len(set(tp.get_lrs(tstate).tolist())) == 4
        assert tstate.env_states.t.shape == (16,) and tstate.obs_vec.shape[0] == 16
        assert all(v.shape[0] == 4 for v in tstate.params.values())


def test_exploit_explore_replaces_the_jax_members_with_the_jax_values():
    jp, tp = _pair()
    with x64_off():
        jstates, _ = jp.init_population(3)
    tstate, _ = tp.init_population(3)
    before = {k: v.clone() for k, v in tstate.params.items()}
    tstate.opt_state.mu["value.bias"].copy_(torch.arange(4.0)[:, None])
    buffers = [x.data_ptr() for x in tree_leaves((tstate.params, tstate.opt_state))]
    first = [0.3, -0.1, 0.2, 0.0]
    for seed, fitness in ((5, first), (6, [1.0, 2.0, -3.0, 0.5])):
        fitness = np.asarray(fitness)
        with x64_off():
            jstates, jfit, jrep = jp._exploit_explore(jstates, fitness.copy(),
                                                      np.random.default_rng(seed))
        tstate, tfit, trep = tp._exploit_explore(tstate, fitness.copy(),
                                                 np.random.default_rng(seed))
        assert trep == jrep
        np.testing.assert_array_equal(tfit, jfit)
        for key in ("learning_rate", "clip_eps", "ent_coef"):
            np.testing.assert_array_equal(tp.get_hyper(tstate, key), jp.get_hyper(jstates, key))
    # the first round replaced member 1 (fitness -0.1) by a copy of the
    # top member, in the state's own tensors
    donor = int(np.argmax(first))
    assert [x.data_ptr() for x in tree_leaves((tstate.params, tstate.opt_state))] == buffers
    assert float(tstate.opt_state.mu["value.bias"][1]) == float(donor)
    assert torch.equal(tstate.params["logits.weight"][1], before["logits.weight"][donor])


def _jax_vmapped(core, method):
    """``jax.vmap(core.<method>)`` jitted with the EnvParams as traced
    arguments (tests/test_torch_rollout.py's ``_jax_phase``: closed over,
    XLA folds ``x / initial_cash`` into a multiply, an ulp off)."""
    env = core.env
    fixed = env.params

    def phase(states, params, *args):
        env.params = params
        try:
            return jax.vmap(getattr(core, method))(states, *args)
        finally:
            env.params = fixed

    jitted = jax.jit(phase)
    return lambda states, *args: jitted(states, fixed, *args)


def _member_params(tp, jparams, m):
    return convert.mlp_params_from_flax(jax.tree.map(lambda x: np.asarray(x[m], np.float32),
                                                     jparams), device="cpu")


# (policy-output tol, loss-term rtol, params atol, share of params within
# it, mu atol, nu atol); the policy's outputs as tests/test_torch_rollout.py
# holds them (bf16: one bf16 ulp at unit scale, flax rounds each product
# before its bias)
TOLERANCES = {"float32": (1e-5, (1e-4, 1e-5), 1e-5, 1.0, 1e-6, 1e-9),
              "bfloat16": (4e-3, (5e-3, 2e-3), 1e-4, 0.98, 5e-4, 1e-6)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_population_step_matches_the_jax_population(dtype):
    jp, tp = _pair(dtype)
    tr, core = tp.trainer, jp.trainer
    pcfg = tr.pcfg
    P, N, T = 4, pcfg.n_envs, pcfg.horizon
    clip, ent = [0.2, 0.05, 0.3, 0.1], [0.01, 0.1, 0.001, 0.05]
    with x64_off():
        jstates, _ = jp.init_population(0)
        jstates = jp._set_hyper(jstates, "clip_eps", jnp.asarray(clip, jnp.float32))
        jstates = jp._set_hyper(jstates, "ent_coef", jnp.asarray(ent, jnp.float32))
        # the step the JAX population takes, and its draws: the rollout's
        # actions, then each member's permutations from its carried key
        jnew, jmetrics = _jax_vmapped(core, "_train_step_impl")(jstates)
        inter, (jtraj, jlast) = _jax_vmapped(core, "_rollout_phase")(jstates)
        n_perm = N if pcfg.minibatch_scheme == "env_permute" else N * T
        perms = np.stack([
            np.stack([np.asarray(jax.random.permutation(k, n_perm))
                      for k in jax.random.split(inter.rng[m], pcfg.epochs + 1)[1:]])
            for m in range(P)])
    tstate, _ = tp.init_population(0)
    params = convert.stack_members(_member_params(tp, jstates.params, m) for m in range(P))
    for k, v in tstate.params.items():
        v.copy_(params[k])
    tp.set_hyper(tstate, "clip_eps", clip)
    tp.set_hyper(tstate, "ent_coef", ent)
    for key in ("learning_rate", "clip_eps", "ent_coef"):
        np.testing.assert_array_equal(tp.get_hyper(tstate, key), jp.get_hyper(jstates, key))

    def rows(x):  # (P, T, N, ...) -> (T, P * N, ...)
        x = np.asarray(x)
        return np.swapaxes(x, 0, 1).reshape(T, P * N, *x.shape[3:])

    actions = torch.from_numpy(rows(jtraj["action"]))
    t_inter, (ttraj, tlast) = tr.rollout_phase(tstate, actions=actions)
    for key in ("reward", "done", "action"):
        assert_bitwise(rows(jtraj[key]), ttraj[key], key)
    # obs in the collect dtype (bfloat16 under a bf16 policy), compared as f32
    assert_bitwise(rows(jtraj["obs"]).astype(np.float32), ttraj["obs"].float(), "obs")
    out_tol, l_rtol, p_atol, share, mu_atol, nu_atol = TOLERANCES[dtype]
    for key in ("logp", "value"):
        np.testing.assert_allclose(to_np(ttraj[key]), rows(jtraj[key]), rtol=out_tol,
                                   atol=out_tol)
    np.testing.assert_allclose(to_np(tlast), np.asarray(jlast).reshape(-1), rtol=out_tol,
                               atol=out_tol)
    tnew, tmetrics = tr.update_phase(t_inter, (ttraj, tlast),
                                     permutations=torch.from_numpy(perms))
    for key in ("loss", "policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(to_np(tmetrics[key]), np.asarray(jmetrics[key]),
                                   rtol=l_rtol[0], atol=l_rtol[1], err_msg=key)
    for key in ("nonfinite_skips", "guard_updates", "poisoned_env_resets", "mean_reward",
                "mean_episode_done"):
        # the rewards are bitwise the JAX ones; their means cancel to
        # ~1e-9 here, so the order of the sum shows at 1e-16
        np.testing.assert_allclose(to_np(tmetrics[key]), np.asarray(jmetrics[key]), rtol=1e-6,
                                   atol=1e-12, err_msg=key)
    assert tmetrics["grad_norm"].shape == (P,)
    adam = jnew.opt_state.inner_state[1][0]
    np.testing.assert_array_equal(to_np(tnew.opt_state.count), np.asarray(adam.count))
    close = []
    for m in range(P):
        ref = _member_params(tp, jnew.params, m)
        for k, ours in tnew.params.items():
            diff = np.abs(to_np(ours[m]) - to_np(ref[k]))
            assert diff.max() <= 8 * float(tp.get_lrs(tnew)[m]), (m, k)
            close.append((diff <= p_atol).ravel())
        for name, tree, atol in (("mu", adam.mu, mu_atol), ("nu", adam.nu, nu_atol)):
            ref = _member_params(tp, tree, m)
            for k, ours in getattr(tnew.opt_state, name).items():
                np.testing.assert_allclose(to_np(ours[m]), to_np(ref[k]), rtol=0, atol=atol,
                                           err_msg=f"{name} {m} {k}")
    assert np.concatenate(close).mean() >= share
    # the env rows after the step: the JAX members' batches, member-major
    with x64_off():
        for field in ("t", "equity_delta"):
            assert_bitwise(np.asarray(getattr(jnew.env_states, field)).reshape(P * N),
                           getattr(tnew.env_states, field), field)


def _member_state(tr, state, m, solo):
    """Member ``m`` of a population state as a single trainer's state."""
    n = tr.pcfg.n_envs
    rows = slice(m * n, (m + 1) * n)
    opt = state.opt_state
    params = {k: v[m].clone() for k, v in state.params.items()}
    adam = solo.optimizer.init(params)
    adam = adam._replace(count=opt.count[m].clone(),
                         mu={k: v[m].clone() for k, v in opt.mu.items()},
                         nu={k: v[m].clone() for k, v in opt.nu.items()})
    return state._replace(
        params=params, opt_state=adam,
        env_states=type(state.env_states)(*(x[rows].clone() for x in state.env_states)),
        obs_vec=state.obs_vec[rows].clone(),
        policy_carry=tuple(c[rows].clone() for c in state.policy_carry))


@pytest.mark.parametrize("policy,kwargs", [("mlp", {"hidden": [16, 16]}), ("lstm", {"hidden": 8})])
def test_each_member_equals_a_single_trainer_stepped_alone(policy, kwargs):
    config = {**DEFAULT_VALUES, **SMALL, "policy": policy, "policy_kwargs": kwargs,
              "input_data_file": "examples/data/eurusd_sample.csv"}
    from gymfx_tpu_torch.core.runtime import Environment

    env = Environment(config, device="cpu")
    pcfg = ppo_config_from(config)
    P, N, T = 3, pcfg.n_envs, pcfg.horizon
    pop = PPOTrainer(env, pcfg, members=P)
    state = pop.init_state(5)
    hyper = {"learning_rate": [1e-3, 3e-4, 5e-3], "clip_eps": [0.2, 0.05, 0.3],
             "ent_coef": [0.01, 0.1, 0.0]}
    for key, vals in hyper.items():
        state.opt_state.hyper[key].copy_(torch.tensor(vals))
    rng = np.random.default_rng(2)
    actions = torch.from_numpy(rng.integers(0, 3, (T, P * N)))
    perms = torch.from_numpy(np.stack([[rng.permutation(N) for _ in range(pcfg.epochs)]
                                       for _ in range(P)]))
    inter, out = pop.rollout_phase(state, actions=actions)
    new, metrics = pop.update_phase(inter, out, permutations=perms)
    for m in range(P):
        f32 = {k: float(np.float32(v[m])) for k, v in hyper.items()}
        solo = PPOTrainer(env, pcfg._replace(lr=f32["learning_rate"], clip_eps=f32["clip_eps"],
                                             ent_coef=f32["ent_coef"]))
        s = _member_state(pop, state, m, solo)
        rows = slice(m * N, (m + 1) * N)
        s_inter, s_out = solo.rollout_phase(s, actions=actions[:, rows])
        for k, v in s_out[0].items():
            for a, b in zip(tree_leaves(v), tree_leaves(out[0][k])):
                np.testing.assert_allclose(to_np(a), to_np(b[:, rows]), rtol=0, atol=1e-6,
                                           err_msg=k)
        s_new, s_metrics = solo.update_phase(s_inter, s_out, permutations=perms[m])
        for k, v in s_metrics.items():
            np.testing.assert_allclose(float(v), float(metrics[k][m]), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        for name, ours, mine in (("params", new.params, s_new.params),
                                 ("mu", new.opt_state.mu, s_new.opt_state.mu),
                                 ("nu", new.opt_state.nu, s_new.opt_state.nu)):
            for k, v in mine.items():
                np.testing.assert_allclose(to_np(v), to_np(ours[k][m]), rtol=0, atol=1e-6,
                                           err_msg=f"{name} {k}")
        assert int(s_new.opt_state.count) == int(new.opt_state.count[m]) == pcfg.minibatches
        for a, b in zip(tree_leaves((s_new.env_states, s_new.obs_vec, s_new.policy_carry)),
                        tree_leaves((new.env_states, new.obs_vec, new.policy_carry))):
            np.testing.assert_allclose(to_np(a), to_np(b[rows]), rtol=0, atol=1e-6)


def test_train_pbt_from_config_writes_the_jax_keys_and_a_loadable_checkpoint(tmp_path):
    """``main --mode training --trainer pbt`` without ``portfolio_files``
    (``train_pbt_from_config``'s bar branch): the JAX function's keys, the
    best member's params checkpoint, which ``--driver_mode policy``
    evaluates."""
    over = dict(SMALL, pbt_population=4, pbt_interval=2, eval_split=0.4,
                input_data_file="examples/data/eurusd_sample.csv", max_rows=120)
    (tmp_path / "small.json").write_text(json.dumps(over))
    argv = ["--load_config", str(tmp_path / "small.json"), "--checkpoint_dir",
            str(tmp_path / "ckpt"), "--results_file", str(tmp_path / "results.json"),
            "--save_config", str(tmp_path / "config.json"), "--quiet_mode"]
    port = main(argv + ["--mode", "training", "--trainer", "pbt", "--train_total_steps",
                        str(3 * 4 * 4 * 8)], device="cpu")
    with x64_off():
        want = JPBT.train_pbt_from_config({**JAX_DEFAULTS, **over,
                                           "train_total_steps": 3 * 4 * 4 * 8})
    assert sorted(port) == sorted([*want, "checkpoint_dir"])
    assert sorted(port["pbt"]) == sorted(want["pbt"])
    assert port["pbt"]["final_metrics"].keys() >= want["pbt"]["final_metrics"].keys()
    assert (port["eval_scope"], port["eval_bars"], port["train_bars"]) == (
        want["eval_scope"], want["eval_bars"], want["train_bars"])
    assert port["pbt"]["iterations"] == 3 and [r["iter"] for r in port["pbt"]["replacements"]] \
        == [2]
    meta = json.loads((tmp_path / "ckpt" / "metadata.json").read_text())
    assert meta["state_format"] == "params" and meta["policy"] == "mlp"
    evaluated = main(argv + ["--mode", "inference", "--driver_mode", "policy", "--steps",
                             str(port["eval_bars"] - 1)], device="cpu")
    assert evaluated["checkpoint_step"] == port["pbt"]["total_env_steps"]
    # the best member's held-out summary, again
    for key in ("final_equity", "total_return", "trades_total"):
        assert evaluated[key] == port[key], key
    assert eval_policy_from_config({**DEFAULT_VALUES, **over, "checkpoint_dir":
                                    str(tmp_path / "ckpt"), "steps": 40},
                                   device="cpu")["checkpoint_step"] == evaluated["checkpoint_step"]
