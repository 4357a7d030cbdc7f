"""Population-based training over the portfolio (gymfx_tpu_torch/train/
pbt.py, the member axis of train/portfolio_ppo.py, train/optim.py's
per-member hyperparameters) against the JAX package's
(gymfx_tpu/train/pbt.py).

Small sizes: the three sample pairs' first 20 rows, window 8, a
population of 2 (4 for exploit/explore), 4 envs, horizon 8, the MLP.

* ``init_population``'s learning rates and the other hyperparameters
  equal the JAX package's (numpy draws on both sides, float32 BITWISE).
* ``_exploit_explore`` on the same fitness and numpy generator: the same
  replaced members, donors' params and optimizer state copied (exactly,
  in place), the same perturbed hyperparameters (float32 BITWISE) and
  fitness.
* The population step equals each member stepped alone (P = 1, its own
  params, hyperparameters and books): env rows, obs, actions, rewards and
  dones ``torch.equal`` (the same actions injected), log-probs and values
  within 1e-6, the loss terms within rtol 1e-4, params after the update
  within 8 lr and 99% within 1e-5 (one batched GEMM for both members
  against one member's; tests/test_torch_portfolio_ppo.py's rule),
  gradients clipped by each member's own norm.
* The replacement schedule (every ``interval`` steps, never after the
  last); ``train_pbt_from_config``'s result keys equal the JAX
  package's; a mesh, a profile's mesh events and the performance
  observatory raise naming their items.
"""
import numpy as np
import pytest
import torch

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.core import portfolio as JP
from gymfx_tpu.train import pbt as JPBT

from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core import portfolio as TP
from gymfx_tpu_torch.resilience.guards import tree_leaves
from gymfx_tpu_torch.train import pbt as TPBT

from test_torch_parity import to_np, x64_off

FILES = {"EUR_USD": "examples/data/eurusd_sample.csv",
         "GBP_USD": "examples/data/gbpusd_sample.csv",
         "USD_JPY": "examples/data/usdjpy_sample.csv"}
CONFIG = dict(portfolio_files=FILES, window_size=8, max_rows=20, num_envs=4, ppo_horizon=8,
              ppo_minibatches=2, ppo_epochs=2, policy="mlp", pbt_interval=2,
              portfolio_position_sizes=[3.0, 2.0, 0.1])
LR = 3e-4


def _port(population, **over):
    config = {**DEFAULT_VALUES, **CONFIG, "pbt_population": population, **over}
    env = TP.PortfolioEnvironment(config, device="cpu")
    return TPBT.make_portfolio_pbt(dict(config), TPBT._pbt_config_from(config), env)


def _jax(population, **over):
    config = {**JAX_DEFAULTS, **CONFIG, "pbt_population": population, **over}
    with x64_off():
        env = JP.PortfolioEnvironment(config)
        return JPBT.make_portfolio_pbt(dict(config), JPBT._pbt_config_from(config), env=env)


def test_init_population_draws_the_jax_learning_rates():
    for population, seed in ((2, 0), (4, 7)):
        jp, tp = _jax(population), _port(population)
        with x64_off():
            jstates, jfit = jp.init_population(seed)
        tstate, tfit = tp.init_population(seed)
        for key in ("learning_rate", "clip_eps", "ent_coef"):
            np.testing.assert_array_equal(tp.get_hyper(tstate, key), jp.get_hyper(jstates, key))
        np.testing.assert_array_equal(tfit, jfit)
        assert tstate.opt_state.hyper["learning_rate"].dtype == torch.float32


def test_exploit_explore_replaces_the_jax_members_with_the_jax_values():
    jp, tp = _jax(4), _port(4)
    with x64_off():
        jstates, _ = jp.init_population(3)
    tstate, _ = tp.init_population(3)
    before = {k: v.clone() for k, v in tstate.params.items()}
    mu_before = {k: v.clone() for k, v in tstate.opt_state.mu.items()}
    tstate.opt_state.mu["value.bias"].copy_(torch.arange(4.0)[:, None])
    buffers = [x.data_ptr() for x in tree_leaves((tstate.params, tstate.opt_state))]
    for seed, fitness in ((5, [0.3, -0.1, 0.2, 0.0]), (6, [1.0, 2.0, -3.0, 0.5])):
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
    # the first round replaced member 1 (fitness -0.1) by a copy of the top
    # member's params and moments, in the state's own tensors
    donor = int(np.argmax([0.3, -0.1, 0.2, 0.0]))
    assert [x.data_ptr() for x in tree_leaves((tstate.params, tstate.opt_state))] == buffers
    for k, v in tstate.params.items():
        assert torch.equal(v[0], before[k][0]) and torch.equal(v[3], before[k][3])
    assert float(tstate.opt_state.mu["value.bias"][1]) == float(donor)
    assert torch.equal(tstate.params["value.weight"][1], before["value.weight"][donor])
    del mu_before


def _member(state, m, n_envs, n_pairs):
    """Member ``m``'s slice of a population state, as a P = 1 state."""
    env = state.env_states
    books = slice(m * n_envs, (m + 1) * n_envs)
    rows = slice(m * n_envs * n_pairs, (m + 1) * n_envs * n_pairs)
    pick = lambda x: x[m:m + 1].clone()  # noqa: E731
    return state._replace(
        params={k: pick(v) for k, v in state.params.items()},
        opt_state=type(state.opt_state)(
            pick(state.opt_state.count), {k: pick(v) for k, v in state.opt_state.mu.items()},
            {k: pick(v) for k, v in state.opt_state.nu.items()},
            {k: pick(v) for k, v in state.opt_state.hyper.items()}),
        env_states=TP.PortfolioState(
            pairs=type(env.pairs)(*(x[rows].clone() for x in env.pairs)),
            acct=type(env.acct)(*(x[books].clone() for x in env.acct)),
            swept_realized=env.swept_realized[books].clone(),
            prev_realized_q=env.prev_realized_q[books].clone()),
        obs_vec=pick(state.obs_vec))


def test_the_population_step_equals_each_member_stepped_alone():
    pop = _port(2)
    tr = pop.trainer
    state, _ = pop.init_population(1)
    # distinct hyperparameters: member 1 clips tighter, explores harder
    pop.set_hyper(state, "clip_eps", [0.2, 0.05])
    pop.set_hyper(state, "ent_coef", [0.01, 0.1])
    n, n_pairs, pcfg = tr.pcfg.n_envs, tr.n_pairs, tr.pcfg
    rng = np.random.default_rng(4)
    actions = torch.from_numpy(rng.integers(0, 3, (pcfg.horizon, 2, n, n_pairs)))
    n_perm = n  # env_permute
    perms = torch.from_numpy(np.stack([[rng.permutation(n_perm) for _ in range(pcfg.epochs)]
                                       for _ in range(2)]))
    inter, out = tr.rollout_phase(state, actions=actions)
    new, metrics = tr.update_phase(inter, out, permutations=perms)
    solo = _port(1).trainer
    for m in range(2):
        s = _member(state, m, n, n_pairs)
        s_inter, s_out = solo.rollout_phase(s, actions=actions[:, m:m + 1])
        for k, v in s_out[0].items():
            if k in ("logp", "value"):  # the policy's outputs: one batched GEMM
                np.testing.assert_allclose(to_np(v[:, 0]), to_np(out[0][k][:, m]), rtol=0,
                                           atol=1e-6, err_msg=k)
            else:
                assert torch.equal(v[:, 0], out[0][k][:, m]), k
        want = _member(inter, m, n, n_pairs)
        for a, b in zip(tree_leaves(want.env_states), tree_leaves(s_inter.env_states)):
            assert torch.equal(a, b)
        s_new, s_metrics = solo.update_phase(s_inter, s_out, permutations=perms[m:m + 1])
        for k, v in s_metrics.items():
            np.testing.assert_allclose(to_np(v[0]), to_np(metrics[k][m]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        close = []
        for k, v in s_new.params.items():
            diff = np.abs(to_np(v[0]) - to_np(new.params[k][m]))
            assert diff.max() <= 8 * LR, k
            close.append((diff <= 1e-5).ravel())
        assert np.concatenate(close).mean() >= 0.99
        assert int(s_new.opt_state.count[0]) == int(new.opt_state.count[m]) == 4


def test_replacement_schedule_and_the_result_keys_of_the_jax_package():
    pop = _port(2)
    per_iter = 2 * CONFIG["num_envs"] * CONFIG["ppo_horizon"]
    result = pop.train(5 * per_iter, seed=0)
    assert result["iterations"] == 5 and result["total_env_steps"] == 5 * per_iter
    # every interval (2) steps, never after the last
    assert [r["iter"] for r in result["replacements"]] == [2, 4]
    assert all(len(r["replaced"]) == 1 for r in result["replacements"])
    assert result["best_member"] == int(np.argmax(result["fitness"]))
    assert result["best_params"]["value.bias"].shape == (1, 1)
    result = pop.train(4 * per_iter, seed=0)
    assert [r["iter"] for r in result["replacements"]] == [2]


def test_train_pbt_from_config_writes_the_jax_keys():
    over = dict(train_total_steps=2 * 2 * 4 * 8, eval_split=0.4, max_rows=40,
                pbt_population=2)
    port = TPBT.train_pbt_from_config({**DEFAULT_VALUES, **CONFIG, **over}, device="cpu")
    with x64_off():
        want = JPBT.train_pbt_from_config({**JAX_DEFAULTS, **CONFIG, **over})
    assert sorted(port) == sorted(want)
    assert sorted(port["pbt"]) == sorted(want["pbt"])
    assert sorted(port["in_sample"]) == sorted(want["in_sample"])
    assert (port["trainer"], port["mode"], port["eval_scope"]) == ("pbt_portfolio", "training",
                                                                   "held_out")
    assert port["pbt"]["final_metrics"].keys() == want["pbt"]["final_metrics"].keys()
    assert (port["eval_bars"], port["train_bars"]) == (want["eval_bars"], want["train_bars"])


def test_pbt_without_portfolio_files_and_unported_keys_raise():
    """PBT over the bar venue (no portfolio_files) trains
    (tests/test_torch_pbt_bar.py); with or without a portfolio, a mesh, a
    fault profile's mesh events and the performance observatory's keys
    still raise naming their items."""
    with pytest.raises(NotImplementedError, match="item 17"):
        TPBT.train_pbt_from_config({**DEFAULT_VALUES, "trainer": "pbt", "mesh_shape": "2x2"},
                                   device="cpu")
    with pytest.raises(ValueError, match="not key=value"):
        TPBT.train_pbt_from_config({**DEFAULT_VALUES, **CONFIG, "fault_profile": "x"},
                                   device="cpu")
    for key, value, item in (("mesh_shape", "2x2", 17), ("fault_profile", "mesh=kill:1@2", 17),
                             ("telemetry_compile_watch", True, 30)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            TPBT.train_pbt_from_config({**DEFAULT_VALUES, **CONFIG, key: value}, device="cpu")
