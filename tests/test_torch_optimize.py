"""The GA (gymfx_tpu_torch/train/optimize.py) against the JAX package's
(gymfx_tpu/train/optimize.py).

* The fitness episode's action stream: the port's threefry draws (one
  ``split`` and ``randint(k, (), 0, 3)`` a step from ``PRNGKey(seed)``)
  equal the JAX package's, element for element.
* ``Optimizer._fitness`` at P = 4 over 64 steps against the JAX
  package's vmapped, jitted fitness on the same population: rap, total
  return and drawdown within rtol 1e-6 / atol 1e-11 (XLA:CPU contracts
  the ledger's ``a ± b * c`` into FMAs and divides by a reciprocal in the
  jitted episode, ROADMAP Queue 3; at a position of one unit the values
  are ~1e-6 and agree to ~1e-13), trades equal.
* ``optimize_from_config`` at P = 4, 2 generations, 64 steps and an
  ``atr_period`` grid of two: the same ranks in every generation's
  history, the same ``best_params``, the same result keys (the port adds
  ``capture_seconds``), the held-out label with ``eval_split``.
* The population through its chunk graphs' static buffers
  (``eager=False``, PhaseGraph's CPU mode) equals the eager episode, in
  a first generation and in a second one whose values are copied into
  the same buffers; the candidates score apart in both.
* ``atr_period_grid`` / ``atr_period_bounds``: the JAX package's rules
  and errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.core.runtime import Environment as JaxEnvironment
from gymfx_tpu.train import optimize as J
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.train import optimize as T

from test_torch_parity import x64_off

CSV = "examples/data/eurusd_sample.csv"
RTOL, ATOL = 1e-6, 1e-11
# commission reaches K2's params as a per-row column and separates the
# candidates in every episode
SCHEMA = {"k_sl": [1.0, 4.0], "commission": [0.0, 0.0002]}
BASE = dict(input_data_file=CSV, strategy_plugin="direct_atr_sltp", steps=64, seed=3,
            optimize_population=4, optimize_generations=2, optimize_params=SCHEMA)


def _configs(**over):
    return {**JAX_DEFAULTS, **BASE, **over}, {**DEFAULT_VALUES, **BASE, **over}


@pytest.mark.parametrize("seed", [0, 3, 2**32 - 1])
def test_action_stream_is_the_jax_package_s(seed):
    rng, want = jax.random.PRNGKey(seed), []
    for _ in range(40):
        rng, k = jax.random.split(rng)
        want.append(int(jax.random.randint(k, (), 0, 3, dtype=jnp.int32)))
    ours = T.episode_actions(seed, 40)
    assert ours.dtype == np.int32 and ours.tolist() == want


def test_fitness_matches_the_jax_package_s():
    jcfg, tcfg = _configs(atr_period=7)
    schema = T.hparam_schema(tcfg)
    assert schema == J.hparam_schema(jcfg)
    pop = np.random.default_rng(0).uniform([1.0, 0.0], [4.0, 2e-4], size=(4, 2))
    ours = [x.numpy() for x in T.Optimizer(Environment(tcfg, device="cpu"), schema,
                                           population=4, episode_steps=64)._fitness(pop, 3)]
    with x64_off():
        jopt = J.Optimizer(JaxEnvironment(jcfg), schema, population=4, episode_steps=64)
        want = [np.asarray(x) for x in jopt._fitness(jnp.asarray(pop, jnp.float32),
                                                      jax.random.PRNGKey(3))]
    for name, a, b in zip(("rap", "total_return", "dd_fraction"), ours, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(ours[3], want[3])
    assert len(set(ours[0].tolist())) == 4  # every candidate scored apart


@pytest.mark.parametrize("over", [
    dict(optimize_atr_periods=[7, 14]),
    dict(atr_period=14, eval_split=0.25),
], ids=["sweep", "held-out"])
def test_ga_ranks_and_winner_match_the_jax_package_s(over):
    jcfg, tcfg = _configs(**over)
    ours = T.optimize_from_config(tcfg, device="cpu")
    with x64_off():
        want = J.optimize_from_config(jcfg)
    assert sorted(ours) == sorted([*want, "capture_seconds"])
    assert ours["best_params"] == want["best_params"]
    assert ours["schema"] == want["schema"]
    assert ours["boundary_clipped"] == want["boundary_clipped"]
    assert ours["selection_signal"] == want["selection_signal"] is True
    assert ours["capture_seconds"] == 0.0  # nothing is captured on the CPU
    np.testing.assert_allclose(ours["best_rap"], want["best_rap"], rtol=RTOL, atol=ATOL)
    for a, b in zip(ours["history"], want["history"]):
        assert a["best_candidate"] == b["best_candidate"]
        for key in ("best_rap", "mean_rap", "rap_std"):
            np.testing.assert_allclose(a[key], b[key], rtol=RTOL, atol=ATOL, err_msg=key)
    for key in ("eval_scope", "eval_note"):
        assert ours[key] == want[key]
    if "atr_period_sweep" in want:
        assert [s["best_params"] for s in ours["atr_period_sweep"]] == \
            [s["best_params"] for s in want["atr_period_sweep"]]
    if "held_out" in want:
        for key, value in want["held_out"].items():
            if isinstance(value, float):
                np.testing.assert_allclose(ours["held_out"][key], value, rtol=RTOL, atol=ATOL)
            else:
                assert ours["held_out"][key] == value, key


def test_population_through_its_chunk_graphs_equals_eager():
    _, tcfg = _configs(atr_period=7, steps=130)
    env = Environment(tcfg, device="cpu")
    schema = T.hparam_schema(tcfg)
    pop = np.random.default_rng(1).uniform([1.0, 0.0], [4.0, 2e-4], size=(4, 2))
    graphed = T.Optimizer(env, schema, population=4, episode_steps=130, eager=False)
    eager = T.Optimizer(env, schema, population=4, episode_steps=130, eager=True)
    first = [x.clone() for x in graphed._fitness(pop, 3)]
    assert sorted(k[0] for k in env.episode_graphs.graphs) == [2, 64]
    for a, b, c in zip(first, graphed._fitness(pop, 3), eager._fitness(pop, 3)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert len(set(first[0].tolist())) == 4  # the candidates score apart
    # a new generation's values replay the same graphs, and its fitness
    # is the eager episode's on those values
    pop2 = np.random.default_rng(2).uniform([1.0, 0.0], [4.0, 2e-4], size=(4, 2))
    second = [x.clone() for x in graphed._fitness(pop2, 3)]
    assert len(env.episode_graphs.graphs) == 2
    for a, c in zip(second, eager._fitness(pop2, 3)):
        assert torch.equal(a, c)
    assert len(set(second[0].tolist())) == 4 and not torch.equal(first[0], second[0])


def test_unknown_hyperparameter_and_small_population_raise():
    _, tcfg = _configs()
    env = Environment(tcfg, device="cpu")
    with pytest.raises(ValueError, match="unknown hyperparameter 'nope'"):
        T.Optimizer(env, [("nope", 0.0, 1.0)])
    with pytest.raises(ValueError, match="optimize_population must be >= 2"):
        T.Optimizer(env, T.DEFAULT_SCHEMA, population=1)


@pytest.mark.parametrize("config", [
    {},
    {"strategy_plugin": "direct_atr_sltp"},
    {"strategy_plugin": "direct_atr_sltp", "atr_period": 14},
    {"strategy_plugin": "direct_atr_sltp", "optimize_params": {"atr_period": [5, 11]}},
    {"strategy_plugin": "direct_atr_sltp", "optimize_params": '{"atr_period": [8, 20]}'},
    {"optimize_atr_periods": "[21, 7, 14, 7]"},
    {"optimize_atr_periods": 9},
    {"optimize_atr_periods": [3, 7]},
    {"optimize_atr_periods": "[7,"},
    {"optimize_params": {"atr_period": [0, 5]}, "optimize_atr_periods": [3]},
], ids=["none", "atr-default", "atr-pinned", "override", "override-json", "explicit",
        "scalar", "out-of-range", "bad-json", "bad-bounds"])
def test_atr_period_grid_follows_the_jax_rules(config):
    try:
        want = J.atr_period_grid(config)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            T.atr_period_grid(config)
        assert str(ours.value) == str(e)
        return
    assert T.atr_period_grid(config) == want
    assert T.atr_period_bounds(config) == J.atr_period_bounds(config)


def test_atr_period_declared_but_not_swept_raises():
    _, tcfg = _configs(atr_period=14, optimize_params={"atr_period": [7, 30], "k_sl": [1, 4]})
    with pytest.raises(ValueError, match="declares atr_period but nothing sweeps it"):
        T.optimize_from_config(tcfg, device="cpu")
