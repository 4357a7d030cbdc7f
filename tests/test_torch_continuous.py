"""Continuous actions (gymfx_tpu_torch/train/policies.py's Gaussian twins,
train/ppo.py and train/pbt.py in ``action_space_mode=continuous``)
against the JAX package's, on the CPU.

* The twins against flax, params crossed through
  ``convert.policy_params_from_flax``: ``mlp_continuous``,
  ``lstm_continuous``, ``transformer_ring_continuous`` and
  ``transformer_continuous`` (the ring encoder's twin in both packages).
  float32: mu, log_std and value within 1e-5.  bfloat16: mu and value
  within 4e-3 for the MLP and LSTM twins (the discrete policies' bf16
  tolerance, tests/test_torch_rollout.py), 2e-2 for the ring twins (the
  ring policy's, same file: flax rounds its softmax and every Dense in
  bf16); log_std exactly (a float32 parameter).
* ``normal_logp`` against the JAX function run op by op within rtol 1e-6
  (XLA's and torch's ``exp`` differ by an ulp on some inputs; observed
  2 of 64 values, 1.6e-7 relative); ``gaussian_entropy`` within rtol 1e-6
  (its mean sums in another order; observed one ulp).
* PPO's rollout phase with the JAX draws injected (its Normal actions and
  start offsets; the threefry and torch streams never match) against the
  jitted JAX phase over four phases on a short tape: obs, float actions,
  rewards, dones and env states bitwise, logp and value within 1e-5.
* The loss and its gradients on one minibatch against ``jax.grad`` of the
  JAX ``_loss``: float32 loss terms within rtol 1e-5, gradients rtol
  1e-4 / atol 1e-6; bfloat16 gradients atol 2e-3 (ROADMAP Queue 3).
* A population member's continuous loss (``_member_loss``, two members
  with their own params and minibatches) against the JAX ``_loss`` of
  each member: rtol 1e-5.
* The greedy evaluation (the driver acts on the mean) against the JAX
  ``evaluate``: the summaries' keys equal, integers equal, floats within
  rtol 1e-6 (tests/test_torch_cli.py's tolerance), on a policy whose mean
  crosses both thresholds.
* An unknown ``*_continuous`` name raises the JAX package's ValueError.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.train import policies as jax_policies
from gymfx_tpu.train.common import build_train_eval_envs as jax_build_train_eval_envs
from gymfx_tpu.train.ppo import PPOTrainer as JaxTrainer
from gymfx_tpu.train.ppo import evaluate as jax_evaluate
from gymfx_tpu.train.ppo import ppo_config_from as jax_ppo_config_from

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.train import policies
from gymfx_tpu_torch.train.common import build_train_eval_envs
from gymfx_tpu_torch.train.ppo import PPOTrainer, evaluate, ppo_config_from

from test_torch_cli import assert_results_match
from test_torch_parity import (
    assert_bitwise,
    assert_state_bitwise,
    paired_envs,
    random_walk_columns,
    to_np,
    x64_off,
)

CSV = str(__import__("pathlib").Path(__file__).resolve().parent.parent
          / "examples" / "data" / "eurusd_sample.csv")
TWINS = {
    "mlp_continuous": dict(hidden=(32, 32)),
    "lstm_continuous": dict(hidden=16),
    "transformer_ring_continuous": dict(window=8, d_model=16, n_heads=2, n_layers=1),
    "transformer_continuous": dict(window=8, d_model=16, n_heads=2, n_layers=1),
}
BF16_TOL = {"mlp_continuous": 4e-3, "lstm_continuous": 4e-3,
            "transformer_ring_continuous": 2e-2, "transformer_continuous": 2e-2}


def _close(a, b, label, tol=1e-5):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=tol, atol=tol, err_msg=label)


def _port_params(name, tree):
    return convert.policy_params_from_flax(
        name, jax.tree.map(lambda x: np.asarray(x, np.float32), tree), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(TWINS))
def test_gaussian_twin_matches_flax(name, dtype):
    rng = np.random.default_rng(0)
    kw = TWINS[name]
    token = "transformer" in name
    x = rng.normal(size=(6, 8, 3) if token else (6, 11)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    flax_policy = jax_policies.make_policy(name, dtype=jdt, **kw)
    recurrent = name.startswith("lstm")
    carry = tuple(rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    with x64_off():
        args = (jnp.asarray(x[0]), flax_policy.initial_carry(())) if recurrent else (x[0],)
        tree = flax_policy.init(jax.random.PRNGKey(1), *args)
        if recurrent:
            (mu, log_std), value, _ = jax.vmap(lambda o, c: flax_policy.apply(tree, o, c))(
                jnp.asarray(x), tuple(jnp.asarray(c).astype(jdt) for c in carry))
        else:
            (mu, log_std), value = jax.vmap(lambda o: flax_policy.apply(tree, o))(jnp.asarray(x))
    policy = policies.make_policy(name, x.shape[-1], dtype=tdt, kwargs=dict(kw))
    assert policies.is_continuous(policy)
    policy.load_state_dict(_port_params(name, tree))
    with torch.no_grad():
        args = ((torch.from_numpy(x), tuple(torch.from_numpy(c).to(tdt) for c in carry))
                if recurrent else (torch.from_numpy(x),))
        (tmu, tlog_std), tvalue = policy(*args)[:2]
    assert tmu.dtype == tlog_std.dtype == tvalue.dtype == torch.float32
    assert tmu.shape == tlog_std.shape == tvalue.shape == (6,)
    tol = 1e-5 if dtype == "float32" else BF16_TOL[name]
    _close(tmu, mu, "mu", tol)
    _close(tvalue, value, "value", tol)
    assert_bitwise(log_std, tlog_std, "log_std")


def test_normal_logp_and_entropy_match_jax():
    rng = np.random.default_rng(1)
    x, mu = (rng.normal(size=64).astype(np.float32) for _ in range(2))
    log_std = (0.4 * rng.normal(size=64)).astype(np.float32)
    with x64_off(), jax.disable_jit():
        ref = jax_policies.normal_logp(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(log_std))
        ent = jax_policies.gaussian_entropy(jnp.asarray(log_std))
    ours = policies.normal_logp(*(torch.from_numpy(a) for a in (x, mu, log_std)))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(policies.gaussian_entropy(torch.from_numpy(log_std))),
                               float(ent), rtol=1e-6, atol=0)
    assert policies.HALF_LOG_2PI == jax_policies.HALF_LOG_2PI
    assert policies.GAUSS_ENTROPY_CONST == jax_policies.GAUSS_ENTROPY_CONST


def test_sample_normal_draws_from_the_generator():
    mu, log_std = torch.zeros(4096), torch.full((4096,), -0.5)
    a = policies.sample_normal(torch.Generator().manual_seed(3), (mu, log_std))
    b = policies.sample_normal(torch.Generator().manual_seed(3), (mu, log_std))
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert abs(float(a.std()) - float(np.exp(-0.5))) < 0.03


def test_unknown_continuous_name_raises_the_jax_value_error():
    with pytest.raises(ValueError, match="unknown policy"):
        jax_policies.make_policy("nonexistent_continuous")
    with pytest.raises(ValueError, match="unknown policy"):
        policies.make_policy("nonexistent_continuous", 4)
    with pytest.raises(ValueError, match="unknown policy"):
        policies.make_policy("nonexistent", 4, continuous=True)


# ---- PPO --------------------------------------------------------------------
SMALL = dict(window_size=8, num_envs=8, ppo_horizon=8, policy="mlp",
             policy_kwargs={"hidden": [32, 32]}, random_episode_start=True,
             feature_columns=["CLOSE", "VOLUME"], strategy_plugin="direct_fixed_sltp",
             sl_pips=4.0, tp_pips=8.0, action_space_mode="continuous",
             continuous_action_threshold=0.3, ppo_minibatches=2)


def _pair(**over):
    jax_env, torch_env = paired_envs(random_walk_columns(n=24, seed=9), **{**SMALL, **over})
    return (JaxTrainer(jax_env, jax_ppo_config_from(jax_env.config)),
            PPOTrainer(torch_env, ppo_config_from(torch_env.config)))


def _jax_phase(trainer):
    """``trainer._rollout_phase`` jitted with the EnvParams as traced
    arguments (tests/test_torch_rollout.py's _jax_phase)."""
    env, fixed = trainer.env, trainer.env.params

    def phase(js, params):
        env.params = params
        try:
            return trainer._rollout_phase(js)
        finally:
            env.params = fixed

    jitted = jax.jit(phase)
    return lambda js: jitted(js, fixed)


def test_rollout_phase_matches_jax_with_injected_normal_draws():
    jt, tt = _pair()
    n = tt.pcfg.n_envs
    state = tt.init_state(0)
    assert tt._continuous and isinstance(tt.policy, policies.ContinuousMLPPolicy)
    dones, kinds = 0, set()
    with x64_off():
        js = jt.init_state(0)
        state = state._replace(params=_port_params("mlp_continuous", js.params))
        phase = _jax_phase(jt)
        for p in range(4):
            _, k0 = jax.random.split(js.rng)
            offsets = np.array(jax.random.randint(k0, (n,), 0, max(1, jt.env.cfg.n_bars - 2)))
            js, (traj, last) = phase(js)
            state, (ttraj, tlast) = tt.rollout_phase(
                state, actions=torch.from_numpy(np.array(traj["action"])),
                start_offsets=torch.from_numpy(offsets))
            assert ttraj["action"].dtype == torch.float32
            for key in ("obs", "reward", "done", "action"):
                assert_bitwise(traj[key], ttraj[key], f"phase {p} traj {key}")
            for key in ("logp", "value"):
                _close(ttraj[key], traj[key], f"phase {p} {key}")
            _close(tlast, last, f"phase {p} bootstrap value")
            assert_state_bitwise(js.env_states, state.env_states, f"phase {p}")
            dones += int(np.asarray(traj["done"]).sum())
            a = np.asarray(traj["action"])
            kinds |= {int(k) for k in np.where(a >= 0.3, 1, np.where(a <= -0.3, 2, 0)).ravel()}
    assert dones > 0 and kinds == {0, 1, 2}  # auto-reset ran; every coerced action occurred


def _batch(tt, m, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(m, tt.obs_dim)).astype(np.float32),
        "action": rng.normal(0, 0.7, size=(m,)).astype(np.float32),
        "logp": rng.uniform(-1.5, -0.3, size=(m,)).astype(np.float32),
        "adv": rng.normal(size=(m,)).astype(np.float32),
        "ret": rng.normal(size=(m,)).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax(dtype):
    jt, tt = _pair(policy_dtype=dtype)
    batch = _batch(tt, 32, seed=2)
    with x64_off():
        jparams = jt.init_state(0).params
        (jloss, jaux), jgrads = jax.value_and_grad(jt._loss, has_aux=True)(
            jparams, {**{k: jnp.asarray(v) for k, v in batch.items()}, "pcarry": ()})
    loss, aux, grads = tt.loss_and_grads(_port_params("mlp_continuous", jparams),
                                         {k: torch.from_numpy(v) for k, v in batch.items()})
    ltol = 1e-5 if dtype == "float32" else 4e-3
    np.testing.assert_allclose(float(loss), float(jloss), rtol=ltol, atol=ltol)
    for key in ("policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=ltol, atol=ltol,
                                   err_msg=key)
    ref = _port_params("mlp_continuous", jgrads)
    assert sorted(ref) == sorted(grads) and "log_std" in grads
    for k in ref:
        if dtype == "float32":
            np.testing.assert_allclose(to_np(grads[k]), to_np(ref[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(to_np(grads[k]), to_np(ref[k]), rtol=0, atol=2e-3,
                                       err_msg=k)
    assert float(grads["log_std"].abs().sum()) > 0


def test_population_member_loss_matches_jax_per_member():
    jt, _ = _pair()
    tt = PPOTrainer(_pair()[1].env, _pair()[1].pcfg, members=2)
    with x64_off():
        members = [jt.init_state(s).params for s in (0, 1)]
    batches = [_batch(tt, 16, seed=s) for s in (3, 4)]
    params = convert.stack_members([_port_params("mlp_continuous", p) for p in members])
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}
    hyper = {"clip_eps": torch.full((2,), tt.pcfg.clip_eps),
             "ent_coef": torch.full((2,), tt.pcfg.ent_coef)}
    with torch.no_grad():
        total, terms = tt._member_loss(params, stacked, hyper)
    assert total.shape == (2,)
    for m in range(2):
        with x64_off():
            jloss, jaux = jt._loss(members[m], {**{k: jnp.asarray(v) for k, v in
                                                  batches[m].items()}, "pcarry": ()})
        np.testing.assert_allclose(float(total[m]), float(jloss), rtol=1e-5, atol=1e-6)
        for key in ("policy_loss", "value_loss", "entropy"):
            np.testing.assert_allclose(float(terms[key][m]), float(jaux[key]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"member {m} {key}")


def test_greedy_evaluation_acts_on_the_mean_as_jax():
    over = dict(input_data_file=CSV, window_size=8, feature_columns=["CLOSE", "VOLUME"],
                num_envs=4, ppo_horizon=8, policy_kwargs={"hidden": [32, 32]},
                timeframe="M1", action_space_mode="continuous",
                continuous_action_threshold=0.1, max_rows=200)
    jcfg, tcfg = dict(JAX_DEFAULTS, **over), dict(DEFAULT_VALUES, **over)
    with x64_off():
        jenv, _ = jax_build_train_eval_envs(jcfg)
        jtr = JaxTrainer(jenv, jax_ppo_config_from(jcfg))
        # a sharper policy: its mean crosses both thresholds
        jparams = jax.tree.map(lambda x: 3.0 * x, jtr.init_state(2).params)
        ref = json.loads(json.dumps(jax_evaluate(jtr, jparams)))
    tenv, _ = build_train_eval_envs(tcfg, device="cpu")
    ttr = PPOTrainer(tenv, ppo_config_from(tcfg))
    ours = json.loads(json.dumps(evaluate(ttr, _port_params("mlp_continuous", jparams))))
    assert_results_match(ref, ours)
    assert ours["trades_total"] >= 2
