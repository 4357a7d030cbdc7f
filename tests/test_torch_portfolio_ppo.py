"""The portfolio policies and PPO trainer (gymfx_tpu_torch/train/
portfolio_ppo.py, train/policies.py ``TransformerPolicy``) against the JAX
package's (gymfx_tpu/train/portfolio_ppo.py, policies.py).

Small sizes: the three sample pairs' first 20 rows (19-step episodes, so
that the third rollout phase auto-resets), window 8, 4 envs, horizon 8,
2 epochs of 2 minibatches; the JAX trainer's params converted
through ``convert.py`` and stacked as one member (P = 1).

* The policies against flax: ``PortfolioMLPPolicy``,
  ``PortfolioTransformerPolicy``, ``PortfolioRingTransformerPolicy`` (K4's
  plain version here) and the single-pair ``TransformerPolicy``, float32
  logits and value within 1e-5 (tests/test_torch_train.py's policy
  tolerance); ``TransformerPolicy`` in bfloat16 within 1e-2 of flax's
  (observed 5.8e-3: XLA keeps float32 between the bf16 ops of its fused
  attention and LayerNorms, the port rounds at each op; the same kind of
  gap as the LSTM's, tests/test_torch_impala.py).  Member-stacked params
  give each member's own outputs (within 1e-6: one batched GEMM).
* The rollout phase with the JAX trainer's actions injected, against the
  jitted ``_rollout_phase``: obs, actions, rewards, dones and the env
  states within rtol 1e-6 / atol 1e-5 (the jitted env step's fused
  multiply-adds, tests/test_torch_portfolio.py); logp, values and the
  bootstrap within 1e-5.
* The update phase from the JAX trainer's trajectory with its
  permutations injected, against the jitted ``_update_phase`` (the MLP
  under both minibatch schemes, the Transformer): tests/test_torch_train.
  py's float32 tolerances (gradients rtol 1e-4, the first layer's atol
  4e-6 against the others' 1e-6 as its inputs reach 151, loss terms rtol 1e-4,
  params within 8 lr and 99% within 1e-5, mu 1e-6, nu 1e-9; see the
  test).
* ``evaluate``'s summary against the JAX package's on the same params:
  every number within rtol 1e-5, the trade counts equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.core import portfolio as JP
from gymfx_tpu.train import portfolio_ppo as JPPO
from gymfx_tpu.train.policies import TransformerPolicy as FlaxTransformer

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core import portfolio as TP
from gymfx_tpu_torch.train import portfolio_ppo as TPPO
from gymfx_tpu_torch.train.policies import TransformerPolicy

from test_torch_parity import to_np, x64_off

FILES = {"EUR_USD": "examples/data/eurusd_sample.csv",
         "GBP_USD": "examples/data/gbpusd_sample.csv",
         "USD_JPY": "examples/data/usdjpy_sample.csv"}
ENV = dict(portfolio_files=FILES, window_size=8, max_rows=20, margin_rate=0.02, leverage=20.0,
           portfolio_position_sizes=[3.0, 2.0, 0.1])
CONVERT = {"mlp": convert.mlp_params_from_flax,
           "transformer": convert.transformer_params_from_flax,
           "transformer_ring": convert.ring_transformer_params_from_flax}


def _envs():
    with x64_off():
        jenv = JP.PortfolioEnvironment({**JAX_DEFAULTS, **ENV})
    return jenv, TP.PortfolioEnvironment({**DEFAULT_VALUES, **ENV}, device="cpu")


def _close(a, b, label, rtol=1e-6, atol=1e-5):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, f"{label}: {a.shape} != {b.shape}"
    if a.dtype.kind in "fc" or b.dtype.kind in "fc":
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64), rtol=rtol,
                                   atol=atol, err_msg=label)
    else:
        np.testing.assert_array_equal(b, a, err_msg=label)


def _trainers(policy, scheme="env_permute"):
    jenv, tenv = _envs()
    kw = dict(n_envs=4, horizon=8, epochs=2, minibatches=2, policy=policy,
              minibatch_scheme=scheme)
    with x64_off():
        jtr = JPPO.PortfolioPPOTrainer(jenv, JPPO.PortfolioPPOConfig(**kw))
        jstate = jtr.init_state(3)
    ttr = TPPO.PortfolioPPOTrainer(tenv, TPPO.PortfolioPPOConfig(**kw))
    params = convert.stack_members([CONVERT[policy](jax.tree.map(np.asarray, jstate.params),
                                                    device="cpu")])
    tstate = ttr.init_state(0)
    tstate = tstate._replace(params=params,
                             opt_state=ttr.optimizer.init_members(params, ttr.initial_hyper()))
    return jtr, jstate, ttr, tstate


def _compare_states(jst, tst, label):
    for f in jst.acct._fields:
        _close(getattr(jst.acct, f), getattr(tst.acct, f), f"{label} acct {f}")
    for f in jst.pairs._fields:
        x = np.asarray(getattr(jst.pairs, f))
        _close(x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]), getattr(tst.pairs, f),
               f"{label} pairs {f}")


@pytest.mark.parametrize("policy", sorted(CONVERT))
def test_portfolio_policies_match_flax(policy):
    jtr, jstate, ttr, tstate = _trainers(policy)
    x = np.random.default_rng(0).normal(size=(5, *ttr.obs_shape)).astype(np.float32)
    with x64_off():
        lj, vj = jax.vmap(lambda v: jtr.policy.apply(jstate.params, v))(jnp.asarray(x))
    lt, vt = ttr.forward(tstate.params, torch.from_numpy(x)[None])
    _close(lj, lt[0], f"{policy} logits", rtol=0, atol=1e-5)
    _close(vj, vt[0], f"{policy} value", rtol=0, atol=1e-5)
    # two members: each one's outputs are its own (one batched GEMM a
    # layer for both; the batch's GEMM may sum in another order than a
    # one-member GEMM: within 1e-6)
    other = {k: v * 0.5 for k, v in tstate.params.items()}
    two = {k: torch.cat([v, other[k]]) for k, v in tstate.params.items()}
    l2, v2 = ttr.forward(two, torch.from_numpy(np.stack([x, x])))
    l1, v1 = ttr.forward(other, torch.from_numpy(x)[None])
    for a, b in ((l2[0], lt[0]), (v2[0], vt[0]), (l2[1], l1[0]), (v2[1], v1[0])):
        _close(b, a, f"{policy} member outputs", rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype,jdtype,tol", [(torch.float32, jnp.float32, 1e-5),
                                              (torch.bfloat16, jnp.bfloat16, 1e-2)])
def test_transformer_policy_matches_flax(dtype, jdtype, tol):
    flax_policy = FlaxTransformer(d_model=32, n_heads=4, n_layers=2, dtype=jdtype)
    x = np.random.default_rng(1).normal(size=(6, 8, 5)).astype(np.float32)
    with x64_off():
        params = flax_policy.init(jax.random.PRNGKey(1), jnp.asarray(x[0]))
        lj, vj = jax.vmap(lambda t: flax_policy.apply(params, t))(jnp.asarray(x))
    policy = TransformerPolicy(5, 8, d_model=32, n_heads=4, n_layers=2, dtype=dtype)
    policy.load_state_dict(convert.transformer_params_from_flax(jax.tree.map(np.asarray, params),
                                                                device="cpu"))
    with torch.no_grad():
        lt, vt = policy(torch.from_numpy(x))
    _close(lj, lt, "logits", rtol=0, atol=tol)
    _close(vj, vt, "value", rtol=0, atol=tol)


def _jax_rollout(jtr, jstate):
    """The JAX trainer's rollout phase, jitted once per trainer."""
    if not hasattr(jtr, "_test_rollout"):
        jtr._test_rollout = jax.jit(jtr._rollout_phase)
    with x64_off():
        return jtr._test_rollout(jstate)


@pytest.mark.parametrize("policy", ["mlp", "transformer"])
def test_rollout_phase_matches_the_jax_trainer(policy):
    jtr, jstate, ttr, tstate = _trainers(policy)
    dones = 0
    for phase in range(3):
        jinter, (jtraj, jboot) = _jax_rollout(jtr, jstate)
        actions = torch.from_numpy(np.asarray(jtraj["action"]))[:, None]
        tinter, (ttraj, tboot) = ttr.rollout_phase(tstate, actions=actions)
        for k in ("obs", "action", "reward", "done"):
            _close(jtraj[k], ttraj[k][:, 0], f"phase {phase} traj {k}")
        for k in ("logp", "value"):
            _close(jtraj[k], ttraj[k][:, 0], f"phase {phase} traj {k}", rtol=0)
        _close(jboot, tboot[0], f"phase {phase} bootstrap", rtol=0)
        _close(jinter.obs_vec, tinter.obs_vec[0], f"phase {phase} obs_vec")
        _compare_states(jinter.env_states, tinter.env_states, f"phase {phase}")
        dones += int(np.asarray(jtraj["done"]).sum())
        jstate, tstate = jinter, tinter
    assert dones > 0  # an episode ended and its books auto-reset


def _jax_permutations(jtr, rng):
    pcfg = jtr.pcfg
    n_perm = pcfg.n_envs if pcfg.minibatch_scheme == "env_permute" else pcfg.n_envs * pcfg.horizon
    _, *ks = jax.random.split(rng, pcfg.epochs + 1)
    return np.stack([np.asarray(jax.random.permutation(k, n_perm)) for k in ks])


LR = 3e-4


@pytest.mark.parametrize("policy,scheme", [("mlp", "env_permute"), ("mlp", "sample_permute"),
                                           ("transformer", "env_permute")])
def test_update_phase_matches_the_jax_trainer(policy, scheme):
    """tests/test_torch_train.py's float32 tolerances: the first
    minibatch's gradients at rtol 1e-4 / atol 1e-6 (4e-6 for the first
    layer's weights, whose inputs reach 151), the loss terms at rtol
    1e-4, mu at 1e-6, nu at 1e-9; every param within 8 lr of JAX's after
    the 4 Adam steps and 99% of them within 1e-5.  Adam steps an element
    by ~lr whatever its gradient's size, and the portfolio obs carries
    columns near zero (returns, flat positions), whose weights' gradients
    are rounding noise that may step either way (observed: 0.6% of the
    MLP's first layer)."""
    from gymfx_tpu.train.common import minibatch_plan

    jtr, jstate, ttr, tstate = _trainers(policy, scheme)
    jinter, (jtraj, jboot) = _jax_rollout(jtr, jstate)
    # the JAX trajectory itself: the jitted env step's rewards differ from
    # the port's in their last bits, which the advantage normalization
    # would carry into the loss
    tout = ({k: torch.from_numpy(np.asarray(v))[:, None] for k, v in jtraj.items()},
            torch.from_numpy(np.asarray(jboot))[None])
    pcfg = jtr.pcfg
    with x64_off():
        perms = _jax_permutations(jtr, jinter.rng)
        jnew, jm = jax.jit(jtr._update_phase)(jinter, (jtraj, jboot))
        advs, rets = jtr._gae(jtraj, jboot)
        fields = {"obs": jtraj["obs"], "action": jtraj["action"], "logp": jtraj["logp"],
                  "adv": advs, "ret": rets}
        _, mb, jtake = minibatch_plan(fields, scheme=scheme, n_envs=pcfg.n_envs,
                                      horizon=pcfg.horizon, minibatches=pcfg.minibatches)
        jgrads = jax.grad(lambda p: jtr._loss(p, jtake(jnp.asarray(perms[0][:mb])))[0])(
            jstate.params)
    tadv, tret = ttr._gae(tout[0], tout[1])
    _, _, take = ttr._minibatch_plan({k: tout[0][k] for k in ("obs", "action", "logp")}
                                     | {"adv": tadv, "ret": tret})
    _, _, tgrads = ttr.loss_and_grads(tstate.params, take(torch.from_numpy(perms[0][:mb])[None]),
                                      tstate.opt_state.hyper)
    want_grads = CONVERT[policy](jax.tree.map(np.asarray, jgrads), device="cpu")
    for k, g in want_grads.items():
        # the first layer reads USD_JPY's prices (~151): its gradients'
        # rounding noise is that much larger (observed 1.2e-6)
        first = k in ("hidden.0.weight", "encoder.embed.weight")
        _close(g, tgrads[k][0], f"grad {k}", rtol=1e-4, atol=4e-6 if first else 1e-6)
    tnew, tm = ttr.update_phase(tstate, tout, permutations=torch.from_numpy(perms)[None])
    for k in ("loss", "policy_loss", "value_loss", "entropy", "mean_reward"):
        _close(jm[k], tm[k][0], f"metric {k}", rtol=1e-4, atol=1e-6)
    adam = jnew.opt_state[1][0]
    assert tnew.opt_state.count.tolist() == [int(adam.count)] == [4]
    close = []
    for k, v in CONVERT[policy](jax.tree.map(np.asarray, jnew.params), device="cpu").items():
        diff = np.abs(to_np(tnew.params[k][0]) - to_np(v))
        assert diff.max() <= 8 * LR, k
        close.append((diff <= 1e-5).ravel())
    assert np.concatenate(close).mean() >= 0.99
    for name, ours, ref, atol in (("mu", tnew.opt_state.mu, adam.mu, 1e-6),
                                  ("nu", tnew.opt_state.nu, adam.nu, 1e-9)):
        for k, v in CONVERT[policy](jax.tree.map(np.asarray, ref), device="cpu").items():
            _close(v, ours[k][0], f"{name} {k}", rtol=0, atol=atol)


def test_evaluate_matches_the_jax_summary():
    jtr, jstate, ttr, tstate = _trainers("mlp")
    with x64_off():
        want = JPPO.evaluate(jtr, jstate.params)
    got = TPPO.evaluate(ttr, tstate.params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-9, err_msg=k)
        else:
            assert got[k] == v, k


def test_the_portfolio_policies_and_encodings():
    _, tenv = _envs()
    state, obs = tenv.reset(2)
    assert sorted(obs) == ["equity_norm", "position", "prices", "returns",
                           "steps_remaining_norm", "unrealized_pnl_norm"]
    tokens = TPPO.tokens_from_obs(obs, 8, min_dims=3)
    # prices and returns are (window, I) a book, the rest broadcast
    assert tokens.shape == (2, 8, 3 + 1 + 3 + 3 + 1 + 3)
    assert TPPO.flatten_obs(obs).shape == (2, 3 + 24 + 24 + 1 + 3 + 1)
    with pytest.raises(ValueError, match="supports policy"):
        TPPO.make_portfolio_policy("lstm", 8, 3, 8)
