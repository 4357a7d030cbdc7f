"""The port's PPO update phase and its parts against the JAX package.

* Guards: ``tree_all_finite``, ``select_tree`` and ``quarantine_mask``
  against ``gymfx_tpu.resilience.guards``: exact (bool results).
* Optimizer: ``ClipAdam`` against ``optax.chain(clip_by_global_norm,
  adam)`` for four steps, ``mu_dtype`` float32 and bfloat16, the clip
  triggering on two of them.  rtol 1e-6 / atol 1e-9 on params and
  moments: the same f32 ops in the same order, but ``b ** count`` may
  come from different pow implementations (an ulp).
* ``minibatch_plan`` under both schemes: exact gathers; the scheme
  checks: the same errors and warnings.
* GAE against ``PPOTrainer._gae`` with dones inside the horizon: rtol
  1e-6 / atol 1e-7 (XLA:CPU may fuse the multiply-adds of a jitted
  scan, ROADMAP.md Queue 3).
* One whole update phase from the same params, the same trajectory and
  the JAX permutations, against ``PPOTrainer._update_phase`` (guard on):
  the MLP in f32 and bf16 under both schemes, and transformer_ring in
  f32, 2 epochs x 2 minibatches.  float32: the first minibatch's
  gradients at rtol 1e-4 / atol 1e-6 (the CPU GEMM libraries sum in
  different orders; observed 2e-7), the loss terms at rtol 1e-4, the
  params after 4 Adam steps at atol 1e-5 (observed 2.5e-6), mu at 1e-6,
  nu at 1e-9.  bfloat16: flax rounds each bf16 product before its bias,
  torch once after it (ROADMAP.md Queue 3), so gradients differ by up to
  a few % of the largest (atol 2e-3; observed 8.5e-4), the loss terms at
  rtol 5e-3 (observed 7e-4), mu at 5e-4, nu at 1e-6, and 98% of the
  params at 1e-4.  Adam steps an element by ~lr whatever its gradient's
  size, so an element whose gradient is rounding noise may step the
  other way: every param stays within 8 lr of JAX's.  The attention's
  key bias has an exact gradient of zero (it adds a constant to a row of
  scores), so it is held only to that bound.
* The NaN guard: a NaN reward in one env skips exactly the minibatch
  updates JAX skips and quarantines the same env.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gymfx_tpu.resilience import guards as jguards
from gymfx_tpu.train.common import minibatch_plan as jax_minibatch_plan
from gymfx_tpu.train.common import resolve_minibatch_scheme as jax_resolve
from gymfx_tpu.train.common import validate_minibatch_scheme as jax_validate
from gymfx_tpu.train.ppo import PPOTrainer as JaxTrainer
from gymfx_tpu.train.ppo import ppo_config_from as jax_ppo_config_from

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.resilience import guards
from gymfx_tpu_torch.train.common import (
    minibatch_plan,
    resolve_minibatch_scheme,
    validate_minibatch_scheme,
)
from gymfx_tpu_torch.train.optim import ClipAdam, apply_updates, global_norm
from gymfx_tpu_torch.train.ppo import (
    PPOTrainer,
    TrainState,
    ppo_config_from,
    resolve_optimizer_state_dtype,
)

from test_torch_parity import assert_bitwise, paired_envs, random_walk_columns, to_np, x64_off


# ---- guards ------------------------------------------------------------
def _poisoned_tree(rng):
    a = rng.normal(size=(4, 5, 3)).astype(np.float32)
    a[2, 3, 1] = np.nan
    b = rng.normal(size=(4, 5)).astype(np.float32)
    b[0, 1] = np.inf
    c = np.zeros((4, 5), np.int32)
    return {"a": a, "b": b, "c": c}


def test_guards_match_jax():
    rng = np.random.default_rng(0)
    tree = _poisoned_tree(rng)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    with x64_off():
        jtree = {k: jnp.asarray(v) for k, v in tree.items()}
        for sub in ({"b": tree["b"][:, 2:]}, tree, {"c": tree["c"]}):
            ref = bool(jguards.tree_all_finite({k: jnp.asarray(v) for k, v in sub.items()}))
            assert bool(guards.tree_all_finite({k: torch.from_numpy(v) for k, v in sub.items()})) == ref
        for mode in ("nonfinite", "nan"):
            for axis in (0, 1):
                ref = np.asarray(jguards.quarantine_mask(jtree, env_axis=axis, mode=mode))
                ours = guards.quarantine_mask(ttree, env_axis=axis, mode=mode)
                np.testing.assert_array_equal(to_np(ours), ref, err_msg=f"{mode} axis {axis}")
        old = {"a": jnp.zeros(3), "n": (jnp.ones(2), jnp.arange(2))}
        new = {"a": jnp.ones(3), "n": (jnp.zeros(2), jnp.arange(2) + 5)}
        t_old = {"a": torch.zeros(3), "n": (torch.ones(2), torch.arange(2))}
        t_new = {"a": torch.ones(3), "n": (torch.zeros(2), torch.arange(2) + 5)}
        for pred in (True, False):
            ref = jguards.select_tree(jnp.asarray(pred), new, old)
            ours = guards.select_tree(torch.tensor(pred), t_new, t_old)
            assert_bitwise(ref["a"], ours["a"])
            assert_bitwise(ref["n"][0], ours["n"][0])
            np.testing.assert_array_equal(np.asarray(ref["n"][1]), to_np(ours["n"][1]))
    with pytest.raises(ValueError, match="mode"):
        guards.quarantine_mask(ttree, mode="inf")


# ---- optimizer ----------------------------------------------------------
@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_clip_adam_matches_optax_chain(mu_dtype):
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(6, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    # gradient scales: steps 0 and 2 clip (global norm > 0.5), 1 and 3 do not
    grads = [{k: (s * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
             for s in (3.0, 0.01, 5.0, 0.02)]
    opt = optax.chain(optax.clip_by_global_norm(0.5),
                      optax.adam(3e-4, mu_dtype=getattr(jnp, mu_dtype)))
    ours = ClipAdam(3e-4, 0.5, getattr(torch, mu_dtype))
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tstate = ours.init(tparams)
    with x64_off():
        jparams = {k: jnp.asarray(v) for k, v in params.items()}
        jstate = opt.init(jparams)
        for step, g in enumerate(grads):
            jupd, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
            jparams = optax.apply_updates(jparams, jupd)
            tg = {k: torch.from_numpy(v) for k, v in g.items()}
            tupd, tstate, g_norm = ours.update(tg, tstate)
            tparams = apply_updates(tparams, tupd)
            np.testing.assert_allclose(float(g_norm), float(optax.global_norm(g)), rtol=1e-6)
            assert (float(g_norm) >= 0.5) == (step % 2 == 0)
            adam = jstate[1][0]
            assert int(tstate.count) == int(adam.count) == step + 1
            for k in params:
                np.testing.assert_allclose(to_np(tparams[k]), np.asarray(jparams[k]),
                                           rtol=1e-6, atol=1e-9, err_msg=f"step {step} {k}")
                assert tstate.mu[k].dtype == getattr(torch, mu_dtype)
                np.testing.assert_allclose(to_np(tstate.mu[k]), np.asarray(adam.mu[k], np.float32),
                                           rtol=1e-6, atol=1e-9, err_msg=f"mu {k}")
                np.testing.assert_allclose(to_np(tstate.nu[k]), np.asarray(adam.nu[k]),
                                           rtol=1e-6, atol=1e-12, err_msg=f"nu {k}")
    assert float(global_norm({"x": torch.tensor([3.0, 4.0])})) == 5.0


def test_optimizer_state_dtype_resolution():
    assert resolve_optimizer_state_dtype({}) == torch.float32
    assert resolve_optimizer_state_dtype({"optimizer_state_dtype": "BFloat16"}) == torch.bfloat16
    with pytest.raises(ValueError, match="optimizer_state_dtype"):
        resolve_optimizer_state_dtype({"optimizer_state_dtype": "float16"})


# ---- minibatching -------------------------------------------------------
@pytest.mark.parametrize("scheme", ["env_permute", "sample_permute"])
def test_minibatch_plan_matches_jax(scheme):
    rng = np.random.default_rng(2)
    t, n, mbs = 4, 6, 3
    fields = {"obs": rng.normal(size=(t, n, 5)).astype(np.float32),
              "action": rng.integers(0, 3, (t, n)).astype(np.int32)}
    with x64_off():
        jn, jmb, jtake = jax_minibatch_plan({k: jnp.asarray(v) for k, v in fields.items()},
                                            scheme=scheme, n_envs=n, horizon=t, minibatches=mbs)
        n_perm, mb, take = minibatch_plan({k: torch.from_numpy(v) for k, v in fields.items()},
                                          scheme=scheme, n_envs=n, horizon=t, minibatches=mbs)
        assert (n_perm, mb) == (jn, jmb)
        perm = rng.permutation(n_perm)
        for i in range(mbs):
            idx = perm[i * mb:(i + 1) * mb]
            ref, ours = jtake(jnp.asarray(idx)), take(torch.from_numpy(idx))
            for k in fields:
                assert_bitwise(ref[k], ours[k], f"{scheme} mb {i} {k}")


def test_minibatch_scheme_checks_match_jax():
    for args in (("bogus", 8, 4), ("env_permute", 10, 4)):
        with pytest.raises(ValueError) as ref:
            jax_validate(*args)
        with pytest.raises(ValueError, match=str(ref.value).split("(")[0].strip()):
            validate_minibatch_scheme(*args)
    with pytest.warns(UserWarning, match="drops 2 of 30"):
        validate_minibatch_scheme("sample_permute", 10, 4, horizon=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        validate_minibatch_scheme("sample_permute", 8, 4, horizon=3)
    for n_envs in (2, 8):
        ours, ref = {"ppo_minibatch_scheme": "env_permute"}, {"ppo_minibatch_scheme": "env_permute"}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            resolve_minibatch_scheme(ours, n_envs, 4)
            jax_resolve(ref, n_envs, 4)
        assert ours == ref


# ---- GAE and the whole update phase --------------------------------------
def _pair(policy="mlp", dtype="float32", scheme="env_permute", **over):
    cols = random_walk_columns(n=48, seed=5)
    kwargs = {"hidden": [16, 16, 16]} if policy == "mlp" else \
        {"d_model": 32, "n_heads": 2, "n_layers": 2}
    config = dict(
        window_size=16 if policy != "mlp" else 8, num_envs=8, ppo_horizon=8, ppo_epochs=2,
        ppo_minibatches=2, policy=policy, policy_kwargs=kwargs, policy_dtype=dtype,
        ppo_minibatch_scheme=scheme, feature_columns=["CLOSE", "VOLUME"],
    )
    config.update(over)
    jax_env, torch_env = paired_envs(cols, **config)
    return (JaxTrainer(jax_env, jax_ppo_config_from(jax_env.config)),
            PPOTrainer(torch_env, ppo_config_from(torch_env.config)))


def _trajectory(trainer, seed=0):
    """A seeded trajectory of the trainer's shapes (numpy)."""
    rng = np.random.default_rng(seed)
    t, n = trainer.pcfg.horizon, trainer.pcfg.n_envs
    return {
        "obs": rng.normal(size=(t, n, *trainer.obs_shape)).astype(np.float32),
        "action": rng.integers(0, 3, (t, n)).astype(np.int32),
        "logp": rng.uniform(-1.6, -0.6, (t, n)).astype(np.float32),
        "value": (0.5 * rng.normal(size=(t, n))).astype(np.float32),
        "reward": (0.1 * rng.normal(size=(t, n))).astype(np.float32),
        "done": rng.random((t, n)) < 0.15,
    }, (0.5 * rng.normal(size=(n,))).astype(np.float32)


def _jax_traj(traj, collect_dtype):
    out = {k: jnp.asarray(v) for k, v in traj.items()}
    out["obs"] = out["obs"].astype(collect_dtype)
    out["pcarry"] = ()
    return out


def _torch_traj(traj, collect_dtype):
    out = {k: torch.from_numpy(v) for k, v in traj.items()}
    out["obs"] = out["obs"].to(collect_dtype)
    return out


def test_gae_matches_ppo_trainer():
    jt, tt = _pair()
    traj, last = _trajectory(tt, seed=3)
    assert traj["done"].any()
    with x64_off():
        ref_adv, ref_ret = jax.jit(jt._gae)(_jax_traj(traj, jnp.float32), jnp.asarray(last))
    adv, ret = tt._gae(_torch_traj(traj, torch.float32), torch.from_numpy(last))
    np.testing.assert_allclose(to_np(adv), np.asarray(ref_adv), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(to_np(ret), np.asarray(ref_ret), rtol=1e-6, atol=1e-7)


def _converter(trainer):
    if trainer.pcfg.policy == "mlp":
        return convert.mlp_params_from_flax
    return convert.ring_transformer_params_from_flax


def _as_torch_tree(trainer, tree):
    return _converter(trainer)(jax.tree.map(lambda x: np.asarray(x, np.float32), tree), device="cpu")


def _run_both(jt, tt, traj, last):
    """The JAX update phase (jitted, EnvParams as traced arguments) and
    the port's from the same params, trajectory and permutations."""
    pcfg = tt.pcfg
    n_perm = pcfg.n_envs if pcfg.minibatch_scheme == "env_permute" else pcfg.n_envs * pcfg.horizon
    with x64_off():
        js = jt.init_state(0)
        _, *keys = jax.random.split(js.rng, pcfg.epochs + 1)
        perms = np.stack([np.asarray(jax.random.permutation(k, n_perm)) for k in keys])
        env, fixed = jt.env, jt.env.params

        def update(state, rollout_out, params):
            env.params = params
            try:
                return jt._update_phase(state, rollout_out)
            finally:
                env.params = fixed

        jtraj = _jax_traj(traj, jt.pcfg.collect_dtype)
        jnew, jmetrics = jax.jit(update)(js, (jtraj, jnp.asarray(last)), fixed)
        # the first minibatch's gradients
        advs, rets = jt._gae(jtraj, jnp.asarray(last))
        fields = {"obs": jtraj["obs"], "action": jtraj["action"], "logp": jtraj["logp"],
                  "adv": advs, "ret": rets, "pcarry": ()}
        _, mb, jtake = jax_minibatch_plan(fields, scheme=pcfg.minibatch_scheme, n_envs=pcfg.n_envs,
                                          horizon=pcfg.horizon, minibatches=pcfg.minibatches)
        jgrads = jax.grad(lambda p: jt._loss(p, jtake(jnp.asarray(perms[0][:mb])))[0])(js.params)
    params = _as_torch_tree(tt, js.params)
    ts = tt.init_state(0)
    ts = ts._replace(params=params, opt_state=tt.optimizer.init(params))
    ttraj = _torch_traj(traj, pcfg.collect_dtype)
    advs, rets = tt._gae(ttraj, torch.from_numpy(last))
    _, _, take = minibatch_plan({"obs": ttraj["obs"], "action": ttraj["action"],
                                 "logp": ttraj["logp"], "adv": advs, "ret": rets},
                                scheme=pcfg.minibatch_scheme, n_envs=pcfg.n_envs,
                                horizon=pcfg.horizon, minibatches=pcfg.minibatches)
    _, _, tgrads = tt.loss_and_grads(params, take(torch.from_numpy(perms[0][:mb])))
    tnew, tmetrics = tt.update_phase(ts, (ttraj, torch.from_numpy(last)),
                                     permutations=torch.from_numpy(perms))
    return (jnew, jmetrics, _as_torch_tree(tt, jgrads)), (tnew, tmetrics, tgrads)


UPDATE_CASES = [
    ("mlp", "float32", "env_permute"),
    ("mlp", "float32", "sample_permute"),
    ("mlp", "bfloat16", "env_permute"),
    ("mlp", "bfloat16", "sample_permute"),
    ("transformer_ring", "float32", "env_permute"),
]


LR = 3e-4
# (gradient atol, loss-term rtol, params atol, mu atol, nu atol); see the
# module docstring
TOLERANCES = {"float32": (1e-6, 1e-4, 1e-5, 1e-6, 1e-9), "bfloat16": (2e-3, 5e-3, 1e-4, 5e-4, 1e-6)}


@pytest.mark.parametrize("policy,dtype,scheme", UPDATE_CASES)
def test_update_phase_matches_ppo_trainer(policy, dtype, scheme):
    jt, tt = _pair(policy, dtype, scheme)
    traj, last = _trajectory(tt)
    (jnew, jm, jgrads), (tnew, tm, tgrads) = _run_both(jt, tt, traj, last)
    g_atol, l_rtol, p_atol, mu_atol, nu_atol = TOLERANCES[dtype]
    for k, g in tgrads.items():
        np.testing.assert_allclose(to_np(g), to_np(jgrads[k]), rtol=1e-4, atol=g_atol,
                                   err_msg=f"grad {k}")
    np.testing.assert_allclose(float(global_norm(tgrads)), float(global_norm(jgrads)),
                               rtol=l_rtol)
    for key in ("loss", "policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=l_rtol, atol=1e-5,
                                   err_msg=key)
    for key in ("nonfinite_skips", "guard_updates", "poisoned_env_resets", "mean_reward",
                "mean_episode_done"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6, err_msg=key)
    assert float(tm["nonfinite_skips"]) == 0.0 and np.isfinite(float(tm["grad_norm"]))
    adam = jnew.opt_state[1][0]
    assert int(tnew.opt_state.count) == int(adam.count) == 4
    start = _as_torch_tree(tt, jt.init_state(0).params) if policy != "mlp" else None
    ref_params = _as_torch_tree(tt, jnew.params)
    close = []
    for k, ours in tnew.params.items():
        diff = np.abs(to_np(ours) - to_np(ref_params[k]))
        # an Adam step has size ~lr whatever the gradient's size, so an
        # element whose gradient is rounding noise (bf16, or the key bias,
        # whose exact gradient is zero: it adds a constant to a row of
        # scores) may step the other way: 4 steps apart at most
        assert diff.max() <= 8 * LR, k
        if k.endswith(".k.bias"):
            assert np.abs(to_np(ours) - to_np(start[k])).max() <= 8 * LR
            continue
        close.append((diff <= p_atol).ravel())
    assert np.concatenate(close).mean() >= (1.0 if dtype == "float32" else 0.98)
    for name, ours, ref, atol in (("mu", tnew.opt_state.mu, adam.mu, mu_atol),
                                  ("nu", tnew.opt_state.nu, adam.nu, nu_atol)):
        ref = _as_torch_tree(tt, ref)
        for k in ours:
            if not k.endswith(".k.bias"):
                np.testing.assert_allclose(to_np(ours[k]), to_np(ref[k]), rtol=0, atol=atol,
                                           err_msg=f"{name} {k}")


@pytest.mark.parametrize("scheme", ["env_permute", "sample_permute"])
def test_nan_reward_skips_and_quarantines_like_jax(scheme):
    jt, tt = _pair("mlp", "float32", scheme)
    traj, last = _trajectory(tt, seed=4)
    traj["reward"][3, 5] = np.nan
    (jnew, jm, _), (tnew, tm, _) = _run_both(jt, tt, traj, last)
    skips = float(jm["nonfinite_skips"])
    assert skips > 0 and float(tm["nonfinite_skips"]) == skips
    assert float(tm["poisoned_env_resets"]) == float(jm["poisoned_env_resets"]) == 1.0
    assert int(tnew.opt_state.count) == int(jnew.opt_state[1][0].count) == 4 - skips
    ref = _as_torch_tree(tt, jnew.params)
    for k in ref:
        np.testing.assert_allclose(to_np(tnew.params[k]), to_np(ref[k]), rtol=0, atol=1e-5)
    for key in ("loss", "policy_loss", "value_loss", "entropy"):
        if np.isnan(float(jm[key])):
            assert np.isnan(float(tm[key])), key
        else:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4, atol=1e-5)


def test_quarantine_resets_the_poisoned_env_state():
    _, tt = _pair()
    state = tt.init_state(0)
    state, (traj, last) = tt.rollout_phase(state)
    traj["reward"][2, 1] = float("nan")
    moved = state.env_states.t.clone()
    new, metrics = tt.update_phase(state, (traj, last))
    assert float(metrics["poisoned_env_resets"]) == 1.0
    assert int(new.env_states.t[1]) == int(tt._reset_state.t[0])
    assert torch.equal(new.env_states.t[2:], moved[2:])
    assert torch.equal(new.obs_vec[1], tt._reset_vec[0])


# ---- the train step ------------------------------------------------------
@pytest.mark.parametrize("policy", ["mlp", "transformer_ring"])
def test_train_many_equals_train_steps_and_stacks_metrics(policy):
    _, tt = _pair(policy)
    s1, m1 = tt.train_step(tt.init_state(7))
    s2, m2 = tt.train_step(s1)
    many, stacked = tt.train_many(tt.init_state(7), 2)
    assert set(stacked) == set(m1) and all(v.shape == (2,) for v in stacked.values())
    for key in m1:
        assert_bitwise(torch.stack([m1[key], m2[key]]), stacked[key], key)
    for k in s2.params:
        assert torch.equal(s2.params[k], many.params[k])
    assert float(stacked["nonfinite_skips"].sum()) == 0.0
    assert bool(torch.isfinite(stacked["loss"]).all())
    assert isinstance(many, TrainState)
    assert any(not torch.equal(many.params[k], tt.init_state(7).params[k]) for k in many.params)
    with pytest.raises(ValueError, match="k >= 1"):
        tt.train_many(many, 0)
