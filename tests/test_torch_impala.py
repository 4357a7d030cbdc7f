"""The LSTM policy, PPO with its recurrent carry, and the IMPALA trainer
(gymfx_tpu_torch/train/policies.py, ppo.py, impala.py) against the JAX
package's (gymfx_tpu/train/policies.py::LSTMPolicy, ppo.py, impala.py).

Small sizes throughout: 8 envs, hidden 16, horizon and unroll 8, a short
tape so that episodes end inside a phase and the carry resets on done.

* ``LSTMPolicy`` against flax through ``convert.lstm_params_from_flax``:
  float32 within 1e-5 (observed 1.2e-7); bfloat16 logits and value
  within 4e-3 (observed 2.3e-3: the PR 1 bf16 policy tolerance), the
  carry within 2^-6 of its largest element (two bf16 ulps; observed one):
  the port rounds at flax's points, XLA may keep f32 between them inside
  a fusion.
* PPO-LSTM: the rollout phase with the JAX draws injected, against the
  jitted ``PPOTrainer._rollout_phase`` (EnvParams traced, as in
  tests/test_torch_rollout.py) over four phases: obs, actions, rewards,
  dones, env states BITWISE; logp, value, the stored carries and the
  carry after within 1e-5.  The update phase from the same params,
  segment (stored carries included) and permutations, against the jitted
  ``_update_phase``, both minibatch schemes: the loss terms within rtol
  1e-4, params after 4 Adam steps within 1e-5, mu within 1e-6, nu 1e-9
  (tests/test_torch_train.py's float32 tolerances).
* IMPALA: the rollout phase (actions injected) against the jitted
  ``ImpalaTrainer._rollout_phase`` over four phases, as PPO's, with the
  carry the actors started from BITWISE; ``_vtrace`` against the jitted
  one within rtol 1e-6 / atol 1e-7 (XLA:CPU contracts ``delta + discount
  * c * acc`` into a fused multiply-add inside jit) and against the op-by-
  op one (``jax.disable_jit``) BITWISE; the update phase over three
  chained updates with ``sync_every = 2`` (the second syncs the actors):
  the loss terms and ``mean_rho`` within rtol 1e-4, learner and actor
  params within 1e-5 after each, the sync counter equal, the actors
  equal to the learner exactly after the sync.
* The non-finite guard: a NaN reward skips the update (learner params
  and Adam state kept bit for bit) and quarantines that env, as JAX does.
* A resume from a checkpoint equals the uninterrupted run leaf by leaf;
  ``main --mode training --trainer impala`` writes the JAX package's
  results keys, and ``--driver_mode policy`` on its checkpoint
  reproduces the held-out summary.
* What remains unported raises ``not_ported`` naming its ROADMAP item.
"""
import json
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.app.main import main as jax_main
from gymfx_tpu.train.impala import ImpalaTrainer as JaxImpala
from gymfx_tpu.train.impala import impala_config_from as jax_impala_config_from
from gymfx_tpu.train.policies import LSTMPolicy as FlaxLSTM
from gymfx_tpu.train.ppo import PPOTrainer as JaxPPO
from gymfx_tpu.train.ppo import ppo_config_from as jax_ppo_config_from

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.app.main import main
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.train import checkpoint as ckpt
from gymfx_tpu_torch.train.impala import (
    ImpalaState,
    ImpalaTrainer,
    impala_config_from,
    train_impala_from_config,
)
from gymfx_tpu_torch.train.policies import LSTMPolicy, make_policy
from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

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
HIDDEN = 16
SMALL = dict(window_size=8, num_envs=8, policy="lstm", policy_kwargs={"hidden": HIDDEN},
             feature_columns=["CLOSE", "VOLUME"], strategy_plugin="direct_fixed_sltp",
             sl_pips=4.0, tp_pips=8.0, reward_plugin="dd_penalized_reward", penalty_lambda=0.5)


def _params(tree):
    return convert.lstm_params_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), tree),
                                         device="cpu")


def _close(a, b, label, tol=1e-5):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=tol, atol=tol, err_msg=label)


def _traced(fn, env):
    """``fn(state, *args)`` jitted with the EnvParams as traced arguments
    (tests/test_torch_rollout.py's _jax_phase)."""
    fixed = env.params

    def call(state, params, *args):
        env.params = params
        try:
            return fn(state, *args)
        finally:
            env.params = fixed

    jitted = jax.jit(call)
    return lambda state, *args: jitted(state, fixed, *args)


# ---- the policy ------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_policy_matches_flax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 11)).astype(np.float32)
    c0, h0 = (rng.normal(size=(7, HIDDEN)).astype(np.float32) for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    flax_policy = FlaxLSTM(hidden=HIDDEN, dtype=jdt)
    with x64_off():
        params = flax_policy.init(jax.random.PRNGKey(1), jnp.zeros((11,)),
                                  flax_policy.initial_carry(()))
        carry = (jnp.asarray(c0).astype(jdt), jnp.asarray(h0).astype(jdt))
        ref = jax.vmap(lambda xx, cc: flax_policy.apply(params, xx, cc))(jnp.asarray(x), carry)
    policy = make_policy("lstm", 11, dtype=tdt, kwargs={"hidden": HIDDEN})
    assert isinstance(policy, LSTMPolicy)
    policy.load_state_dict(_params(params))
    with torch.no_grad():
        logits, value, (c, h) = policy(torch.from_numpy(x), (torch.from_numpy(c0).to(tdt),
                                                              torch.from_numpy(h0).to(tdt)))
    assert logits.dtype == value.dtype == torch.float32 and c.dtype == h.dtype == tdt
    head_tol = 1e-5 if dtype == "float32" else 4e-3
    _close(logits, ref[0], "logits", head_tol)
    _close(value, ref[1], "value", head_tol)
    for name, ours, theirs in (("c", c, ref[2][0]), ("h", h, ref[2][1])):
        theirs = np.asarray(theirs.astype(jnp.float32))
        tol = 1e-5 if dtype == "float32" else 2.0 ** -6 * float(np.abs(theirs).max())
        np.testing.assert_allclose(to_np(ours), theirs, rtol=0, atol=tol, err_msg=name)
    zero = policy.initial_carry(3)
    assert all(z.shape == (3, HIDDEN) and z.dtype == tdt and not z.any() for z in zero)
    assert zero[0].data_ptr() != zero[1].data_ptr()


# ---- PPO with the recurrent carry ------------------------------------------
def _ppo_pair(**over):
    cols = random_walk_columns(n=18, seed=9)
    jax_env, torch_env = paired_envs(cols, ppo_horizon=8, ppo_minibatches=2, ppo_epochs=2,
                                     **{**SMALL, **over})
    return (JaxPPO(jax_env, jax_ppo_config_from(jax_env.config)),
            PPOTrainer(torch_env, ppo_config_from(torch_env.config)))


def test_ppo_lstm_rollout_phase_matches_jax_with_injected_draws():
    jt, tt = _ppo_pair()
    phase = _traced(jt._rollout_phase, jt.env)
    state = tt.init_state(0)
    assert [tuple(x.shape) for x in state.policy_carry] == [(8, HIDDEN)] * 2
    dones = 0
    with x64_off():
        js = jt.init_state(0)
        state = state._replace(params=_params(js.params))
        for p in range(4):
            js, (traj, last) = phase(js)
            state, (ttraj, tlast) = tt.rollout_phase(
                state, actions=torch.from_numpy(np.array(traj["action"])))
            for key in ("obs", "reward", "done", "action"):
                assert_bitwise(traj[key], ttraj[key], f"phase {p} traj {key}")
            for key in ("logp", "value"):
                _close(ttraj[key], traj[key], f"phase {p} {key}")
            _close(tlast, last, f"phase {p} bootstrap value")
            for i in range(2):
                _close(ttraj["pcarry"][i], traj["pcarry"][i], f"phase {p} stored carry {i}")
                _close(state.policy_carry[i], js.policy_carry[i], f"phase {p} carry {i}")
            assert_state_bitwise(js.env_states, state.env_states, f"phase {p}")
            dones += int(np.asarray(traj["done"]).sum())
    assert dones > 0  # episodes ended, so carries were reset on done
    assert float(state.policy_carry[1].abs().max()) > 0


def _segment(t, n, obs_dim, seed=0, carry=True):
    rng = np.random.default_rng(seed)
    seg = {
        "obs": rng.normal(size=(t, n, obs_dim)).astype(np.float32),
        "action": rng.integers(0, 3, (t, n)).astype(np.int32),
        "reward": (0.1 * rng.normal(size=(t, n))).astype(np.float32),
        "done": rng.random((t, n)) < 0.15,
    }
    if carry:
        seg["pcarry"] = tuple((0.5 * rng.normal(size=(t, n, HIDDEN))).astype(np.float32)
                              for _ in range(2))
    return seg, rng


@pytest.mark.parametrize("scheme", ["env_permute", "sample_permute"])
def test_ppo_lstm_update_phase_matches_jax(scheme):
    jt, tt = _ppo_pair(ppo_minibatch_scheme=scheme)
    pcfg = tt.pcfg
    seg, rng = _segment(pcfg.horizon, pcfg.n_envs, tt.obs_dim, seed=1)
    seg["logp"] = rng.uniform(-1.6, -0.6, seg["done"].shape).astype(np.float32)
    seg["value"] = (0.5 * rng.normal(size=seg["done"].shape)).astype(np.float32)
    last = (0.5 * rng.normal(size=(pcfg.n_envs,))).astype(np.float32)
    n_perm = pcfg.n_envs if scheme == "env_permute" else pcfg.n_envs * pcfg.horizon
    with x64_off():
        js = jt.init_state(0)
        _, *keys = jax.random.split(js.rng, pcfg.epochs + 1)
        perms = np.stack([np.asarray(jax.random.permutation(k, n_perm)) for k in keys])
        jseg = {k: (tuple(jnp.asarray(x) for x in v) if k == "pcarry" else jnp.asarray(v))
                for k, v in seg.items()}
        jnew, jm = _traced(jt._update_phase, jt.env)(js, (jseg, jnp.asarray(last)))
    params = _params(js.params)
    ts = tt.init_state(0)
    ts = ts._replace(params=params, opt_state=tt.optimizer.init(params))
    tseg = {k: (tuple(torch.from_numpy(x) for x in v) if k == "pcarry" else torch.from_numpy(v))
            for k, v in seg.items()}
    tnew, tm = tt.update_phase(ts, (tseg, torch.from_numpy(last)),
                               permutations=torch.from_numpy(perms))
    for key in ("loss", "policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    assert float(tm["nonfinite_skips"]) == float(jm["nonfinite_skips"]) == 0.0
    ref = _params(jnew.params)
    for k in ref:
        np.testing.assert_allclose(to_np(tnew.params[k]), to_np(ref[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    adam = jnew.opt_state[1][0]
    for name, ours, theirs, atol in (("mu", tnew.opt_state.mu, adam.mu, 1e-6),
                                     ("nu", tnew.opt_state.nu, adam.nu, 1e-9)):
        theirs = _params(theirs)
        for k in theirs:
            np.testing.assert_allclose(to_np(ours[k]), to_np(theirs[k]), rtol=0, atol=atol,
                                       err_msg=f"{name} {k}")
    for i in range(2):
        assert_bitwise(jnew.policy_carry[i], tnew.policy_carry[i], f"carry {i}")
    assert any(not torch.equal(tnew.params[k], params[k]) for k in params)


# ---- IMPALA ------------------------------------------------------------------
def _impala_pair(**over):
    cols = random_walk_columns(n=18, seed=9)
    jax_env, torch_env = paired_envs(cols, impala_unroll=8, impala_sync_every=2,
                                     **{**SMALL, **over})
    return (JaxImpala(jax_env, jax_impala_config_from(jax_env.config)),
            ImpalaTrainer(torch_env, impala_config_from(torch_env.config)))


def _to_port_state(trainer, js):
    """The port's ImpalaState holding the JAX state's values."""
    state = trainer.init_state(0)
    return state._replace(
        learner_params=_params(js.learner_params), actor_params=_params(js.actor_params),
        policy_carry=tuple(torch.from_numpy(np.array(x)) for x in js.policy_carry),
        updates_since_sync=torch.tensor(int(js.updates_since_sync), dtype=torch.int32))


def test_impala_rollout_phase_matches_jax_with_injected_actions():
    jt, tt = _impala_pair()
    phase = _traced(jt._rollout_phase, jt.env)
    dones = 0
    with x64_off():
        js = jt.init_state(0)
        state = _to_port_state(tt, js)
        for p in range(4):
            before = js.policy_carry
            js, (traj, init_carry) = phase(js)
            state, (ttraj, tinit) = tt.rollout_phase(
                state, actions=torch.from_numpy(np.array(traj["action"])))
            for i in range(2):
                assert_bitwise(before[i], init_carry[i], "JAX's start carry")
                _close(tinit[i], init_carry[i], f"phase {p} start carry {i}")
                _close(state.policy_carry[i], js.policy_carry[i], f"phase {p} carry {i}")
            for key in ("obs", "reward", "done", "action"):
                assert_bitwise(traj[key], ttraj[key], f"phase {p} traj {key}")
            _close(ttraj["mu_logp"], traj["mu_logp"], f"phase {p} mu_logp")
            assert_state_bitwise(js.env_states, state.env_states, f"phase {p}")
            assert_bitwise(js.obs_vec, state.obs_vec, f"phase {p} obs_vec")
            dones += int(np.asarray(traj["done"]).sum())
    assert dones > 0
    assert isinstance(state, ImpalaState)


def _vtrace_case(seed=0, t=8, n=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, n)).astype(np.float32), rng.normal(size=(n,)).astype(np.float32),
            (0.3 * rng.normal(size=(t, n))).astype(np.float32), rng.random((t, n)) < 0.2,
            np.exp(0.7 * rng.normal(size=(t, n))).astype(np.float32))


def test_vtrace_matches_jax():
    jt, tt = _impala_pair(vtrace_rho_bar=1.0, vtrace_c_bar=0.9)
    case = _vtrace_case()
    assert (case[4] > 1.0).any() and (case[4] < 0.9).any()  # both clips act
    ours = tt._vtrace(*(torch.from_numpy(x) for x in case))
    with x64_off():
        jitted = jax.jit(jt._vtrace)(*(jnp.asarray(x) for x in case))
        with jax.disable_jit():
            ops = jt._vtrace(*(jnp.asarray(x) for x in case))
    for i, name in enumerate(("vs", "pg_adv")):
        np.testing.assert_allclose(to_np(ours[i]), np.asarray(jitted[i]), rtol=1e-6, atol=1e-7,
                                   err_msg=f"{name} vs jit")
        assert_bitwise(ops[i], ours[i], f"{name} vs op by op")


def _impala_segment(tt, seed):
    seg, rng = _segment(tt.icfg.unroll, tt.icfg.n_envs, tt.obs_spec.total_size, seed, carry=False)
    seg["mu_logp"] = rng.uniform(-1.6, -0.6, seg["done"].shape).astype(np.float32)
    init = tuple((0.5 * rng.normal(size=(tt.icfg.n_envs, HIDDEN))).astype(np.float32)
                 for _ in range(2))
    return seg, init


def _run_updates(jt, tt, seeds, poison=None):
    """Chained JAX and port update phases on seeded segments: a list of
    ((JAX state, metrics), (port state, metrics)) after each."""
    update = _traced(jt._update_phase, jt.env)
    out = []
    with x64_off():
        js = jt.init_state(0)
        ts = _to_port_state(tt, js)
        for seed in seeds:
            seg, init = _impala_segment(tt, seed)
            if poison is not None:
                seg["reward"][poison] = np.nan
            js, jm = update(js, ({k: jnp.asarray(v) for k, v in seg.items()},
                                 tuple(jnp.asarray(x) for x in init)))
            ts, tm = tt.update_phase(ts, ({k: torch.from_numpy(v) for k, v in seg.items()},
                                          tuple(torch.from_numpy(x) for x in init)))
            out.append(((js, jm), (ts, tm)))
    return out


def test_impala_update_phase_matches_jax_and_syncs_the_actors():
    jt, tt = _impala_pair()
    start = tt.init_state(0)
    with x64_off():
        start = _to_port_state(tt, jt.init_state(0))
    runs = _run_updates(jt, tt, seeds=(3, 4, 5))
    assert set(runs[0][1][1]) == set(runs[0][0][1])  # the JAX package's metric keys
    for step, ((js, jm), (ts, tm)) in enumerate(runs, 1):
        for key in ("loss", "policy_loss", "value_loss", "entropy", "mean_rho"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"update {step} {key}")
        for key in ("mean_reward", "mean_episode_done", "nonfinite_skips", "guard_updates",
                    "poisoned_env_resets"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6), key
        assert int(ts.updates_since_sync) == int(js.updates_since_sync) == step % 2
        for name, ours, theirs in (("learner", ts.learner_params, js.learner_params),
                                   ("actor", ts.actor_params, js.actor_params)):
            theirs = _params(theirs)
            for k in theirs:
                np.testing.assert_allclose(to_np(ours[k]), to_np(theirs[k]), rtol=0, atol=1e-5,
                                           err_msg=f"update {step} {name} {k}")
        synced = step % 2 == 0
        for k in ts.learner_params:
            same = torch.equal(ts.actor_params[k], ts.learner_params[k])
            assert same == synced or not synced and torch.equal(ts.actor_params[k],
                                                                 runs[step - 2][1][0].actor_params[k]
                                                                 if step > 1 else start.actor_params[k])
            assert ts.actor_params[k].data_ptr() != ts.learner_params[k].data_ptr()
    assert float(runs[0][1][1]["mean_rho"]) != 1.0


def test_nan_reward_skips_the_update_and_quarantines_like_jax():
    jt, tt = _impala_pair()
    with x64_off():
        before = _to_port_state(tt, jt.init_state(0))
    ((js, jm), (ts, tm)), = _run_updates(jt, tt, seeds=(6,), poison=(2, 3))
    assert float(tm["nonfinite_skips"]) == float(jm["nonfinite_skips"]) == 1.0
    assert float(tm["poisoned_env_resets"]) == float(jm["poisoned_env_resets"]) == 1.0
    for k in ts.learner_params:  # the skipped update kept the learner bit for bit
        assert torch.equal(ts.learner_params[k], before.learner_params[k])
    assert int(ts.opt_state.count) == int(jt.optimizer.init(js.learner_params)[1][0].count) == 0
    assert_state_bitwise(js.env_states, ts.env_states, "quarantined env batch")
    assert not ts.policy_carry[0][3].any() and not ts.policy_carry[1][3].any()
    assert np.isnan(float(tm["loss"])) and np.isnan(float(jm["loss"]))


def test_quarantine_resets_a_poisoned_env_after_a_rollout():
    _, tt = _impala_pair()
    state, (traj, init) = tt.rollout_phase(tt.init_state(0))
    traj["reward"][2, 1] = float("nan")
    moved = state.env_states.t.clone()
    new, metrics = tt.update_phase(state, (traj, init))
    assert float(metrics["poisoned_env_resets"]) == 1.0
    assert int(new.env_states.t[1]) == int(tt._reset_state.t[0])
    assert torch.equal(new.env_states.t[2:], moved[2:])
    assert not new.policy_carry[0][1].any()


def test_train_many_equals_train_steps():
    _, tt = _impala_pair()
    s1, m1 = tt.train_step(tt.init_state(7))
    s2, m2 = tt.train_step(s1)
    many, stacked = tt.train_many(tt.init_state(7), 2)
    assert set(stacked) == set(m1) and all(v.shape == (2,) for v in stacked.values())
    for key in m1:
        assert_bitwise(torch.stack([m1[key], m2[key]]), stacked[key], key)
    for k in s2.learner_params:
        assert torch.equal(s2.learner_params[k], many.learner_params[k])
    with pytest.raises(ValueError, match="k >= 1"):
        tt.train_many(many, 0)


# ---- the command line, checkpoints ---------------------------------------------
def _cli_config(tmp_path, **over):
    config = dict(DEFAULT_VALUES, input_data_file=CSV, mode="training", trainer="impala",
                  num_envs=4, impala_unroll=8, policy="lstm", policy_kwargs={"hidden": HIDDEN},
                  reward_plugin="dd_penalized_reward", window_size=8, eval_split=0.25,
                  train_total_steps=3 * 4 * 8)
    config.update(over)
    path = tmp_path / "impala.json"
    path.write_text(json.dumps(config))
    return path


def _argv(tmp_path, name, cfg, *extra):
    return ["--load_config", str(cfg), "--results_file", str(tmp_path / f"{name}.json"),
            "--save_config", str(tmp_path / f"{name}_config.json"), "--quiet_mode", *extra]


def _keys(tree):
    """A results tree's keys, every leaf (a number, a string or None) one
    marker."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return "leaf"


def test_cli_trains_impala_with_the_jax_keys_and_the_policy_mode_reproduces_it(tmp_path):
    cfg = _cli_config(tmp_path)
    full = tmp_path / "full"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trained = main(_argv(tmp_path, "train", cfg, "--checkpoint_dir", str(full),
                             "--checkpoint_every", "1"), device="cpu")
        with x64_off():
            ref = jax_main(_argv(tmp_path, "jax", cfg, "--checkpoint_dir", str(tmp_path / "jck"),
                                 "--train_total_steps", str(4 * 8)))
    assert json.loads((tmp_path / "train.json").read_text()) == json.loads(json.dumps(trained))
    ref_keys, our_keys = _keys(json.loads(json.dumps(ref))), _keys(json.loads(json.dumps(trained)))
    ref_keys["train_metrics"].pop("last_checkpoint_step", None)
    our_keys["train_metrics"].pop("last_checkpoint_step", None)
    our_keys["checkpoint_dir"] = ref_keys["checkpoint_dir"]
    assert our_keys == ref_keys
    tm = trained["train_metrics"]
    assert tm["iterations"] == 3 and tm["nonfinite_skips"] == 0.0
    assert trained["eval_scope"] == "held_out"
    assert ckpt._list_steps(full) == [32, 64, 96]
    assert ckpt.read_metadata(str(full))["policy"] == "lstm"
    eval_bars = trained["eval_bars"]
    policy = main(_argv(tmp_path, "policy", cfg, "--mode", "inference", "--driver_mode", "policy",
                        "--checkpoint_dir", str(full), "--steps", str(eval_bars - 1)),
                  device="cpu")
    for key in ("final_equity", "total_return", "max_drawdown_pct", "trades_total", "sharpe_ratio",
                "sharpe_ratio_steps"):
        assert policy[key] == trained[key], key
    assert policy["checkpoint_step"] == 96 and policy["mode"] == "inference"


def test_resume_equals_the_uninterrupted_run_leaf_by_leaf(tmp_path):
    config = json.loads(_cli_config(tmp_path).read_text())
    full, resumed = tmp_path / "full", tmp_path / "resumed"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        train_impala_from_config(dict(config, checkpoint_dir=str(full), checkpoint_every=1),
                                 device="cpu")
        resumed.mkdir()
        shutil.copytree(full / "32", resumed / "32")
        shutil.copytree(full / "64", resumed / "64")
        for name in ("digest_32.json", "digest_64.json", "metadata.json"):
            shutil.copy(full / name, resumed)
        again = train_impala_from_config(
            dict(config, checkpoint_dir=str(resumed), checkpoint_every=1, resume_training=True,
                 train_total_steps=32), device="cpu")
    assert again["train_metrics"]["iterations"] == 1
    a = torch.load(full / "96" / "state.pt", weights_only=True)
    b = torch.load(resumed / "96" / "state.pt", weights_only=True)
    assert list(a) == list(b)
    assert {k.split(".")[0] for k in a} == set(ImpalaState._fields)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # a params-only checkpoint warm-starts the learner and the actors
    trainer = ImpalaTrainer(Environment(config, device="cpu"), impala_config_from(config))
    ckpt.save_checkpoint(str(tmp_path / "params"), trainer.init_state(3).learner_params, step=5)
    state, params, step = ckpt.load_train_state(str(tmp_path / "params"), trainer)
    assert state is None and step == 5 and set(params) == set(trainer.params_template())


@pytest.mark.parametrize("over", [{"action_space_mode": "continuous"}])
def test_unported_impala_options_raise_naming_the_roadmap_item(over):
    """Continuous actions (item 11) are ported: the trainer takes the
    LSTM's Gaussian twin and trains a step (tests/test_torch_impala_
    curriculum.py holds it against JAX)."""
    from gymfx_tpu_torch.train.policies import ContinuousLSTMPolicy

    config = dict(DEFAULT_VALUES, input_data_file=CSV, num_envs=4, impala_unroll=4,
                  policy="lstm", window_size=8, policy_kwargs={"hidden": 8}, **over)
    trainer = ImpalaTrainer(Environment(config, device="cpu"), impala_config_from(config))
    assert isinstance(trainer.policy, ContinuousLSTMPolicy)
    state, metrics = trainer.train_step(trainer.init_state(0))
    assert state.env_states.t.shape == (4,) and np.isfinite(float(metrics["mean_rho"]))


def test_impala_over_a_one_tape_library_trains_through_its_entry():
    """``feed=curriculum`` (item 11, ported) through
    ``train_impala_from_config``: a one-tape library is the env's own tape."""
    config = dict(DEFAULT_VALUES, input_data_file=CSV, num_envs=4, impala_unroll=4,
                  policy="lstm", window_size=8, policy_kwargs={"hidden": 8}, feed="curriculum",
                  tapes=f"file:{CSV}", train_total_steps=32)
    out = train_impala_from_config(config, device="cpu")
    assert out["train_metrics"]["iterations"] == 2


@pytest.mark.parametrize("over,item", [
    ({"fault_profile": "nan_bars=3;mesh=kill:0@1"}, 17),
    ({"mesh_shape": {"data": 1}}, 17),
    ({"elastic_resume": True}, 17),
])
def test_unported_impala_training_keys_raise_naming_the_roadmap_item(over, item):
    config = dict(DEFAULT_VALUES, input_data_file=CSV, num_envs=4, impala_unroll=4,
                  policy="lstm", window_size=8, **over)
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}$"):
        train_impala_from_config(config, device="cpu")


def test_impala_train_refuses_logging_and_telemetry(capsys):
    """The loop logs (``log_every``, one dispatch late, the JAX package's
    line) and takes telemetry now (tests/test_torch_telemetry.py); the
    mesh faults still raise."""
    config = dict(DEFAULT_VALUES, input_data_file=CSV, num_envs=4, impala_unroll=4,
                  policy="lstm", window_size=8)
    trainer = ImpalaTrainer(Environment(config, device="cpu"), impala_config_from(config))
    trainer.train(32, log_every=1)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(" {")[0] for line in lines] == ["[impala] iter 1/2", "[impala] iter 2/2"]
    with pytest.raises(NotImplementedError, match="Queue 1 item 17$"):
        trainer.train(16, mesh_faults=("x",))
