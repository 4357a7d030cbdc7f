"""The pipelined superstep (``superstep_overlap``) and the update's
recompute (``ppo_update_remat``) against the JAX package: the port of
tests/test_overlap_superstep.py.

* k = 1 overlapped is the sequential step: PPO's and IMPALA's states
  (params, moments, env batch, generator) and metrics ``torch.equal``.
* The port's ``train/common.make_train_many_overlapped`` at k = 3 on
  PPO's phases against the JAX ``make_train_many_overlapped`` (jitted,
  EnvParams traced): the draws of each JAX phase of the overlapped
  schedule (each body's rollout from the first key of its split, its
  update from the second) are recorded and injected through
  ``rollout_phase(actions=)`` and ``update_phase(permutations=)``.  The
  rewards and dones bitwise; the loss terms within rtol 1e-4 and the
  params within 1e-5 (tests/test_torch_train.py's float32 tolerances).
  IMPALA at k = 3: the metrics stacked, the learner fields merged.
* ``feed=curriculum`` with ``superstep_overlap`` raises the JAX
  package's ValueError with its message (PPO and IMPALA).
* ``ppo_update_remat``: the params after an update within atol 1e-6 of
  the update without it, as the JAX test holds them (observed: equal),
  and within tests/test_torch_train.py's tolerances of the JAX remat
  update from the same params, trajectory and permutations; a population
  (``members=2``) likewise.
* Both keys default off, in both packages.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.core.runtime import Environment as JaxEnvironment
from gymfx_tpu.train.common import make_train_many_overlapped as jax_overlapped
from gymfx_tpu.train.impala import ImpalaTrainer as JaxImpala
from gymfx_tpu.train.impala import impala_config_from as jax_impala_config_from
from gymfx_tpu.train.ppo import PPOTrainer as JaxTrainer
from gymfx_tpu.train.ppo import ppo_config_from as jax_ppo_config_from

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.resilience.guards import tree_leaves
from gymfx_tpu_torch.train.common import make_train_many_overlapped, split_generator
from gymfx_tpu_torch.train.impala import ImpalaTrainer, impala_config_from
from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

from test_torch_parity import assert_bitwise, paired_envs, random_walk_columns, to_np, x64_off

CSV = "examples/data/eurusd_sample.csv"
SMALL = dict(input_data_file=CSV, window_size=8, feature_columns=["CLOSE", "VOLUME"],
             num_envs=8, ppo_horizon=8, ppo_minibatches=2, policy_kwargs={"hidden": [16, 16, 16]})
IMPALA = dict(input_data_file=CSV, window_size=8, num_envs=8, impala_unroll=8,
              impala_sync_every=2, policy="lstm", policy_kwargs={"hidden": 16})


def _trainer(**over):
    config = dict(DEFAULT_VALUES, **SMALL)
    config.update(over)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return PPOTrainer(Environment(config, device="cpu"), ppo_config_from(config))


def _impala(**over):
    config = dict(DEFAULT_VALUES, **IMPALA)
    config.update(over)
    return ImpalaTrainer(Environment(config, device="cpu"), impala_config_from(config))


def _assert_states_equal(a, b, what):
    fields = lambda s: tuple(x for x in s if not isinstance(x, torch.Generator))  # noqa: E731
    la, lb = tree_leaves(fields(a)), tree_leaves(fields(b))
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{what}: leaf {i}"
    assert torch.equal(a.generator.get_state(), b.generator.get_state()), f"{what}: generator"


# ---- k = 1: the sequential step ---------------------------------------------
@pytest.mark.parametrize("make", [_trainer, _impala], ids=["ppo", "impala"])
def test_overlapped_k1_bitwise_equals_sequential(make):
    seq, ovl = make(), make(superstep_overlap=True)
    cfg = getattr(ovl, "pcfg", None) or ovl.icfg
    assert cfg.superstep_overlap
    s_seq, m_seq = seq.train_many(seq.init_state(0), 1)
    s_ovl, m_ovl = ovl.train_many(ovl.init_state(0), 1)
    _assert_states_equal(s_seq, s_ovl, "k = 1 state")
    assert set(m_seq) == set(m_ovl)
    for key in m_seq:
        assert torch.equal(m_seq[key], m_ovl[key]), key


# ---- k = 3 against the JAX function ----------------------------------------
def _ppo_pair():
    cols = random_walk_columns(n=48, seed=5)
    jax_env, torch_env = paired_envs(
        cols, window_size=8, num_envs=8, ppo_horizon=8, ppo_epochs=2, ppo_minibatches=2,
        policy_kwargs={"hidden": [16, 16, 16]}, ppo_minibatch_scheme="env_permute",
        feature_columns=["CLOSE", "VOLUME"], superstep_overlap=True)
    return (JaxTrainer(jax_env, jax_ppo_config_from(jax_env.config)),
            PPOTrainer(torch_env, ppo_config_from(torch_env.config)))


def _traced(fn, env):
    """``fn(state, *args)`` jitted with the EnvParams as traced arguments
    (tests/test_torch_rollout.py's ``_jax_phase``: closed over, XLA folds
    ``x / initial_cash`` into a multiply, an ulp off the port's)."""
    fixed = env.params

    def call(state, params, *args):
        env.params = params
        try:
            return fn(state, *args)
        finally:
            env.params = fixed

    jitted = jax.jit(call)
    return lambda state, *args: jitted(state, fixed, *args)


def _params(tree):
    return convert.mlp_params_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), tree),
                                        device="cpu")


K = 3


def test_make_train_many_overlapped_k3_matches_the_jax_function():
    jt, tt = _ppo_pair()
    pcfg = tt.pcfg
    with x64_off():
        js0 = jt.init_state(0)
        train_many = jax_overlapped(jt._rollout_phase, jt._update_phase)
        ref, ref_metrics = _traced(lambda s: train_many(s, K), jt.env)(js0)
        # the overlapped schedule's draws, phase by phase: the prologue's
        # rollout, then each body's rollout (the first key of the body's
        # split) and update (the second), then the epilogue's update
        rollout, update = _traced(jt._rollout_phase, jt.env), _traced(jt._update_phase, jt.env)

        def perms(key):
            return np.stack([np.asarray(jax.random.permutation(k, pcfg.n_envs))
                             for k in jax.random.split(key, pcfg.epochs + 1)[1:]])

        inter, out = rollout(js0)
        actions, permutations, rewards = [out[0]["action"]], [], [out[0]["reward"]]
        for _ in range(K - 1):
            r_next, r_upd = jax.random.split(inter.rng)
            inter2, out2 = rollout(inter._replace(rng=r_next))
            actions.append(out2[0]["action"])
            rewards.append(out2[0]["reward"])
            permutations.append(perms(r_upd))
            updated, _ = update(inter._replace(rng=r_upd), out)
            inter, out = inter2._replace(params=updated.params, opt_state=updated.opt_state), out2
        permutations.append(perms(inter.rng))
    params = _params(js0.params)
    state = tt.init_state(0)
    state = state._replace(params=params, opt_state=tt.optimizer.init(params))
    acts, prms = iter(actions), iter(permutations)
    seen = []

    def rollout_phase(s):
        s, out = tt.rollout_phase(s, actions=torch.from_numpy(np.array(next(acts))))
        seen.append(out[0]["reward"])
        return s, out

    def update_phase(s, out):
        return tt.update_phase(s, out, permutations=torch.from_numpy(next(prms)))

    new, metrics = make_train_many_overlapped(rollout_phase, update_phase)(state, K)
    assert next(acts, None) is None and next(prms, None) is None
    for i, (ours, theirs) in enumerate(zip(seen, rewards)):
        assert_bitwise(theirs, ours, f"rollout {i} rewards")
    assert all(v.shape == (K,) for v in metrics.values())
    for key in ("loss", "policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(to_np(metrics[key]), np.asarray(ref_metrics[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    for key in ("mean_reward", "mean_episode_done", "nonfinite_skips", "poisoned_env_resets"):
        np.testing.assert_allclose(to_np(metrics[key]), np.asarray(ref_metrics[key]), rtol=1e-6,
                                   atol=1e-9, err_msg=key)
    theirs = _params(ref.params)
    for k in theirs:
        np.testing.assert_allclose(to_np(new.params[k]), to_np(theirs[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert int(new.opt_state.count) == int(ref.opt_state[1][0].count) == K * 4
    assert_bitwise(ref.env_states.t, new.env_states.t, "env t")
    assert_bitwise(ref.env_states.equity_delta, new.env_states.equity_delta, "equity")


def test_overlapped_draws_come_from_split_streams():
    """Each body's two phases draw from streams split off the carried
    generator (a function of its state, drawing nothing), so PPO's k = 3
    overlapped run is the composition of its phases in the documented
    order with those generators, whatever runs first."""
    tr = _trainer(superstep_overlap=True)
    gen = torch.Generator().manual_seed(3)
    a, b = split_generator(gen), split_generator(gen)
    assert all(torch.equal(x.get_state(), y.get_state()) for x, y in zip(a, b))
    assert not torch.equal(a[0].get_state(), a[1].get_state())
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(3).get_state())
    s0 = tr.init_state(2)
    new, metrics = tr.train_many(tr.init_state(2), K)
    inter, out = tr.rollout_phase(s0)
    for _ in range(K - 1):
        g_roll, g_upd = split_generator(inter.generator)
        updated, _ = tr.update_phase(inter._replace(generator=g_upd), out)
        inter, out = tr.rollout_phase(inter._replace(generator=g_roll))  # update first
        inter = inter._replace(params=updated.params, opt_state=updated.opt_state)
    ref, last = tr.update_phase(inter, out)
    for k in ref.params:
        assert torch.equal(ref.params[k], new.params[k]), k
    assert torch.equal(last["loss"], metrics["loss"][-1])
    assert torch.equal(new.generator.get_state(), ref.generator.get_state())


def test_impala_overlapped_k3_stacks_metrics_and_merges_the_learner_fields():
    tr = _impala(superstep_overlap=True)
    s0 = tr.init_state(0)
    state, metrics = tr.train_many(s0, K)
    for key, arr in metrics.items():
        assert arr.shape == (K,), key
        assert bool(torch.isfinite(arr).all()), key
    # three updates with sync_every = 2: the actors synced at the second
    assert int(state.updates_since_sync) == 1
    assert any(not torch.equal(state.learner_params[k], state.actor_params[k])
               for k in state.learner_params)
    assert int(state.opt_state.count) == K


# ---- the JAX package's refusal ------------------------------------------------
@pytest.mark.parametrize("trainer", ["ppo", "impala"])
def test_curriculum_with_overlap_raises_the_jax_valueerror(trainer):
    over = dict(feed="curriculum", tapes=f"file:{CSV}", superstep_overlap=True, window_size=8,
                num_envs=4)
    if trainer == "ppo":
        with pytest.raises(ValueError) as ref:
            JaxTrainer(JaxEnvironment(dict(JAX_DEFAULTS, **over)),
                       jax_ppo_config_from(dict(JAX_DEFAULTS, **over)))
        with pytest.raises(ValueError) as ours:
            _trainer(**over)
    else:
        over.update(impala_unroll=4, policy="lstm", policy_kwargs={"hidden": 8})
        with pytest.raises(ValueError) as ref:
            JaxImpala(JaxEnvironment(dict(JAX_DEFAULTS, **over)),
                      jax_impala_config_from(dict(JAX_DEFAULTS, **over)))
        with pytest.raises(ValueError) as ours:
            ImpalaTrainer(Environment(dict(DEFAULT_VALUES, **over), device="cpu"),
                          impala_config_from(dict(DEFAULT_VALUES, **over)))
    assert str(ours.value) == str(ref.value)


# ---- ppo_update_remat --------------------------------------------------------
def _update_pair(trainer_a, trainer_b):
    """One update phase of each trainer from the same state, trajectory and
    generator state."""
    inter, out = trainer_a.rollout_phase(trainer_a.init_state(0))

    def fresh():
        gen = torch.Generator()
        gen.set_state(inter.generator.get_state())
        return inter._replace(generator=gen)

    return trainer_a.update_phase(fresh(), out), trainer_b.update_phase(fresh(), out)


@pytest.mark.parametrize("members", [None, 2], ids=["single", "members2"])
def test_remat_params_match_no_remat(members):
    """The backward recomputes the forward (the same ops in the same order):
    the params after an update within 1e-6 of the plain update's."""
    config = dict(DEFAULT_VALUES, **SMALL)
    env = Environment(config, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plain = PPOTrainer(env, ppo_config_from(config), members=members)
        remat = PPOTrainer(env, ppo_config_from({**config, "ppo_update_remat": True}),
                           members=members)
    assert remat.pcfg.update_remat and not plain.pcfg.update_remat
    (s_plain, m_plain), (s_remat, m_remat) = _update_pair(plain, remat)
    for k in s_plain.params:
        np.testing.assert_allclose(to_np(s_remat.params[k]), to_np(s_plain.params[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(to_np(m_remat["loss"]), to_np(m_plain["loss"]), rtol=0, atol=1e-5)
    assert any(not torch.equal(s_remat.params[k], remat.init_state(0).params[k])
               for k in s_remat.params)


def test_remat_update_matches_the_jax_remat_update():
    cols = random_walk_columns(n=48, seed=5)
    jax_env, torch_env = paired_envs(
        cols, window_size=8, num_envs=8, ppo_horizon=8, ppo_epochs=2, ppo_minibatches=2,
        policy_kwargs={"hidden": [16, 16, 16]}, feature_columns=["CLOSE", "VOLUME"],
        ppo_update_remat=True)
    jt = JaxTrainer(jax_env, jax_ppo_config_from(jax_env.config))
    tt = PPOTrainer(torch_env, ppo_config_from(torch_env.config))
    assert jt.pcfg.update_remat and tt.pcfg.update_remat
    with x64_off():
        js = jt.init_state(0)
        inter, out = _traced(jt._rollout_phase, jt.env)(js)
        perms = np.stack([np.asarray(jax.random.permutation(k, 8))
                          for k in jax.random.split(inter.rng, jt.pcfg.epochs + 1)[1:]])
        jnew, jm = _traced(jt._update_phase, jt.env)(inter, out)
    params = _params(js.params)
    ts = tt.init_state(0)
    ts = ts._replace(params=params, opt_state=tt.optimizer.init(params))
    ts, tout = tt.rollout_phase(ts, actions=torch.from_numpy(np.asarray(out[0]["action"])))
    assert_bitwise(out[0]["reward"], tout[0]["reward"], "rewards")
    tnew, tm = tt.update_phase(ts, tout, permutations=torch.from_numpy(perms))
    for key in ("loss", "policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    theirs = _params(jnew.params)
    for k in theirs:
        np.testing.assert_allclose(to_np(tnew.params[k]), to_np(theirs[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_overlap_and_remat_default_off():
    from gymfx_tpu.train.impala import impala_config_from as jax_impala_from

    config = dict(DEFAULT_VALUES, window_size=8)
    jconfig = dict(JAX_DEFAULTS, window_size=8)
    pcfg, jpcfg = ppo_config_from(config), jax_ppo_config_from(jconfig)
    assert pcfg.superstep_overlap is False is jpcfg.superstep_overlap
    assert pcfg.update_remat is False is jpcfg.update_remat
    assert impala_config_from(config).superstep_overlap is False
    assert jax_impala_from(jconfig).superstep_overlap is False


# ---- the static-buffer driver and the recompute under capture ---------------
@pytest.mark.parametrize("make", [_trainer, _impala], ids=["ppo", "impala"])
def test_the_two_set_static_buffer_driver_equals_the_eager_schedule(make):
    """The card's overlapped driver (two sets of phase graphs, the update
    reading its set's rollout buffers while the next rollout fills the
    other set's) in the CPU's static-buffer mode against the schedule op by
    op, k = 3 and again on its own donated outputs: torch.equal."""
    from gymfx_tpu_torch.train.impala import LEARNER_FIELDS

    tr = make(superstep_overlap=True)
    fields = LEARNER_FIELDS if hasattr(tr, "icfg") else ("params", "opt_state")
    eager = make_train_many_overlapped(tr._rollout_phase_eager, tr._update_phase_eager, fields)
    run = (tr._train_many_overlapped_graphed if hasattr(tr, "icfg") else
           lambda s, k: tr._train_many_overlapped_graphed(s, None, k))
    s0 = tr.init_state(1)
    ref, ref_m = eager(_copy(s0), K)
    got, got_m = run(_copy(s0), K)
    _assert_states_equal(got, ref, "k = 3")
    for key in ref_m:
        assert torch.equal(got_m[key], ref_m[key]), key
    assert sorted(k for k, *_ in tr._graphs) == ["rollout", "rollout_b", "update", "update_b"]
    ref, _ = eager(_copy(ref), K)
    got, _ = run(got, K)
    _assert_states_equal(got, ref, "k = 3 on the donated state")


def _copy(state):
    def one(x):
        if isinstance(x, torch.Generator):
            gen = torch.Generator()
            gen.set_state(x.get_state())
            return gen
        from gymfx_tpu_torch.core import graphs

        return graphs.clone_tree(x)

    return type(state)(*(one(x) for x in state))


def test_the_remat_update_body_never_syncs_the_host():
    """The update graph's body with ``ppo_update_remat`` on a ring policy
    (K4's autograd.Function forward run again in the backward) syncs
    nothing with the host, so it captures (tests/test_torch_graphs.py's
    guard)."""
    from gymfx_tpu_torch.config import flagship

    from test_torch_graphs import NoHostSync

    config = flagship.long_context_config(
        CSV, num_envs=4, ppo_horizon=4, ppo_minibatches=2, window_size=16, ppo_update_remat=True,
        policy_kwargs={"d_model": 16, "n_heads": 2, "n_layers": 2})
    tr = PPOTrainer(Environment(config, device="cpu"), ppo_config_from(config))
    tr._train_many_graphed(tr.init_state(0), None, 1)
    update = [g for (kind, *_), g in tr._graphs.items() if kind == "update"][0]
    with NoHostSync():
        update.body(update.inputs)
