"""IMPALA: the actor-learner with V-trace off-policy correction.

The port of ``gymfx_tpu/train/impala.py`` for one device:
:class:`ImpalaConfig` and :func:`impala_config_from` (:48-117),
:class:`ImpalaState` (:120-129) and :class:`ImpalaTrainer` with
``init_state``, ``rollout_phase`` (:255-312, :389-405), the learner
replay (:314-330), ``_vtrace`` (:332-354), ``_loss`` (:356-387),
``update_phase`` (:407-492), ``train_step``, ``train_many`` and ``train``
(:503-654); the command line's ``train_impala_from_config`` (:656-776)
and ``_EvalShim`` (:778-).

* Rollout: ``unroll`` steps of the actors, the env batch stepping with a
  stale copy of the policy (``actor_params``, refreshed every
  ``sync_every`` learner updates), done envs auto-resetting with a fresh
  carry.  The phase returns the segment and the carry the actors
  started from.
* Update: the learner replays the whole segment from that carry with
  ``learner_params`` (the recurrent carry reset on done), V-trace
  corrects the actors' staleness, and one clip-by-global-norm Adam step
  (train/optim.py) follows.  Under ``nonfinite_guard`` a non-finite loss
  or gradient keeps the learner params and optimizer state as they were
  (``torch.where`` on a device flag: no host sync), and envs whose
  segment went non-finite restart from a fresh episode.  The actor sync
  is a device-side select on the staleness counter.

The V-trace recursion ``delta + discount * c * acc`` is an ``a + b * c``
form that XLA:CPU contracts into a fused multiply-add inside jit; the
port rounds the product first, as the op-by-op JAX package does
(ROADMAP Queue 3).

On a CUDA device each phase is a CUDA graph (core/graphs.py), captured
at its first call for each static signature and replayed, the update
graph reading the rollout graph's static buffers in place: the segment,
the post-rollout state and, as the carry the actors started from, the
rollout graph's static input carry (the next rollout replay copies a new
carry into it only after this update has read it).  Learner and actor
params are distinct buffers throughout, as the JAX package keeps them
for donation (:242-244).

In ``action_space_mode=continuous`` the actors draw from the Gaussian
twin (``ppo.sample_action``), the segment's actions are float32, and
V-trace's importance weights and ``mean_rho`` come from Normal
log-densities (``exp(pi_logp - mu_logp)``) (:274-290, :356-370).

Under ``feed=curriculum`` (:177-200, :407-418, :612-625) each superstep
boundary draws one tape (``curriculum.pick``, ledgered as a
``curriculum_pick`` row) and both phases take it as an argument: on the
card it is copied into one staging tape (``PolicyTrainer._stage``), so
one graph pair serves every tape of the library; the rollout's and the
quarantine's resets come from the active tape.

Test hooks: ``rollout_phase(state, actions=...)`` replaces the actors'
draws with given ones (on the card copied into the static buffer of a
graph of their own), so a test can feed the JAX package's draws.

``superstep_overlap`` pipelines the superstep as PPO's does
(``train/common.make_train_many_overlapped``; on the card two sets of
graphs on two streams, ``train/common.run_overlapped_graphed``), the
update's learner fields (learner and actor params, the optimizer state,
the staleness counter) merged into the next rollout's carry.
``feed=curriculum`` with ``superstep_overlap`` raises the JAX package's
ValueError; a mesh and the elastic controller raise (item 17).
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from gymfx_tpu_torch.core import env as env_core
from gymfx_tpu_torch.core import graphs
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.core.types import EnvState, not_ported
from gymfx_tpu_torch.resilience.guards import quarantine_mask, select_tree, tree_all_finite, tree_map
from gymfx_tpu_torch.train import ppo
from gymfx_tpu_torch.train.checkpoint import resume_from_config, save_checkpoint
from gymfx_tpu_torch.telemetry.spans import profiler_range
from gymfx_tpu_torch.train.common import (
    TrainLoop,
    build_train_eval_envs,
    labeled_eval_summary,
    make_train_many_overlapped,
    make_train_many_with_data,
    masked_reset,
    profiler_workload,
    run_overlapped_graphed,
)
from gymfx_tpu_torch.train.optim import AdamState, ClipAdam, apply_updates
from gymfx_tpu_torch.train.policies import (
    is_continuous,
    is_recurrent,
    is_token_policy,
    make_obs_encoder,
    make_obs_spec,
    make_trainer_policy,
)


class ImpalaConfig(NamedTuple):
    n_envs: int = 256
    unroll: int = 64
    gamma: float = 0.99
    rho_bar: float = 1.0
    c_bar: float = 1.0
    lr: float = 3e-4
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    sync_every: int = 4          # actor params refresh period (staleness)
    policy: str = "lstm"
    policy_dtype: Any = torch.float32
    policy_kwargs: Tuple[Tuple[str, Any], ...] = ()
    collect_dtype: Any = torch.float32
    nonfinite_guard: bool = True
    opt_state_dtype: Any = torch.float32
    superstep_overlap: bool = False


def impala_config_from(config: Dict[str, Any]) -> ImpalaConfig:
    dt = ppo._DTYPES[str(config.get("policy_dtype", "float32"))]
    return ImpalaConfig(
        n_envs=int(config.get("num_envs", 256) or 256),
        unroll=int(config.get("impala_unroll", 64)),
        gamma=float(config.get("gamma", 0.99)),
        rho_bar=float(config.get("vtrace_rho_bar", 1.0)),
        c_bar=float(config.get("vtrace_c_bar", 1.0)),
        lr=float(config.get("learning_rate", 3e-4)),
        ent_coef=float(config.get("entropy_coef", 0.01)),
        vf_coef=float(config.get("value_coef", 0.5)),
        max_grad_norm=float(config.get("max_grad_norm", 0.5)),
        sync_every=int(config.get("impala_sync_every", 4)),
        policy=str(config.get("policy") or "lstm"),
        policy_dtype=dt,
        policy_kwargs=tuple(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in (config.get("policy_kwargs") or {}).items()
        ),
        collect_dtype=ppo.resolve_collect_dtype(config, dt),
        nonfinite_guard=bool(config.get("nonfinite_guard", True)),
        opt_state_dtype=ppo.resolve_optimizer_state_dtype(config),
        superstep_overlap=bool(config.get("superstep_overlap", False)),
    )


# what the update owns, merged into the next rollout's carry under
# superstep_overlap (the JAX package's :197-205)
LEARNER_FIELDS = ("learner_params", "actor_params", "opt_state", "updates_since_sync")
# the update graph's inputs that are the rollout graph's static buffers
_SHARED = ("actor_params", "env_states", "obs_vec", "policy_carry", "traj", "init_carry")


class ImpalaState(NamedTuple):
    learner_params: Dict[str, torch.Tensor]
    actor_params: Dict[str, torch.Tensor]  # the actors' stale copy, its own buffers
    opt_state: AdamState
    env_states: EnvState
    obs_vec: Any
    policy_carry: Any                      # (c, h) of (n_envs, hidden), () if feed-forward
    generator: torch.Generator             # the actors' draws
    updates_since_sync: Any                # 0-d int32 tensor on the device


class ImpalaTrainer(ppo.PolicyTrainer):
    """IMPALA for one Environment and ImpalaConfig.  On a CUDA device both
    phases run from CUDA graphs (see the module docstring); on the CPU
    they run eagerly.  ``_rollout_phase_eager`` and ``_update_phase_eager``
    run a phase op by op on any device, for comparisons."""

    def __init__(self, env: Environment, icfg: ImpalaConfig):
        if env.curriculum is not None and icfg.superstep_overlap:
            raise ValueError(ppo.CURRICULUM_OVERLAP_ERROR)
        self.env = env
        self.icfg = icfg
        self.device = env.device
        cfg = env.cfg
        data = env.require_resident_data("IMPALA training (random-access rollouts)")
        reset_state, reset_obs = env_core.reset(cfg, env.params, data, 1)
        self.obs_spec = make_obs_spec(reset_obs)
        self._encode = make_obs_encoder(icfg.policy, cfg.window_size, self.obs_spec)
        self._reset_state = reset_state
        self._reset_vec = self._encode(reset_obs)
        self.obs_shape = tuple(self._reset_vec.shape[1:])
        in_dim = self.obs_shape[-1] if is_token_policy(icfg.policy) else self.obs_spec.total_size
        self.policy = make_trainer_policy(
            icfg.policy, in_dim, continuous=cfg.action_space_mode == "continuous",
            dtype=icfg.policy_dtype, kwargs=dict(icfg.policy_kwargs), window=cfg.window_size,
        ).to(self.device)
        self._recurrent = is_recurrent(self.policy)
        self._continuous = is_continuous(self.policy)
        self.optimizer = ClipAdam(icfg.lr, icfg.max_grad_norm, icfg.opt_state_dtype)
        # the guard's updates-a-phase metric: one whole-step update
        self._guard_updates = torch.ones((), device=self.device)
        # feed=curriculum: a tape a superstep, each phase taking it
        self.curriculum = env.curriculum
        self._graphs_on = self.device.type == "cuda"
        self._graphs: Dict[tuple, graphs.PhaseGraph] = {}
        self._gens = tuple(torch.Generator(device=self.device) for _ in range(2))
        self._staging = None

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> ImpalaState:
        """Policy weights and the actors' generator from ``seed`` (as
        PPOTrainer.init_state), the actors' copy in buffers of its own, a
        fresh optimizer state, every env at the fresh reset state."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        ppo.init_policy_weights(self.policy, gen)
        params = {k: v.detach().clone() for k, v in self.policy.named_parameters()}
        n = self.icfg.n_envs
        return ImpalaState(
            learner_params=params,
            actor_params=graphs.clone_tree(params),
            opt_state=self.optimizer.init(params),
            env_states=EnvState(*(x.expand(n, *x.shape[1:]).clone() for x in self._reset_state)),
            obs_vec=self._reset_vec.expand(n, *self.obs_shape).clone(),
            policy_carry=self.initial_carry(n),
            generator=gen,
            updates_since_sync=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    # ------------------------------------------------------------------
    def rollout_phase(self, state: ImpalaState, data=None, *, actions=None):
        """Collect one unroll with the actor params on the env's tape, or
        on the tape ``data`` (the curriculum's pick; the auto-reset then
        comes from it).  Returns (post-rollout state, (segment dict of
        (unroll, n_envs, ...) tensors, the carry the actors started
        from)), new tensors that no later call overwrites;
        ``state.generator`` advances.  ``actions`` ((unroll, n_envs) int,
        float in continuous mode) replaces the actors' draws (test
        hook)."""
        run = self._rollout_phase_graphed if self._graphs_on else self._rollout_phase_eager
        return run(state, data, actions=actions)

    def _rollout_phase_graphed(self, state: ImpalaState, data=None, *, actions=None):
        """:meth:`rollout_phase` from the rollout graph, its outputs cloned."""
        graph = self._rollout_graphed(state, self._stage(data), self._hooks(actions=actions))
        out = graphs.clone_tree(graph.outputs)
        init_carry = graphs.clone_tree(graph.inputs["policy_carry"])
        return (state._replace(env_states=out["env_states"], obs_vec=out["obs_vec"],
                               policy_carry=out["policy_carry"]),
                (out["traj"], init_carry))

    def _rollout_phase_eager(self, state: ImpalaState, data=None, *, actions=None):
        """:meth:`rollout_phase` op by op, drawing from ``state.generator``."""
        with profiler_range("rollout"):
            env_states, obs_vec, pcarry, traj = self._rollout_body(
                state.actor_params, state.env_states, state.obs_vec, state.policy_carry, data,
                state.generator, actions)
        return (state._replace(env_states=env_states, obs_vec=obs_vec, policy_carry=pcarry),
                (traj, state.policy_carry))

    @torch.no_grad()
    def _rollout_body(self, actor_params, env_states, obs_vec, pcarry, data, gen, actions=None):
        """The rollout phase on ``data`` (None: the env's tape) as a
        function of its inputs, drawing from ``gen``: (env states, obs_vec,
        policy carry, segment).  It syncs nothing with the host, so it is
        what the rollout graph captures."""
        env, cfg, icfg = self.env, self.env.cfg, self.icfg
        n, unroll, dev = icfg.n_envs, icfg.unroll, self.device
        tape = env.data if data is None else data
        reset_state, reset_vec = self._fresh(data)
        cont = self._continuous
        traj = {
            "obs": torch.empty((unroll, n, *self.obs_shape), dtype=icfg.collect_dtype, device=dev),
            "action": torch.empty((unroll, n), dtype=ppo.action_dtype(cont), device=dev),
            "mu_logp": torch.empty((unroll, n), dtype=torch.float32, device=dev),
            "reward": torch.empty((unroll, n), dtype=torch.float32, device=dev),
            "done": torch.empty((unroll, n), dtype=torch.bool, device=dev),
        }
        carry0 = self.initial_carry(1)
        for t in range(unroll):
            dist, _, pcarry2 = self.policy_step(actor_params, obs_vec, pcarry)
            if actions is None:
                action = ppo.sample_action(dist, gen, cont)
            else:
                action = actions[t].to(device=dev, dtype=torch.float32 if cont else torch.int64)
            logp = ppo.action_logp(dist, action, cont)
            env_states2, reward, done, _ = env_core.transition(
                cfg, env.params, tape, env_states, action)
            obs_vec2 = self._encode(env_core.build_obs(env_states2, tape, cfg, env.params))
            traj["obs"][t] = obs_vec
            traj["action"][t] = action
            traj["mu_logp"][t] = logp
            traj["reward"][t] = reward
            traj["done"][t] = done
            env_states = masked_reset(done, reset_state, env_states2)
            obs_vec = masked_reset(done, reset_vec, obs_vec2)
            pcarry = masked_reset(done, carry0, pcarry2) if self._recurrent else pcarry2
        return env_states, obs_vec, pcarry, traj

    # ------------------------------------------------------------------
    def _learner_replay(self, params, traj, init_carry, final_obs_vec):
        """The distributions (logits, or stacked ``(mu, log_std)``) and values
        over the segment with the learner params,
        threading the carry from ``init_carry`` (reset on done), and the
        bootstrap value of the final obs."""
        carry0 = self.initial_carry(1)
        pcarry, dists, values = init_carry, [], []
        for t in range(traj["obs"].shape[0]):
            dt, vt, pcarry = self.policy_step(params, traj["obs"][t], pcarry)
            if self._recurrent:
                pcarry = masked_reset(traj["done"][t], carry0, pcarry)
            dists.append(dt)
            values.append(vt)
        _, bootstrap, _ = self.policy_step(params, final_obs_vec, pcarry)
        dist = (tuple(torch.stack(x) for x in zip(*dists)) if self._continuous
                else torch.stack(dists))
        return dist, torch.stack(values), bootstrap

    def _vtrace(self, values, bootstrap, rewards, dones, rhos):
        """(vs, pg_adv), each (unroll, n_envs), with no gradient: a reverse
        loop over the unroll."""
        g = self.icfg.gamma
        values, bootstrap, rhos = values.detach(), bootstrap.detach(), rhos.detach()
        discounts = g * (1.0 - dones.to(torch.float32))
        cs = torch.clamp_max(rhos, self.icfg.c_bar)
        clipped_rhos = torch.clamp_max(rhos, self.icfg.rho_bar)
        values_next = torch.cat([values[1:], bootstrap[None]], dim=0)
        deltas = clipped_rhos * (rewards + discounts * values_next - values)
        vs_minus_v = torch.empty_like(deltas)
        acc = torch.zeros_like(bootstrap)
        for t in range(deltas.shape[0] - 1, -1, -1):
            acc = deltas[t] + discounts[t] * cs[t] * acc
            vs_minus_v[t] = acc
        vs = values + vs_minus_v
        vs_next = torch.cat([vs[1:], bootstrap[None]], dim=0)
        pg_adv = clipped_rhos * (rewards + discounts * vs_next - values)
        return vs, pg_adv

    def _loss(self, params, traj, init_carry, final_obs_vec):
        """(total loss, dict of its terms) of one segment."""
        dist, values, bootstrap = self._learner_replay(params, traj, init_carry, final_obs_vec)
        pi_logp = ppo.action_logp(dist, traj["action"], self._continuous)
        entropy = ppo.policy_entropy(dist, self._continuous)
        rhos = torch.exp(pi_logp - traj["mu_logp"])
        vs, pg_adv = self._vtrace(values, bootstrap, traj["reward"], traj["done"], rhos)
        policy_loss = -torch.mean(pi_logp * pg_adv)
        value_loss = 0.5 * torch.mean((vs - values) ** 2)
        total = policy_loss + self.icfg.vf_coef * value_loss - self.icfg.ent_coef * entropy
        return total, dict(policy_loss=policy_loss, value_loss=value_loss, entropy=entropy,
                           mean_rho=rhos.mean())

    def loss_and_grads(self, params, traj, init_carry, final_obs_vec):
        """(loss, loss terms, gradients by param name) of one segment."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            loss, aux = self._loss(leaves, traj, init_carry, final_obs_vec)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return (loss.detach(), {k: a.detach() for k, a in aux.items()},
                dict(zip(leaves.keys(), grads)))

    def update_phase(self, state: ImpalaState, rollout_out, data=None):
        """One V-trace learner update on a collected segment, the guard's
        bookkeeping and the actor sync: (new state, metrics dict of 0-d
        tensors), new tensors that no later call overwrites.  Quarantined
        envs restart from the fresh reset of the active tape ``data`` (the
        env's own when None)."""
        run = self._update_phase_graphed if self._graphs_on else self._update_phase_eager
        return run(state, rollout_out, data)

    def _update_inputs(self, state: ImpalaState, rollout_out) -> Dict[str, Any]:
        traj, init_carry = rollout_out
        return dict(learner_params=state.learner_params, actor_params=state.actor_params,
                    opt_state=state.opt_state, env_states=state.env_states,
                    obs_vec=state.obs_vec, policy_carry=state.policy_carry,
                    updates_since_sync=state.updates_since_sync, traj=traj,
                    init_carry=init_carry)

    def _update_phase_graphed(self, state: ImpalaState, rollout_out, data=None):
        """:meth:`update_phase` from the update graph, its outputs cloned."""
        out = graphs.clone_tree(self._update_graphed(
            self._update_inputs(state, rollout_out), self._stage(data), state.generator).outputs)
        return self._updated_state(out, state.generator), out["metrics"]

    def _update_phase_eager(self, state: ImpalaState, rollout_out, data=None):
        """:meth:`update_phase` op by op."""
        with profiler_range("update"):
            out = self._update_body(self._update_inputs(state, rollout_out), data)
        return self._updated_state(out, state.generator), out["metrics"]

    @staticmethod
    def _updated_state(out, generator) -> ImpalaState:
        return ImpalaState(out["learner_params"], out["actor_params"], out["opt_state"],
                           out["env_states"], out["obs_vec"], out["policy_carry"], generator,
                           out["updates_since_sync"])

    def _update_body(self, x: Dict[str, Any], data=None) -> Dict[str, Any]:
        """The update phase on ``data`` (None: the env's tape) as a
        function of its inputs (the dict of :meth:`_update_inputs`): a
        dict of the new state's fields and the metrics.  It syncs nothing
        with the host, so it is what the update graph captures."""
        icfg = self.icfg
        traj = x["traj"]
        learner, opt_state = x["learner_params"], x["opt_state"]
        env_states, obs_vec, pcarry = x["env_states"], x["obs_vec"], x["policy_carry"]
        loss, aux, grads = self.loss_and_grads(learner, traj, x["init_carry"], obs_vec)
        updates, new_opt_state, _ = self.optimizer.update(grads, opt_state)
        new_params = apply_updates(learner, updates)
        metrics = dict(loss=loss, mean_reward=traj["reward"].mean(),
                       mean_episode_done=traj["done"].to(torch.float32).mean(), **aux)
        if icfg.nonfinite_guard:
            # one update a step, so the guard is whole-step: a non-finite
            # loss or gradient keeps the learner params and moments
            ok = torch.isfinite(loss) & tree_all_finite(grads)
            learner = select_tree(ok, new_params, learner)
            opt_state = select_tree(ok, new_opt_state, opt_state)
            metrics["nonfinite_skips"] = 1.0 - ok.to(torch.float32)
            metrics["guard_updates"] = self._guard_updates
            poison = quarantine_mask(
                {"reward": traj["reward"], "obs": traj["obs"], "mu_logp": traj["mu_logp"]},
                env_axis=1,
            ) | quarantine_mask({"obs_vec": obs_vec, "env_states": env_states},
                                env_axis=0, mode="nan")
            # the quarantine's resets come from the active tape
            reset_state, reset_vec = self._fresh(data)
            env_states = masked_reset(poison, reset_state, env_states)
            obs_vec = masked_reset(poison, reset_vec, obs_vec)
            if self._recurrent:
                pcarry = masked_reset(poison, self.initial_carry(1), pcarry)
            metrics["poisoned_env_resets"] = poison.to(torch.float32).sum()
        else:
            learner, opt_state = new_params, new_opt_state
        count = x["updates_since_sync"] + 1
        do_sync = count >= icfg.sync_every
        actor = tree_map(lambda new, old: torch.where(do_sync, new, old), learner,
                         x["actor_params"])
        count = torch.where(do_sync, torch.zeros_like(count), count)
        return dict(learner_params=learner, actor_params=actor, opt_state=opt_state,
                    env_states=env_states, obs_vec=obs_vec, policy_carry=pcarry,
                    updates_since_sync=count, metrics=metrics)

    # ------------------------------------------------------------------
    def train_step(self, state: ImpalaState, data=None):
        """One rollout phase then one update phase, on the env's tape or on
        ``data``: (state, metrics).  On a CUDA device the two graphs replay
        back to back and the returned state's tensors are the update
        graph's static outputs, which the next train step overwrites (the
        port's ``donate_argnums=0``); the metrics are new tensors."""
        if not self._graphs_on:
            inter, rollout_out = self.rollout_phase(state, data)
            return self.update_phase(inter, rollout_out, data)
        state, stacked = self._train_many_graphed(state, 1, data)
        return state, {key: v[0] for key, v in stacked.items()}

    def train_many(self, state: ImpalaState, k: int):
        """``k`` train steps on the env's tape: see
        :meth:`train_many_with_data`."""
        return self.train_many_with_data(state, None, k)

    def train_many_with_data(self, state: ImpalaState, data, k: int):
        """``k`` train steps on one tape (the JAX package's
        ``make_train_many_with_data``): (state, metrics stacked on a
        leading ``(k,)`` axis, on the device).  On the card ``data`` is
        copied into the staging tape once, the 2k replays are chained with
        no host round trip and the state is donated as in
        :meth:`train_step`.  Under ``superstep_overlap`` (``k > 1``, on the
        env's own tape: a trainer over a curriculum refuses it) the
        superstep is pipelined (see the module docstring)."""
        if self.icfg.superstep_overlap and int(k) > 1:
            if self._graphs_on:
                return self._train_many_overlapped_graphed(state, int(k))
            return make_train_many_overlapped(self.rollout_phase, self.update_phase,
                                              LEARNER_FIELDS)(state, k)
        if self._graphs_on:
            return self._train_many_graphed(state, k, data)
        return make_train_many_with_data(self.train_step)(state, data, k)

    def _train_many_overlapped_graphed(self, state: ImpalaState, k: int):
        """The overlapped superstep from the graphs of sets A (the
        sequential step's) and B on two streams."""

        def rollout(s, which, generator):
            # the actor params it read, from its own static input (see
            # PPOTrainer._train_many_overlapped_graphed)
            graph = self._rollout_graphed(s, None, {}, which, generator)
            out = graph.outputs
            return (s._replace(actor_params=graph.inputs["actor_params"],
                               env_states=out["env_states"], obs_vec=out["obs_vec"],
                               policy_carry=out["policy_carry"]),
                    (out["traj"], graph.inputs["policy_carry"]), graph)

        def update(s, rollout_out, graph, which, generator):
            out = self._update_graphed(self._update_inputs(s, rollout_out), None, generator,
                                       _SHARED, which,
                                       buffers=self._update_buffers(s, graph)).outputs
            return self._updated_state(out, generator), out["metrics"]

        return run_overlapped_graphed(state, k, rollout, update, LEARNER_FIELDS,
                                      self._side_stream())

    def _train_many_graphed(self, state: ImpalaState, k: int, data=None):
        k = int(k)
        if k < 1:
            raise ValueError(f"train_many needs k >= 1, got {k}")
        tape = self._stage(data)
        history = []
        for _ in range(k):
            state, metrics = self._train_step_graphed(state, tape)
            history.append(torch.stack(list(metrics.values())))
        return state, dict(zip(metrics, torch.stack(history).unbind(1)))

    # ---- the graphs (core/graphs.py) ------------------------------------
    def _graph(self, kind: str, inputs, tape, build):
        key = (kind, id(tape), self.icfg, self.env.cfg, tuple(sorted(inputs)),
               graphs.signature(inputs))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = build()
        return graph

    def _rollout_graphed(self, state: ImpalaState, tape, hooks, s: int = 0, generator=None):
        """The rollout graph of set ``s`` for ``state`` on ``tape`` (None or
        the staging tape), run from
        ``generator`` (``state.generator`` by default): its static inputs
        are actor_params, env_states, obs_vec and policy_carry (the carry
        the actors start from), its static outputs env_states, obs_vec,
        policy_carry and traj."""
        inputs = dict(actor_params=state.actor_params, env_states=state.env_states,
                      obs_vec=state.obs_vec, policy_carry=state.policy_carry, **hooks)
        gen = self._gens[s]

        def body(x):
            env_states, obs_vec, pcarry, traj = self._rollout_body(
                x["actor_params"], x["env_states"], x["obs_vec"], x["policy_carry"], tape, gen,
                x.get("actions"))
            return dict(env_states=env_states, obs_vec=obs_vec, policy_carry=pcarry, traj=traj)

        kind = ppo._KINDS["rollout"][s]
        graph = self._graph(kind, inputs, tape, lambda: graphs.PhaseGraph(
            body, graphs.clone_tree(inputs), gen, name=f"{type(self).__name__}.{kind}"))
        return self._replay("rollout", graph, inputs,
                            state.generator if generator is None else generator, s)

    def _update_graphed(self, inputs, tape, generator, shared=(), s: int = 0, buffers=None):
        """The update graph of set ``s`` for ``inputs`` on ``tape``, run; a
        graph built here takes the tensors named in ``shared`` of
        ``buffers`` (``inputs`` by default: the rollout graph's buffers) as
        its static buffers, and copies of the rest."""
        static = inputs if buffers is None else buffers
        kind = ppo._KINDS["update"][s]
        graph = self._graph(kind, inputs, tape, lambda: graphs.PhaseGraph(
            lambda x: self._update_body(x, tape), {
                k: v if k in shared else graphs.clone_tree(v) for k, v in static.items()},
            self._gens[s], name=f"{type(self).__name__}.{kind}"))
        return self._replay("update", graph, inputs, generator, s)

    @staticmethod
    def _update_buffers(state: ImpalaState, graph) -> Dict[str, Any]:
        """The update graph's inputs for ``state`` after the rollout graph
        ``graph``: its actor params and, as the carry the actors started
        from, its input carry; its outputs; the rest ``state``'s."""
        out = graph.outputs
        return dict(learner_params=state.learner_params,
                    actor_params=graph.inputs["actor_params"], opt_state=state.opt_state,
                    env_states=out["env_states"], obs_vec=out["obs_vec"],
                    policy_carry=out["policy_carry"],
                    updates_since_sync=state.updates_since_sync, traj=out["traj"],
                    init_carry=graph.inputs["policy_carry"])

    def _train_step_graphed(self, state: ImpalaState, tape):
        """One train step from the graphs on ``tape``: (state, metrics), both
        the update graph's static outputs.  The update reads the rollout
        graph's static buffers: its outputs, its actor params and, as the
        carry the actors started from, its input carry."""
        graph = self._rollout_graphed(state, tape, {})
        out = self._update_graphed(self._update_buffers(state, graph), tape, state.generator,
                                   _SHARED).outputs
        return self._updated_state(out, state.generator), out["metrics"]

    # ------------------------------------------------------------------
    def train(self, total_env_steps: int, seed: int = 0, log_every: int = 0,
              initial_state: Optional[ImpalaState] = None, initial_params=None, *,
              checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
              step_offset: int = 0, checkpoint_metadata: Optional[Dict[str, Any]] = None,
              max_consecutive_skips: int = 10, preempt_at: Optional[int] = None,
              supersteps_per_dispatch: int = 1, telemetry=None, mesh_faults=(),
              checkpoint_keep: int = 0):
        """Run IMPALA for about ``total_env_steps`` env steps: ``total_env_steps
        // (n_envs * unroll)`` iterations (at least one), in supersteps of
        ``supersteps_per_dispatch`` train steps, through
        ``resilience/loop.ResilientLoop`` (checkpoints, the skip guard) as
        ``PPOTrainer.train``; under ``feed=curriculum`` each superstep
        boundary draws one tape (``curriculum.pick``) and the superstep
        trains on it.  ``initial_params`` warm-starts both the
        learner and the actors.  Returns ``(state, metrics)``: the last
        iteration's metrics as floats plus ``env_steps_per_sec``,
        ``iterations``, ``total_env_steps`` and ``last_checkpoint_step``
        when one was saved.  ``log_every``, ``preempt_at`` and
        ``telemetry`` act as in ``PPOTrainer.train``; mesh faults
        (ROADMAP Queue 1 item 17) raise."""
        if mesh_faults:
            raise not_ported("ImpalaTrainer.train(mesh_faults=...)", 17)
        state = self.init_state(seed) if initial_state is None else initial_state
        if initial_params is not None:
            state = state._replace(learner_params=initial_params,
                                   actor_params=graphs.clone_tree(initial_params))
        per_iter = self.icfg.n_envs * self.icfg.unroll
        iters = max(1, int(total_env_steps) // per_iter)
        K = max(1, int(supersteps_per_dispatch or 1))
        tape = None
        loop = TrainLoop(
            "impala", iters=iters, steps_per_iter=per_iter, log_every=log_every,
            telemetry=telemetry, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, step_offset=step_offset,
            checkpoint_metadata=checkpoint_metadata,
            max_consecutive_skips=max_consecutive_skips if self.icfg.nonfinite_guard else 0,
            preempt_at=preempt_at, checkpoint_keep=int(checkpoint_keep or 0),
            workload=lambda it_start, kk: profiler_workload(
                self, state, kk, algo="impala", params=state.learner_params,
                n_envs=self.icfg.n_envs, horizon=self.icfg.unroll, data=tape),
        )
        loop.start(lambda: state.generator.get_state())
        t0 = time.perf_counter()
        metrics: Dict[str, Any] = {}
        it = 0
        while it < iters:
            k = min(K, iters - it)
            loop.begin_superstep(it, k)
            if self.curriculum is not None:
                # one weighted seed-deterministic tape per superstep boundary
                _, _, tape = self.curriculum.pick(it)
            with loop.span(it, k):
                if k == 1:
                    state, metrics = self.train_step(state, tape)
                    guard_metrics = metrics
                else:
                    state, guard_metrics = self.train_many_with_data(state, tape, k)
                    metrics = {key: v[-1] for key, v in guard_metrics.items()}
            # a checkpoint copies the state before the next step overwrites it
            loop.after_superstep(it, k, guard_metrics, lambda: (state, state.learner_params))
            it += k
        loop.finish(lambda: (state, state.learner_params))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        out = {key: float(v) for key, v in metrics.items()}
        out["env_steps_per_sec"] = per_iter * iters / dt
        out["iterations"] = iters
        out["total_env_steps"] = per_iter * iters
        if loop.hooks.last_checkpoint_step is not None:
            out["last_checkpoint_step"] = loop.hooks.last_checkpoint_step
        return state, out


# ---------------------------------------------------------------------------
def train_impala_from_config(config: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """``mode=training trainer=impala``: train IMPALA, checkpoint, and
    return a summary that merges the training metrics with the greedy
    evaluation's, under the config's fault profile and telemetry (the
    JAX package's :672+).  What PPO's entry refuses raises here too."""
    ppo._refuse_unported_training_keys(config)
    return _train_impala_from_config(config, device=device)


def _train_impala_from_config(config: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    env, eval_env = build_train_eval_envs(config, device=device)
    # chaos runs: the fault profile contaminates the TRAINING feed
    env, profile = ppo.contaminated_training_env(env, config)
    icfg = impala_config_from(config)
    trainer = ImpalaTrainer(env, icfg)
    total = int(config.get("train_total_steps", 1_000_000))
    resume_state, resume_params, resume_step = resume_from_config(config, trainer)
    ckpt_meta = {"policy": icfg.policy, "policy_kwargs": dict(icfg.policy_kwargs)}

    def run(telemetry):
        if telemetry is not None and telemetry.ledger is not None and (
                resume_state is not None or resume_params is not None):
            telemetry.ledger.record("checkpoint_restore", step=int(resume_step))
        return trainer.train(
            total, seed=int(config.get("seed", 0) or 0),
            initial_state=resume_state, initial_params=resume_params,
            checkpoint_dir=config.get("checkpoint_dir"),
            checkpoint_every=int(config.get("checkpoint_every", 0) or 0),
            step_offset=resume_step,
            checkpoint_metadata=ckpt_meta,
            max_consecutive_skips=int(config.get("guard_max_consecutive_skips", 10) or 0),
            supersteps_per_dispatch=int(config.get("supersteps_per_dispatch", 1) or 1),
            preempt_at=profile.get("preempt_at"),
            telemetry=telemetry,
            checkpoint_keep=int(config.get("checkpoint_keep", 0) or 0),
        )

    state, train_metrics = ppo.train_with_telemetry(config, "impala", run)
    # the greedy evaluation through PPO's evaluate(), on held-out bars
    # when the config holds some out
    summary = labeled_eval_summary(
        lambda e: ppo.evaluate(_EvalShim(trainer, env=e), state.learner_params),
        env, eval_env,
    )
    summary["train_metrics"] = train_metrics
    ckpt_dir = config.get("checkpoint_dir")
    if ckpt_dir:
        final_step = resume_step + train_metrics["total_env_steps"]
        if train_metrics.get("last_checkpoint_step") != final_step:
            save_checkpoint(
                ckpt_dir, state, step=final_step, metadata=ckpt_meta,
                params=state.learner_params, keep=int(config.get("checkpoint_keep", 0) or 0),
                protect=(int(resume_step),),
            )
        summary["checkpoint_dir"] = str(ckpt_dir)
    return summary


class _EvalShim:
    """The trainer surface ``ppo.evaluate`` needs; ``env`` overrides the
    episode's dataset (the held-out evaluation)."""

    def __init__(self, trainer: ImpalaTrainer, env=None):
        self.env = env if env is not None else trainer.env
        self.policy = trainer.policy
        self._encode = trainer._encode
        self.policy_step = trainer.policy_step
        self.initial_carry = trainer.initial_carry
        self._continuous = trainer._continuous
        self._greedy_driver = None
