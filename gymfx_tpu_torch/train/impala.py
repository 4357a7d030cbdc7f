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

Test hooks: ``rollout_phase(state, actions=...)`` replaces the actors'
draws with given ones (on the card copied into the static buffer of a
graph of their own), so a test can feed the JAX package's draws.

``feed=curriculum`` (the tape as a phase argument) and
``superstep_overlap`` raise ``not_ported`` with their ROADMAP items, as do
telemetry, fault profiles, ``log_every``, a mesh and the elastic
controller.
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F

from gymfx_tpu_torch.core import env as env_core
from gymfx_tpu_torch.core import graphs
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.core.types import EnvState, not_ported
from gymfx_tpu_torch.resilience.guards import quarantine_mask, select_tree, tree_all_finite, tree_map
from gymfx_tpu_torch.train import ppo
from gymfx_tpu_torch.train.checkpoint import resume_from_config, save_checkpoint
from gymfx_tpu_torch.train.common import (
    TrainLoop,
    build_train_eval_envs,
    labeled_eval_summary,
    make_train_many_with_data,
    masked_reset,
)
from gymfx_tpu_torch.train.optim import AdamState, ClipAdam, apply_updates
from gymfx_tpu_torch.train.policies import (
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
        if icfg.superstep_overlap:
            raise not_ported("superstep_overlap (the pipelined superstep driver)", 20)
        if env.curriculum is not None:
            raise not_ported("IMPALA over feed=curriculum (train_many_with_data)", 11)
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
        self.optimizer = ClipAdam(icfg.lr, icfg.max_grad_norm, icfg.opt_state_dtype)
        # the guard's updates-a-phase metric: one whole-step update
        self._guard_updates = torch.ones((), device=self.device)
        self._graphs_on = self.device.type == "cuda"
        self._graphs: Dict[tuple, graphs.PhaseGraph] = {}
        self._gen = torch.Generator(device=self.device)

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
        """Collect one unroll with the actor params.  Returns (post-rollout
        state, (segment dict of (unroll, n_envs, ...) tensors, the carry
        the actors started from)), new tensors that no later call
        overwrites; ``state.generator`` advances.  ``actions`` ((unroll,
        n_envs) int) replaces the actors' draws (test hook)."""
        run = self._rollout_phase_graphed if self._graphs_on else self._rollout_phase_eager
        return run(state, data, actions=actions)

    def _rollout_phase_graphed(self, state: ImpalaState, data=None, *, actions=None):
        """:meth:`rollout_phase` from the rollout graph, its outputs cloned."""
        self._refuse_data(data)
        graph = self._rollout_graphed(state, self._hooks(actions=actions))
        out = graphs.clone_tree(graph.outputs)
        init_carry = graphs.clone_tree(graph.inputs["policy_carry"])
        return (state._replace(env_states=out["env_states"], obs_vec=out["obs_vec"],
                               policy_carry=out["policy_carry"]),
                (out["traj"], init_carry))

    def _rollout_phase_eager(self, state: ImpalaState, data=None, *, actions=None):
        """:meth:`rollout_phase` op by op, drawing from ``state.generator``."""
        self._refuse_data(data)
        env_states, obs_vec, pcarry, traj = self._rollout_body(
            state.actor_params, state.env_states, state.obs_vec, state.policy_carry,
            state.generator, actions)
        return (state._replace(env_states=env_states, obs_vec=obs_vec, policy_carry=pcarry),
                (traj, state.policy_carry))

    @torch.no_grad()
    def _rollout_body(self, actor_params, env_states, obs_vec, pcarry, gen, actions=None):
        """The rollout phase as a function of its inputs, drawing from
        ``gen``: (env states, obs_vec, policy carry, segment).  It syncs
        nothing with the host, so it is what the rollout graph captures."""
        env, cfg, icfg = self.env, self.env.cfg, self.icfg
        n, unroll, dev = icfg.n_envs, icfg.unroll, self.device
        tape = env.data
        traj = {
            "obs": torch.empty((unroll, n, *self.obs_shape), dtype=icfg.collect_dtype, device=dev),
            "action": torch.empty((unroll, n), dtype=torch.int32, device=dev),
            "mu_logp": torch.empty((unroll, n), dtype=torch.float32, device=dev),
            "reward": torch.empty((unroll, n), dtype=torch.float32, device=dev),
            "done": torch.empty((unroll, n), dtype=torch.bool, device=dev),
        }
        carry0 = self.initial_carry(1)
        for t in range(unroll):
            logits, _, pcarry2 = self.policy_step(actor_params, obs_vec, pcarry)
            if actions is None:
                action = ppo.sample_categorical(logits, gen)
            else:
                action = actions[t].to(device=dev, dtype=torch.int64)
            logp = F.log_softmax(logits, dim=1).gather(1, action[:, None])[:, 0]
            env_states2, reward, done, _ = env_core.transition(
                cfg, env.params, tape, env_states, action)
            obs_vec2 = self._encode(env_core.build_obs(env_states2, tape, cfg, env.params))
            traj["obs"][t] = obs_vec
            traj["action"][t] = action
            traj["mu_logp"][t] = logp
            traj["reward"][t] = reward
            traj["done"][t] = done
            env_states = masked_reset(done, self._reset_state, env_states2)
            obs_vec = masked_reset(done, self._reset_vec, obs_vec2)
            pcarry = masked_reset(done, carry0, pcarry2) if self._recurrent else pcarry2
        return env_states, obs_vec, pcarry, traj

    # ------------------------------------------------------------------
    def _learner_replay(self, params, traj, init_carry, final_obs_vec):
        """Logits and values over the segment with the learner params,
        threading the carry from ``init_carry`` (reset on done), and the
        bootstrap value of the final obs."""
        carry0 = self.initial_carry(1)
        pcarry, logits, values = init_carry, [], []
        for t in range(traj["obs"].shape[0]):
            lt, vt, pcarry = self.policy_step(params, traj["obs"][t], pcarry)
            if self._recurrent:
                pcarry = masked_reset(traj["done"][t], carry0, pcarry)
            logits.append(lt)
            values.append(vt)
        _, bootstrap, _ = self.policy_step(params, final_obs_vec, pcarry)
        return torch.stack(logits), torch.stack(values), bootstrap

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
        logits, values, bootstrap = self._learner_replay(params, traj, init_carry, final_obs_vec)
        logp_all = F.log_softmax(logits, dim=-1)
        pi_logp = logp_all.gather(-1, traj["action"].to(torch.int64)[..., None])[..., 0]
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
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
        tensors), new tensors that no later call overwrites."""
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
        self._refuse_data(data)
        out = graphs.clone_tree(
            self._update_graphed(self._update_inputs(state, rollout_out), state.generator).outputs)
        return self._updated_state(out, state.generator), out["metrics"]

    def _update_phase_eager(self, state: ImpalaState, rollout_out, data=None):
        """:meth:`update_phase` op by op."""
        self._refuse_data(data)
        out = self._update_body(self._update_inputs(state, rollout_out))
        return self._updated_state(out, state.generator), out["metrics"]

    @staticmethod
    def _updated_state(out, generator) -> ImpalaState:
        return ImpalaState(out["learner_params"], out["actor_params"], out["opt_state"],
                           out["env_states"], out["obs_vec"], out["policy_carry"], generator,
                           out["updates_since_sync"])

    def _update_body(self, x: Dict[str, Any]) -> Dict[str, Any]:
        """The update phase as a function of its inputs (the dict of
        :meth:`_update_inputs`): a dict of the new state's fields and the
        metrics.  It syncs nothing with the host, so it is what the update
        graph captures."""
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
            env_states = masked_reset(poison, self._reset_state, env_states)
            obs_vec = masked_reset(poison, self._reset_vec, obs_vec)
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
        """One rollout phase then one update phase: (state, metrics).  On
        a CUDA device the two graphs replay back to back and the returned
        state's tensors are the update graph's static outputs, which the
        next train step overwrites (the port's ``donate_argnums=0``); the
        metrics are new tensors."""
        self._refuse_data(data)
        if not self._graphs_on:
            inter, rollout_out = self.rollout_phase(state)
            return self.update_phase(inter, rollout_out)
        state, stacked = self._train_many_graphed(state, 1)
        return state, {key: v[0] for key, v in stacked.items()}

    def train_many(self, state: ImpalaState, k: int):
        """``k`` train steps: (state, metrics stacked on a leading ``(k,)``
        axis, on the device); on the card the 2k replays are chained with
        no host round trip and the state is donated as in
        :meth:`train_step`."""
        if self._graphs_on:
            return self._train_many_graphed(state, k)
        return make_train_many_with_data(lambda s, _: self.train_step(s))(state, None, k)

    def _train_many_graphed(self, state: ImpalaState, k: int):
        k = int(k)
        if k < 1:
            raise ValueError(f"train_many needs k >= 1, got {k}")
        history = []
        for _ in range(k):
            state, metrics = self._train_step_graphed(state)
            history.append(torch.stack(list(metrics.values())))
        return state, dict(zip(metrics, torch.stack(history).unbind(1)))

    @staticmethod
    def _refuse_data(data) -> None:
        if data is not None:
            raise not_ported("IMPALA over feed=curriculum (train_many_with_data)", 11)

    # ---- the graphs (core/graphs.py) ------------------------------------
    def _graph(self, kind: str, inputs, build):
        key = (kind, self.icfg, self.env.cfg, tuple(sorted(inputs)), graphs.signature(inputs))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = build()
        return graph

    def _rollout_graphed(self, state: ImpalaState, hooks):
        """The rollout graph for ``state``, run: its static inputs are
        actor_params, env_states, obs_vec and policy_carry (the carry the
        actors start from), its static outputs env_states, obs_vec,
        policy_carry and traj."""
        inputs = dict(actor_params=state.actor_params, env_states=state.env_states,
                      obs_vec=state.obs_vec, policy_carry=state.policy_carry, **hooks)

        def body(x):
            env_states, obs_vec, pcarry, traj = self._rollout_body(
                x["actor_params"], x["env_states"], x["obs_vec"], x["policy_carry"], self._gen,
                x.get("actions"))
            return dict(env_states=env_states, obs_vec=obs_vec, policy_carry=pcarry, traj=traj)

        graph = self._graph("rollout", inputs, lambda: graphs.PhaseGraph(
            body, graphs.clone_tree(inputs), self._gen))
        return self._replay(graph, inputs, state.generator)

    def _update_graphed(self, inputs, generator, shared=()):
        """The update graph for ``inputs``, run; a graph built here takes
        the tensors of ``inputs`` named in ``shared`` as its static buffers
        (the rollout graph's), and copies of the rest."""
        graph = self._graph("update", inputs, lambda: graphs.PhaseGraph(self._update_body, {
            k: v if k in shared else graphs.clone_tree(v) for k, v in inputs.items()}, self._gen))
        return self._replay(graph, inputs, generator)

    def _train_step_graphed(self, state: ImpalaState):
        """One train step from the graphs: (state, metrics), both the
        update graph's static outputs.  The update reads the rollout
        graph's static buffers: its outputs, its actor params and, as the
        carry the actors started from, its input carry."""
        graph = self._rollout_graphed(state, {})
        out = graph.outputs
        inputs = dict(learner_params=state.learner_params,
                      actor_params=graph.inputs["actor_params"], opt_state=state.opt_state,
                      env_states=out["env_states"], obs_vec=out["obs_vec"],
                      policy_carry=out["policy_carry"],
                      updates_since_sync=state.updates_since_sync, traj=out["traj"],
                      init_carry=graph.inputs["policy_carry"])
        shared = ("actor_params", "env_states", "obs_vec", "policy_carry", "traj", "init_carry")
        out = self._update_graphed(inputs, state.generator, shared).outputs
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
        ``PPOTrainer.train``.  ``initial_params`` warm-starts both the
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
        loop = TrainLoop(
            "impala", iters=iters, steps_per_iter=per_iter, log_every=log_every,
            telemetry=telemetry, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, step_offset=step_offset,
            checkpoint_metadata=checkpoint_metadata,
            max_consecutive_skips=max_consecutive_skips if self.icfg.nonfinite_guard else 0,
            preempt_at=preempt_at, checkpoint_keep=int(checkpoint_keep or 0),
        )
        loop.start(lambda: state.generator.get_state())
        t0 = time.perf_counter()
        metrics: Dict[str, Any] = {}
        it = 0
        while it < iters:
            k = min(K, iters - it)
            with loop.span(it, k):
                if k == 1:
                    state, metrics = self.train_step(state)
                    guard_metrics = metrics
                else:
                    state, guard_metrics = self.train_many(state, k)
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
    if str(config.get("feed") or "replay").lower() == "curriculum":
        raise not_ported("IMPALA over feed=curriculum (train_many_with_data)", 11)
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
        self._greedy_driver = None
