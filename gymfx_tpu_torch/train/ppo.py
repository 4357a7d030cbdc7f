"""PPO: the rollout phase, the update phase and the train step.

The port of ``gymfx_tpu/train/ppo.py``: :class:`PPOConfig`,
:func:`resolve_collect_dtype`, :func:`resolve_optimizer_state_dtype`,
:func:`ppo_config_from` (:45-163), :class:`TrainState` and
:class:`PPOTrainer` with ``init_state``, ``rollout_phase`` (:307-386,
:452-467), ``_gae`` (:388-406), ``_loss`` (:408-443), ``update_phase``
(:469-615), ``train_step``, ``train_many`` and ``train`` (:637-802).
Each phase takes an explicit tape ``data`` (the curriculum's pick), as
the JAX package's phases do; a streamed Environment is refused.

* Rollout: ``horizon`` steps of the policy acting (categorical draw from
  a ``torch.Generator``), every env stepping through the kernel chain
  (core/env.transition), done envs auto-resetting (from random start
  offsets when ``random_episode_start`` is set), the trajectory stored
  with obs in ``collect_dtype``.
* Update: GAE, then ``epochs`` x ``minibatches`` clipped-PPO steps with
  clip-by-global-norm Adam (train/optim.py) over ``minibatch_plan``'s
  minibatches.  Under ``nonfinite_guard`` a minibatch whose loss or
  gradients are not finite leaves params and optimizer state as they
  were (``torch.where`` on a device flag: no host sync), and envs whose
  trajectory went non-finite restart from a fresh episode.

Params are a dict of float32 tensors applied with
``torch.func.functional_call``; the policy module only gives the
structure.  The metrics are the JAX package's dict of 0-d tensors, plus
``grad_norm``, the mean pre-clip gradient global norm of the updates
taken.

On a CUDA device the phases are the JAX package's compiled, donated
programs (``jax.jit(self._train_step_impl, donate_argnums=0)``, :227;
the curriculum's traced tape, :234-249; ``train_many``, :631): each is a
CUDA graph (core/graphs.py) captured at its first call for each static
signature and replayed, the update graph reading the rollout graph's
static outputs in place, every explicit tape copied into one staging
tape.  Each phase is a body function of its inputs
(``_rollout_body``, ``_update_body``) that syncs nothing with the host.

Test hooks: ``rollout_phase(state, actions=..., start_offsets=...)`` and
``update_phase(state, rollout_out, permutations=...)`` replace the
phase's own draws with given ones, so a test can feed the JAX package's
draws (its threefry stream and torch's never match).
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
from gymfx_tpu_torch.resilience.guards import quarantine_mask, select_tree, tree_all_finite
from gymfx_tpu_torch.train.common import (
    make_train_many_with_data,
    masked_reset,
    minibatch_plan,
    validate_minibatch_scheme,
)
from gymfx_tpu_torch.train.optim import AdamState, ClipAdam, apply_updates
from gymfx_tpu_torch.train.policies import (
    is_token_policy,
    make_obs_encoder,
    make_obs_spec,
    make_trainer_policy,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PPOConfig(NamedTuple):
    n_envs: int = 256
    horizon: int = 128
    epochs: int = 4
    minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-4
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    policy: str = "mlp"
    policy_dtype: Any = torch.float32
    policy_kwargs: Tuple[Tuple[str, Any], ...] = ()
    minibatch_scheme: str = "sample_permute"
    collect_dtype: Any = torch.float32
    nonfinite_guard: bool = True
    opt_state_dtype: Any = torch.float32
    superstep_overlap: bool = False
    update_remat: bool = False


def resolve_collect_dtype(config: Dict[str, Any], policy_dtype) -> Any:
    """Trajectory-obs storage dtype: the narrower of
    ``rollout_collect_dtype`` and the policy compute dtype."""
    cd = _DTYPES[str(config.get("rollout_collect_dtype", "float32"))]
    if policy_dtype == torch.bfloat16 or cd == torch.bfloat16:
        return torch.bfloat16
    return cd


def resolve_optimizer_state_dtype(config: Dict[str, Any]) -> Any:
    """Adam first-moment storage dtype from ``optimizer_state_dtype``;
    params and the second moment stay float32."""
    dt = str(config.get("optimizer_state_dtype", "float32")).lower()
    if dt not in ("float32", "bfloat16"):
        raise ValueError(
            f"optimizer_state_dtype must be 'float32' or 'bfloat16', got {dt!r}"
        )
    return _DTYPES[dt]


def ppo_config_from(config: Dict[str, Any]) -> PPOConfig:
    dt = _DTYPES[str(config.get("policy_dtype", "float32"))]
    return PPOConfig(
        n_envs=int(config.get("num_envs", 256) or 256),
        horizon=int(config.get("ppo_horizon", 128)),
        epochs=int(config.get("ppo_epochs", 4)),
        minibatches=int(config.get("ppo_minibatches", 4)),
        gamma=float(config.get("gamma", 0.99)),
        gae_lambda=float(config.get("gae_lambda", 0.95)),
        clip_eps=float(config.get("ppo_clip_eps", 0.2)),
        lr=float(config.get("learning_rate", 3e-4)),
        ent_coef=float(config.get("entropy_coef", 0.01)),
        vf_coef=float(config.get("value_coef", 0.5)),
        max_grad_norm=float(config.get("max_grad_norm", 0.5)),
        policy=str(config.get("policy") or "mlp"),
        policy_dtype=dt,
        policy_kwargs=tuple(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in (config.get("policy_kwargs") or {}).items()
        ),
        minibatch_scheme=str(config.get("ppo_minibatch_scheme", "env_permute")),
        collect_dtype=resolve_collect_dtype(config, dt),
        nonfinite_guard=bool(config.get("nonfinite_guard", True)),
        opt_state_dtype=resolve_optimizer_state_dtype(config),
        superstep_overlap=bool(config.get("superstep_overlap", False)),
        update_remat=bool(config.get("ppo_update_remat", False)),
    )


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]  # float32 policy params by state-dict name
    opt_state: AdamState
    env_states: EnvState             # (n_envs,) batch
    obs_vec: Any                     # (n_envs, *obs_shape) float32 policy inputs
    generator: torch.Generator       # the phases' draws (actions, offsets, permutations)


def sample_categorical(logits, generator: torch.Generator):
    """One draw per row, by the Gumbel-max trick (jax.random.categorical's
    method, with torch's uniform stream)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=1)


def init_policy_weights(policy: torch.nn.Module, generator: torch.Generator) -> None:
    """Fill every Linear from ``generator``: weights ~ N(0, 1/fan_in),
    biases 0 (flax Dense's lecun-normal scale, untruncated); positional
    embeddings ~ N(0, 0.02²); LayerNorms stay at scale 1, bias 0."""
    with torch.no_grad():
        for module in policy.modules():
            if isinstance(module, torch.nn.Linear):
                w = torch.randn(module.weight.shape, generator=generator,
                                device=generator.device)
                module.weight.copy_(w / module.in_features ** 0.5)
                module.bias.zero_()
        for name, p in policy.named_parameters():
            if name.endswith("pos_embed"):
                p.copy_(0.02 * torch.randn(p.shape, generator=generator, device=generator.device))


class PPOTrainer:
    """PPO for one Environment and PPOConfig.

    On a CUDA device each phase runs from a CUDA graph (core/graphs.py),
    captured at its first call for each static signature and replayed
    after: the rollout phase and the update phase, on either venue (the
    LOB venue's bar is one kernel, K8, so its step is small enough to
    capture).  A capture error raises; nothing falls back to eager on the
    card.  On the CPU both phases run eagerly.  ``_rollout_phase_eager``
    and ``_update_phase_eager`` run a phase op by op on any device, for
    comparisons."""

    def __init__(self, env: Environment, pcfg: PPOConfig):
        if pcfg.superstep_overlap:
            raise not_ported("superstep_overlap (the pipelined superstep driver)", 20)
        if pcfg.update_remat:
            raise not_ported("ppo_update_remat (recomputing the forward in the update)", 21)
        validate_minibatch_scheme(pcfg.minibatch_scheme, pcfg.n_envs, pcfg.minibatches,
                                  horizon=pcfg.horizon)
        self.env = env
        self.pcfg = pcfg
        self.device = env.device
        cfg = env.cfg
        data = env.require_resident_data("PPO training (random-access rollouts)")
        reset_state, reset_obs = env_core.reset(cfg, env.params, data, 1)
        self.obs_spec = make_obs_spec(reset_obs)
        self._encode = make_obs_encoder(pcfg.policy, cfg.window_size, self.obs_spec)
        self._reset_state = reset_state
        self._reset_vec = self._encode(reset_obs)
        self.obs_dim = self.obs_spec.total_size
        self.obs_shape = tuple(self._reset_vec.shape[1:])
        self._random_start = bool(env.config.get("random_episode_start", False))
        in_dim = self.obs_shape[-1] if is_token_policy(pcfg.policy) else self.obs_dim
        self.policy = make_trainer_policy(
            pcfg.policy, in_dim, continuous=cfg.action_space_mode == "continuous",
            dtype=pcfg.policy_dtype, kwargs=dict(pcfg.policy_kwargs), window=cfg.window_size,
        ).to(self.device)
        self.optimizer = ClipAdam(pcfg.lr, pcfg.max_grad_norm, pcfg.opt_state_dtype)
        # the guard's updates-a-phase metric: copied to the device once,
        # here, never inside a captured update phase
        self._guard_updates = torch.tensor(float(pcfg.epochs * pcfg.minibatches),
                                           device=self.device)
        # feed=curriculum: the sampler swaps whole tapes at superstep
        # boundaries, and each phase takes the active tape explicitly
        self.curriculum = env.curriculum
        # the phases' CUDA graphs (core/graphs.py), by static signature;
        # the one generator registered with them, set from the state's
        # generator before each replay; the staging tape every explicit
        # tape is copied into, so one graph serves every tape
        self._graphs_on = self.device.type == "cuda"
        self._graphs: Dict[tuple, graphs.PhaseGraph] = {}
        self._gen = torch.Generator(device=self.device)
        self._staging = None

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        """Policy weights and the phases' generator from ``seed``, a fresh
        optimizer state, every env at the fresh reset state."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        init_policy_weights(self.policy, gen)
        params = {k: v.detach().clone() for k, v in self.policy.named_parameters()}
        n = self.pcfg.n_envs
        env_states = EnvState(*(x.expand(n, *x.shape[1:]).clone() for x in self._reset_state))
        obs_vec = self._reset_vec.expand(n, *self.obs_shape).clone()
        return TrainState(params, self.optimizer.init(params), env_states, obs_vec, gen)

    def policy_forward(self, params: Dict[str, torch.Tensor], x):
        """(logits, value) of the policy with ``params`` on inputs ``x``."""
        return torch.func.functional_call(self.policy, params, (x,))

    # ------------------------------------------------------------------
    def _fresh(self, data):
        """The fresh single-env reset (state, policy input): the env's
        own, or that of an explicit tape."""
        if data is None:
            return self._reset_state, self._reset_vec
        reset_state, reset_obs = env_core.reset(self.env.cfg, self.env.params, data, 1)
        return reset_state, self._encode(reset_obs)

    def rollout_phase(self, state: TrainState, data=None, *, actions=None, start_offsets=None):
        """Collect one horizon on the env's tape, or on the tape ``data``
        (the curriculum's pick: the random-start bank and the fresh reset
        then come from it).  Returns (post-rollout state, (trajectory dict
        of (horizon, n_envs, ...) tensors, bootstrap value (n_envs,))),
        new tensors that no later call overwrites; ``state.generator``
        advances.  On a CUDA device the phase is replayed from its graph,
        on the CPU it runs eagerly.

        ``actions`` ((horizon, n_envs) int) and ``start_offsets``
        ((n_envs,) int) replace the phase's own draws (test hook; on the
        card they are copied into the static buffers of a graph of their
        own)."""
        run = self._rollout_phase_graphed if self._graphs_on else self._rollout_phase_eager
        return run(state, data, actions=actions, start_offsets=start_offsets)

    def _rollout_phase_graphed(self, state: TrainState, data=None, *, actions=None,
                               start_offsets=None):
        """:meth:`rollout_phase` from the rollout graph, its outputs cloned."""
        hooks = self._hooks(actions=actions, start_offsets=start_offsets)
        out = graphs.clone_tree(self._rollout_graphed(state, self._stage(data), hooks).outputs)
        return (state._replace(env_states=out["env_states"], obs_vec=out["obs_vec"]),
                (out["traj"], out["last_value"]))

    def _rollout_phase_eager(self, state: TrainState, data=None, *, actions=None,
                             start_offsets=None):
        """:meth:`rollout_phase` op by op, drawing from ``state.generator``."""
        env_states, obs_vec, traj, last_value = self._rollout_body(
            state.params, state.env_states, state.obs_vec, data, state.generator,
            actions, start_offsets)
        return state._replace(env_states=env_states, obs_vec=obs_vec), (traj, last_value)

    @torch.no_grad()
    def _rollout_body(self, params, env_states, obs_vec, data, gen, actions=None,
                      start_offsets=None):
        """The rollout phase as a function of its inputs, drawing from
        ``gen``: (env states, obs_vec, trajectory, bootstrap value).  It
        syncs nothing with the host, so it is what the rollout graph
        captures."""
        env, cfg, pcfg = self.env, self.env.cfg, self.pcfg
        n, horizon = pcfg.n_envs, pcfg.horizon
        tape = env.data if data is None else data
        if self._random_start:
            if start_offsets is None:
                start_offsets = torch.randint(
                    0, max(1, cfg.n_bars - 2), (n,), generator=gen, device=self.device
                )
            reset_state, fresh_obs = env_core.reset_at(
                cfg, env.params, tape, start_offsets.to(self.device)
            )
            reset_vec = self._encode(fresh_obs)
        else:
            reset_state, reset_vec = self._fresh(data)

        dev = self.device
        traj = {
            "obs": torch.empty((horizon, n, *self.obs_shape), dtype=pcfg.collect_dtype, device=dev),
            "action": torch.empty((horizon, n), dtype=torch.int32, device=dev),
            "logp": torch.empty((horizon, n), dtype=torch.float32, device=dev),
            "value": torch.empty((horizon, n), dtype=torch.float32, device=dev),
            "reward": torch.empty((horizon, n), dtype=torch.float32, device=dev),
            "done": torch.empty((horizon, n), dtype=torch.bool, device=dev),
        }
        for t in range(horizon):
            logits, value = self.policy_forward(params, obs_vec)
            if actions is None:
                action = sample_categorical(logits, gen)
            else:
                action = actions[t].to(device=dev, dtype=torch.int64)
            logp = F.log_softmax(logits, dim=1).gather(1, action[:, None])[:, 0]
            env_states2, reward, done, _ = env_core.transition(
                cfg, env.params, tape, env_states, action
            )
            obs_vec2 = self._encode(env_core.build_obs(env_states2, tape, cfg, env.params))
            traj["obs"][t] = obs_vec
            traj["action"][t] = action
            traj["logp"][t] = logp
            traj["value"][t] = value
            traj["reward"][t] = reward
            traj["done"][t] = done
            env_states = masked_reset(done, reset_state, env_states2)
            obs_vec = masked_reset(done, reset_vec, obs_vec2)
        _, last_value = self.policy_forward(params, obs_vec)
        return env_states, obs_vec, traj, last_value

    # ------------------------------------------------------------------
    def _gae(self, traj, last_value):
        """(advantages, returns), each (horizon, n_envs): a reverse loop
        over time."""
        g, lam = self.pcfg.gamma, self.pcfg.gae_lambda
        reward, value, done = traj["reward"], traj["value"], traj["done"]
        advs = torch.empty_like(reward)
        adv_next, v_next = torch.zeros_like(last_value), last_value
        for t in range(reward.shape[0] - 1, -1, -1):
            nonterm = 1.0 - done[t].to(torch.float32)
            delta = reward[t] + g * v_next * nonterm - value[t]
            adv_next = delta + g * lam * nonterm * adv_next
            advs[t] = adv_next
            v_next = value[t]
        return advs, advs + value

    def _loss(self, params, batch):
        """(total loss, dict of its terms) of one flat minibatch."""
        logits, value = self.policy_forward(params, batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, batch["action"].to(torch.int64)[:, None])[:, 0]
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        clip_eps = self.pcfg.clip_eps
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
        policy_loss = -torch.mean(torch.minimum(unclipped, clipped))
        value_loss = 0.5 * torch.mean((value - batch["ret"]) ** 2)
        total = policy_loss + self.pcfg.vf_coef * value_loss - self.pcfg.ent_coef * entropy
        return total, dict(policy_loss=policy_loss, value_loss=value_loss, entropy=entropy)

    def loss_and_grads(self, params, batch):
        """(loss, loss terms, gradients by param name) of one minibatch."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            loss, aux = self._loss(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return (loss.detach(), {k: a.detach() for k, a in aux.items()},
                dict(zip(leaves.keys(), grads)))

    def update_phase(self, state: TrainState, rollout_out, data=None, *, permutations=None):
        """GAE, the minibatched epochs and the guard's bookkeeping on one
        collected trajectory.  Returns (new state, metrics dict of 0-d
        tensors), new tensors that no later call overwrites;
        ``state.generator`` advances.  Quarantined envs restart from the
        fresh reset of the active tape ``data`` (the env's own when None).
        On a CUDA device the phase is replayed from its graph (every
        venue), on the CPU it runs eagerly.  ``permutations`` ((epochs,
        n_perm) int) replaces the per-epoch draws (test hook; on the card
        copied into the static buffer of a graph of its own)."""
        run = self._update_phase_graphed if self._graphs_on else self._update_phase_eager
        return run(state, rollout_out, data, permutations=permutations)

    def _update_phase_graphed(self, state: TrainState, rollout_out, data=None, *,
                              permutations=None):
        """:meth:`update_phase` from the update graph, its outputs cloned."""
        traj, last_value = rollout_out
        inputs = dict(params=state.params, opt_state=state.opt_state, env_states=state.env_states,
                      obs_vec=state.obs_vec, traj=traj, last_value=last_value,
                      **self._hooks(permutations=permutations))
        out = graphs.clone_tree(
            self._update_graphed(inputs, self._stage(data), state.generator).outputs)
        return self._updated_state(out, state.generator), out["metrics"]

    def _update_phase_eager(self, state: TrainState, rollout_out, data=None, *,
                            permutations=None):
        """:meth:`update_phase` op by op, drawing from ``state.generator``."""
        traj, last_value = rollout_out
        out = self._update_body(state.params, state.opt_state, state.env_states, state.obs_vec,
                                traj, last_value, data, state.generator, permutations)
        return self._updated_state(out, state.generator), out["metrics"]

    @staticmethod
    def _updated_state(out, generator) -> TrainState:
        return TrainState(out["params"], out["opt_state"], out["env_states"], out["obs_vec"],
                          generator)

    def _update_body(self, params, opt_state, env_states, obs_vec, traj, last_value, data, gen,
                     permutations=None):
        """The update phase as a function of its inputs, drawing from
        ``gen``: a dict of params, opt_state, env_states, obs_vec and
        metrics.  It syncs nothing with the host, so it is what the update
        graph captures."""
        pcfg = self.pcfg
        advs, returns = self._gae(traj, last_value)
        fields = {"obs": traj["obs"], "action": traj["action"], "logp": traj["logp"],
                  "adv": advs, "ret": returns}
        n_perm, mb, take = minibatch_plan(
            fields, scheme=pcfg.minibatch_scheme, n_envs=pcfg.n_envs,
            horizon=pcfg.horizon, minibatches=pcfg.minibatches,
        )
        guard = pcfg.nonfinite_guard
        losses, terms, oks, norms = [], [], [], []
        for epoch in range(pcfg.epochs):
            if permutations is None:
                perm = torch.randperm(n_perm, generator=gen, device=self.device)
            else:
                perm = permutations[epoch].to(self.device)
            for i in range(pcfg.minibatches):
                batch = take(perm[i * mb:(i + 1) * mb])
                loss, aux, grads = self.loss_and_grads(params, batch)
                updates, new_opt_state, g_norm = self.optimizer.update(grads, opt_state)
                new_params = apply_updates(params, updates)
                if guard:
                    # a non-finite loss or gradient keeps the last-good
                    # params and moments bit for bit
                    ok = torch.isfinite(loss) & tree_all_finite(grads)
                    params = select_tree(ok, new_params, params)
                    opt_state = select_tree(ok, new_opt_state, opt_state)
                else:
                    ok = torch.ones((), dtype=torch.bool, device=self.device)
                    params, opt_state = new_params, new_opt_state
                losses.append(loss)
                terms.append(aux)
                oks.append(ok)
                norms.append(g_norm)
        losses, norms = torch.stack(losses), torch.stack(norms)
        stacked = {k: torch.stack([t[k] for t in terms]) for k in terms[0]}
        if guard:
            okf = torch.stack(oks).to(torch.float32)
            n_ok = okf.sum()

            def mmean(x):
                # mean over the updates taken; NaN when every one was skipped
                safe = torch.where(torch.isfinite(x), x, 0.0)
                return torch.where(n_ok > 0, (safe * okf).sum() / torch.clamp_min(n_ok, 1.0),
                                   torch.nan)

            metrics = dict(
                loss=mmean(losses),
                policy_loss=mmean(stacked["policy_loss"]),
                value_loss=mmean(stacked["value_loss"]),
                entropy=mmean(stacked["entropy"]),
                mean_reward=traj["reward"].mean(),
                mean_episode_done=traj["done"].to(torch.float32).mean(),
                nonfinite_skips=(1.0 - okf).sum(),
                guard_updates=self._guard_updates,
                grad_norm=mmean(norms),
            )
            # quarantine: envs whose rollout or carried state went
            # non-finite restart from a fresh episode
            poison = quarantine_mask(
                {"reward": traj["reward"], "obs": traj["obs"], "value": traj["value"],
                 "logp": traj["logp"]},
                env_axis=1,
            ) | quarantine_mask({"obs_vec": obs_vec, "env_states": env_states},
                                env_axis=0, mode="nan")
            reset_state, reset_vec = self._fresh(data)
            env_states = masked_reset(poison, reset_state, env_states)
            obs_vec = masked_reset(poison, reset_vec, obs_vec)
            metrics["poisoned_env_resets"] = poison.to(torch.float32).sum()
        else:
            metrics = dict(
                loss=losses.mean(),
                policy_loss=stacked["policy_loss"].mean(),
                value_loss=stacked["value_loss"].mean(),
                entropy=stacked["entropy"].mean(),
                mean_reward=traj["reward"].mean(),
                mean_episode_done=traj["done"].to(torch.float32).mean(),
                grad_norm=norms.mean(),
            )
        return dict(params=params, opt_state=opt_state, env_states=env_states, obs_vec=obs_vec,
                    metrics=metrics)

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, data=None):
        """One rollout phase then one update phase, on the env's tape or
        on ``data``: (state, metrics).

        On a CUDA device the two graphs replay back to back, the update
        graph reading the rollout graph's static outputs in place, and
        the returned state's tensors are the update graph's static
        outputs: the next train step or ``train_many`` overwrites them
        (the port's form of JAX's ``donate_argnums=0``; clone what must
        outlive it).  The metrics are new tensors."""
        if not self._graphs_on:
            inter, rollout_out = self.rollout_phase(state, data)
            return self.update_phase(inter, rollout_out, data)
        state, stacked = self._train_many_graphed(state, data, 1)
        return state, {key: v[0] for key, v in stacked.items()}

    def train_many(self, state: TrainState, k: int):
        """``k`` train steps on the env's tape: (state, metrics stacked on
        a leading ``(k,)`` axis); see :meth:`train_many_with_data`."""
        return self.train_many_with_data(state, None, k)

    def train_many_with_data(self, state: TrainState, data, k: int):
        """``k`` train steps on one tape (the JAX package's
        ``make_train_many_with_data``, gymfx_tpu/train/common.py:43-57):
        (state, metrics stacked on a leading ``(k,)`` axis).  On a CUDA
        device ``data`` is copied into the staging tape once, the 2k
        replays are chained with no host round trip, and the metrics are
        stacked on the device (the caller fetches them once); the state is
        donated as in :meth:`train_step`."""
        run = self._train_many_graphed if self._graphs_on else \
            make_train_many_with_data(self.train_step)
        return run(state, data, k)

    def _train_many_graphed(self, state: TrainState, data, k: int):
        """:meth:`train_many_with_data` from the graphs."""
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
    def _hooks(self, **hooks):
        """The test hooks that are set, on the device: static inputs of a
        graph of their own."""
        return {k: v.to(self.device) for k, v in hooks.items() if v is not None}

    def _stage(self, data):
        """The tape the graphs read for ``data``: None for the env's own,
        else the staging tape with ``data``'s tensors copied in (every tape
        of a curriculum has one shape, so one staging tape, and one graph
        keyed on it, serves them all; the graphs hold it, so it is never
        freed under them)."""
        if data is None:
            return None
        fields = {k: v for k, v in data._asdict().items() if isinstance(v, torch.Tensor)}
        staging = self._staging
        if staging is None or graphs.signature(data) != graphs.signature(staging):
            self._staging = data._replace(**{k: v.clone() for k, v in fields.items()})
            return self._staging
        graphs.copy_tree({k: getattr(staging, k) for k in fields}, fields)
        return staging

    def _graph(self, kind: str, inputs, tape, build):
        """The cached graph of ``kind`` for this static signature (built by
        ``build()`` on a miss)."""
        key = (kind, id(tape), self.pcfg, self.env.cfg, tuple(sorted(inputs)),
               graphs.signature(inputs))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = build()
        return graph

    def _replay(self, graph, inputs, generator):
        """Run ``graph`` on ``inputs`` from ``generator``'s state, advance
        ``generator`` as the eager phase would, and return ``graph``."""
        self._gen.set_state(generator.get_state())
        graph(inputs)
        generator.set_state(self._gen.get_state())
        return graph

    def _rollout_graphed(self, state: TrainState, tape, hooks):
        """The rollout graph for ``state`` on ``tape`` (None or the staging
        tape), run: its static outputs are env_states, obs_vec, traj and
        last_value."""
        inputs = dict(params=state.params, env_states=state.env_states, obs_vec=state.obs_vec,
                      **hooks)

        def body(x):
            env_states, obs_vec, traj, last_value = self._rollout_body(
                x["params"], x["env_states"], x["obs_vec"], tape, self._gen,
                x.get("actions"), x.get("start_offsets"))
            return dict(env_states=env_states, obs_vec=obs_vec, traj=traj, last_value=last_value)

        graph = self._graph("rollout", inputs, tape, lambda: graphs.PhaseGraph(
            body, graphs.clone_tree(inputs), self._gen))
        return self._replay(graph, inputs, state.generator)

    def _update_graphed(self, inputs, tape, generator, shared=()):
        """The update graph for ``inputs`` on ``tape``, run: its static
        outputs are params, opt_state, env_states, obs_vec and metrics.  A
        graph built here takes the tensors of ``inputs`` named in
        ``shared`` as its static buffers (the rollout graph's), and copies
        of the rest."""

        def body(x):
            return self._update_body(x["params"], x["opt_state"], x["env_states"], x["obs_vec"],
                                     x["traj"], x["last_value"], tape, self._gen,
                                     x.get("permutations"))

        graph = self._graph("update", inputs, tape, lambda: graphs.PhaseGraph(body, {
            k: v if k in shared else graphs.clone_tree(v) for k, v in inputs.items()}, self._gen))
        return self._replay(graph, inputs, generator)

    def _train_step_graphed(self, state: TrainState, tape):
        """One train step from the graphs on ``tape``: (state, metrics),
        both the update graph's static outputs.  The update graph's static
        inputs are the rollout graph's static buffers, so nothing is
        copied between the two."""
        graph = self._rollout_graphed(state, tape, {})
        inputs = dict(params=graph.inputs["params"], opt_state=state.opt_state, **graph.outputs)
        shared = ("params", "env_states", "obs_vec", "traj", "last_value")
        out = self._update_graphed(inputs, tape, state.generator, shared).outputs
        return self._updated_state(out, state.generator), out["metrics"]

    def train(self, total_env_steps: int, seed: int = 0, log_every: int = 0,
              initial_params=None, initial_state: Optional[TrainState] = None, *,
              supersteps_per_dispatch: int = 1, checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0, step_offset: int = 0, checkpoint_metadata=None,
              max_consecutive_skips: Optional[int] = None, preempt_at: Optional[int] = None,
              telemetry=None, mesh_faults=(), checkpoint_keep: int = 0):
        """Run PPO for about ``total_env_steps`` env steps (the JAX
        package's loop, train/ppo.py:637-802): ``total_env_steps //
        (n_envs * horizon)`` iterations (at least one), in supersteps of
        ``supersteps_per_dispatch`` train steps.  Under ``feed=curriculum``
        each superstep boundary draws one tape (``curriculum.pick``) and
        the superstep trains on it.  ``initial_state`` continues a run,
        ``initial_params`` warm-starts the params.

        Returns ``(state, metrics)``: the last iteration's metrics as
        floats plus ``env_steps_per_sec``, ``iterations`` and
        ``total_env_steps``.  Logging, checkpoints, the divergence
        watchdog, preemption, telemetry and mesh faults come with ROADMAP
        Queue 1 item 10 and raise when set."""
        unported = dict(log_every=log_every, checkpoint_dir=checkpoint_dir,
                        checkpoint_every=checkpoint_every, step_offset=step_offset,
                        checkpoint_metadata=checkpoint_metadata,
                        max_consecutive_skips=max_consecutive_skips, preempt_at=preempt_at,
                        telemetry=telemetry, mesh_faults=mesh_faults,
                        checkpoint_keep=checkpoint_keep)
        for name, value in unported.items():
            if value or (name == "max_consecutive_skips" and value is not None):
                raise not_ported(f"PPOTrainer.train({name}=...)", 10)
        state = self.init_state(seed) if initial_state is None else initial_state
        if initial_params is not None:
            state = state._replace(params=initial_params)
        steps_per_iter = self.pcfg.n_envs * self.pcfg.horizon
        iters = max(1, int(total_env_steps) // steps_per_iter)
        K = max(1, int(supersteps_per_dispatch or 1))
        t0 = time.perf_counter()
        metrics: Dict[str, Any] = {}
        it = 0
        while it < iters:
            k = min(K, iters - it)
            tape = None
            if self.curriculum is not None:
                # one weighted seed-deterministic tape per superstep boundary
                _, _, tape = self.curriculum.pick(it)
            if k == 1:
                state, metrics = self.train_step(state, tape)
            else:
                state, stacked = self.train_many_with_data(state, tape, k)
                metrics = {key: v[-1] for key, v in stacked.items()}
            it += k
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        out = {key: float(v) for key, v in metrics.items()}
        out["env_steps_per_sec"] = steps_per_iter * iters / dt
        out["iterations"] = iters
        out["total_env_steps"] = steps_per_iter * iters
        return state, out
