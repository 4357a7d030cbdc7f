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
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.core.types import EnvState, not_ported
from gymfx_tpu_torch.resilience.guards import quarantine_mask, select_tree, tree_all_finite
from gymfx_tpu_torch.train.common import (
    make_train_many,
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
    """PPO for one Environment and PPOConfig."""

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
        self.train_many = make_train_many(self.train_step)
        # feed=curriculum: the sampler swaps whole tapes at superstep
        # boundaries, and each phase takes the active tape explicitly
        self.curriculum = env.curriculum
        self.train_many_with_data = make_train_many_with_data(self.train_step)

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

    @torch.no_grad()
    def rollout_phase(self, state: TrainState, data=None, *, actions=None, start_offsets=None):
        """Collect one horizon on the env's tape, or on the tape ``data``
        (the curriculum's pick: the random-start bank and the fresh reset
        then come from it).  Returns (post-rollout state, (trajectory dict
        of (horizon, n_envs, ...) tensors, bootstrap value (n_envs,))).

        ``actions`` ((horizon, n_envs) int) and ``start_offsets``
        ((n_envs,) int) replace the phase's own draws (test hook)."""
        env, cfg, pcfg = self.env, self.env.cfg, self.pcfg
        gen, params = state.generator, state.params
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
        env_states, obs_vec = state.env_states, state.obs_vec
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
        return state._replace(env_states=env_states, obs_vec=obs_vec), (traj, last_value)

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
        tensors).  Quarantined envs restart from the fresh reset of the
        active tape ``data`` (the env's own when None).  ``permutations``
        ((epochs, n_perm) int) replaces the per-epoch draws (test hook)."""
        pcfg = self.pcfg
        traj, last_value = rollout_out
        advs, returns = self._gae(traj, last_value)
        fields = {"obs": traj["obs"], "action": traj["action"], "logp": traj["logp"],
                  "adv": advs, "ret": returns}
        n_perm, mb, take = minibatch_plan(
            fields, scheme=pcfg.minibatch_scheme, n_envs=pcfg.n_envs,
            horizon=pcfg.horizon, minibatches=pcfg.minibatches,
        )
        params, opt_state = state.params, state.opt_state
        guard = pcfg.nonfinite_guard
        losses, terms, oks, norms = [], [], [], []
        for epoch in range(pcfg.epochs):
            if permutations is None:
                perm = torch.randperm(n_perm, generator=state.generator, device=self.device)
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
        env_states, obs_vec = state.env_states, state.obs_vec
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
                guard_updates=torch.tensor(float(pcfg.epochs * pcfg.minibatches),
                                           device=self.device),
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
        new_state = TrainState(params, opt_state, env_states, obs_vec, state.generator)
        return new_state, metrics

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, data=None):
        """One rollout phase then one update phase, on the env's tape or
        on ``data``: (state, metrics)."""
        inter, rollout_out = self.rollout_phase(state, data)
        return self.update_phase(inter, rollout_out, data)

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
