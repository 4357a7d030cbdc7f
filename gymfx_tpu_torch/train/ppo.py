"""PPO's rollout phase: the policy acting on the batched env.

The port of ``gymfx_tpu/train/ppo.py`` lines 45-170, 272-386 and
452-467: :class:`PPOConfig`, :func:`ppo_config_from`,
:func:`resolve_collect_dtype`, and :class:`PPORollout` holding
``init_state(seed)`` and ``rollout_phase(state)``.  One rollout phase
runs ``horizon`` steps: the MLP policy acts (categorical draw from a
``torch.Generator``), every env steps through the kernel chain
(core/env.transition), done envs auto-reset (from random start offsets
when ``random_episode_start`` is set), and the trajectory is stored with
obs in ``collect_dtype``.  The update phase (GAE, the clipped loss,
clip-by-global-norm Adam) comes with ROADMAP.md Queue 1 item 6.

Test hook: ``rollout_phase(state, actions=..., start_offsets=...)``
replaces the phase's own draws with given ones, so a test can feed it
the JAX package's draws (its threefry stream and torch's never match).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.nn import functional as F

from gymfx_tpu_torch.core import env as env_core
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.core.types import EnvState
from gymfx_tpu_torch.train.common import masked_reset
from gymfx_tpu_torch.train.policies import flatten_obs, make_obs_spec, make_policy

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


def resolve_collect_dtype(config: Dict[str, Any], policy_dtype) -> Any:
    """Trajectory-obs storage dtype: the narrower of
    ``rollout_collect_dtype`` and the policy compute dtype."""
    cd = _DTYPES[str(config.get("rollout_collect_dtype", "float32"))]
    if policy_dtype == torch.bfloat16 or cd == torch.bfloat16:
        return torch.bfloat16
    return cd


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
    )


class RolloutState(NamedTuple):
    env_states: EnvState       # (n_envs,) batch
    obs_vec: Any               # (n_envs, obs_dim) float32 policy inputs
    generator: torch.Generator  # the phase's draws (actions, start offsets)


def sample_categorical(logits, generator: torch.Generator):
    """One draw per row, by the Gumbel-max trick (jax.random.categorical's
    method, with torch's uniform stream)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=1)


def init_policy_weights(policy: torch.nn.Module, generator: torch.Generator) -> None:
    """Fill every Linear from ``generator``: weights ~ N(0, 1/fan_in),
    biases 0 (flax Dense's lecun-normal scale, untruncated)."""
    with torch.no_grad():
        for module in policy.modules():
            if isinstance(module, torch.nn.Linear):
                w = torch.randn(module.weight.shape, generator=generator,
                                device=generator.device)
                module.weight.copy_(w / module.in_features ** 0.5)
                module.bias.zero_()


class PPORollout:
    """The rollout phase of PPO for one Environment and PPOConfig."""

    def __init__(self, env: Environment, pcfg: PPOConfig):
        self.env = env
        self.pcfg = pcfg
        self.device = env.device
        cfg = env.cfg
        reset_state, reset_obs = env_core.reset(cfg, env.params, env.data, 1)
        self.obs_spec = make_obs_spec(reset_obs)
        self._reset_state = reset_state
        self._reset_vec = flatten_obs(reset_obs, self.obs_spec)
        self.obs_dim = self.obs_spec.total_size
        self._random_start = bool(env.config.get("random_episode_start", False))
        self.policy = make_policy(
            pcfg.policy, self.obs_dim,
            continuous=cfg.action_space_mode == "continuous",
            dtype=pcfg.policy_dtype, kwargs=dict(pcfg.policy_kwargs),
        ).to(self.device)

    def init_state(self, seed: int = 0) -> RolloutState:
        """Policy weights and the phase's generator from ``seed``; every
        env at the fresh reset state."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        init_policy_weights(self.policy, gen)
        n = self.pcfg.n_envs
        env_states = EnvState(*(x.expand(n, *x.shape[1:]).clone() for x in self._reset_state))
        obs_vec = self._reset_vec.expand(n, -1).clone()
        return RolloutState(env_states, obs_vec, gen)

    @torch.no_grad()
    def rollout_phase(self, state: RolloutState, *, actions=None, start_offsets=None):
        """Collect one horizon.  Returns (post-rollout state, trajectory
        dict of (horizon, n_envs, ...) tensors, bootstrap value (n_envs,)).

        ``actions`` ((horizon, n_envs) int) and ``start_offsets``
        ((n_envs,) int) replace the phase's own draws (test hook)."""
        env, cfg, pcfg = self.env, self.env.cfg, self.pcfg
        gen = state.generator
        n, horizon = pcfg.n_envs, pcfg.horizon
        if self._random_start:
            if start_offsets is None:
                start_offsets = torch.randint(
                    0, max(1, cfg.n_bars - 2), (n,), generator=gen, device=self.device
                )
            reset_state, fresh_obs = env_core.reset_at(
                cfg, env.params, env.data, start_offsets.to(self.device)
            )
            reset_vec = flatten_obs(fresh_obs, self.obs_spec)
        else:
            reset_state, reset_vec = self._reset_state, self._reset_vec

        dev = self.device
        traj = {
            "obs": torch.empty((horizon, n, self.obs_dim), dtype=pcfg.collect_dtype, device=dev),
            "action": torch.empty((horizon, n), dtype=torch.int32, device=dev),
            "logp": torch.empty((horizon, n), dtype=torch.float32, device=dev),
            "value": torch.empty((horizon, n), dtype=torch.float32, device=dev),
            "reward": torch.empty((horizon, n), dtype=torch.float32, device=dev),
            "done": torch.empty((horizon, n), dtype=torch.bool, device=dev),
        }
        env_states, obs_vec = state.env_states, state.obs_vec
        for t in range(horizon):
            logits, value = self.policy(obs_vec)
            if actions is None:
                action = sample_categorical(logits, gen)
            else:
                action = actions[t].to(device=dev, dtype=torch.int64)
            logp = F.log_softmax(logits, dim=1).gather(1, action[:, None])[:, 0]
            env_states2, reward, done, _ = env_core.transition(
                cfg, env.params, env.data, env_states, action
            )
            obs_vec2 = flatten_obs(env_core.build_obs(env_states2, env.data, cfg, env.params),
                                   self.obs_spec)
            traj["obs"][t] = obs_vec
            traj["action"][t] = action
            traj["logp"][t] = logp
            traj["value"][t] = value
            traj["reward"][t] = reward
            traj["done"][t] = done
            env_states = masked_reset(done, reset_state, env_states2)
            obs_vec = masked_reset(done, reset_vec, obs_vec2)
        _, last_value = self.policy(obs_vec)
        return RolloutState(env_states, obs_vec, gen), traj, last_value
