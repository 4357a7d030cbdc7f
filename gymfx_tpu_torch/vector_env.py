"""The Gymnasium VectorEnv over the port's batched env step.

The port of ``gymfx_tpu/vector_env.py``: external RL libraries consume
batched envs through the ``gymnasium.vector.VectorEnv`` API, and
:class:`GymFxVectorEnv` serves them from one batched step of ``num_envs``
rows (no subprocesses, no env copies).  On the card the step is one CUDA
graph (``gym_env.StepProgram``: the batch's state and the previous
step's done flags its static inputs, updated in place; obs, reward and
done packed and copied to pinned host memory behind one event); on the
CPU op by op.

It follows gymnasium's next-step autoreset: an env that terminated at
step t returns its fresh reset observation at step t+1, with reward 0
and done False, and its action at t+1 is discarded (it was conditioned
on the previous episode's terminal observation).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from gymfx_tpu_torch.core import env as env_core
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.gym_compat import VectorEnv, batch_space
from gymfx_tpu_torch.gym_env import (
    StepProgram,
    action_space_for,
    actions_tensor,
    build_base_observation_space,
)
from gymfx_tpu_torch.train.common import masked_reset


class GymFxVectorEnv(VectorEnv):
    """``num_envs`` envs of one config as one gymnasium VectorEnv
    (``device``: CUDA unless the caller names another)."""

    def __init__(self, config: Dict[str, Any], num_envs: int, dataset=None, *, device=None):
        self._env = Environment(config, dataset=dataset, device=device)
        cfg = self._env.cfg
        self.num_envs = int(num_envs)
        self.single_observation_space = build_base_observation_space(
            self._env.config, window_size=cfg.window_size)
        self.single_action_space = action_space_for(cfg)
        self.observation_space = batch_space(self.single_observation_space, self.num_envs)
        self.action_space = batch_space(self.single_action_space, self.num_envs)

        env, n = self._env, self.num_envs
        data = env.require_resident_data("GymFxVectorEnv")
        fresh_state, fresh_obs = env_core.reset(cfg, env.params, data, 1)
        self._fresh = (fresh_state, fresh_obs)

        def step_fn(carry, actions):
            states, prev_done = carry
            stepped, obs, reward, done, _ = env_core.step(cfg, env.params, data, states, actions)
            # next-step autoreset: an env that terminated last step takes
            # this step as its reset
            states = masked_reset(prev_done, fresh_state, stepped)
            obs = {k: masked_reset(prev_done, fresh_obs[k], v) for k, v in obs.items()}
            reward = torch.where(prev_done, torch.zeros_like(reward), reward)
            done = torch.where(prev_done, torch.zeros_like(done), done)
            return (states, done), (obs, reward, done)

        self._program = StepProgram(step_fn, None, env.device)
        self._started = False
        self._n = n

    @property
    def device(self) -> torch.device:
        return self._env.device

    # ------------------------------------------------------------------
    def reset(self, *, seed: Optional[int] = None, options=None):
        fresh_state, fresh_obs = self._fresh
        n = self._n
        states = type(fresh_state)(*(x.expand(n, *x.shape[1:]).clone() for x in fresh_state))
        prev_done = torch.zeros((n,), dtype=torch.bool, device=self.device)
        self._program.load((states, prev_done))
        self._started = True
        obs = {k: v.expand(n, *v.shape[1:]).cpu().numpy() for k, v in fresh_obs.items()}
        return self._np_obs(obs), {}

    def step(self, actions):
        if not self._started:
            raise RuntimeError("Call reset() before step().")
        obs, reward, done = self._program.step(actions_tensor(actions, self._n))
        terminations = np.asarray(done, bool)
        return (self._np_obs(obs), np.asarray(reward, np.float32), terminations,
                np.zeros(self._n, bool), {})

    def close_extras(self, **kwargs):
        self._started = False

    @staticmethod
    def _np_obs(obs) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v, np.float32) for k, v in obs.items()}
