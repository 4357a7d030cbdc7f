"""Shared trainer helpers: the port of ``gymfx_tpu/train/common.py``'s
``make_train_many_with_data`` (:43-57), ``validate_minibatch_scheme`` and
``resolve_minibatch_scheme`` (:315-371), ``minibatch_plan`` (:374-409)
and ``masked_reset``.

Trees of fields are dicts of tensors.  ``make_train_many_with_data`` is
the eager loop (the CPU's): on a CUDA device ``PPOTrainer`` chains its
phases' graph replays instead (train/ppo.py); either way the metrics
come back stacked on a leading ``(k,)`` axis, on the device.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional

import torch


def masked_reset(done, fresh, cur):
    """Where ``done`` ((N,) bool), replace each env's entry of ``cur``
    with ``fresh``'s (a tensor or a NamedTuple of tensors; ``fresh``
    broadcasts over the env axis, so a single-env (1, ...) reset state
    serves every env)."""

    def one(f, c):
        return torch.where(done.view(-1, *([1] * (c.dim() - 1))), f, c)

    if isinstance(cur, tuple):
        return type(cur)(*(one(f, c) for f, c in zip(fresh, cur)))
    return one(fresh, cur)


def make_train_many_with_data(step: Callable):
    """The curriculum's ``train_many(state, data, k)``: ``k`` train steps
    of ``step(state, data) -> (state, metrics)`` on one tape, the metrics
    stacked on a leading ``(k,)`` axis (the JAX package's
    ``make_train_many_with_data``, :43-57)."""

    def train_many(state, data, k: int):
        k = int(k)
        if k < 1:
            raise ValueError(f"train_many needs k >= 1, got {k}")
        history = []
        for _ in range(k):
            state, metrics = step(state, data)
            history.append(metrics)
        return state, {key: torch.stack([m[key] for m in history]) for key in history[0]}

    return train_many


def validate_minibatch_scheme(scheme: str, n_envs: int, minibatches: int,
                              *, horizon: Optional[int] = None) -> None:
    """Construction-time validation shared by the PPO trainers."""
    if scheme not in ("sample_permute", "env_permute"):
        raise ValueError(
            "ppo_minibatch_scheme must be 'sample_permute' or "
            f"'env_permute', got {scheme!r}"
        )
    if scheme == "env_permute" and n_envs % minibatches:
        raise ValueError(
            f"env_permute needs num_envs ({n_envs}) divisible by "
            f"ppo_minibatches ({minibatches})"
        )
    if scheme == "sample_permute" and horizon is not None:
        # the plan slices floor(T*N / minibatches) samples per minibatch,
        # so a remainder is never trained on in that epoch
        total = int(horizon) * int(n_envs)
        dropped = total % int(minibatches)
        if dropped:
            warnings.warn(
                f"sample_permute drops {dropped} of {total} samples per "
                f"epoch (horizon*num_envs={total} not divisible by "
                f"ppo_minibatches={minibatches}); pick sizes where "
                "horizon*num_envs % minibatches == 0 to train on every "
                "sample",
                stacklevel=2,
            )


def resolve_minibatch_scheme(config, n_envs: int, minibatches: int) -> None:
    """From-config resolution of the env_permute default: with fewer envs
    than minibatches no whole-trajectory minibatch exists, so degrade to
    sample_permute with a warning.  Mutates ``config`` in place."""
    scheme = str(config.get("ppo_minibatch_scheme", "env_permute"))
    if scheme == "env_permute" and int(n_envs) < int(minibatches):
        warnings.warn(
            f"ppo_minibatch_scheme=env_permute needs num_envs "
            f"({n_envs}) >= ppo_minibatches ({minibatches}); falling "
            "back to sample_permute for this run — raise num_envs to a "
            "multiple of ppo_minibatches to use trajectory minibatches",
            stacklevel=2,
        )
        config["ppo_minibatch_scheme"] = "sample_permute"


def minibatch_plan(fields: Dict[str, torch.Tensor], *, scheme: str, n_envs: int,
                   horizon: int, minibatches: int):
    """``(n_perm, mb, take)``: a per-epoch permutation of ``n_perm``
    indices is cut into ``minibatches`` chunks of ``mb``, and ``take(idx)``
    gathers one flat minibatch from the (T, N, ...) ``fields``.

      sample_permute  an iid shuffle of all T*N samples;
      env_permute     permute envs; a minibatch holds whole (T, ...)
                      trajectories, flattened env-major.
    """
    if scheme == "env_permute":
        source = {k: x.swapaxes(0, 1) for k, x in fields.items()}
        mb = n_envs // minibatches

        def take(idx):
            return {k: x[idx].reshape(mb * horizon, *x.shape[2:]) for k, x in source.items()}

        return n_envs, mb, take

    n_total = horizon * n_envs
    source = {k: x.reshape(n_total, *x.shape[2:]) for k, x in fields.items()}

    def take(idx):
        return {k: x[idx] for k, x in source.items()}

    return n_total, n_total // minibatches, take
