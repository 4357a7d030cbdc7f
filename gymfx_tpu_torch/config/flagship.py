"""The flagship configuration the port is measured at.

The JAX package's bench.py PPO configuration (bench.py:372-401: 8,192
bar-venue envs, window 32, horizon 64, the 3x256 tanh MLP in bf16, bf16
trajectory obs, both rollout kernel knobs on) plus the OHLCV feature
columns, so the feature-window kernel K1 runs: with no feature columns
``n_features`` is 0 and bench.py's rollout never reaches it.
"""
from __future__ import annotations

from typing import Any, Dict

from gymfx_tpu_torch.config.defaults import DEFAULT_VALUES

FEATURE_COLUMNS = ["OPEN", "HIGH", "LOW", "CLOSE", "VOLUME"]


def flagship_config(input_data_file: str, **over) -> Dict[str, Any]:
    config = dict(DEFAULT_VALUES)
    config.update(
        input_data_file=input_data_file,
        num_envs=8192,
        ppo_horizon=64,
        ppo_epochs=1,
        ppo_minibatches=4,
        policy="mlp",
        policy_dtype="bfloat16",
        ppo_minibatch_scheme="env_permute",
        window_size=32,
        rollout_obs_kernel="on",
        rollout_collect_dtype="bfloat16",
        rollout_env_kernel="on",
        feature_columns=list(FEATURE_COLUMNS),
    )
    config.update(over)
    return config
