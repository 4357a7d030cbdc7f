"""The configurations the port is measured at.

``flagship_config``: the JAX package's bench.py PPO configuration (bench.py:372-401: 8,192
bar-venue envs, window 32, horizon 64, the 3x256 tanh MLP in bf16, bf16
trajectory obs, both rollout kernel knobs on) plus the OHLCV feature
columns, so the feature-window kernel K1 runs: with no feature columns
``n_features`` is 0 and bench.py's rollout never reaches it.

``long_context_config``: the long-context row of the JAX package's
tools/tpu_bench.py (:42-57 with the row at :244): the transformer_ring
policy (d_model 128, 4 heads of 32, 2 layers) over a window of 256 bars,
256 envs, horizon 64, one epoch of 4 env-permuted minibatches, bf16, plus
the flagship's OHLCV feature columns, bf16 trajectory obs and both
rollout kernel knobs, so K1-K3 run beside K4.

``lob_config`` ("flagship-lob-train"): the flagship on the LOB venue, as
the JAX package documents its run (docs/lob.md:16-20: ``--venue lob
--lob_scenario lob_volatile``), with ``lob_match_kernel="on"`` and
``rollout_env_kernel="off"`` (the JAX package refuses the bar venue's
kernels on the LOB venue; the LOB step runs K1, K3 and K5, never K2).
``direct_fixed_sltp`` at the default 20/40 pips rests a take-profit in
the book and arms a stop on every entry; ``position_size=40`` with
``lob_lot_units=1`` makes one entry walk three seeded 16-lot levels, the
setting of the JAX package's tests/test_lob.py:283/296-310.  Every other
LOB knob keeps its default: 24 levels x 4 queue slots, 8 seeded levels,
64 flow messages per bar, flow seed 0, tick 1e-5.

``curriculum_config`` ("flagship-curriculum-train"): the flagship trained
over a tape library (``feed="curriculum"``, the JAX package's
data/tapes.py): ``tapes`` lists the tapes (``"file:PATH[@W],..."`` or a
list of dicts; tape 0 is the env's own dataset), ``data_compress="on"``
holds tapes 1.. compressed on the card (each pick decoded by K6 on the
default ``lob_tick_size`` grid of 1e-5), and ``random_episode_start``
spreads the 8,192 envs over each long tape instead of replaying its
first bars.

``baseline_sharpe_config`` ("baseline-sharpe-atr-train"): BASELINE.json's
config 3 as the JAX package runs it at full size (tools/baseline_configs.py:
85-112): 4,096 envs, ``sharpe_reward`` (its 64-slot ring, annualization
252), ``direct_atr_sltp`` (ATR period 14, k_sl 2, k_tp 4), the 3x256 tanh
MLP in float32, horizon 32, one epoch (of the default 4 env-permuted
minibatches) on examples/data/eurusd_sample.csv.  ``rollout_env_kernel``
stays ``"off"`` and ``rollout_obs_kernel`` too, since the JAX package
refuses its env kernels with the sharpe reward (the port's K2 and K3 run
all the same: the device decides); no feature columns, so K1 does not run.

``impala_lstm_config`` ("baseline-impala-lstm-train"): BASELINE.json's
config 4 as the JAX package benches it (tools/tpu_bench.py:60-75, the
``impala_lstm`` row at :245): IMPALA over 4,096 envs with an unroll of
64, window 32, the LSTM policy (hidden 256) in bfloat16 and
``dd_penalized_reward`` at the default penalty, on
examples/data/eurusd_sample.csv.

``portfolio_pbt_config`` ("baseline-portfolio-pbt"): BASELINE.json's
config 5 as the JAX package runs it at full size (tools/baseline_configs.py:
139-157): population-based training over the three-pair portfolio
(EUR_USD, GBP_USD, USD_JPY from examples/data/), the flax Transformer
policy (d_model 128, 4 heads, 2 layers) over a window of 32 bars, float32,
a population of 4 x 64 envs, horizon 64, exploit/explore every 2 steps,
200,000 env steps (12 population steps of 16,384).  Its env step runs K2
and K3 over the 768 pair rows; no feature columns, so K1 does not run.

``flagship_continuous_config`` ("flagship-continuous-train") and
``long_context_continuous_config`` ("long-context-continuous-train"): the
two configurations with ``action_space_mode="continuous"`` and nothing
else changed: the policies are their Gaussian twins (the 3x256 MLP twin;
the ring encoder's twin, K4), the env thresholds the sampled action at
the default ``continuous_action_threshold`` of 0.33.

``impala_curriculum_config`` ("impala-curriculum-train"):
``impala_lstm_config``'s trainer (IMPALA, 4,096 envs, unroll 64, the bf16
LSTM, ``dd_penalized_reward``) over ``curriculum_config``'s tape library
(compressed tapes, each pick decoded by K6; the flagship's feature
columns, so K1 runs).

``portfolio_transformer_config`` ("portfolio-transformer-train"):
examples/configs/train_portfolio_transformer.json, the single portfolio
trainer: 512 envs, horizon 64, ``margin_rate`` 0.02 (the account's margin
preflight and closeout on), leverage 20, the Transformer policy.
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


def long_context_config(input_data_file: str, **over) -> Dict[str, Any]:
    config = flagship_config(
        input_data_file,
        num_envs=256,
        policy="transformer_ring",
        policy_kwargs={"d_model": 128, "n_heads": 4, "n_layers": 2},
        window_size=256,
    )
    config.update(over)
    return config


def flagship_continuous_config(input_data_file: str, **over) -> Dict[str, Any]:
    return flagship_config(input_data_file, **{"action_space_mode": "continuous", **over})


def long_context_continuous_config(input_data_file: str, **over) -> Dict[str, Any]:
    return long_context_config(input_data_file, **{"action_space_mode": "continuous", **over})


def lob_config(input_data_file: str, **over) -> Dict[str, Any]:
    config = flagship_config(
        input_data_file,
        venue="lob",
        lob_scenario="lob_volatile",
        lob_match_kernel="on",
        rollout_env_kernel="off",
        strategy_plugin="direct_fixed_sltp",
        position_size=40.0,
        lob_lot_units=1.0,
    )
    config.update(over)
    return config


def curriculum_config(tapes, **over) -> Dict[str, Any]:
    """flagship-curriculum-train over ``tapes`` (the ``tapes`` config key:
    a string or a list of entries; tape 0 is also ``input_data_file``)."""
    from gymfx_tpu_torch.data.tapes import parse_tape_specs

    first = parse_tape_specs({"tapes": tapes})[0]
    config = flagship_config(
        first.source,
        feed="curriculum",
        tapes=tapes,
        data_compress="on",
        random_episode_start=True,
        lob_tick_size=1e-5,
    )
    config.update(over)
    return config


def baseline_sharpe_config(input_data_file: str, **over) -> Dict[str, Any]:
    config = dict(DEFAULT_VALUES)
    config.update(
        input_data_file=input_data_file,
        mode="training",
        num_envs=4096,
        reward_plugin="sharpe_reward",
        strategy_plugin="direct_atr_sltp",
        atr_period=14,
        k_sl=2.0,
        k_tp=4.0,
        policy="mlp",
        ppo_horizon=32,
        ppo_epochs=1,
        rollout_env_kernel="off",
    )
    config.update(over)
    return config


def impala_lstm_config(input_data_file: str, **over) -> Dict[str, Any]:
    config = dict(DEFAULT_VALUES)
    config.update(
        input_data_file=input_data_file,
        mode="training",
        trainer="impala",
        num_envs=4096,
        impala_unroll=64,
        policy="lstm",
        policy_dtype="bfloat16",
        reward_plugin="dd_penalized_reward",
        window_size=32,
    )
    config.update(over)
    return config


# the keys of impala_lstm_config that make it IMPALA's config 4
IMPALA_KEYS = ("mode", "trainer", "num_envs", "impala_unroll", "policy", "policy_dtype",
               "reward_plugin", "window_size")


def impala_curriculum_config(tapes, **over) -> Dict[str, Any]:
    """impala-curriculum-train: config 4's IMPALA trainer over ``tapes``
    (as :func:`curriculum_config`)."""
    impala = impala_lstm_config("")
    config = curriculum_config(tapes, **{k: impala[k] for k in IMPALA_KEYS})
    config.update(over)
    return config


PORTFOLIO_FILES = {
    "EUR_USD": "examples/data/eurusd_sample.csv",
    "GBP_USD": "examples/data/gbpusd_sample.csv",
    "USD_JPY": "examples/data/usdjpy_sample.csv",
}


def _portfolio_files(root: str) -> Dict[str, str]:
    return {pair: f"{root.rstrip('/')}/{path}" if root else path
            for pair, path in PORTFOLIO_FILES.items()}


def portfolio_pbt_config(root: str = "", **over) -> Dict[str, Any]:
    """baseline-portfolio-pbt; ``root`` is the directory that holds
    examples/ (the working directory when empty)."""
    config = dict(DEFAULT_VALUES)
    config.update(
        mode="training",
        trainer="pbt",
        portfolio_files=_portfolio_files(root),
        policy="transformer",
        window_size=32,
        num_envs=64,
        ppo_horizon=64,
        pbt_population=4,
        pbt_interval=2,
        train_total_steps=200_000,
    )
    config.update(over)
    return config


def portfolio_transformer_config(root: str = "", **over) -> Dict[str, Any]:
    """portfolio-transformer-train (examples/configs/
    train_portfolio_transformer.json)."""
    config = dict(DEFAULT_VALUES)
    config.update(
        mode="training",
        trainer="portfolio",
        policy="transformer",
        portfolio_files=_portfolio_files(root),
        num_envs=512,
        ppo_horizon=64,
        train_total_steps=5_000_000,
        margin_rate=0.02,
        leverage=20.0,
    )
    config.update(over)
    return config
