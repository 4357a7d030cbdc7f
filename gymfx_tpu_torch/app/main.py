#!/usr/bin/env python3
"""The command line: the port of ``gymfx_tpu/app/main.py`` (:70-141,
:184-456).

    python -m gymfx_tpu_torch.app.main --mode training --input_data_file ... \\
        --checkpoint_dir ckpt --results_file results.json

:func:`main` parses the JAX package's flags (config/cli.py), merges
defaults < config file < flags < unknown ``--key value`` pairs
(config/merger.py), runs :func:`run_mode` and writes the results JSON,
key for key the JAX package's:

* ``mode=training``: ``train/ppo.train_from_config`` (checkpoints, the
  non-finite skip guard, ``resume_training``, the greedy evaluation on
  the held-out bars), or with ``trainer=impala``
  ``train/impala.train_impala_from_config`` (the same, for IMPALA), with
  ``trainer=portfolio`` ``train/portfolio_ppo.train_portfolio_from_config``
  (the multi-pair portfolio over ``portfolio_files``), with
  ``trainer=pbt`` ``train/pbt.train_pbt_from_config`` (population-based
  training over the portfolio, or over the bar venue without
  ``portfolio_files``); each under the config's ``fault_profile`` and
  ``telemetry_*`` keys;
* ``mode=optimization``: ``train/optimize.optimize_from_config``, the
  GA over a strategy's params (each generation one batched episode of
  the population, from the episode graphs on the card), with the outer
  ``atr_period`` sweep;
* ``driver_mode=policy``: ``train/ppo.eval_policy_from_config`` restores
  a checkpoint's params and reruns its greedy evaluation (with
  ``portfolio_files``, ``train/portfolio_ppo.
  eval_portfolio_policy_from_config``);
* anything else: :func:`_run_env_scan`, the diagnostic episode of a
  built-in driver, from the episode graphs on the card; with ``num_envs >
  1`` a batch evaluation of that many envs in one batched episode; with
  ``verify_execution`` env 0's decision stream replayed through the
  float64 replay engine (:func:`verify_execution`).

Every entry runs on the card unless the caller passes ``device="cpu"``.
With ``gym_loop=true`` (or a driver mode the diagnostic episode does not
know) the host driver steps a ``gym_env.GymFxEnv`` instead
(:func:`_run_gym_loop`).  What the port does not take raises
``core/types.not_ported`` naming its ROADMAP Queue 1 item: a third-party
plugin (9), and,
in training, the elastic controller, a mesh and a fault profile's mesh
events (17).

:func:`export_scaled_features` is the offline scaled-feature export: an
episode's scaled feature windows ``(n_steps, window, F)`` for steps
``1..n_steps`` in one call of K7 (``ops/window_zscore.
batched_scaled_windows``: the kernel on the card, its plain version on
the CPU), the binary columns passed through on the host with the obs
path's clip and nan_to_num, exactly as the JAX function does, written
with ``np.savez_compressed`` (``scaled_windows``, ``feature_columns``).
The scaled columns get no nan_to_num, as in the JAX function.
"""
from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.config.cli import parse_args
from gymfx_tpu_torch.config.handler import load_config, save_config
from gymfx_tpu_torch.config.merger import merge_config, process_unknown_args
from gymfx_tpu_torch.core.types import ACTION_DIAG_KEYS, EXEC_DIAG_KEYS, not_ported
from gymfx_tpu_torch.ops.window_zscore import batched_scaled_windows
from gymfx_tpu_torch.resilience.guards import tree_map

# the built-in plugins' declared parameter defaults (gymfx_tpu/plugins/
# builtin/), merged under the diagnostic episode's config as the JAX
# package merges them: a key the config lacks takes the plugin's value, so
# the default broker's slippage_perc (0.0) outranks a --slippage flag there
PLUGIN_DEFAULTS = {
    "data_feed_plugin": {
        "default_data_feed": {"input_data_file": "examples/data/eurusd_sample.csv",
                              "date_column": "DATE_TIME", "headers": True, "max_rows": None,
                              "price_column": "CLOSE"},
    },
    "broker_plugin": {
        "default_broker": {"initial_cash": 10000.0, "commission": 0.0, "slippage_perc": 0.0,
                           "leverage": 1.0},
        "oanda_broker": {"oanda_token": None, "oanda_account_id": None,
                         "oanda_instrument": "EUR_USD", "oanda_practice": True,
                         "live_retry_max_attempts": 4, "live_retry_base_delay": 0.25,
                         "live_retry_max_delay": 8.0, "live_retry_timeout": 30.0,
                         "live_retry_budget": 64, "live_breaker_threshold": 5,
                         "live_breaker_recovery_time": 30.0},
    },
    "strategy_plugin": {
        "default_strategy": {"driver_mode": "buy_hold", "replay_actions_file": None,
                             "seed": None},
        "direct_atr_sltp": {"atr_period": 14, "k_sl": 2.0, "k_tp": 3.0, "position_size": 1.0,
                            "rel_volume": None, "leverage": 1.0, "min_order_volume": 0.0,
                            "max_order_volume": 1000000000000.0, "size_mode": "fx_units",
                            "min_sltp_frac": 0.001, "max_sltp_frac": 0.2,
                            "sltp_risk_mode": "fixed_atr", "baseline_rel_volume": 0.05,
                            "max_risk_rel_volume": 0.5, "rel_volume_sl_shrink_alpha": 0.35,
                            "rel_volume_tp_shrink_alpha": 0.2, "min_k_sl": 1.0,
                            "min_reward_risk_ratio": 1.0, "max_planned_loss_fraction": None,
                            "session_filter": False, "entry_dow_start": 0,
                            "entry_hour_start": 12, "force_close_dow": 4,
                            "force_close_hour": 20},
        "direct_fixed_sltp": {"sl_pips": 20.0, "tp_pips": 40.0, "pip_size": 0.0001,
                              "position_size": 1.0},
    },
    "preprocessor_plugin": {
        "default_preprocessor": {"window_size": 32, "price_column": "CLOSE"},
        "feature_window_preprocessor": {"window_size": 32, "price_column": "CLOSE",
                                        "feature_columns": [], "feature_binary_columns": [],
                                        "feature_scaling": "rolling_zscore",
                                        "feature_scaling_window": 256,
                                        "include_price_window": True,
                                        "include_agent_state": True, "feature_clip": 10.0},
    },
    "reward_plugin": {
        "dd_penalized_reward": {"penalty_lambda": 1.0, "initial_cash": 10000.0},
        "pnl_reward": {"reward_scale": 1.0, "initial_cash": 10000.0},
        "sharpe_reward": {"window": 64, "annualization_factor": 252.0, "initial_cash": 10000.0},
    },
    "metrics_plugin": {
        "default_metrics": {},
        "trading_metrics": {"risk_lambda": 1.0, "metric_schema": "trading.metrics.v1"},
    },
}
BUILTIN_DRIVERS = ("buy_hold", "flat", "random", "replay")


def _collect_plugin_defaults(config: Dict[str, Any]) -> Dict[str, Any]:
    merged: Dict[str, Any] = {}
    for key, family in PLUGIN_DEFAULTS.items():
        name = str(config[key])
        if name not in family:
            raise not_ported(f"the {key} {name!r} (a third-party plugin, plugins/registry.py)", 9)
        merged.update(family[name])
    return merged


def make_cli_driver(config: Dict[str, Any]):
    """Host-side diagnostic action source ``(obs, info, step) -> action``,
    the gym loop's (the JAX package's, reference
    strategy_plugins/default_strategy.py:44-54)."""
    mode = str(config.get("driver_mode", "buy_hold"))
    rng = np.random.default_rng(config.get("seed"))
    if mode == "replay":
        path = config.get("replay_actions_file")
        if not path:
            raise ValueError("driver_mode=replay requires replay_actions_file")
        with open(path, "r", encoding="utf-8") as fh:
            actions = [int(row.get("action", 0)) for row in csv.DictReader(fh)]
        return lambda obs, info, step: actions[step] if step < len(actions) else 0
    if mode == "random":
        return lambda obs, info, step: int(rng.integers(0, 3))
    if mode == "flat":
        return lambda obs, info, step: 0
    if mode == "buy_hold":
        return lambda obs, info, step: 1 if step == 0 else 0
    raise ValueError(f"unknown driver_mode {mode!r}")


def run_mode(config: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """Dispatch: ``mode=training`` runs the PPO trainer (the IMPALA
    trainer with ``trainer=impala``); ``driver_mode=policy`` restores a
    checkpoint and runs a greedy evaluation episode; everything else runs
    the diagnostic episode."""
    from gymfx_tpu_torch.train.impala import train_impala_from_config
    from gymfx_tpu_torch.train.ppo import eval_policy_from_config, train_from_config

    if config.get("mode") == "training":
        trainer = str(config.get("trainer", "ppo")).lower()
        if trainer == "impala":
            return train_impala_from_config(config, device=device)
        if trainer == "pbt":
            from gymfx_tpu_torch.train.pbt import train_pbt_from_config

            return train_pbt_from_config(config, device=device)
        if trainer == "portfolio":
            from gymfx_tpu_torch.train.portfolio_ppo import train_portfolio_from_config

            return train_portfolio_from_config(config, device=device)
        return train_from_config(config, device=device)
    if config.get("mode") == "optimization":
        from gymfx_tpu_torch.train.optimize import optimize_from_config

        return optimize_from_config(config, device=device)
    if config.get("driver_mode") == "policy":
        if config.get("export_scaled_features"):
            raise ValueError(
                "export_scaled_features is supported on the scanned "
                "diagnostic episode path only; run the export as a "
                "separate inference invocation"
            )
        if config.get("portfolio_files"):
            from gymfx_tpu_torch.train.portfolio_ppo import eval_portfolio_policy_from_config

            return eval_portfolio_policy_from_config(config, device=device)
        return eval_policy_from_config(config, device=device)
    return _run_env(config, device=device)


def _run_env(config: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    # plugin defaults merge at the lowest precedence
    config = merge_config(config, _collect_plugin_defaults(config), {}, {}, {}, {})
    mode = str(config.get("driver_mode", "buy_hold"))
    if mode in BUILTIN_DRIVERS and not config.get("gym_loop"):
        return _run_env_scan(config, device=device)
    return _run_gym_loop(config, device=device)


def _run_gym_loop(config: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """The step-by-step Gymnasium path (``gym_loop=true``, or a driver
    mode the diagnostic episode does not know): the host driver of
    :func:`make_cli_driver` steps a ``gym_env.GymFxEnv`` (one CUDA graph a
    step on the card) until the episode ends or ``steps`` run out, and
    returns its summary."""
    from gymfx_tpu_torch.gym_env import build_environment

    if config.get("export_scaled_features"):
        # honor-or-reject: the export is the diagnostic episode's feature
        # (it reads the Environment's feature tensors); silently writing
        # no file would strand a downstream pipeline
        raise ValueError(
            "export_scaled_features is supported on the scanned episode "
            "path only (builtin driver_mode without gym_loop); run the "
            "export as a separate inference invocation"
        )
    env = build_environment(config=config, device=device)
    decide = make_cli_driver(config)
    try:
        obs, info = env.reset(seed=config.get("seed"))
        done = False
        steps = int(config.get("steps", 500))
        step_count = 0
        while not done and step_count < steps:
            action = decide(obs, info, step_count)
            obs, _, terminated, truncated, info = env.step(action)
            done = bool(terminated or truncated)
            step_count += 1
        return env.summary()
    finally:
        env.close()


def export_scaled_features(env, config: Dict[str, Any], n_steps: int, path: str) -> Dict[str, Any]:
    """Write the scaled feature windows of steps ``1..n_steps`` of
    ``env``'s resident tape to ``path`` (.npz).  Returns the JAX
    function's summary (``path``, ``shape``, ``columns``) plus
    ``seconds``: host seconds for the windows (K7, the copy to the host
    and the binary passthrough) and for the save, apart."""
    cfg = env.cfg
    data = env.require_resident_data("export_scaled_features")
    if cfg.n_features == 0:
        raise ValueError(
            "export_scaled_features requires feature_columns in the config "
            "(the scaled windows ARE the feature-window preprocessor's "
            "output)"
        )
    w = cfg.window_size
    clip = float(cfg.feature_clip or 0.0)
    t0 = time.perf_counter()
    steps = torch.arange(1, n_steps + 1, dtype=torch.int32, device=data.padded_features.device)
    windows = batched_scaled_windows(
        data.padded_features, data.feat_mean, data.feat_std, data.feat_neutral, steps,
        window=w, clip=clip,
    )
    arr = windows.cpu().numpy()  # a fresh f32 array: the binary columns are written into it
    if any(cfg.binary_mask):
        # binary passthrough columns carry raw values, exactly like the
        # obs path, still under its clip and nan_to_num clamp
        raw = np.asarray(data.padded_features.cpu().numpy(), np.float32)
        steps_np = np.arange(1, n_steps + 1)
        for j, is_bin in enumerate(cfg.binary_mask):
            if is_bin:
                col = sliding_window_view(raw[:, j], w)[steps_np]
                if clip > 0:
                    col = np.clip(col, -clip, clip)
                arr[:, :, j] = np.nan_to_num(col, nan=0.0, posinf=clip, neginf=-clip)
    t1 = time.perf_counter()
    columns = [str(c) for c in (env.config.get("feature_columns") or [])]
    np.savez_compressed(path, scaled_windows=arr, feature_columns=np.asarray(columns))
    t2 = time.perf_counter()
    return {"path": path, "shape": list(arr.shape), "columns": columns,
            "seconds": {"windows": t1 - t0, "save": t2 - t1}}


def _run_env_scan(config: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """The diagnostic episode of a built-in driver and its host-side
    summary (the JAX package's one-scan episode; reference summary
    surface app/env.py:697-716).  With ``num_envs > 1``, a batch
    evaluation: every env runs the episode in one batch, the ``batch``
    key holds the outcome statistics and the rest reports env 0."""
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.metrics import compute_analyzers, summarize_default, summarize_trading
    from gymfx_tpu_torch.train.ppo import env_state_row

    env = Environment(config, device=device)
    driver = env.make_driver()
    steps = int(config.get("steps", 500))
    seed = int(config.get("seed", 0) or 0)
    n_envs = int(config.get("num_envs", 1) or 1)
    initial_cash = float(config.get("initial_cash", 10000.0))
    batch_stats = None
    if n_envs > 1:
        env.require_resident_data("num_envs > 1 batch evaluation")
    state_b, out_b = env.rollout(driver, steps, seed=seed, n_envs=n_envs)
    if n_envs > 1:
        finals = out_b["equity_delta"][-1].cpu().numpy().astype(np.float64)
        returns = finals / initial_cash
        batch_stats = {
            "num_envs": n_envs,
            "mean_total_return": float(returns.mean()),
            "std_total_return": float(returns.std(ddof=1)),
            "min_total_return": float(returns.min()),
            "max_total_return": float(returns.max()),
            "mean_trades": float(state_b.trade_count.cpu().numpy().mean()),
        }
    state = env_state_row(state_b, 0)
    out = tree_map(lambda v: v[:, 0].cpu(), out_b)

    equity = out["equity_delta"].numpy().astype(np.float64) + initial_cash
    done = out["done"].numpy().astype(bool)
    n_steps = int(np.argmax(done)) + 1 if done.any() else steps
    ts = env.dataset.timestamps[1: n_steps + 1]
    analyzers = compute_analyzers(equity=equity, done=done, state=state, timestamps=ts)
    final_equity = float(equity[n_steps - 1])
    name = str(config.get("metrics_plugin", "default_metrics"))
    summarize = {"default_metrics": summarize_default,
                 "trading_metrics": summarize_trading}[name]
    summary = summarize(initial_cash=initial_cash, final_equity=final_equity,
                        analyzers=analyzers, config=config)
    action_diag = {key: int(state.action_diag[i]) for i, key in enumerate(ACTION_DIAG_KEYS)}
    action_diag["raw_abs_sum"] = float(state.raw_abs_sum)
    has_steps = action_diag["steps"] > 0
    action_diag["raw_min"] = float(state.raw_min) if has_steps else None
    action_diag["raw_max"] = float(state.raw_max) if has_steps else None
    action_diag["continuous_action_threshold"] = (
        float(config.get("continuous_action_threshold", 0.33) or 0.33)
        if str(config.get("action_space_mode", "discrete")) == "continuous"
        else None
    )
    summary["action_diagnostics"] = action_diag
    summary["execution_diagnostics"] = {
        key: int(state.exec_diag[i]) for i, key in enumerate(EXEC_DIAG_KEYS)
    }
    record_path = config.get("record_actions_file")
    if record_path:
        # the executed action stream in the replay schema (driver_mode=replay
        # reads it back)
        with open(record_path, "w", encoding="utf-8", newline="") as fh:
            writer = csv.writer(fh)
            writer.writerow(["action"])
            for a in out["action"][:n_steps].tolist():
                writer.writerow([int(a)])
        summary["record_actions_file"] = str(record_path)

    export_path = config.get("export_scaled_features")
    if export_path:
        report = export_scaled_features(env, config, n_steps, str(export_path))
        summary["export_scaled_features"] = {k: report[k] for k in ("path", "shape", "columns")}

    if "event_context" in out:
        # event fields of the last executed (pre-termination) step
        last = n_steps - 1
        summary["event_context_diagnostics"] = {
            k: v[last].item() for k, v in out["event_context"].items()
        }
    else:
        summary["event_context_diagnostics"] = {}
    if batch_stats is not None:
        summary["batch"] = batch_stats
    if config.get("verify_execution"):
        summary["execution_crosscheck"] = verify_execution(config, env, state, out, seed)
    return summary


def verify_execution(config: Dict[str, Any], env, state, out, seed: int) -> Dict[str, Any]:
    """Replay env 0's decision stream through the float64 replay engine
    and reconcile the realized balances (``simulation/crosscheck.py``),
    reusing the episode's final ``state`` and its trace ``out``: the scan
    side is not run again.  Only a bankruptcy (``termination_reason``,
    not the bar cursor: a bankruptcy on the final bar would fool it)
    invalidates the check; a configuration the check cannot take records
    a skip and never aborts the finished run."""
    from gymfx_tpu_torch.core.types import TERMINATION_BANKRUPT
    from gymfx_tpu_torch.simulation.crosscheck import crosscheck_episode

    bankrupt = int(state.termination_reason) == TERMINATION_BANKRUPT
    try:
        return crosscheck_episode(config, seed=seed, env=env, scan_state=state, trace=out,
                                  terminated=bankrupt)
    except (ValueError, TypeError) as exc:
        # TypeError covers null-valued instrument keys in a config file
        return {"status": "skipped", "reason": f"{type(exc).__name__}: {exc}"}


def main(argv=None, *, device=None) -> Dict[str, Any]:
    """Parse ``argv`` (the process's arguments when None), merge the
    layered config, run it on ``device`` (CUDA unless named), write the
    results JSON and return the summary."""
    args, unknown = parse_args(argv)
    cli_args = vars(args)

    config = DEFAULT_VALUES.copy()
    file_config = load_config(args.load_config) if args.load_config else {}
    unknown_dict = process_unknown_args(unknown)
    config = merge_config(config, {}, {}, file_config, cli_args, unknown_dict)

    if config.get("mode") not in {"training", "optimization", "inference"}:
        raise ValueError("mode must be one of training|optimization|inference")

    summary = run_mode(config, device=device)

    results_file = Path(config.get("results_file") or "results.json")
    results_file.parent.mkdir(parents=True, exist_ok=True)
    with results_file.open("w", encoding="utf-8") as fh:
        json.dump(summary, fh, indent=2, default=str)

    if config.get("save_config"):
        save_config(config, config["save_config"])

    if not config.get("quiet_mode", False):
        print(json.dumps(summary, indent=2, default=str))
    return summary


if __name__ == "__main__":
    main()
