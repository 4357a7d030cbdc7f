"""CLI argument surface: the port's copy of ``gymfx_tpu/config/cli.py``
(:8-197), flag for flag, so a command line written for the JAX package
parses unchanged.  Unknown ``--key value`` pairs pass through into the
config with type coercion (config/merger.py).
"""
import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="gymfx-tpu runtime (PyTorch/CUDA port: env + trainer)."
    )
    parser.add_argument("--mode", choices=["training", "optimization", "inference"])
    parser.add_argument(
        "--driver_mode", choices=["random", "buy_hold", "flat", "replay", "policy"]
    )
    parser.add_argument("--steps", type=int)

    parser.add_argument("--input_data_file", type=str)
    parser.add_argument("--date_column", type=str)
    parser.add_argument("--price_column", type=str)
    parser.add_argument("--headers", action="store_true", default=None)
    parser.add_argument("--max_rows", type=int)

    parser.add_argument("--window_size", type=int)
    parser.add_argument("--initial_cash", type=float)
    parser.add_argument("--position_size", type=float)
    parser.add_argument("--commission", type=float)
    parser.add_argument("--slippage", type=float)
    parser.add_argument("--seed", type=int)

    parser.add_argument("--data_feed_plugin", type=str)
    parser.add_argument("--broker_plugin", type=str)
    parser.add_argument("--strategy_plugin", type=str)
    parser.add_argument("--preprocessor_plugin", type=str)
    parser.add_argument("--reward_plugin", type=str)
    parser.add_argument("--metrics_plugin", type=str)

    # execution venue (docs/lob.md)
    parser.add_argument("--venue", choices=["bar", "lob"])
    parser.add_argument("--lob_depth_levels", type=int)
    parser.add_argument("--lob_queue_slots", type=int)
    parser.add_argument("--lob_messages_per_bar", type=int)
    parser.add_argument("--lob_seed_levels", type=int)
    parser.add_argument("--lob_flow_seed", type=int)
    parser.add_argument(
        "--lob_scenario",
        choices=["lob_calm", "lob_trend", "lob_volatile", "lob_thin",
                 "lob_flash_crash"],
    )
    parser.add_argument("--lob_tick_size", type=float)
    parser.add_argument("--lob_lot_units", type=float)

    # data feed: replayed CSV tape vs the generative scenario engine
    # (docs/scenarios.md)
    parser.add_argument("--feed", choices=["replay", "scengen", "curriculum"])
    parser.add_argument(
        "--scengen_preset",
        choices=["regime_mix", "trend_calm", "range_chop", "flash_crash",
                 "gap_open", "liquidity_drought", "multi_asset_calm",
                 "multi_asset_stress"],
    )
    parser.add_argument("--scengen_bars", type=int)
    parser.add_argument("--scengen_seed", type=int)
    parser.add_argument(
        "--scengen_snap_to_tick", action="store_true", default=None
    )

    # billion-bar data path (docs/performance.md): compressed tapes and
    # the dataset-of-tapes curriculum registry
    parser.add_argument(
        "--data_compress", choices=["off", "on", "interpret"]
    )
    parser.add_argument("--tapes", type=str)
    parser.add_argument("--curriculum_seed", type=int)

    parser.add_argument("--replay_actions_file", type=str)
    parser.add_argument("--results_file", type=str)
    parser.add_argument("--load_config", type=str)
    parser.add_argument("--save_config", type=str)
    parser.add_argument("--quiet_mode", action="store_true", default=None)

    # TPU-framework flags
    parser.add_argument("--num_envs", type=int)
    parser.add_argument(
        "--policy",
        choices=["mlp", "lstm", "transformer", "transformer_ring",
                 "transformer_ulysses"],
    )
    parser.add_argument("--checkpoint_dir", type=str)
    parser.add_argument("--train_total_steps", type=int)

    # resilience flags (docs/resilience.md)
    parser.add_argument("--checkpoint_every", type=int)
    parser.add_argument("--fault_profile", type=str)
    parser.add_argument("--guard_max_consecutive_skips", type=int)

    # elastic degraded-mesh training (docs/resilience.md, "Elastic
    # training"): auto-resume on survivor meshes after device loss
    parser.add_argument(
        "--elastic_resume", action="store_true", default=None
    )
    parser.add_argument("--elastic_max_retries", type=int)
    parser.add_argument("--elastic_backoff_s", type=float)
    parser.add_argument(
        "--elastic_shrink_policy", choices=["repartition", "reject"]
    )
    parser.add_argument("--checkpoint_keep", type=int)

    # pod-scale mesh (docs/performance.md, "Scaling out"); JSON axis
    # sizes, e.g. '{"data": 8}' or '{"data": 16, "model": 2}'
    parser.add_argument("--mesh_shape", type=str)

    # dispatch / memory flags (docs/performance.md)
    parser.add_argument("--supersteps_per_dispatch", type=int)
    parser.add_argument("--stream_hbm_budget_mb", type=float)
    parser.add_argument(
        "--ppo_minibatch_scheme", choices=["env_permute", "sample_permute"]
    )
    parser.add_argument(
        "--rollout_obs_kernel", choices=["off", "on", "interpret"]
    )
    parser.add_argument(
        "--rollout_env_kernel", choices=["off", "on", "interpret"]
    )
    parser.add_argument(
        "--lob_match_kernel", choices=["off", "on", "interpret"]
    )
    parser.add_argument(
        "--rollout_collect_dtype", choices=["float32", "bfloat16"]
    )
    parser.add_argument(
        "--optimizer_state_dtype", choices=["float32", "bfloat16"]
    )
    parser.add_argument(
        "--superstep_overlap", action="store_true", default=None
    )
    parser.add_argument(
        "--ppo_update_remat", action="store_true", default=None
    )

    # serving flags (docs/serving.md); buckets as JSON, e.g. "[1,8,64]"
    parser.add_argument("--serve_buckets", type=str)
    parser.add_argument("--serve_max_batch_wait_ms", type=float)
    parser.add_argument(
        "--serve_batch_mode", choices=["auto", "exact", "matmul"]
    )

    # serving overload resilience (docs/serving.md, "Overload behavior")
    parser.add_argument("--serve_max_queue", type=int)
    parser.add_argument(
        "--serve_shed_policy", choices=["reject", "evict_oldest"]
    )
    parser.add_argument("--serve_deadline_ms", type=float)
    parser.add_argument(
        "--serve_fallback", choices=["hold", "flat", "reject"]
    )
    parser.add_argument("--serve_breaker_threshold", type=int)
    parser.add_argument("--serve_breaker_recovery_s", type=float)
    parser.add_argument("--feed_stale_after_s", type=float)

    # device-resident sessions (docs/serving.md, "Device-resident
    # sessions"); 0 slots = the host-carry serving path
    parser.add_argument("--serve_session_slots", type=int)
    parser.add_argument(
        "--serve_slot_mirror", action="store_true", default=None
    )
    parser.add_argument(
        "--serve_staging", action="store_true", default=None
    )

    # telemetry (docs/observability.md); all off unless set
    parser.add_argument(
        "--telemetry_enabled", action="store_true", default=None
    )
    parser.add_argument("--telemetry_jsonl", type=str)
    parser.add_argument(
        "--telemetry_spans", action="store_true", default=None
    )
    parser.add_argument("--telemetry_http_port", type=int)
    parser.add_argument("--telemetry_slo_window_s", type=float)

    # run forensics (docs/observability.md: ledger / compile watch /
    # flight recorder); all off unless set
    parser.add_argument("--telemetry_ledger", type=str)
    parser.add_argument("--telemetry_flight_recorder_dir", type=str)
    parser.add_argument("--telemetry_flight_recorder_k", type=int)
    parser.add_argument(
        "--telemetry_compile_watch", action="store_true", default=None
    )

    # performance observatory (docs/observability.md: managed
    # jax.profiler capture + measured-MFU reports); off unless set
    parser.add_argument("--telemetry_profile_dir", type=str)
    parser.add_argument("--telemetry_profile_supersteps", type=str)
    parser.add_argument("--telemetry_profile_every", type=int)

    return parser.parse_known_args(argv)
