"""Config defaults: the port's own copy of the JAX package's key surface.

The port imports nothing from ``gymfx_tpu``, so the defaults dict is
copied here key for key; a config written for the JAX package loads
unchanged.  Keys the port does not implement yet are still accepted and
validated where they are read (core/runtime.py raises for the ones a
later ROADMAP item brings).
"""

DEFAULT_VALUES = {
    # execution
    "mode": "inference",  # training|optimization|inference
    "driver_mode": "buy_hold",  # random|buy_hold|flat|replay|policy
    "steps": 500,

    # plugin selection (registry names; mirrors reference entry-point names)
    "data_feed_plugin": "default_data_feed",
    "broker_plugin": "default_broker",
    "strategy_plugin": "default_strategy",
    "preprocessor_plugin": "default_preprocessor",
    "reward_plugin": "pnl_reward",
    "metrics_plugin": "default_metrics",

    # data + symbol
    "input_data_file": "examples/data/eurusd_sample.csv",  # repo-root relative
    "date_column": "DATE_TIME",
    "price_column": "CLOSE",
    "instrument": "EUR_USD",
    "timeframe": "M1",
    "headers": True,
    "max_rows": None,

    # env and execution settings
    "window_size": 32,
    "initial_cash": 10000.0,
    "position_size": 1.0,
    "simulation_engine": "scan",  # the XLA scan engine (reference: backtrader|nautilus)
    "execution_cost_profile": None,
    "commission": 0.0,
    "slippage": 0.0,
    "leverage": 1.0,
    "min_equity": None,  # default: 1% of initial_cash (reference app/env.py:122)
    # opt-in scan-engine venue quantization: fills/brackets on the
    # instrument's tick grid, order sizes on its size step, min_quantity
    # denial — the replay venue's book semantics (DIVERGENCES #9d closed)
    "venue_quantization": False,
    # execution venue: "bar" = broker scan (next-open fills, H/L
    # brackets); "lob" = the vectorized limit-order-book engine
    # (gymfx_tpu/lob/, docs/lob.md) — agent orders walk a seeded book
    # driven by a deterministic per-bar message flow
    "venue": "bar",
    "lob_depth_levels": 24,      # book price levels per side
    "lob_queue_slots": 4,        # FIFO orders per level
    "lob_messages_per_bar": 64,  # flow messages per bar (static shape)
    "lob_seed_levels": 8,        # seeded depth levels per side at open
    "lob_flow_seed": 0,          # order-flow PRNG seed
    "lob_scenario": "lob_calm",  # lob_calm|lob_trend|lob_volatile|lob_thin|lob_flash_crash
    "lob_tick_size": 1e-5,       # quote-currency size of one book tick
    "lob_lot_units": 0.0,        # units per lot (0 = position_size)
    # data feed: "replay" = the CSV tape (input_data_file); "scengen" =
    # the seed-deterministic generative scenario engine
    # (gymfx_tpu/scengen/, docs/scenarios.md) — same MarketData pipeline,
    # no file needed
    "feed": "replay",
    "scengen_preset": "regime_mix",  # scengen/params.py preset registry
    "scengen_bars": 2048,            # generated tape length in bars
    "scengen_seed": 0,               # generation PRNG seed (decoupled
                                     # from the training seed)
    "scengen_pairs": None,           # portfolio pair list (None = the
                                     # default 4 USD-quote pairs)
    # snap generated OHLC onto the lob_tick_size grid at synthesis (f64,
    # before the f32 cast) so scengen tapes satisfy data_compress's
    # on-grid requirement; False = bitwise-identical generation
    "scengen_snap_to_tick": False,
    "action_space_mode": "discrete",  # discrete|continuous
    "continuous_action_threshold": 0.33,
    "seed": 0,

    # optional replay actions
    "replay_actions_file": None,

    # config I/O
    "remote_log": None,
    "remote_load_config": None,
    "remote_save_config": None,
    "username": None,
    "password": None,
    "load_config": None,
    "save_config": "./config_out.json",
    "save_log": "./debug_out.json",
    "results_file": "./results.json",
    "quiet_mode": False,

    # ---- TPU-framework keys (new capability; no reference counterpart) ----
    "num_envs": 1,            # vmapped env batch size
    "compute_dtype": "float32",   # float32 on TPU; float64 for oracle checks
    "mesh_shape": None,       # e.g. {"data": 4, "model": 2}; None = single device
    "train_total_steps": 1_000_000,
    "checkpoint_dir": None,
    # out-of-sample evaluation: hold out the LAST fraction of bars
    # (chronological split) or evaluate on a separate file
    "eval_split": None,
    "eval_data_file": None,
    # policy: unset by default — PPO defaults to "mlp", IMPALA to "lstm";
    # pass --policy mlp|lstm|transformer|transformer_ring|
    # transformer_ulysses to override.
    "policy": None,

    # ---- resilience (docs/resilience.md) ----
    # in-jit non-finite guard on every train step: skip poisoned
    # minibatches (keep last-good params/opt state) instead of
    # propagating NaN into the weights
    "nonfinite_guard": True,
    # abort training after this many CONSECUTIVE fully-skipped steps
    "guard_max_consecutive_skips": 10,
    # preemption-safe periodic auto-checkpointing: save every N env
    # steps into checkpoint_dir (0 = final save only)
    "checkpoint_every": 0,
    # deterministic fault-injection profile for chaos tests, e.g.
    # "nan_bars=30-31;transport=http:503,http:503,ok;preempt_at=2;seed=7"
    "fault_profile": None,
    # ---- elastic degraded-mesh training (docs/resilience.md,
    # "Elastic training") — every knob below unset keeps today's code
    # paths bitwise identical (pinned by tests/test_elastic.py) ----
    # master switch: route the training entry through the elastic
    # auto-resume controller (parallel/elastic.py run_elastic) — on
    # device loss the mesh is re-planned over the survivors and the run
    # resumes from the last digest-verified checkpoint
    "elastic_resume": False,
    # bounded retry budget: how many device-loss resumes before the
    # error propagates (each retry shrinks the mesh further)
    "elastic_max_retries": 2,
    # host-side backoff between a device loss and its resume attempt
    "elastic_backoff_s": 0.0,
    # honor-or-reject when num_envs / pbt_population no longer divide
    # the survivor mesh's data axis: "repartition" shrinks the data
    # axis to the largest size that still divides the batch;
    # "reject" raises ElasticReplanError instead of changing the
    # env->shard mapping
    "elastic_shrink_policy": "repartition",  # repartition | reject
    # checkpoint retention: keep only the newest N step dirs (digest +
    # empty-leaves sidecars pruned with them); 0 = keep everything.
    # The step an active resume points at is never pruned.
    "checkpoint_keep": 0,

    # ---- dispatch / memory (docs/performance.md) ----
    # superstep driver: fuse K train steps into one donated lax.scan
    # dispatch; metrics (incl. guard counters) accumulate on device and
    # are fetched once per superstep (1 = per-step dispatch)
    "supersteps_per_dispatch": 1,
    # stream the bar history host->device in double-buffered shards when
    # the resident MarketData would exceed this many MiB (None = always
    # resident); rollout-only — trainers need the full history resident
    "stream_hbm_budget_mb": None,
    # int16 tick-delta wire format for streamed shards and the
    # curriculum tape library (data/compress.py, docs/performance.md
    # "Billion-bar data path"): off = f32 everywhere (bitwise-identical
    # default), on = fused Pallas decode on TPU, interpret = the same
    # kernel interpreted (CPU-testable bitwise oracle)
    "data_compress": "off",
    # feed=curriculum tape registry: 'file:PATH[@W],scengen:PRESET[@W]'
    # string or a JSON list of {file|scengen, weight, ...} dicts
    # (data/tapes.py); tape 0 is the environment's own dataset
    "tapes": None,
    # PCG64 seed for the weighted tape draws (None = the training seed)
    "curriculum_seed": None,
    # PPO minibatch source: env-permuted trajectory minibatches
    # (contiguous update-phase DMA; measured 12.4M vs 8.3M steps/s at
    # 8192 envs with identical held-out learning — the round-5 fix,
    # examples/results/minibatch_scheme_parity.json) vs the classic
    # flattened sample permutation.  env_permute needs num_envs
    # divisible by ppo_minibatches; configs where that cannot hold
    # (num_envs < ppo_minibatches, e.g. the single-env inference
    # default) degrade to sample_permute with a warning at the
    # from-config entry points (train/common.resolve_minibatch_scheme)
    "ppo_minibatch_scheme": "env_permute",  # env_permute | sample_permute
    # per-step fused feature scaling in the rollout (pallas kernel,
    # ops/window_zscore.fused_step_obs): off = plain XLA (the bitwise
    # oracle), on = pallas on TPU / XLA fallback elsewhere, interpret =
    # pallas interpret mode anywhere (CPU parity tests)
    "rollout_obs_kernel": "off",
    # fused env-dynamics kernel family (ops/env_dynamics.py): the bar
    # venue's fill/bracket/financing chain and the mark/reward chain as
    # two env-blocked pallas VMEM passes bracketing the strategy kernel.
    # off = plain XLA (the bitwise oracle), on = pallas on TPU / XLA
    # fallback elsewhere, interpret = pallas interpret mode anywhere
    "rollout_env_kernel": "off",
    # pallas LOB stream matching (ops/lob_match.py): sort-free ranked
    # matcher with exact int32 parity vs lob/book.py; same mode contract
    "lob_match_kernel": "off",
    # storage dtype for the COLLECTED trajectory obs (the widest rollout
    # buffers): bfloat16 halves trajectory write+read HBM traffic;
    # actions/log-probs/values always stay f32 so PPO ratio numerics
    # are untouched (quality-parity gate: docs/performance.md)
    "rollout_collect_dtype": "float32",  # float32 | bfloat16
    # opt-in bf16 optimizer state: Adam's first moment (the largest
    # optimizer buffer) stored in bfloat16; params and the second moment
    # stay float32 (the master-weight rule).  Gated by a learning-parity
    # smoke (tests/test_opt_state_dtype.py), off by default
    "optimizer_state_dtype": "float32",  # float32 | bfloat16
    # overlap superstep driver (train/common.make_train_many_overlapped):
    # iteration i's rollout is issued against pre-update params while
    # iteration i-1's update GEMMs execute, so the XLA scheduler can
    # overlap the two phases.  Opt-in: rollouts see one-update-stale
    # params and guard-quarantine env resets are dropped inside a
    # dispatch (docs/performance.md, "MFU push")
    "superstep_overlap": False,
    # rematerialize the policy forward in the PPO loss (jax.remat): the
    # update phase recomputes activations inside the backward GEMM chain
    # instead of staging them through HBM — numerically identical,
    # memory-traffic win on TPU
    "ppo_update_remat": False,
    # live-path retry/backoff + circuit breaker (oanda_broker plugin)
    "live_retry_max_attempts": 4,
    "live_retry_base_delay": 0.25,
    "live_retry_max_delay": 8.0,
    "live_retry_timeout": 30.0,
    "live_retry_budget": 64,
    "live_breaker_threshold": 5,
    "live_breaker_recovery_time": 30.0,

    # ---- serving (gymfx_tpu/serve/, docs/serving.md) ----
    # AOT-compiled padded-batch ladder: every bucket compiles at boot so
    # the decision path never traces (bench_infer.py)
    "serve_buckets": [1, 8, 64, 512, 4096],
    # micro-batcher coalescing window: max extra latency a request pays
    # to share a dispatch with concurrent sessions
    "serve_max_batch_wait_ms": 2.0,
    # auto = matmul on TPU (MXU batching), exact elsewhere (responses
    # bit-identical to the unbatched policy at every bucket size)
    "serve_batch_mode": "auto",
    # compile + run every bucket at engine construction (False defers
    # to first use — only for tooling that never serves)
    "serve_warmup": True,
    # ---- serving overload resilience (docs/serving.md, "Overload
    # behavior") — admission control is OFF by default (unbounded
    # queue, no deadlines), so the bare serving path behaves exactly
    # as before; production configs bound both.
    # admission queue capacity (requests queued ahead of the batching
    # window); null = unbounded
    "serve_max_queue": None,
    # full-queue shed policy: reject (newest submit fails fast with
    # ShedError) | evict_oldest (oldest queued request is dropped so the
    # freshest data wins)
    "serve_shed_policy": "reject",
    # per-request deadline; a request that cannot dispatch before it
    # fails fast with DeadlineExceeded instead of occupying a batch
    # slot.  null = no deadline
    "serve_deadline_ms": None,
    # live degraded-mode fallback when the serving path sheds / misses
    # a deadline / trips the breaker: hold (keep the current pending
    # target, no venue traffic) | flat (route to flat) | reject (raise
    # the typed error to the caller)
    "serve_fallback": "hold",
    # serving circuit breaker around engine dispatch: consecutive
    # dispatch failures to trip OPEN (0 disables), and the open ->
    # half-open recovery window
    "serve_breaker_threshold": 5,
    "serve_breaker_recovery_s": 5.0,
    # live stale-feed watchdog: when the gap since the previous bar
    # exceeds this many seconds, PolicyDecisionService decides via the
    # fallback policy instead of acting on a stale window.  null = off
    "feed_stale_after_s": None,
    # ---- device-resident sessions (docs/serving.md, "Device-resident
    # sessions") — recurrent session carry cached in pre-allocated
    # device slot arrays; each dispatch passes only slot indices + obs
    # through a fused gather->policy->scatter program (zero per-decision
    # carry transfers).  0 keeps the host-carry serving path bitwise
    # identical to the pre-slot code.
    "serve_session_slots": 0,
    # one-dispatch-late host mirror of dirty slots: the failover /
    # blue-green carry-handoff contract.  Only read with slots enabled
    "serve_slot_mirror": True,
    # pipelined batch assembly: the micro-batcher fills double-buffered
    # host staging while the previous batch's executable runs, and
    # resolves batch N only after batch N+1 is dispatched.  Only
    # engages with serve_session_slots > 0
    "serve_staging": True,
    # ---- continuous deployment (docs/serving.md, "Hot-swap and
    # blue/green"; docs/resilience.md) — only read when a
    # BlueGreenDeployer / deploy controller is constructed; a plain
    # engine + batcher session never touches these.
    # pinned-obs rows per shadow-parity probe run against the standby
    # engine before a promote flips routing; 0 disables the probe
    "serve_swap_parity_probe": 4,
    # run the scenario gate in --quick mode inside the deploy
    # controller's train->gate->swap loop (full matrix when False)
    "deploy_gate_quick": True,

    # ---- decision fleet (docs/serving.md, "Decision fleet") — only
    # read when serve_fleet_replicas >= 1; with it at 0 the serving path
    # is the single engine + micro-batcher pair, bitwise identical to
    # the pre-fleet code.
    # active replicas behind the fleet front-end; 0 = fleet off
    "serve_fleet_replicas": 0,
    # warm standby engines booted alongside (promoted on failover)
    "serve_fleet_standbys": 1,
    # fleet-wide admission gate: total queued requests across replicas
    # before submits shed with reason "fleet_queue_full"; null = no gate
    # (per-replica serve_max_queue still applies)
    "serve_fleet_max_queue": None,
    # supervisor probe cadence / per-probe timeout / pinned-obs rows
    "serve_fleet_probe_interval_s": 0.25,
    "serve_fleet_probe_timeout_s": 2.0,
    "serve_fleet_probe_rows": 2,
    # probe latency above this marks a replica degraded (new sessions
    # avoid it); consecutive probe FAILURES at/above dead_after mark it
    # dead and trigger failover
    "serve_fleet_degraded_latency_ms": 250.0,
    "serve_fleet_dead_after": 1,
    # replica-death re-routes per request before its future fails with
    # the underlying error
    "serve_fleet_retry_limit": 2,
    # SessionStateStore capacity: LRU-evicted beyond this many sessions
    "serve_fleet_max_sessions": 1000000,

    # ---- telemetry (gymfx_tpu/telemetry/, docs/observability.md) ----
    # ALL off by default: with every telemetry_* knob unset,
    # telemetry_from_config returns None and the train/serve hot paths
    # are bitwise identical to the pre-telemetry code.
    # master switch: metrics registry + device metric drain + serve
    # instruments
    "telemetry_enabled": False,
    # rotating JSONL sink path for structured rows (metric snapshots,
    # spans, run summaries); null = no sink
    "telemetry_jsonl": None,
    # host-side span records around supersteps/serve dispatch (plus
    # jax.profiler TraceAnnotation regions under an active trace)
    "telemetry_spans": False,
    # /metrics (Prometheus) + /healthz (JSON) endpoint port for the
    # serving stack; 0 = ephemeral, null = no endpoint
    "telemetry_http_port": None,
    # rolling window for the serving SLO gauges (shed_rate,
    # deadline_miss_rate, p99 over the last N seconds)
    "telemetry_slo_window_s": 60.0,

    # ---- run forensics (ledger / compile watch / flight recorder) ----
    # append-only schema-pinned JSONL run ledger path (lifecycle events:
    # compiles, superstep dispatches, checkpoints, preemption,
    # divergence, gate verdicts, bench rows); null = no ledger
    "telemetry_ledger": None,
    # directory for flight-recorder postmortem bundles (last-K superstep
    # metric stacks + rng key + resilience snapshot + compile events,
    # dumped on divergence/watchdog/preemption); null = no recorder
    "telemetry_flight_recorder_dir": None,
    # ring-buffer depth: how many drained superstep frames a postmortem
    # bundle retains
    "telemetry_flight_recorder_k": 8,
    # install jax.monitoring compile listeners + executable
    # fingerprinting (gymfx_compile_* metrics, silent-recompile and
    # serve-bucket-miss detection)
    "telemetry_compile_watch": False,

    # ---- performance observatory (telemetry/profiler.py) ----
    # capture-bundle directory for managed jax.profiler traces around
    # superstep windows (manifest + scope map + profile_capture ledger
    # event; read back by tools/profile_report.py); null = no profiling
    "telemetry_profile_dir": None,
    # comma-separated superstep indices to capture ("1" or "1,8");
    # null with profile_dir set = capture superstep 1 (the first
    # dispatch whose window holds no jit compile)
    "telemetry_profile_supersteps": None,
    # additionally capture every Nth superstep; 0 = off
    "telemetry_profile_every": 0,
}
