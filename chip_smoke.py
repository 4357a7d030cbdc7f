#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gymfx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX and nothing
of the JAX package, builds the port's CUDA kernels from
``gymfx_tpu_torch/csrc`` with nvcc, and runs these phases in order; any
failure exits non-zero:

1. device   CUDA must be available; prints the card and
            ``nvidia-smi --query-gpu=name,power.limit``.
2. build    nvcc builds the six kernel libraries at once, one process
            per source: K1-K3, K6-K7, K9 and K10 (sm_90a, -fmad=false),
            K4, K5 with K8 (sm_90a), timed, with ptxas' register and spill
            report (and each env-, data- and flow-library kernel's
            registers and stack frame: K1's two paths, K2's 8
            instantiations, K3, K2's and K3's memory skeletons; K6, K7's
            two instantiations; K9; K4's 16 f32 window kernels).
3. kernels  each kernel against its plain PyTorch version on the card at
            the main path's shapes.  K1-K3 (torch.equal): K1 at (8192,
            32, 5) with NaN, ±inf, neutral envs and a binary mask, three
            mask/clip cases, also at N = 1, 63 and 8193, (63, 9, 3) (108-
            byte faces), (63, 30, 5) and windows 4 bytes off 16-byte
            alignment (both of its paths); K2 and K3 at 8192 envs over
            every combination of their static flags, K2 also at N = 1, 63
            and 8193 (the flagship's flags and one with slip_match,
            financing and the ohlc policy), K3 also at N = 1, 63 and 8193
            with both rewards and mark_pred and live all true, all false
            and mixed.  K3's sharpe path (its ring of W returns read and
            written a step) at N = 1, 63, 4,096 and 8,193, W = 2 and 64,
            mark_pred and live all, none and mixed, stepped W + 3 times on
            its own outputs so that the ring wraps: torch.equal at every
            step; timed at the baseline configuration's N = 4,096, W = 64
            beside its bound (K3's bytes and the ring read and written),
            its plain version and K3's pnl path at the same N.  Beside K1-K3's times: the
            launch floor (an empty kernel at each one's grid, timed the
            same way), K2's and K3's memory skeletons (their loads and
            stores without their arithmetic), a clone of K1's window, each at one env, K1
            on its env-block path, and what the wrappers' host time is
            made of (a pointer check, the output allocations, K3's seven
            outputs as seven allocations and as one block's rows, a
            ctypes launch).
            K4 forward and backward at the update's shapes (4096, 256, 4,
            32) bf16, the rollout's (256, 256, 4, 32) bf16, a causal f32
            case, S = 1024 and D = 128 (f32 and bf16); float32 (CUDA-core
            route) within 1e-4 x max|plain|, bfloat16 (tensor-core route)
            within 2^-6 x max|plain| (each side rounds an f32 value once,
            so they differ by at most one bf16 ulp of an element, 2^-7 of
            the largest), and within 2^-7 x max|emulation| of the
            emulation of its rounding points (ops/cases.py), with two
            backward calls bitwise equal; each case prints its route and
            the bf16 kernels' shared memory.  Then every case of
            cases.ATTENTION_BF16_CASES and, on the f32 window kernels
            (S <= 64), of cases.ATTENTION_F32_WINDOW_CASES (the ring
            twin's shapes, ragged windows, every instantiated head dim),
            checked, not timed: f32 also within 2^-19 x max|emulation|
            of the emulation of its sums in order, and every backward
            (f32 too) bitwise over two calls.  Matmuls in the plain versions
            run in full f32 (TF32 off, printed).  Times, for every case:
            device time per call from CUDA-graph replays (CUDA events,
            median of 21 replays of 20 calls) for the kernels; the plain
            versions and ``scaled_dot_product_attention`` (K4's library
            yardstick, forward and autograd backward) between CUDA
            events; the bound: the larger of the bytes moved over the
            H100 SXM's 3.35 TB/s and the operations over its peak for
            their type (f32 67 TFLOP/s for K1-K3 and f32 K4 cases, the
            bf16 tensor cores' 989 TFLOP/s for bf16 K4 cases, int32 16.7
            TOP/s for K5 and K8).  K5 (LOB stream matching, int32, torch.equal
            on books and fill records): the venue's seed streams at
            8,192 books (16 messages, 24 levels x 4 slots), the flow mix
            of every scenario at bench.py --lob's shape (1,024 books x
            256 messages) at depths 8, 16, 24 and 48, every hand-built
            stream of ops/cases.py (adversarial, capacity overflow,
            agent maker fills, agent sweeps, cancel and reuse), streams
            whose lots wrap int32 sums, and one book for each of the
            kernel's 16 templates (1-2 levels a lane x 1-8 slots), and
            streams of one message kind each (ops/cases.py LOB_KINDS);
            timed at both shapes in us/call and us/message, with fills/s
            (bench.py --lob's metric) at 1,024 x 256 x depth 24, each
            kind alone in us/message at that shape, and each template's
            registers, stack frame and spills from ptxas.  K8 (one bar
            of the LOB venue, int32, torch.equal on the final books and
            its eight results): the venue's shape (8,192 books of 24 x 4
            seeded by the venue's seed stream, 64 lob_volatile messages,
            the agent's orders of ops/cases.LOB_BAR_PATHS: open walks
            both ways, a forced liquidation, a sub-lot denial, gap stops,
            free-running brackets, a take-profit filled in part then
            pulled by the stop, a stop firing on the last message, no
            brackets), one case per template, and books whose lots wrap
            int32; timed at the venue's shape beside its bound, its
            launch floor, its plain version and its wrapper's host time
            (50 calls enqueued), with each template's ptxas registers,
            stack frame and spills.  K9 (one bar's flow messages, int32,
            torch.equal on the five streams): every scenario at the
            venue's shape (8,192 envs x 64 messages) with int32 and int64
            bar rows, and at 13 x 17, 37 x 70, 1 x 1 and 4,099 x 33;
            timed at the venue's shape beside its bound (the function's
            threefry blocks and each message's operations, at the int32
            rate), its launch floor, its plain version and its wrapper's
            host time, with its ptxas registers and frame.  K6 (q16
            tape decode, torch.equal): int16 extremes, divisors 1, 60,
            1440 and f32(1e5), ragged row counts; K7 (batched scaled
            windows, bitwise with NaN matching NaN): NaN and +-inf
            features, neutral rows, steps 0 and n,
            clip 10, 0 and 1.5, then random, the export's (1..n, a ragged
            last tile) and clamped steps at F 1, 3, 5, 7 and W 8, 32, 64,
            aligned and with the features 4 bytes off alignment, and at
            600,000 steps (every CTA walks two tiles or more: the
            export's steps, and turns of staged tiles alternating with
            scattered, clamped ones) at F 3 and 5, aligned and not.  Their
            times come at the paths' shapes in phases 8-10 (bound at 3.35
            TB/s).
4. main     PPO training at flagship width: 8,192 bar-venue envs, window
            32, OHLCV features (F=5, obs dim 164), the 3x256 tanh MLP in
            bf16 with weights from torch.Generator(seed), horizon 64, one
            epoch of 4 env-permuted minibatches; three train steps through
            PPOTrainer.train_step, each timed: the first captures the
            rollout and update phases as CUDA graphs (core/graphs.py),
            every later one replays them.  K1/K2/K3 must each count 64
            launches a phase at capture (x4: three warm-ups and the
            capture; a replay moves no count), and a torch.profiler trace
            of one replay must show each 64 times by kernel name and the
            update none; losses finite, no update skipped, the params must
            move; step 1's rollout phase replayed from the graph must
            equal the same phase op by op with the plain versions on the
            card (torch.equal).  Then graphed against eager
            (torch.equal, the generator's state included): one rollout
            phase, one update phase (params, Adam state, metrics,
            quarantined envs), and train_many (k = 3) against three eager
            train steps, from one saved state; capture seconds, graphed
            and eager phase ms (medians of steps 2-3) and env steps/s.
5. long     PPO training in the long-context configuration
            (config/flagship.long_context_config: transformer_ring,
            d_model 128, 4 heads, 2 layers, window 256, 256 envs, bf16),
            two graphed train steps.  K4 must count 130 forwards a rollout
            phase (65 policy forwards x 2 layers) plus 8 forwards and 8
            backwards an update (4 minibatches x 2 layers), K1-K3 64, at
            capture (x4) and in the profiler trace of one replay; losses
            finite, no update skipped.  Then one update phase from the
            saved state with fixed permutations, once replayed through K4
            (the permutations copied into a graph of their own) and once
            op by op with its plain versions on the card (which must
            launch no K4): loss and value loss within rtol
            1e-2, entropy within rtol 1e-3, policy loss within atol 1e-3
            (it is a mean of terms near zero), gradient global norm
            within rtol 5e-2 — the attention outputs differ by bf16
            rounding flips, which the bf16 network carries on.  Then
            graphed against eager as in main.
6. lob      PPO training on the LOB venue at flagship width
            (config/flagship.lob_config, "flagship-lob-train": 8,192 envs,
            lob_volatile flow, 64 messages per bar, direct_fixed_sltp,
            40-lot entries), three train steps from the rollout and update
            graphs, as main.  Per rollout phase K1, K3, K5, K8 and K9
            must launch 64 times each and K2 never, the update none of
            them: at capture (x4) and by kernel name in a profiler trace
            of one replay, which must run no sort, scan or scatter kernel
            (the argsort engine; torch.gather's kernel aside) and no int64
            bitwise or shift kernel (the plain flow's threefry words);
            kernels a step printed.  Losses finite, no update skipped.
            Step 1's rollout phase replayed from the graph, re-run op by
            op with the plain versions of K1, K3, K5, K8 and K9 on the
            card, must give the same
            env states, trajectory and bootstrap value (torch.equal).
            Then graphed against eager as in main.
7. episode  Environment.rollout with the buy_hold driver, 1 env, on the
            card, from the episode drivers' CUDA graphs (core/rollout.py:
            one graph a chunk length, 64 steps and the remainder): 400
            bar-venue steps (K2 and K3 4 x (64 + 16) launches, the warm-ups
            and captures of both chunk graphs, K1 one more for the reset's
            obs; a second, replayed episode adds only that reset) and 50
            LOB-venue steps (K3, K5, K8 and K9 4 x 50, K1 one more, K2
            none); each episode must equal the same episode op by op on
            the card (eager, torch.equal on every output and the final
            state) and on the CPU; ms a step graphed, eager and with the
            capture, and the capture seconds, printed.
8. curriculum  four M1 tapes of 2^18 bars (EUR/USD-, GBP/USD-, AUD/USD-
            and NZD/USD-like random walks in whole 1e-5 ticks, OHLCV,
            generated from the seed into a temporary directory) as
            config/flagship.curriculum_config ("flagship-curriculum-train":
            8,192 envs, 3x256 bf16 MLP, horizon 64, window 32, F=5,
            data_compress on, random starts): tape 0 resident f32, tapes
            1-3 compressed.  Each compressed tape decoded on the card must
            equal the direct f32 build and the plain decode (torch.equal,
            every field); codec report, ratios and byte report printed; K6
            timed at a pick's group beside the int16 stack before it.
            PPOTrainer.train runs 4 supersteps (K=1), graphed: 4 picks, at
            least one compressed, each copied into one staging tape, so
            one graph a phase serves every tape; K2 and K3 64 a replay, K1
            66 (65 in the rollout: also the random-start bank's obs; 1 in
            the update: the active tape's fresh reset), at capture (x4) and
            in the profiler trace of one replay; K6 exactly its q16 groups
            per compressed pick and never for tape 0; losses finite, no
            update skipped.  One graphed rollout phase on a compressed
            tape, re-run op by op with the plain decode and plain K1-K3,
            must be torch.equal; then graphed against eager as in main.
9. export   export_scaled_features on one tape for 262,143 steps:
            (262,143, 32, 5) f32 through one K7 launch; the saved array
            must equal the plain version's bitwise; K7 timed at that
            shape beside its launch floor at its grid, zeroing an output
            of the same size (this card's write-bound yardstick) and its
            wrapper's host time at 64 steps; the windows' and the save's
            seconds printed apart.
10. stream  one tape streamed with budgets that cut 256-bar shards:
            data_compress on (the ring does not hold the tape: pinned
            copies of compressed shards on a side stream, K6 once per q16
            group per shard) and off (pinned f32 shards); a buy_hold
            episode of one env for 2,048 steps over 8 shards each, from the
            chunk graphs (each shard copied into one staging shard, its
            row0 a device tensor, so one graph serves every shard), equal
            to the resident episode and to the same episode op by op
            (torch.equal, every output and the final state); K6 timed at
            a shard's group.  The episode is cut to 2,048 steps because the
            eager episode it is held against is host-bound (~3 ms a step);
            the tape is at full size.
11. baseline BASELINE.json's configurations 3 and 4 at full width
            (config/flagship.py): baseline_sharpe_config ("baseline-sharpe-
            atr-train": PPO, 4,096 envs, sharpe_reward over a 64-slot ring,
            direct_atr_sltp, the 3x256 f32 MLP, horizon 32) and
            impala_lstm_config ("baseline-impala-lstm-train": IMPALA, 4,096
            envs, unroll 64, the LSTM (hidden 256) in bf16,
            dd_penalized_reward), three graphed train steps each: K2 and
            K3 a horizon (32) or an unroll (64) of launches a rollout
            phase at capture (x4; the sharpe path's own count too) and by
            name in the profiler trace of one replay, the update none;
            losses finite, no update skipped; then graphed against eager
            as in main (IMPALA's train_many, k = 3, crosses an actor sync)
            with each phase's ms and env steps/s, and for IMPALA the
            device ms of its learner replay (the LSTM over the segment,
            forward and backward) beside the update phase's.
12. cli     the command line (gymfx_tpu_torch/app/main.py main) on a
            generated 2^15-bar M1 tape at flagship width with a quarter
            of the bars held out: --mode training for 3 iterations with a
            checkpoint after each (the JAX package's results keys, three
            digest-verified steps); a resume from step 2 for one iteration,
            whose step-3 train state must equal the uninterrupted run's
            leaf by leaf (params, Adam state, env batch, generator state);
            --driver_mode policy on the checkpoint, which must reproduce
            the held-out summary number for number; the evaluation
            episode's ms a step replayed and its capture seconds, 2,048 of
            its steps graphed == eager, and one 64-step chunk replay's
            kernels by name (K1, K2, K3 64 each); the diagnostic episode
            with buy_hold (1 env, the whole tape; its first 2,048 steps ==
            the CPU's) and random (8,192 envs x 2,048 steps == the eager
            episode on the card), each through main.  Then IMPALA through
            main (--trainer impala, impala_lstm_config on the same tape):
            one iteration with a checkpoint, then --driver_mode policy on
            it, which must reproduce the held-out summary.
14. portfolio BASELINE.json's configuration 5 (config/flagship.py
            portfolio_pbt_config, "baseline-portfolio-pbt": PBT over the
            EUR/USD, GBP/USD, USD/JPY portfolio, the flax Transformer
            policy in float32, 4 members x 64 envs x 3 pairs = 768 pair
            rows, horizon 64, exploit/explore every 2 steps).  Before it,
            in the kernels phase, K2 and K3 with a param row per env
            (three distinct rows) against their plain versions
            (torch.equal) at 768 and 24,576 rows over every flag
            combination and both rewards, and both param forms timed at
            8,192 rows (the per-row form also at 24,576).  Then the
            env itself with per-pair commission and slippage
            (portfolio_param_overrides: config 5 sets none, so its own
            steps pass every param 0-d): 4 steps at 768 rows, one K2
            and one K3 launch a step, equal to the CPU's plain step
            (torch.equal).  Then 3 population steps with one
            exploit/explore, graphed against eager (torch.equal,
            generator included); K2 and K3 4 x 64
            launches at capture, 64 each by name in one rollout replay
            (one launch a step for every row of the population); no
            capture after the first step; the phases' ms and env
            steps/s, and PBTTrainer.train over the configuration's
            200,000 env steps (12 population steps).  Then the same
            population under policy=transformer_ring (K4's f32 window
            kernels): one step graphed == eager, attn_fwd_window and
            attn_bwd_window counted by name in the replays (130 forwards
            a rollout replay, 16 and 16 an update replay), the twin's
            rollout and update replays timed beside the transformer
            twin's of this call, and K4 f32 forward and backward checked
            against their plain versions and the emulation and timed at
            the rollout's (256, 32, 4, 32) and an update minibatch's
            (4,096, 32, 4, 32) beside the streamed kernels' earlier times, the plain version,
            SDPA, the bound, the memory skeleton and the launch floor
            (profile_attention.f32_window_probes) and the wrapper's host
            time.
15. portfolio cli  main --trainer portfolio on portfolio_transformer_config
            (examples/configs/train_portfolio_transformer.json: 512 envs,
            margin 0.02, leverage 20) with eval_split 0.3 for 2
            iterations with a checkpoint each; --driver_mode policy on it,
            which must reproduce the held-out summary; main --trainer pbt
            on portfolio_pbt_config with eval_split 0.3 for 4 population
            steps, the best member's held-out summary.
16. configs  the shipped example configs that need cost profiles, the GA
            and the replay engine,
            each through main from examples/configs/ at its shipped size:
            inference_financed_profile (the final balance),
            optimize_atr (the GA: 64 candidates, 12 generations, the 4
            atr_period grid points, each generation one batched episode
            from its chunk graphs; best_params, best_rap,
            selection_signal, the best period's wall and capture seconds
            and the whole call's) and inference_verified_execution (the
            cross-check run, not skipped, within its bound).  Then the
            financed profile (execution_cost_profiles/pessimistic_v1,
            the smoke rate table, venue_quantization) at flagship width
            over the cli phase's generated 2^15-bar M1 tape: the accrual
            column non-zero on its 22 rollover bars; one env's buy_hold
            episode over its first 8,192 bars, whose cash moves on
            exactly the 5 rollover bars among them, by the rate table's
            amount; 8,192 envs of
            random actions over the first 1,408 bars (past the first
            rollover), graphed == eager (torch.equal) and one 64-step
            chunk replay's kernels by name (fill_brackets_kernel<false,
            true, false> 64, K3 64); K2 at those 8,192 envs on the
            first rollover bar's real rates torch.equal to its plain
            version and timed beside it and its bound.  The GA's
            population (64 candidates, 500 steps, tuning k_sl and
            commission, a per-row column of K2's params) for two
            generations, each graphed twice == eager (torch.equal
            fitness), the candidates' rap not all equal, the second
            generation's values replayed through the first's graphs;
            one chunk replay's K2 and K3 counted and the generation
            timed.  The LOB venue (flagship-lob-train's book) with
            financing, 1,024 envs x 64 random steps over a tape whose
            rollover is bar 40: graphed == eager (torch.equal), the
            positions equal to the unfinanced episode's and the equity
            apart by the accrual on the rollover step alone.  The portfolio with a profile per
            pair (commission and spread differ) and financing over three
            generated pair tapes that cross a rollover at bar 20: 256
            books x 3 pairs for 24 steps, one K2 and one K3 launch a
            step, each pair's own accrual and params as row columns,
            every leaf equal to the CPU's plain step (torch.equal).
17. serve   the serving stack (gymfx_tpu_torch/serve/), after portfolio,
            in 20-40 s: engine_from_config boots bench_infer.py's
            configuration (DEFAULT_VALUES on the 500-bar sample, window
            32, the ladder 1/8/64/512/4,096, a 2 ms window) for serve-mlp
            (the 3x256 f32 MLP), serve-ring (transformer_ring at its
            defaults, f32) and serve-lstm-slots (the LSTM, hidden 256,
            bf16, 1,024 session slots) in matmul mode (auto), a CUDA
            graph a bucket (each bucket's capture seconds printed, no
            capture after boot); K4's forward counted at the ring
            ladder's capture and by name in one replay of each bucket (2
            a replay).  exact mode at the ladder (1, 8, 64) for all three:
            every row of every bucket, padded fills and the chunking above
            64 included, torch.equal to the policy on that row alone (the
            LSTM from non-zero carries, its carry too); each bucket's
            replay ms.  matmul: the largest difference against the
            single-row forward and across buckets, over max|single-row|,
            within SERVE_MATMUL_TOL.  BarFeaturizer over the sample's bars
            at flagship_config (OHLCV, 8,192 envs): the obs torch.equal to
            the env's (K1) at reset and every step.  The micro-batcher, 64
            client threads x 50 single-bar requests, synchronous and
            pipelined: every answer torch.equal to decide_batch (the exact
            ladder).  The LSTM's slots: 48 sessions x 8 steps torch.equal
            to host-carry threading, the mirror equal to the host carry
            and the device rows after each resolve, two slot and three
            host dispatches in flight resolving to their own rows.
            bench_infer.py's numbers for serve-mlp beside the card's name
            and power limit: 256 sequential batch-of-1 decisions (the
            eager policy, and the engine's decide), decide_batch at 1,024
            rows x 20, and the batcher's p50 / p99 request latency split
            into queue, window and dispatch (its answers within
            SERVE_MATMUL_TOL of the exact ladder's).  swap_weights:
            accepted, the next dispatch on the new weights; a mismatched
            one refused, nothing changed; no late capture anywhere.  K4's
            forward timed at (B, 32, 4, 32), B = 1, 8, 64, 512, 4,096,
            beside its plain version, SDPA and its bound.
18. scengen the scenario generator (gymfx_tpu_torch/scengen/), after
            serve, within SCENGEN_BUDGET_S (60 s).  K10 (the generator's
            scan) torch.equal to its plain version on its eight outputs
            for every preset at bench.py --scengen's shape (65,536 bars x
            4 assets, PRNGKey(0)) on fx_timestamp_grid's M1 Monday mask,
            and at 2 x 1, 4,096 x 1 and 4,096 x 33; the bars of each flag
            kind printed; timed (graph replays) beside its bytes bound, its
            serial floor (K10_CHAIN_CYCLES a bar at the SM clock), its
            launch floor and its plain version, with generate's ms and
            bars/s (bench.py's bars x assets).  K9's flag route
            torch.equal to its plain version for every scenario at 8,192
            envs x 64 messages with bar flags of every kind, timed beside
            K9's replay route.  flagship-scengen-train: flagship_config on
            a generated 32,768-bar regime_mix tape snapped to the tick
            grid: 3 graphed train steps, K10 one launch (the generation),
            K1-K3 64 a phase at capture and by name in a replay, a rollout
            phase graphed == eager; the tape streamed in compressed
            256-bar shards (K6): a 2,048-step episode == the resident one.
            A curriculum of scengen:flash_crash@2 and scengen:range_chop@1
            (tape 1 compressed): PPOTrainer.train 3 supersteps, K10 twice,
            K6 on the compressed pick.  lob-scengen: lob_config on
            generated liquidity_drought and flash_crash tapes, random
            starts: liquidity_drought 2 graphed train steps, K5, K8 and K9
            64 a phase at capture, K9 every time by its flag route;
            flash_crash a rollout phase of horizon 4 replayed from its
            graph == the plain versions op by op (torch.equal).  Config 5's
            population (portfolio_pbt_config) on a generated
            multi_asset_stress book of EUR/USD, GBP/USD and USD/JPY, then
            on a portfolio curriculum of two presets (the staging rows
            hold the last pick's book): PBTTrainer.train 2 population
            steps each, K2/K3 64 a phase at capture.
19. pbt     PBT over the bar venue, after portfolio, before serve:
            flagship_config's PPO as a population of PBT_MEMBERS (4) x
            8,192 envs (32,768 env rows in one batch, member-stacked
            params, PPOTrainer(members=4)), pbt_interval 2: 3 population
            steps with an exploit/explore after the second, graphed ==
            eager (torch.equal, generator, fitness and replaced members
            included), K1-K3 4 x 64 launches at the capture and none after
            (no recapture after the in-place exploit/explore), 64 each by
            name in one rollout replay for every row; the rollout and
            update replays timed and the population's env steps/s printed
            beside the card's name and power limit; main --trainer pbt (2
            population steps, the best member's params checkpointed and
            evaluated on held-out bars, the policy mode on the checkpoint
            == the training summary); an LSTM (hidden 128) and a
            transformer_ring (d_model 64, 1 layer; K4 launched) population
            at 1,024 envs x 16 steps, one step graphed == eager each.
19. telemetry  after configs: flagship_config on a generated 2^15-bar M1
            tape, 3 iterations through train_from_config with every
            trainer telemetry key on (JSONL sink, spans, loopback HTTP,
            ledger, flight recorder) and off: final states torch.equal to
            each other and to the bare loop of train_step (no hooks
            around it), the ledger valid with its kinds, the sink's drained
            metrics the returned ones, the allocator watermark gauges;
            fault_profile preempt_at=2 raises after iteration 2 with its
            checkpoint and a valid postmortem, its resume == the
            uninterrupted run; env steps/s with every key and log_every=1
            on beside off (off/on/off/on, TELEMETRY_RATE_ITERS each, the
            console lines checked), the drain's host us a superstep past
            its event wait and its parts timed; serve-mlp with instruments
            under a FlakyEngine plan, /metrics and /healthz scraped on
            loopback (counts, late_compiles 0).
13. summary one JSON line {"kernels": [...]}, then the last line
            {"ok": true, "device": {...}}.
It also writes its numbers to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
N_ENVS = 8192
WINDOW = 32
HORIZON = 64
TRAIN_STEPS = 3
LONG_STEPS = 2
LOB_STEPS = 3
EPISODE_STEPS = 400
# the eager one-env LOB step is host-bound; the episode's first trade
# closes at step 1
LOB_EPISODE_STEPS = 50
# the data path: four M1 tapes of 2^18 bars (about 8 months of an FX
# trading week's grid), generated from SEED as random walks in whole
# 1e-5 ticks at these pairs' levels
TAPE_BARS = 2 ** 18
TAPE_LEVELS = {"eurusd": 1.10, "gbpusd": 1.27, "audusd": 0.66, "nzdusd": 0.60}
CURRICULUM_SUPERSTEPS = 4
STREAM_STEPS = 2048
STREAM_SHARD_BARS = 256
# the cli phase: a 2^15-bar M1 tape (a quarter held out), 3 training
# iterations; the diagnostic and evaluation episodes held to eager ones of
# 2,048 steps (the eager step is host-bound)
CLI_BARS, CLI_ITERS, CLI_EAGER_STEPS = 2 ** 15, 3, 2048
# PBT over the bar venue: flagship-train's population (config 5's 4
# members); the LSTM and ring populations' smaller depth
PBT_MEMBERS, PBT_SMALL_ENVS, PBT_SMALL_HORIZON = 4, 1024, 16
# the telemetry phase's train_from_config runs and its on/off rate runs
TELEMETRY_ITERS, TELEMETRY_RATE_ITERS = 3, 8
# K2 and K3 with a param row per env: baseline-portfolio-pbt's rows (4
# members x 64 envs x 3 pairs) and the flagship's envs x 3 pairs
PORTFOLIO_ROWS = (768, 8192 * 3)
# the held-out summary's numbers (summarize_trading and the step Sharpe)
CLI_SUMMARY_KEYS = ("initial_cash", "final_equity", "total_return", "max_drawdown_pct",
                    "max_drawdown_money", "sharpe_ratio", "sqn", "trades_total", "trades_won",
                    "trades_lost", "avg_trade_pnl", "metric_schema", "max_drawdown_fraction",
                    "risk_penalty_lambda", "risk_adjusted_total_return", "rap",
                    "sharpe_ratio_steps")
# the configs phase: the shipped configs it runs through main, the financed
# episode's envs and steps (22 chunks, past the tape's first rollover at
# bar 1,320), the pair tapes' bars (a rollover at bar 20) and books
SHIPPED_CONFIGS = ("inference_financed_profile", "optimize_atr", "inference_verified_execution")
FINANCED_STEPS, PAIR_BARS, PAIR_BOOKS, PAIR_STEPS = 1408, 96, 256, 24
LOB_FIN_BARS, LOB_FIN_STEPS, LOB_FIN_ENVS = 128, 64, 1024
# the GA's card check tunes a K2 per-row column beside k_sl, so that its
# candidates score apart (the shipped config's k_sl and k_tp do not on
# its 500 bars)
GA_SCHEMA = {"k_sl": [1.0, 4.0], "commission": [0.0, 0.0002]}
# the one-env buy_hold episode over the financed tape: its first 5 rollovers
BUY_HOLD_STEPS = 8192
PESSIMISTIC = "examples/configs/execution_cost_profiles/pessimistic_v1.json"
RATES = "examples/data/fx_rollover_rates_smoke.csv"
# K7 at a batch whose tiles outnumber twice its persistent grid's CTAs
K7_MANY_TILES = 600_000

# the H100 SXM data sheet: HBM3 bytes/s, f32 FLOP/s outside the tensor
# cores, bf16 dense tensor-core FLOP/s
BANDWIDTH, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
# int32 operations per second outside the tensor cores: 132 SMs x 64
# INT32 lanes x 1.98 GHz (the clock behind the 67 TFLOP/s f32 figure;
# Hopper has half as many INT32 lanes as FP32 lanes per SM)
INT32_OPS = 132 * 64 * 1.98e9
# K5: int32 operations per slot of the half a message touches (eligibility,
# prior, fill clip, stats, compaction), counted from the kernel source
K5_OPS_PER_SLOT = 8
# f32 arithmetic per element (K1) or per env (K2, K3), counted from the
# kernel source (compares and selects included): the operation side of
# the bound, which bytes outweigh for all three
OPS_PER_ITEM = {"step_obs": 8, "fill_brackets": 120, "mark_reward": 20}
# K3's sharpe path beyond K3's: a slot's select, two adds and a multiply,
# and the mean, variance, two roots, the ratio and the selects after
SHARPE_OPS_PER_SLOT, SHARPE_OPS = 4, 16
REPLACES = {
    "step_obs": "gymfx_tpu/ops/window_zscore.py:193",
    "fill_brackets": "gymfx_tpu/ops/env_dynamics.py:234",
    "mark_reward": "gymfx_tpu/ops/env_dynamics.py:280",
    # K3's sharpe path: the Pallas K3 refuses the sharpe reward, which the
    # JAX package computes on its XLA path (gymfx_tpu/core/rewards.py:47)
    "mark_reward_sharpe": "gymfx_tpu/ops/env_dynamics.py:280",
    "attention_forward": "gymfx_tpu/ops/fused_attention.py:172",
    "attention_backward": "gymfx_tpu/ops/fused_attention.py:150",
    "process_stream": "gymfx_tpu/ops/lob_match.py:289",
    # K8 has no Pallas counterpart: it is the counterpart of the reference's
    # lax.scan over a bar's flow
    "lob_bar": "gymfx_tpu/lob/venue.py:267",
    # K9 has no Pallas counterpart either: it is the counterpart of the
    # jax.random draws of the reference's bar_messages
    "bar_flow": "gymfx_tpu/lob/flow.py:102",
    "decode_q16_block": "gymfx_tpu/ops/tape_decode.py:63",
    "batched_scaled_windows": "gymfx_tpu/ops/window_zscore.py:110",
    # K9's flag route: the same draws under the blended FlowParams of
    # gymfx_tpu/lob/scenarios.py::flow_params_from_regime
    "bar_flow_flags": "gymfx_tpu/lob/flow.py:102",
    # K10 has no Pallas counterpart: it is the counterpart of the
    # reference's lax.scan over a generation's bars
    "scengen_scan": "gymfx_tpu/scengen/engine.py:232",
}
SOURCES = {"attention_forward": "gymfx_tpu_torch/csrc/attention_kernels.cu",
           "attention_backward": "gymfx_tpu_torch/csrc/attention_kernels.cu",
           "process_stream": "gymfx_tpu_torch/csrc/lob_kernels.cu",
           "lob_bar": "gymfx_tpu_torch/csrc/lob_kernels.cu",
           "bar_flow": "gymfx_tpu_torch/csrc/flow_kernels.cu",
           "bar_flow_flags": "gymfx_tpu_torch/csrc/flow_kernels.cu",
           "scengen_scan": "gymfx_tpu_torch/csrc/scengen_kernels.cu",
           "decode_q16_block": "gymfx_tpu_torch/csrc/data_kernels.cu",
           "batched_scaled_windows": "gymfx_tpu_torch/csrc/data_kernels.cu"}
# kernel-name patterns in a profiler trace of one graph replay (K4's
# backward counted by its dQ kernel, one a bf16 backward call)
KERNEL_NAMES = {"step_obs": "step_obs", "fill_brackets": "fill_brackets_kernel",
                "mark_reward": "mark_reward_kernel", "attention_forward": "attn_fwd",
                "attention_backward": "attn_bwd_dq", "process_stream": "lob_stream_kernel",
                "lob_bar": "lob_bar_kernel", "bar_flow": "bar_flow_kernel"}
# kernels of the argsort engine (lob/book.py): none may run in a replayed
# LOB rollout phase
ENGINE_KERNELS = ("sort", "scan", "scatter", "cumsum")
# torch.gather's kernel (a scatter-gather kernel that is not scatter-like):
# the rollout gathers the sampled action's log-probability once a step
GATHER_KERNEL = "_cuda_scatter_gather_internal_kernel<false"
# traces of one replay taken at most, where a trace lost records, and the
# seconds a trace waits after the replay before the profiler stops
TRACE_TRIES, TRACE_DRAIN_S = 5, 0.5
# K5 cases: the bench.py --lob shape and its depth sweep
LOB_BOOKS, LOB_MSGS, LOB_DEPTHS, LOB_SLOTS = 1024, 256, (8, 16, 24, 48), 4
# K5's templates: (levels a lane, queue slots), depth 1-32 -> 1, 33-64 -> 2
K5_INSTANCES = [(per_lane, slots) for per_lane in (1, 2) for slots in range(1, 9)]
# K8 at the venue's shape: flagship-lob-train's books, lob_volatile bars
K8_MSGS, K8_SCENARIO = 64, "lob_volatile"
# K9: int32 operations of one threefry-2x32 block (lob/prng.py) in their
# fewest instructions: 20 rounds of add, rotate (one funnel shift) and xor,
# the count's add to the key, and one add for each of the 5 key
# injections (the other folds into the round's add as a 3-input add; a
# key's parity word and injection constants are the key's, not a
# block's); of a message beyond its draws: a word's xor (one a draw), a
# uniform's shift, or and subtraction, randint's fold of its two words,
# and the path's float32 operations and the selects and clamps
THREEFRY_OPS, K9_UNIFORM_OPS, K9_RANDINT_OPS, K9_MSG_OPS = 66, 3, 6, 24
# K9 at odd shapes: (envs, messages, bar-row dtype)
K9_ODD = ((13, 17, "int64"), (37, 70, "int32"), (1, 1, "int32"), (4099, 33, "int64"))
# K10: bench.py --scengen's shape (65,536 bars x 4 assets, PRNGKey(0)) on
# fx_timestamp_grid's M1 Monday mask, and the edge shapes (bars, assets)
SCENGEN_BARS, SCENGEN_ASSETS = 65536, 4
K10_EDGES = ((2, 1), (4096, 1), (4096, 33))
# K10's serial floor: a bar's loop-carried chain is the regime's (the three
# thresholds picked by the last regime, three compares, the nested selects
# of the new one): ~6 dependent ALU operations of ~4 cycles, at the card's
# SM clock (nvidia-smi clocks.max.sm)
K10_CHAIN_CYCLES = 24
# f32 operations of a bar (the chain, the counters, the bar's scalars) and
# of an asset's bar (ret, gap, log prices, the wicks and four expf of ~12
# instructions each): the operation side of K10's bound
K10_BAR_OPS, K10_ASSET_OPS = 40, 70
# the scengen phase: flagship-scengen-train's tape (M1 bars snapped to the
# tick grid), lob-scengen's presets, the curriculum's tapes, the streamed
# episode's steps over shards of STREAM_SHARD_BARS, the lob-scengen plain
# comparison's horizon (the plain LOB phase runs the argsort engine, ~0.5 s a
# step at 8,192 envs), config 5's generated pairs, and the phase's budget
SCENGEN_TAPE_BARS = 32768
SCENGEN_LOB_PRESETS = ("liquidity_drought", "flash_crash")
SCENGEN_TAPES = "scengen:flash_crash@2,scengen:range_chop@1"
SCENGEN_CURRICULUM_SEED = 1  # its first three picks: tapes 0, 1, 0
SCENGEN_BOOKS_SEED = 0  # the portfolio curriculum's first two picks: books 1, 0
SCENGEN_PLAIN_HORIZON = 4
SCENGEN_PAIRS = ("EUR_USD", "GBP_USD", "USD_JPY")
SCENGEN_BUDGET_S = 60.0
# K4 cases: label -> ((B, S, H, D), dtype, causal); "update" is the
# update's shape (4 minibatches of 64 envs x 64 steps), "rollout" the
# rollout's
ATTENTION_CASES = {
    "update": ((4096, 256, 4, 32), "bfloat16", False),
    "rollout": ((256, 256, 4, 32), "bfloat16", False),
    "causal_f32": ((64, 256, 4, 32), "float32", True),
    "window_1024": ((16, 1024, 4, 32), "bfloat16", True),
    "head_dim_128": ((4, 77, 3, 128), "float32", False),
    "head_dim_128_bf16": ((4, 77, 3, 128), "bfloat16", False),
}
# K4 f32 times at the ring twin's shapes on the streamed kernels, before
# the window kernels took these windows, us: the ranges PERF.md §6 gives
# for them (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
# as "earlier"
K4_F32_EARLIER_US = {"update": {"forward": (626.5, 633.0), "backward": (1479.6, 1493.2)},
                     "rollout": {"forward": (48.8, 49.5), "backward": (100.6, 102.2)}}
# the bf16 kernels against the emulation of their rounding points
# (gymfx_tpu_torch/ops/cases.py): only the order of the f32 sums differs,
# so the two round nearly the same value to bf16 once: at most one ulp of
# the largest element
EMULATION_TOL = 2.0 ** -7
# the f32 window kernels against the emulation of their sums in order:
# the card's expf and torch's exp differ in their last ulps, which move
# an output by a few ulps of the largest element
F32_EMULATION_TOL = 2.0 ** -19
# the serve phase: the three served configurations (bench_infer.py's
# DEFAULT_VALUES on the 500-bar sample, window 32, the default ladder,
# 2 ms window), the exact ladder they are also held to, bench_infer.py's
# load (64 clients x 50 single-bar requests; 256 sequential decisions;
# 20 closed-loop dispatches of 1,024 rows), the LSTM's session slots and
# its slot checks (48 sessions x 8 steps, two in-flight dispatches of 30)
SERVE_CONFIGS = {
    "serve-mlp": {"policy": "mlp"},
    "serve-ring": {"policy": "transformer_ring"},
    "serve-lstm-slots": {"policy": "lstm", "policy_dtype": "bfloat16",
                         "serve_session_slots": 1024},
}
SERVE_EXACT_BUCKETS = (1, 8, 64)
SERVE_EXACT_ROWS = (1, 5, 8, 30, 64, 133)
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_WAIT_MS = 64, 50, 2.0
SERVE_SEQ, SERVE_BATCH, SERVE_ITERS = 256, 1024, 20
SERVE_SESSIONS, SERVE_SLOT_STEPS, SERVE_INFLIGHT = 48, 8, 30
# matmul mode against the single-row forward and across buckets: the
# largest difference of the logits, value and carry over the largest
# magnitude of the single-row result; f32 within 1e-5 (the ROADMAP
# Queue 3 pin for policy outputs), bf16 within 2^-5 (a bf16 ulp of the
# carry, 2^-8, grown through the cell's 4 gates and the f32 heads)
SERVE_MATMUL_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
# K4's forward timed at the serving ladder's batches of (B, 32, 4, 32)
SERVE_K4_BATCHES = (1, 8, 64, 512, 4096)
# the phase's budget on the card, capture included
SERVE_BUDGET_S = 60.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def device_ms(torch, fn, reps: int = 20, trials: int = 21) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a
    CUDA graph, replayed ``trials`` times between CUDA events; the
    median replay over ``reps``.  The replay has no host work in it, so
    this is the kernels' time alone."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # no cyclic collection mid-capture: it could destroy a dead trainer's
    # graphs, which invalidates this capture
    gc.collect()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    finally:
        gc.enable()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def event_ms(torch, fn, reps: int = 3, trials: int = 5) -> float:
    """Time of one ``fn()`` call between CUDA events without a graph
    (for work that allocates gigabytes or runs autograd): the median of
    ``trials`` runs of ``reps`` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us(torch, fn, calls: int = 200) -> float:
    """Wall time per call of ``fn()`` over ``calls`` back-to-back calls,
    ending in a synchronize: the wrapper's host cost when it exceeds the
    device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def max_abs_err(torch, a, b) -> float:
    if a.dtype == torch.bool:
        return float((a != b).sum())
    a, b = a.double(), b.double()
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def bits_equal(torch, a, b) -> bool:
    """Bitwise equality of two f32 tensors, NaN matching NaN (of any
    payload): torch.equal on the bits, where torch.equal on the values
    would call two NaNs unequal and -0.0 equal to 0.0."""
    nan_a, nan_b = a.isnan(), b.isnan()
    return bool(torch.equal(nan_a, nan_b)) and bool(torch.equal(
        torch.where(nan_a, 0, a.view(torch.int32)), torch.where(nan_b, 0, b.view(torch.int32))))


def nan_abs_err(torch, a, b) -> float:
    """max_abs_err over the elements that are not NaN on both sides."""
    return max_abs_err(torch, torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def k6_bound(delta):
    """K6: the int16 block read, base and divisor read, the f32 block
    written; an add, a conversion and a division per element."""
    c, rows = delta.shape
    return bound(nbytes(delta) + 8 * c + 4 * c * rows, 3 * c * rows, F32_FLOPS)


def attention_tolerance(torch, ref) -> float:
    scale = 2.0 ** -6 if ref.dtype == torch.bfloat16 else 1e-4
    return scale * float(ref.float().abs().max())


def bound(moved: float, ops: float, peak: float):
    byte_ms, op_ms = moved / BANDWIDTH * 1e3, ops / peak * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


def check_kernels_k1_k3(torch, dev, kernels) -> None:
    from gymfx_tpu_torch.config.flagship import FEATURE_COLUMNS
    from gymfx_tpu_torch.core.types import EnvConfig
    from gymfx_tpu_torch.ops import cases, env_dynamics, window_zscore

    def on_card(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    n, w, f = N_ENVS, WINDOW, len(FEATURE_COLUMNS)
    err, k1_cases = 0.0, 0
    # the flagship's shape, the edge shapes, windows 4 bytes off 16-byte
    # alignment (a slice of a larger buffer) and F = 5 rows that do not
    # fill whole row groups: the last three take the env-block path
    for (cn, cw, cf), offset in ([(shape, 0) for shape in cases.K1_EDGE_SHAPES]
                                 + [((n, w, f), 1), ((63, 9, 3), 1), ((63, 30, 5), 0)]):
        win, mean, std, neutral = on_card(*cases.obs_case(SEED, cn, cw, cf))
        if offset:
            buf = torch.empty(win.numel() + 4, device=dev)
            win = buf[offset:offset + win.numel()].view(cn, cw, cf).copy_(win)
            check(win.data_ptr() % 16 == 4 * offset, "K1: the window is not 4 bytes off alignment")
        for mask, clip in [((), 10.0), ((False,) * (cf - 1) + (True,), 1.5), ((), 0.0)]:
            ours = window_zscore.step_obs(win, mean, std, neutral, binary_mask=mask, clip=clip)
            ref = window_zscore.scale_feature_window(win, mean, std, neutral, mask, clip)
            torch.cuda.synchronize()
            check(torch.equal(ours, ref),
                  f"K1 step_obs != plain ({(cn, cw, cf)}, offset {offset}, mask={mask}, clip={clip})")
            err = max(err, max_abs_err(torch, ours, ref))
            k1_cases += 1
    win, mean, std, neutral = on_card(*cases.obs_case(SEED, n, w, f))
    one = [t[:1].contiguous() for t in (win, mean, std, neutral)]
    b_ms, b_by = bound(2 * nbytes(win) + nbytes(mean, std, neutral),
                       OPS_PER_ITEM["step_obs"] * win.numel(), F32_FLOPS)
    kernels["step_obs"] = dict(
        max_abs_err=err, ms=device_ms(torch, lambda: window_zscore.step_obs(win, mean, std, neutral)),
        plain_ms=device_ms(torch, lambda: window_zscore.scale_feature_window(win, mean, std, neutral)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        host_us=host_us(torch, lambda: window_zscore.step_obs(win, mean, std, neutral)),
        ms_one_env=device_ms(torch, lambda: window_zscore.step_obs(*one)),
    )
    # the same window 4 bytes off alignment takes the env-block path
    buf = torch.empty(win.numel() + 4, device=dev)
    off = buf[1:1 + win.numel()].view(n, w, f).copy_(win)
    kernels["step_obs"]["ms_env_blocks"] = device_ms(
        torch, lambda: window_zscore.step_obs(off, mean, std, neutral))

    def ledger(cfg, seed):
        """cases.ledger_case at N_ENVS envs, on the card: (state, bars,
        advance, mark, live)."""
        fields, mark, bars, advance, rng = cases.ledger_case(seed, n)
        st = cases.ledger_state(cfg, {**fields, **mark}, dev)
        o, h, l, c, acc = on_card(*(bars[k] for k in ("o", "h", "l", "c", "accrual")))
        adv, mark_pred, live = on_card(advance, rng.random(n) < 0.7, rng.random(n) < 0.8)
        return st, (o, h, l, c, acc if cfg.financing_enabled else None), adv, mark_pred, live

    errs = {"fill_brackets": 0.0, "mark_reward": 0.0}
    combos = 0
    for flags in cases.FLAG_GRID:
        for reward in cases.REWARDS:
            cfg = cases.flag_config(flags, reward, WINDOW)
            p = cases.env_params({**cases.PARAM_SETS[sorted(cases.PARAM_SETS)[combos % 2]],
                                  **cases.MARK_PARAMS}, dev)
            st, (o, h, l, c, acc), adv, mark, live = ledger(cfg, combos)
            ref = env_dynamics.fill_brackets_plain(st, o, h, l, c, acc, adv, cfg, p)
            # the kernel advances its counter block in place: give it its own
            ours = env_dynamics.fill_brackets(st._replace(exec_diag=st.exec_diag.clone()),
                                              o, h, l, c, acc, adv, cfg, p)
            for field in ref._fields:
                a, b = getattr(ours, field), getattr(ref, field)
                check(torch.equal(a, b), f"K2 fill_brackets != plain: {field} {cfg}")
                errs["fill_brackets"] = max(errs["fill_brackets"], max_abs_err(torch, a, b))
            ours_st, ours_r = env_dynamics.mark_reward(st, c, mark, live, cfg, p)
            ref_st, ref_r = env_dynamics.mark_reward_plain(st, c, mark, live, cfg, p)
            check(torch.equal(ours_r, ref_r), f"K3 mark_reward != plain: reward {cfg}")
            errs["mark_reward"] = max(errs["mark_reward"], max_abs_err(torch, ours_r, ref_r))
            for field in env_dynamics.MARK_OUT_FIELDS:
                a, b = getattr(ours_st, field), getattr(ref_st, field)
                check(torch.equal(a, b), f"K3 mark_reward != plain: {field} {cfg}")
                errs["mark_reward"] = max(errs["mark_reward"], max_abs_err(torch, a, b))
            combos += 1
    # K2 at its edge sizes, at the flagship's flags and with the three
    # flags its kernel specialises on
    k2_edges = 0
    for size in cases.K2_EDGE_SIZES:
        for flags in cases.K2_EDGE_FLAGS:
            cfg = cases.flag_config(flags, cases.REWARDS[0], WINDOW)
            p = cases.env_params(cases.PARAM_SETS["quantized"], dev)
            fields, mark, bars, advance, _ = cases.ledger_case(size, size)
            st = cases.ledger_state(cfg, {**fields, **mark}, dev)
            o, h, l, c, acc = on_card(*(bars[k] for k in ("o", "h", "l", "c", "accrual")))
            acc = acc if cfg.financing_enabled else None
            adv = torch.from_numpy(advance).to(dev)
            ref = env_dynamics.fill_brackets_plain(st, o, h, l, c, acc, adv, cfg, p)
            ours = env_dynamics.fill_brackets(st._replace(exec_diag=st.exec_diag.clone()),
                                              o, h, l, c, acc, adv, cfg, p)
            for field in ref._fields:
                check(torch.equal(getattr(ours, field), getattr(ref, field)),
                      f"K2 fill_brackets != plain at N = {size}: {field} {cfg}")
            k2_edges += 1
    # K3 at its edge sizes, both rewards, mark_pred and live all true, all
    # false and mixed
    k3_edges = 0
    for size in cases.K2_EDGE_SIZES:
        for reward in cases.REWARDS:
            cfg = cases.flag_config(cases.FLAG_GRID[0], reward, WINDOW)
            p = cases.env_params({**cases.PARAM_SETS["plain"], **cases.MARK_PARAMS}, dev)
            fields, mark, bars, _, rng = cases.ledger_case(size + 1, size)
            st = cases.ledger_state(cfg, {**fields, **mark}, dev)
            c = torch.from_numpy(bars["c"]).to(dev)
            for mark_kind, live_kind in cases.K3_FLAG_PATTERNS:
                mark_pred, live = on_card(cases.flag_pattern(mark_kind, size, rng),
                                          cases.flag_pattern(live_kind, size, rng))
                ours_st, ours_r = env_dynamics.mark_reward(st, c, mark_pred, live, cfg, p)
                ref_st, ref_r = env_dynamics.mark_reward_plain(st, c, mark_pred, live, cfg, p)
                check(torch.equal(ours_r, ref_r),
                      f"K3 mark_reward != plain at N = {size}: reward {reward} {mark_kind}/{live_kind}")
                for field in env_dynamics.MARK_OUT_FIELDS:
                    check(torch.equal(getattr(ours_st, field), getattr(ref_st, field)),
                          f"K3 mark_reward != plain at N = {size}: {field} {reward} "
                          f"{mark_kind}/{live_kind}")
                k3_edges += 1
    torch.cuda.synchronize()
    print(f"kernels: K1 equal to plain on {k1_cases} cases (shapes {list(cases.K1_EDGE_SHAPES)}, "
          f"two windows 4 bytes off alignment and (63, 30, 5), 3 mask/clip cases each); K2 and K3 "
          f"equal to plain on "
          f"{combos} flag combinations, K2 also at N = {list(cases.K2_EDGE_SIZES)} ({k2_edges} cases), "
          f"K3 also at N = {list(cases.K2_EDGE_SIZES)} x both rewards x mark/live all, none and "
          f"mixed ({k3_edges} cases)")

    # times at the flagship configuration's flags (no financing: K2 reads
    # neither the close nor the accrual)
    cfg = EnvConfig(window_size=WINDOW)
    p = cases.env_params({**cases.PARAM_SETS["plain"], **cases.MARK_PARAMS}, dev)
    st, (o, h, l, c, _), adv, mark, live = ledger(cfg, combos)
    fill = lambda: env_dynamics.fill_brackets(st, o, h, l, c, None, adv, cfg, p)  # noqa: E731
    fill_plain = lambda: env_dynamics.fill_brackets_plain(st, o, h, l, c, None, adv, cfg, p)  # noqa: E731
    fields2 = [getattr(st, k) for k in env_dynamics.FILL_FLOAT_FIELDS + env_dynamics.FILL_BOOL_FIELDS
               + env_dynamics.FILL_INT_FIELDS]
    # each field read and written, the bar's O/H/L and the advance flag
    # read, and the one counter column read and written in place
    moved2 = 2 * nbytes(*fields2) + nbytes(o, h, l, adv) + 2 * n * st.exec_diag.element_size()
    b_ms, b_by = bound(moved2, OPS_PER_ITEM["fill_brackets"] * n, F32_FLOPS)
    kernels["fill_brackets"] = dict(
        max_abs_err=errs["fill_brackets"], ms=device_ms(torch, fill),
        plain_ms=device_ms(torch, fill_plain), bound_ms=b_ms, bound_by=b_by, library_ms=None,
        host_us=host_us(torch, fill),
    )
    st1, bars1, adv1 = (st._replace(**{k: getattr(st, k)[:1].contiguous()
                                       for k in env_dynamics.FILL_OUT_FIELDS + ("exec_diag",)}),
                        [t[:1].contiguous() for t in (o, h, l, c)], adv[:1].contiguous())
    kernels["fill_brackets"]["ms_one_env"] = device_ms(
        torch, lambda: env_dynamics.fill_brackets(st1, *bars1, None, adv1, cfg, p))
    markf = lambda: env_dynamics.mark_reward(st, c, mark, live, cfg, p)  # noqa: E731
    mark_plain = lambda: env_dynamics.mark_reward_plain(st, c, mark, live, cfg, p)  # noqa: E731
    # eight fields, the close and two flags read; six fields and the reward written
    moved3 = nbytes(*(getattr(st, k) for k in env_dynamics.MARK_FLOAT_FIELDS), c, mark, live) \
        + nbytes(*(getattr(st, k) for k in env_dynamics.MARK_OUT_FIELDS), st.pos)
    b_ms, b_by = bound(moved3, OPS_PER_ITEM["mark_reward"] * n, F32_FLOPS)
    kernels["mark_reward"] = dict(
        max_abs_err=errs["mark_reward"], ms=device_ms(torch, markf),
        plain_ms=device_ms(torch, mark_plain), bound_ms=b_ms, bound_by=b_by, library_ms=None,
        host_us=host_us(torch, markf),
    )
    # the launch floor: an empty kernel at each kernel's grid, timed as
    # the kernels are (a bound under it cannot be reached)
    from gymfx_tpu_torch.ops import _build

    lib = _build.load_library()
    blocks, rows = window_zscore._step_obs_plan(n, w, f, dev, (), 10.0)[:2]
    check(rows is not None, "K1: the flagship's shape does not take the row-group path")
    grids = {
        "step_obs": (rows[2], window_zscore.K1_ROW_THREADS, 0),
        "step_obs_env_blocks": (blocks[2], window_zscore.K1_THREADS, blocks[1] * f * 9),
        "fill_brackets": (-(-n // lib.gymfx_fill_threads()), lib.gymfx_fill_threads(), 0),
        "mark_reward": (-(-n // lib.gymfx_mark_threads()), lib.gymfx_mark_threads(), 0),
    }
    for key, (grid, threads, smem) in grids.items():
        floor_ms = device_ms(torch, lambda: _build.check_launch(
            lib.gymfx_launch_floor(grid, threads, smem, _build.stream_handle(dev)), "launch_floor"))
        if key == "step_obs_env_blocks":
            kernels["step_obs"].update(env_blocks_launch_floor_ms=floor_ms,
                                       env_blocks_grid=[grid, threads, smem])
        else:
            kernels[key].update(launch_floor_ms=floor_ms, grid=[grid, threads, smem])
    # K2's memory skeleton: its loads and stores without its arithmetic
    blocks2, _ = env_dynamics.fill_outputs(n, dev)
    skel_ptrs = env_dynamics.fill_pointers(
        env_dynamics._fill_inputs(st), blocks2, st.exec_diag, adv, [o, h, l],
        env_dynamics._fill_params(p))
    kernels["fill_brackets"]["skeleton_ms"] = device_ms(torch, lambda: _build.check_launch(
        lib.gymfx_fill_skeleton(skel_ptrs, n, st.exec_diag.shape[1], 0,
                                _build.stream_handle(dev)), "fill_skeleton"))
    # K3's memory skeleton: its loads and stores without its arithmetic
    _, rows3 = env_dynamics.mark_outputs(n, dev)
    skel3 = env_dynamics.mark_pointers(env_dynamics._mark_inputs(st), c, mark, live, rows3,
                                       env_dynamics._mark_params(p))
    kernels["mark_reward"]["skeleton_ms"] = device_ms(torch, lambda: _build.check_launch(
        lib.gymfx_mark_skeleton(skel3, n, _build.stream_handle(dev)), "mark_skeleton"))
    # K1's yardstick: a copy of its window (the same bytes, no arithmetic)
    kernels["step_obs"]["copy_ms"] = device_ms(torch, lambda: win.clone())
    # what the wrappers' host time is made of, us a call; K3's outputs in
    # both forms (the wrapper takes the block)
    host_parts = dict(
        require_one_tensor=host_us(torch, lambda: _build.require(win, "win", torch.float32,
                                                                 (n, w, f), win.device)),
        k1_output_alloc=host_us(torch, lambda: torch.empty_like(win)),
        k2_output_blocks_and_views=host_us(torch, lambda: env_dynamics.fill_outputs(n, dev)),
        k3_seven_output_allocs=host_us(torch, lambda: [torch.empty(n, device=dev)
                                                       for _ in env_dynamics.MARK_OUTPUTS]),
        k3_output_block_and_views=host_us(torch, lambda: env_dynamics.mark_outputs(n, dev)),
        ctypes_launch_of_an_empty_kernel=host_us(torch, lambda: lib.gymfx_launch_floor(
            1, 32, 0, _build.stream_handle(dev))),
    )
    kernels["step_obs"]["host_parts_us"] = host_parts
    print("  wrapper host parts: " + ", ".join(f"{k} {v:.2f} us" for k, v in host_parts.items()))
    print(f"  memory skeletons (every load and store, no arithmetic): fill_brackets "
          f"{kernels['fill_brackets']['skeleton_ms'] * 1e3:.2f} us, mark_reward "
          f"{kernels['mark_reward']['skeleton_ms'] * 1e3:.2f} us; step_obs window copy "
          f"(torch clone): {kernels['step_obs']['copy_ms'] * 1e3:.2f} us")
    for key in ("step_obs", "fill_brackets", "mark_reward"):
        k = kernels[key]
        grid, threads, smem = k["grid"]
        print(f"  {key}: {k['ms'] * 1e3:.2f} us/call on the card (plain {k['plain_ms'] * 1e3:.2f} us, "
              f"bound {k['bound_ms'] * 1e3:.2f} us by {k['bound_by']} at {BANDWIDTH / 1e12:.2f} TB/s, "
              f"launch floor {k['launch_floor_ms'] * 1e3:.2f} us at {grid} CTAs x {threads} threads, "
              f"{smem} B shared), wrapper host {k['host_us']:.1f} us/call"
              + (f", {k['ms_one_env'] * 1e3:.2f} us/call at one env" if "ms_one_env" in k else ""))
    k = kernels["step_obs"]
    grid, threads, smem = k["env_blocks_grid"]
    print(f"  step_obs on the env-block path (the window 4 bytes off alignment): "
          f"{k['ms_env_blocks'] * 1e3:.2f} us/call, launch floor "
          f"{k['env_blocks_launch_floor_ms'] * 1e3:.2f} us at {grid} CTAs x {threads} threads, "
          f"{smem} B shared")


def check_kernels_k3_sharpe(torch, dev, kernels) -> None:
    """K3's sharpe path against its plain version (torch.equal) on rings
    that wrap, then timed at the baseline configuration's shape."""
    from gymfx_tpu_torch.ops import _build, cases, env_dynamics

    err, steps_checked, wraps = 0.0, 0, 0
    for window in cases.SHARPE_WINDOWS:
        for size in cases.SHARPE_SIZES:
            for mark_kind, live_kind in cases.K3_FLAG_PATTERNS:
                cfg, p, st, close, rng = cases.sharpe_case(size, window, size + window, dev)
                closes = torch.from_numpy(cases.sharpe_closes(close, window + 3, rng)).to(dev)
                for step in range(window + 3):
                    mark_pred, live = (torch.from_numpy(cases.flag_pattern(kind, size, rng)).to(dev)
                                       for kind in (mark_kind, live_kind))
                    ours_st, ours_r = env_dynamics.mark_reward(st, closes[step], mark_pred, live,
                                                               cfg, p)
                    ref_st, ref_r = env_dynamics.mark_reward_plain(st, closes[step], mark_pred,
                                                                   live, cfg, p)
                    what = f"K3 sharpe != plain at N = {size}, W = {window}, step {step}, " \
                           f"{mark_kind}/{live_kind}"
                    check(torch.equal(ours_r, ref_r), f"{what}: reward")
                    err = max(err, max_abs_err(torch, ours_r, ref_r))
                    for field in env_dynamics.MARK_OUT_FIELDS + (
                            "reward_buffer", "reward_buffer_idx", "reward_buffer_len"):
                        a, b = getattr(ours_st, field), getattr(ref_st, field)
                        check(torch.equal(a, b), f"{what}: {field}")
                        err = max(err, max_abs_err(torch, a, b))
                    wraps += int((live & (st.reward_buffer_idx == window - 1)).sum())
                    st = ours_st
                    steps_checked += 1
    check(wraps > 0, "K3 sharpe: no ring wrapped")
    torch.cuda.synchronize()
    print(f"kernels: K3's sharpe path equal to plain (torch.equal, reward, carries, ring, slot "
          f"and length) over {steps_checked} steps: N = {list(cases.SHARPE_SIZES)} x W = "
          f"{list(cases.SHARPE_WINDOWS)} x mark/live all, none and mixed, W + 3 steps each on "
          f"the kernel's own outputs ({wraps} ring wraps)")

    # times at the baseline configuration's shape: 4,096 envs, W = 64
    n, window = 4096, 64
    cfg, p, st, close, rng = cases.sharpe_case(n, window, 7, dev)
    c = torch.from_numpy(close).to(dev)
    mark_pred = torch.ones(n, dtype=torch.bool, device=dev)
    live = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    sharpe = lambda: env_dynamics.mark_reward(st, c, mark_pred, live, cfg, p)  # noqa: E731
    plain = lambda: env_dynamics.mark_reward_plain(st, c, mark_pred, live, cfg, p)  # noqa: E731
    pnl_cfg = cfg.__class__(window_size=cfg.window_size)
    pnl = lambda: env_dynamics.mark_reward(st, c, mark_pred, live, pnl_cfg, p)  # noqa: E731
    # K3's bytes, then the ring read and written (W floats each), its slot
    # and length read and written, the annualization factor read
    moved = (nbytes(*(getattr(st, k) for k in env_dynamics.MARK_FLOAT_FIELDS), c, mark_pred, live)
             + nbytes(*(getattr(st, k) for k in env_dynamics.MARK_OUT_FIELDS), st.pos)
             + 2 * nbytes(st.reward_buffer, st.reward_buffer_idx, st.reward_buffer_len) + 4)
    ops = (OPS_PER_ITEM["mark_reward"] + SHARPE_OPS_PER_SLOT * window + SHARPE_OPS) * n
    b_ms, b_by = bound(moved, ops, F32_FLOPS)
    lib = _build.load_library()
    kernels["mark_reward_sharpe"] = dict(
        max_abs_err=err, ms=device_ms(torch, sharpe), plain_ms=device_ms(torch, plain),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, host_us=host_us(torch, sharpe),
        pnl_path_ms_same_n=device_ms(torch, pnl), n_envs=n, window=window, bytes=moved,
        launch_floor_ms=device_ms(torch, lambda: _build.check_launch(lib.gymfx_launch_floor(
            -(-n // env_dynamics.MARK_THREADS), env_dynamics.MARK_THREADS, 0,
            _build.stream_handle(dev)), "launch_floor")),
    )
    k = kernels["mark_reward_sharpe"]
    print(f"  mark_reward sharpe path at N = {n}, W = {window}: {k['ms'] * 1e3:.2f} us/call on the "
          f"card (plain {k['plain_ms'] * 1e3:.2f} us, bound {k['bound_ms'] * 1e3:.2f} us by "
          f"{k['bound_by']}: {moved:,} bytes at {BANDWIDTH / 1e12:.2f} TB/s; launch floor "
          f"{k['launch_floor_ms'] * 1e3:.2f} us; K3's pnl path at the same N "
          f"{k['pnl_path_ms_same_n'] * 1e3:.2f} us), wrapper host {k['host_us']:.1f} us/call")


def check_k4_case(torch, fa, cases, q, k, v, g, causal):
    """K4 forward and backward at one case against the plain versions
    and, in bf16 and on the f32 window kernels, against the emulation of
    their arithmetic, with the backward repeated bitwise; prints the
    case's line.  Returns (forward err, backward err)."""
    shape, dtype = tuple(q.shape), q.dtype
    bf16 = dtype == torch.bfloat16
    kernels = "tensor-core" if bf16 else fa.f32_kernels(shape)
    emulated = {"tensor-core": (cases.attention_forward_emulated,
                                cases.attention_backward_emulated, EMULATION_TOL),
                "window": (cases.attention_f32_window_forward_emulated,
                           cases.attention_f32_window_backward_emulated, F32_EMULATION_TOL)}
    out = fa.attention_forward(q, k, v, causal)
    ref = fa.attention_forward_plain(q, k, v, causal)
    torch.cuda.synchronize()
    err, tol = max_abs_err(torch, out, ref), attention_tolerance(torch, ref)
    check(out.dtype == dtype and err <= tol,
          f"K4 forward != plain at {shape} {dtype} causal={causal}: {err} > {tol}")
    del ref
    emu_errs = []
    if kernels in emulated:
        fwd_emu, bwd_emu, emu_tol = emulated[kernels]
        emu = fwd_emu(q, k, v, causal)
        e, t = max_abs_err(torch, out, emu), emu_tol * float(emu.float().abs().max())
        check(e <= t, f"K4 forward != emulation at {shape} {dtype} causal={causal}: {e} > {t}")
        emu_errs.append(e / float(emu.float().abs().max()))
        del emu
    grads = fa.attention_backward(q, k, v, g, causal)
    bwd_errs = []
    for name, ours, plain in zip("qkv", grads, fa.attention_backward_plain(q, k, v, g, causal)):
        e, t = max_abs_err(torch, ours, plain), attention_tolerance(torch, plain)
        check(ours.dtype == dtype and e <= t,
              f"K4 backward d{name} != plain at {shape} {dtype} causal={causal}: {e} > {t}")
        bwd_errs.append(e)
    if kernels in emulated:
        for name, ours, emu in zip("qkv", grads, bwd_emu(q, k, v, g, causal)):
            big = max(float(emu.float().abs().max()), 1e-30)
            e, t = max_abs_err(torch, ours, emu), emu_tol * big
            check(e <= t, f"K4 backward d{name} != emulation at {shape} {dtype} causal={causal}: "
                  f"{e} > {t}")
            emu_errs.append(e / big)
    again = fa.attention_backward(q, k, v, g, causal)
    bits = (lambda x: x.view(torch.int16)) if bf16 else (lambda x: x.view(torch.int32))
    check(all(torch.equal(bits(a), bits(b)) for a, b in zip(grads, again)),
          f"K4 backward is not deterministic at {shape} {dtype} causal={causal}")
    del grads, again
    torch.cuda.synchronize()
    line = (f"  K4 {shape} {str(dtype).split('.')[-1]} causal={causal}, route {fa.ROUTES[dtype]}"
            f"{'' if bf16 else ' ' + kernels}: forward max err {err:.3g} (tol {tol:.3g}), "
            f"backward max err {max(bwd_errs):.3g}; backward bitwise equal over two calls")
    if kernels in emulated:
        line += (f"; vs emulation max err / max|emulation| {max(emu_errs):.3g} (tol "
                 f"{emu_tol:.3g})")
    if bf16:
        smem = ", ".join(f"{k} {v}" for k, v in fa.bf16_kernel_smem(shape[-1]).items())
        line += (f"; head dim {fa.padded_head_dim(shape[-1])}, dynamic shared memory (bytes): "
                 f"{smem}")
    elif kernels == "window":
        smem = ", ".join(f"{k} {v}" for k, v in fa.f32_window_kernel_smem(shape[1], shape[-1]).items())
        line += (f"; head dim {fa.padded_head_dim(shape[-1], fa.F32_WINDOW_DIM)}, dynamic shared "
                 f"memory (bytes) and warps a CTA: {smem}")
    print(line)
    return err, max(bwd_errs)


def check_kernels_k4(torch, dev, kernels, results) -> None:
    import torch.nn.functional as F

    from gymfx_tpu_torch.ops import fused_attention as fa

    print(f"kernels: K4 plain versions with torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    from gymfx_tpu_torch.ops import cases

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"attention_forward": 0.0, "attention_backward": 0.0}
    timed = {}
    for label, (shape, dtype_name, causal) in ATTENTION_CASES.items():
        dtype = getattr(torch, dtype_name)
        q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4))
        err, bwd_err = check_k4_case(torch, fa, cases, q, k, v, g, causal)
        errs["attention_forward"] = max(errs["attention_forward"], err)
        errs["attention_backward"] = max(errs["attention_backward"], bwd_err)
        b, s, h, d = shape
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fwd_ms = device_ms(torch, lambda: fa.attention_forward(q, k, v, causal))
        bwd_ms = device_ms(torch, lambda: fa.attention_backward(q, k, v, g, causal))
        fwd_plain = event_ms(torch, lambda: fa.attention_forward_plain(q, k, v, causal))
        bwd_plain = event_ms(torch, lambda: fa.attention_backward_plain(q, k, v, g, causal))
        fwd_lib = event_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
                           reps=10)
        leaves = [x.detach().clone().requires_grad_(True) for x in (qt, kt, vt)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        gt = g.transpose(1, 2)
        bwd_lib = event_ms(torch, lambda: torch.autograd.grad(lib_out, leaves, gt, retain_graph=True),
                           reps=10)
        # forward: q, k, v read, o written; QK^T and PV, 2 x 2 D FLOP per
        # (query, key) pair.  backward: q, k, v, dO read, dq, dk, dv
        # written; S recomputed, dV, dP, dQ, dK: 5 x 2 D FLOP per pair
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        fb, fby = bound(4 * nbytes(q), 4 * d * pairs, peak)
        bb, bby = bound(7 * nbytes(q), 10 * d * pairs, peak)
        timed[label] = {
            "shape": list(shape), "dtype": dtype_name, "causal": causal,
            "forward": dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_lib, bound_ms=fb, bound_by=fby),
            "backward": dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_lib, bound_ms=bb, bound_by=bby),
        }
        for key in ("forward", "backward"):
            row = timed[label][key]
            print(f"  K4 {key} at {shape} {dtype_name}: {row['ms']:.4f} ms on the card "
                  f"(plain {row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, "
                  f"bound {row['bound_ms']:.4f} ms by {row['bound_by']})")
        del q, k, v, g, qt, kt, vt, leaves, lib_out, gt
        torch.cuda.empty_cache()
    # every bf16 case of the card tests (each head dim the library
    # instantiates, ragged and multi-tile windows), checked, not timed
    for shape, causal in cases.ATTENTION_BF16_CASES:
        q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(4))
        err, bwd_err = check_k4_case(torch, fa, cases, q, k, v, g, causal)
        errs["attention_forward"] = max(errs["attention_forward"], err)
        errs["attention_backward"] = max(errs["attention_backward"], bwd_err)
    # every f32 case of the window kernels (the ring twin's shapes, ragged
    # windows, every instantiated head dim), checked, not timed
    for shape, causal in cases.ATTENTION_F32_WINDOW_CASES:
        q, k, v, g = (torch.randn(shape, generator=gen, device=dev) for _ in range(4))
        err, bwd_err = check_k4_case(torch, fa, cases, q, k, v, g, causal)
        errs["attention_forward"] = max(errs["attention_forward"], err)
        errs["attention_backward"] = max(errs["attention_backward"], bwd_err)
    # a padded head dim on (B, S, H, D) views of (B, H, D, S) storage,
    # whose d stride is S: the wrapper's padding must come out contiguous
    q, k, v, g = (torch.randn((3, 2, 24, 70), generator=gen, device=dev).to(torch.bfloat16)
                  .permute(0, 3, 1, 2) for _ in range(4))
    err, bwd_err = check_k4_case(torch, fa, cases, q, k, v, g, True)
    errs["attention_forward"] = max(errs["attention_forward"], err)
    errs["attention_backward"] = max(errs["attention_backward"], bwd_err)
    for key in ("forward", "backward"):
        row = timed["update"][key]
        kernels[f"attention_{key}"] = dict(max_abs_err=errs[f"attention_{key}"], ms=row["ms"],
                                           plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                                           bound_by=row["bound_by"], library_ms=row["library_ms"])
    results["attention"] = timed


def ptxas_report(compiler_out: str, key_of) -> dict:
    """ptxas' report (-Xptxas -v) of each kernel that ``key_of`` names
    (mangled name -> key or None): its registers and stack-frame line
    (which counts the spills)."""
    import re

    found, key = {}, None
    for line in compiler_out.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?( |$)", line)
        if m:
            key = key_of(m.group(1))
            continue
        if key is None:
            continue
        if "stack frame" in line:
            found.setdefault(key, {})["frame"] = line.strip()
        elif "registers" in line:
            found.setdefault(key, {})["registers"] = int(re.search(r"Used (\d+) registers",
                                                                   line).group(1))
    return found


def k5_ptxas(compiler_out: str) -> dict:
    """Each K5 template, keyed "<levels a lane, slots>"."""
    import re

    def key_of(name):
        t = re.search(r"lob_stream_kernelILi(\d+)ELi(\d+)EE", name)
        return f"<{t.group(1)}, {t.group(2)}>" if t else None

    return ptxas_report(compiler_out, key_of)


def k8_ptxas(compiler_out: str) -> dict:
    """Each K8 template, keyed "<levels a lane, slots>"."""
    import re

    def key_of(name):
        t = re.search(r"lob_bar_kernelILi(\d+)ELi(\d+)EE", name)
        return f"<{t.group(1)}, {t.group(2)}>" if t else None

    return ptxas_report(compiler_out, key_of)


def flow_ptxas(compiler_out: str) -> dict:
    """K9's one kernel, keyed "bar_flow"."""
    return ptxas_report(compiler_out,
                        lambda name: "bar_flow" if "bar_flow_kernel" in name else None)


def attention_ptxas(compiler_out: str) -> dict:
    """K4's f32 window kernels, keyed "attn_fwd_window<SP, DP>" (window
    and head dim padded)."""
    import re

    def key_of(name):
        t = re.search(r"(attn_(?:fwd|bwd)_window)ILi(\d+)ELi(\d+)EE", name)
        return f"{t.group(1)}<{t.group(2)}, {t.group(3)}>" if t else None

    return ptxas_report(compiler_out, key_of)


def env_ptxas(compiler_out: str) -> dict:
    """Each kernel of the env library: K1's two paths, K2's
    instantiations keyed "<slip_match, financing, ohlc>", K3, the empty
    launch-floor kernel and K2's and K3's memory skeletons."""
    import re

    def key_of(name):
        t = re.search(r"fill_brackets_kernelILb(\d)ELb(\d)ELb(\d)E", name)
        if t:
            return f"fill_brackets<{t.group(1)}, {t.group(2)}, {t.group(3)}>"
        return next((k for k in ("step_obs_rows", "step_obs", "mark_reward", "launch_floor",
                                 "fill_skeleton", "mark_skeleton") if f"{k}_kernel" in name), None)

    return ptxas_report(compiler_out, key_of)


def data_ptxas(compiler_out: str) -> dict:
    """Each kernel of the data library: K6, and K7 keyed by its template
    ("scaled_windows<5>", the export's F; "scaled_windows<0>", any F)."""
    import re

    def key_of(name):
        t = re.search(r"scaled_windows_kernelILi(\d+)EE", name)
        if t:
            return f"scaled_windows<{t.group(1)}>"
        return "q16_decode" if "q16_decode_kernel" in name else None

    return ptxas_report(compiler_out, key_of)


def check_kernels_k5(torch, dev, kernels, results, ptxas) -> None:
    from gymfx_tpu_torch.lob.book import MSG_NOOP, Messages, empty_book
    from gymfx_tpu_torch.ops import cases, lob_match

    err = 0.0

    def equal(msgs, depth, slots, label):
        nonlocal err
        book = empty_book(msgs.kind.shape[0], depth, slots, dev)
        ours = lob_match.process_stream(book, msgs)
        ref = lob_match.process_stream_plain(book, msgs)
        torch.cuda.synchronize()
        for name, a, b in zip((*ours[0]._fields, *ours[1]._fields), (*ours[0], *ours[1]),
                              (*ref[0], *ref[1])):
            err = max(err, max_abs_err(torch, a, b))
            check(torch.equal(a, b), f"K5 process_stream != plain: {label} {name}")
        return ours

    def timed(msgs, depth, slots, plain=True):
        """Device ms (graph replays), plain ms (CUDA events; only where
        ``plain``), bound and the fill events of one call on fresh books."""
        b, m = msgs.kind.shape
        book = empty_book(b, depth, slots, dev)
        out = lob_match.process_stream(book, msgs)
        events = int(out[1].fill_events.sum())
        # each book and stream read once, the books and fill records
        # written once; K5_OPS_PER_SLOT per slot of the touched half for
        # every message that is not a NOOP (the kinds clip to 0-3)
        moved = 2 * nbytes(*book) + nbytes(*msgs) + nbytes(*out[1])
        active = int((torch.clamp(msgs.kind, 0, 3) != MSG_NOOP).sum())
        b_ms, b_by = bound(moved, K5_OPS_PER_SLOT * depth * slots * active, INT32_OPS)
        return dict(
            ms=device_ms(torch, lambda: lob_match.process_stream(book, msgs)),
            plain_ms=event_ms(torch, lambda: lob_match.process_stream_plain(book, msgs),
                              reps=1, trials=3) if plain else None,
            bound_ms=b_ms, bound_by=b_by, library_ms=None, fill_events=events,
            books=b, messages=m, depth=depth, slots=slots,
        )

    seed = cases.lob_seed_streams(N_ENVS, seed=SEED, device=dev)
    equal(seed, 24, LOB_SLOTS, "seed streams")
    n_cases = 1
    for scenario in cases.LOB_SCENARIOS:
        msgs = cases.lob_flow_streams(scenario, LOB_BOOKS, LOB_MSGS, device=dev)
        for depth in LOB_DEPTHS:
            equal(msgs, depth, LOB_SLOTS, f"{scenario} depth {depth}")
            n_cases += 1
    for name in sorted(cases.LOB_STREAMS):
        msgs, depth, slots = cases.lob_stream(name, device=dev)
        ours = equal(msgs, depth, slots, name)
        n_cases += 1
        if name == "agent_maker":
            check(int(ours[1].agent_qty.sum()) == 4, "K5 agent maker fills")
    # lots near 2^31 (level sums and the walk wrap), then one book per
    # (levels a lane, slots) instantiation of the kernel
    for depth, slots in ((4, 3), (2, 2), (33, 1), (40, 8)):
        equal(cases.lob_wrap_streams(64, 80, seed=depth, device=dev), depth, slots,
              f"int32 wrap depth {depth} slots {slots}")
        n_cases += 1
    volatile = cases.lob_flow_streams("lob_volatile", 5, 70, device=dev)
    for per_lane, slots in K5_INSTANCES:
        equal(volatile, 29 if per_lane == 1 else 61, slots, f"<{per_lane}, {slots}> instance")
        n_cases += 1
    # one message kind at a time, after the ADDs that build the books
    start, kinds = cases.lob_kind_streams(LOB_BOOKS, LOB_MSGS, seed=SEED, device=dev)
    for kind, msgs in kinds.items():
        equal(Messages(*(torch.cat(pair, dim=1) for pair in zip(start, msgs))), 24, LOB_SLOTS,
              f"{kind} stream")
        n_cases += 1
    print(f"kernels: K5 equal to plain (torch.equal, books and fill records) on {n_cases} cases, "
          f"max abs err {err:g}")

    venue = timed(seed, 24, LOB_SLOTS)
    sweep = {}
    calm = cases.lob_flow_streams("lob_calm", LOB_BOOKS, LOB_MSGS, device=dev)
    for depth in LOB_DEPTHS:
        row = timed(calm, depth, LOB_SLOTS, plain=depth == 24)
        row["fills_per_s"] = row["fill_events"] / (row["ms"] / 1e3)
        row["msgs_per_s"] = LOB_BOOKS * LOB_MSGS / (row["ms"] / 1e3)
        row["us_per_msg"] = row["ms"] * 1e3 / LOB_MSGS
        sweep[depth] = row
        plain = "" if row["plain_ms"] is None else f"plain {row['plain_ms'] * 1e3:.0f} us, "
        print(f"  K5 {LOB_BOOKS} books x {LOB_MSGS} msgs, depth {depth}: {row['ms'] * 1e3:.1f} us/call, "
              f"{row['us_per_msg']:.3f} us/msg on the card ({plain}bound {row['bound_ms'] * 1e3:.2f} us "
              f"by {row['bound_by']}), {row['fills_per_s']:,.0f} fills/s, {row['msgs_per_s']:,.0f} msgs/s")
    # where a message's time goes: each kind alone from the same books
    built_books = lob_match.process_stream(empty_book(LOB_BOOKS, 24, LOB_SLOTS, dev), start)[0]
    by_kind = {kind: device_ms(torch, lambda: lob_match.process_stream(built_books, msgs)) * 1e3
               / LOB_MSGS for kind, msgs in kinds.items()}
    print(f"  K5 {LOB_BOOKS} books x {LOB_MSGS} msgs of one kind, depth 24, from 12 levels a side: "
          + ", ".join(f"{kind} {us:.3f}" for kind, us in by_kind.items()) + " us/msg")
    venue["us_per_msg"] = venue["ms"] * 1e3 / seed.kind.shape[1]
    print(f"  K5 venue seed streams ({N_ENVS} books x 16 msgs, depth 24): {venue['ms'] * 1e3:.2f} us/call, "
          f"{venue['us_per_msg']:.3f} us/msg (plain {venue['plain_ms'] * 1e3:.0f} us, bound "
          f"{venue['bound_ms'] * 1e3:.2f} us by {venue['bound_by']}), wrapper host "
          f"{host_us(torch, lambda: lob_match.process_stream(empty_book(N_ENVS, 24, LOB_SLOTS, dev), seed)):.1f} us/call")
    print(f"  K5 with process returning its record: {venue['ms'] * 1e3:.2f} us at the venue's "
          f"shape, {sweep[24]['ms'] * 1e3:.1f} us at bench.py --lob's")
    report = k5_ptxas(ptxas)
    check(sorted(report) == sorted(f"<{a}, {b}>" for a, b in K5_INSTANCES),
          f"K5 ptxas report lists {sorted(report)}, not every template")
    for key, line in report.items():
        print(f"  K5 ptxas {key}: {line.get('registers')} registers, {line.get('frame')}")
    kernels["process_stream"] = dict(max_abs_err=err, **{k: venue[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    results["k5"] = {"venue_seed": venue, "bench_lob_sweep": sweep, "us_per_msg_by_kind": by_kind,
                     "ptxas": report}


def check_kernels_k8(torch, dev, kernels, results, ptxas) -> None:
    """K8 against its plain version (torch.equal, final books and results)
    at the venue's shape, at every template and where lot sums wrap int32;
    timed at the venue's shape."""
    from gymfx_tpu_torch.lob.book import MSG_NOOP, BookState
    from gymfx_tpu_torch.ops import _build, cases, lob_bar
    from gymfx_tpu_torch.ops.lob_bar import BarFills

    err = 0.0

    def on_card(case):
        return tuple(type(x)(*(t.to(dev) for t in x)) for x in case[:3])

    def equal(args, label):
        nonlocal err
        ours = lob_bar.run_bar(*args)
        ref = lob_bar.run_bar_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip((*BookState._fields, *BarFills._fields), (*ours[0], *ours[1]),
                              (*ref[0], *ref[1])):
            err = max(err, max_abs_err(torch, a, b))
            check(torch.equal(a, b), f"K8 run_bar != plain: {label} {name}")
        return ours

    case = cases.lob_bar_case(N_ENVS, depth=24, slots=LOB_SLOTS, n_msgs=K8_MSGS, seed=SEED,
                              scenario=K8_SCENARIO)
    book, flow, orders = args = on_card(case)
    paths = case[3]
    _, fills = equal(args, "the venue's shape")
    f = {k: v.cpu().numpy() for k, v in fills._asdict().items()}
    occurred = {path: {"books": int((paths == path).sum()),
                       "tp": int((f["tp_lots"][paths == path] > 0).sum()),
                       "fired": int(f["fired"][paths == path].sum())}
                for path in cases.LOB_BAR_PATHS}
    # each path did what it was built for (as tests/test_torch_lob_bar.py
    # holds it on the CPU)
    held = cases.lob_bar_paths(book, flow, orders, fills, paths)
    check(sorted(held) == sorted(cases.LOB_BAR_PATHS) and all(held.values()),
          f"K8 paths at the venue's shape {held}: {occurred}")
    n_cases = 1
    for per_lane, slots in K5_INSTANCES:
        equal(on_card(cases.lob_bar_case(44, depth=29 if per_lane == 1 else 61, slots=slots,
                                         n_msgs=70, seed=slots)), f"<{per_lane}, {slots}> instance")
        n_cases += 1
    for depth, slots in ((4, 3), (2, 2), (6, 2), (33, 1), (40, 8)):
        equal(on_card(cases.lob_bar_wrap_case(64, 40, depth, slots, seed=depth)),
              f"int32 wrap depth {depth} slots {slots}")
        n_cases += 1
    print(f"kernels: K8 equal to plain (torch.equal, final books and results) on {n_cases} cases "
          f"(the venue's shape, every template, int32 wrap), max abs err {err:g}; paths at the "
          f"venue's shape {occurred}")

    # the bound: every input read once and every output written once; one
    # int32 operation for each flow message that is not a NOOP, each agent
    # walk, rest and cancel that this run's orders make (the stop's cancel
    # and walk where it fired on a print) and each book slot whose lots or
    # owner the bar changed: what the function must do, not this design's
    # cost (a resting ADD or a cancel by oid touches one slot)
    out = lob_bar.run_bar(*args)
    moved = 2 * nbytes(*book) + nbytes(*flow) + nbytes(*orders) + nbytes(*out[1])
    gap = fills.gap_lots > 0
    tp_rest = (orders.take_profit > 0) & (orders.pos_lots > 0) & ~gap
    agent_ops = int((orders.open_lots > 0).sum() + gap.sum() + tp_rest.sum()
                    + 2 * ((fills.fired != 0) & ~gap).sum())
    active = int((torch.clamp(flow.kind, 0, 3) != MSG_NOOP).sum())
    changed = sum(int((a != b).sum()) for a, b in zip(
        (book.bid_qty, book.bid_oid, book.ask_qty, book.ask_oid),
        (out[0].bid_qty, out[0].bid_oid, out[0].ask_qty, out[0].ask_oid)))
    b_ms, b_by = bound(moved, active + agent_ops + changed, INT32_OPS)
    env_lib = _build.load_library("env")
    grid, threads, smem = -(-N_ENVS // 4), 128, 4 * 32 * 16
    floor_ms = device_ms(torch, lambda: _build.check_launch(env_lib.gymfx_launch_floor(
        grid, threads, smem, _build.stream_handle(dev)), "launch_floor"))
    ms = device_ms(torch, lambda: lob_bar.run_bar(*args))
    plain_ms = event_ms(torch, lambda: lob_bar.run_bar_plain(*args), reps=1, trials=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        lob_bar.run_bar(*args)
    host = (time.perf_counter() - t0) / 50 * 1e6  # enqueued, not waited for
    torch.cuda.synchronize()
    report = k8_ptxas(ptxas)
    check(sorted(report) == sorted(f"<{a}, {b}>" for a, b in K5_INSTANCES),
          f"K8 ptxas report lists {sorted(report)}, not every template")
    print(f"  K8 {N_ENVS} books x {K8_MSGS} {K8_SCENARIO} msgs, 24 x {LOB_SLOTS}: "
          f"{ms * 1e3:.2f} us on the card (bound {b_ms * 1e3:.2f} us by {b_by}: {moved / 1e6:.1f} MB, "
          f"{active} flow messages, {agent_ops} agent operations, {changed} slots changed; launch floor "
          f"{floor_ms * 1e3:.2f} us at {grid} CTAs x {threads} threads, {smem} B shared), plain "
          f"{plain_ms * 1e3:.0f} us, wrapper host {host:.1f} us/call (50 calls enqueued)")
    for key, line in report.items():
        print(f"  K8 ptxas {key}: {line.get('registers')} registers, {line.get('frame')}")
    kernels["lob_bar"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=None, launch_floor_ms=floor_ms,
                              wrapper_host_us=host)
    results["k8"] = {"venue": {"books": N_ENVS, "messages": K8_MSGS, "depth": 24,
                               "slots": LOB_SLOTS, "moved_bytes": moved, "active_messages": active,
                               "agent_operations": agent_ops, "slots_changed": changed,
                               "paths": occurred},
                     "ptxas": report, **kernels["lob_bar"]}


def k9_work(torch, out, fp):
    """(threefry blocks, int32 operations) that K9's function needs for
    the messages ``out``: an env's keys (fold_in, the split keys and
    randint's halves of the keys its messages draw from), each message's
    kind and price jitter, its side and qty outside a crash window (which
    forces them), an ADD's band and a cancel's target.  A message was a
    cancel before any crash window iff its oid is not 1 + its index."""
    n, m = out.kind.shape
    idx = torch.arange(m, device=out.kind.device)
    crash = (idx >= fp.crash_at) & (idx < fp.crash_at + fp.crash_len) & (fp.crash_at >= 0)
    free = ~crash.expand(n, m)  # side and qty drawn
    add, cxl = out.kind == 1, out.oid != 1 + idx
    per_env = (2 + 3 + 4 * free.any(1).long() + 3 * add.any(1).long() + cxl.any(1).long())
    counts = {k: int(v.sum()) for k, v in
              dict(msgs=torch.ones_like(add), free=free, add=add, cxl=cxl).items()}
    msg_blocks = 3 * counts["msgs"] + 3 * counts["free"] + 2 * counts["add"] + counts["cxl"]
    blocks = int(per_env.sum()) + msg_blocks
    uniforms = counts["msgs"] + counts["free"] + counts["cxl"]
    randints = counts["msgs"] + counts["free"] + counts["add"]
    ops = (blocks * THREEFRY_OPS + msg_blocks + uniforms * K9_UNIFORM_OPS
           + randints * K9_RANDINT_OPS + counts["msgs"] * K9_MSG_OPS)
    return blocks, ops


def check_kernels_k9(torch, dev, kernels, results, ptxas) -> None:
    """K9 against its plain version (torch.equal, the five streams) for
    every scenario at the venue's shape and at odd shapes; timed at the
    venue's shape beside its bound, launch floor, plain version and host
    enqueue."""
    from gymfx_tpu_torch.lob.scenarios import scenario_flow_params
    from gymfx_tpu_torch.ops import _build, cases, lob_flow

    err, n_cases = 0.0, 0

    def equal(n, n_msgs, scenario, rows, seed):
        nonlocal err, n_cases
        bars = cases.lob_flow_bars(n, rows, seed=seed, device=dev)
        fp = scenario_flow_params(scenario)
        ours = lob_flow.bar_flow(SEED, *bars, n_msgs, fp)
        ref = lob_flow.bar_flow_plain(SEED, *bars, n_msgs, fp)
        torch.cuda.synchronize()
        for name, a, b in zip(ref._fields, ours, ref):
            err = max(err, max_abs_err(torch, a, b))
            check(torch.equal(a, b), f"K9 bar_flow != plain: {scenario} {n} x {n_msgs} {rows} {name}")
        n_cases += 1
        return bars, fp

    for scenario in cases.LOB_SCENARIOS:
        for rows in ("int32", "int64"):
            equal(N_ENVS, K8_MSGS, scenario, rows, seed=1)
        for n, n_msgs, rows in K9_ODD:
            equal(n, n_msgs, scenario, rows, seed=n)
    print(f"kernels: K9 equal to plain (torch.equal, the five streams) on {n_cases} cases (every "
          f"scenario at {N_ENVS} envs x {K8_MSGS} messages, int32 and int64 bar rows, and at "
          f"{', '.join(f'{n} x {m}' for n, m, _ in K9_ODD)}), max abs err {err:g}")

    bars, fp = equal(N_ENVS, K8_MSGS, K8_SCENARIO, "int32", seed=0)
    # the bound: the bar rows and ticks read once, the five streams written
    # once; the threefry blocks and operations that this run's messages
    # need (k9_work)
    out = lob_flow.bar_flow(SEED, *bars, K8_MSGS, fp)
    moved = nbytes(*bars) + nbytes(*out)
    blocks, ops = k9_work(torch, out, fp)
    b_ms, b_by = bound(moved, ops, INT32_OPS)
    env_lib = _build.load_library("env")
    grid, threads = -(-N_ENVS // 4), 128
    floor_ms = device_ms(torch, lambda: _build.check_launch(env_lib.gymfx_launch_floor(
        grid, threads, 0, _build.stream_handle(dev)), "launch_floor"))
    ms = device_ms(torch, lambda: lob_flow.bar_flow(SEED, *bars, K8_MSGS, fp))
    plain_ms = device_ms(torch, lambda: lob_flow.bar_flow_plain(SEED, *bars, K8_MSGS, fp),
                         reps=2, trials=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        lob_flow.bar_flow(SEED, *bars, K8_MSGS, fp)
    host = (time.perf_counter() - t0) / 50 * 1e6  # enqueued, not waited for
    torch.cuda.synchronize()
    report = flow_ptxas(ptxas)
    check(sorted(report) == ["bar_flow"], f"K9 ptxas report lists {sorted(report)}")
    print(f"  K9 {N_ENVS} envs x {K8_MSGS} {K8_SCENARIO} msgs: {ms * 1e3:.2f} us on the card "
          f"(bound {b_ms * 1e3:.2f} us by {b_by}: {blocks:,} threefry blocks, {ops / 1e6:.1f}M "
          f"int32 operations, {moved / 1e6:.2f} MB; launch floor {floor_ms * 1e3:.2f} us at {grid} "
          f"CTAs x {threads} threads), plain {plain_ms * 1e3:.1f} us (graph replays), wrapper host "
          f"{host:.1f} us/call (50 calls enqueued); ptxas {report['bar_flow'].get('registers')} "
          f"registers, {report['bar_flow'].get('frame')}")
    kernels["bar_flow"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None, launch_floor_ms=floor_ms,
                               wrapper_host_us=host)
    results["k9"] = {"venue": {"envs": N_ENVS, "messages": K8_MSGS, "scenario": K8_SCENARIO,
                               "threefry_blocks": blocks, "operations": ops,
                               "moved_bytes": moved, "cases": n_cases},
                     "ptxas": report, **kernels["bar_flow"]}


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi clocks.max.sm failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def check_kernels_k10(torch, dev, kernels, results, ptxas) -> None:
    """K10 against its plain version (torch.equal on the eight outputs) for
    every preset at bench.py --scengen's shape and at the edge shapes;
    timed beside its bytes bound, its serial floor, its launch floor and
    its plain version, with generate's ms and bars/s (bench.py:165-172:
    bars x assets over a generation's wall time)."""
    import numpy as np

    from gymfx_tpu_torch.lob import prng
    from gymfx_tpu_torch.ops import _build
    from gymfx_tpu_torch.ops import scengen_scan as k10
    from gymfx_tpu_torch.scengen import engine, feed
    from gymfx_tpu_torch.scengen.params import preset_names, scenario_params

    key = prng.PRNGKey(0, dev)
    shocks = {}

    def inputs(preset, n, a):
        _, monday = feed.fx_timestamp_grid(n, 1 / 60)
        if (n, a) not in shocks:
            shocks[n, a] = engine.draw_shocks(key, n, a)
        return engine.scan_inputs(shocks[n, a], scenario_params(preset), monday), monday

    err, plain_s, n_cases, kinds = 0.0, {}, 0, {}
    for preset in preset_names():
        for n, a in ((SCENGEN_BARS, SCENGEN_ASSETS),) + K10_EDGES:
            args, monday = inputs(preset, n, a)
            ours = k10.scengen_scan(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = k10.paths_plain(*args)
            torch.cuda.synchronize()
            if (n, a) == (SCENGEN_BARS, SCENGEN_ASSETS):
                plain_s[preset] = time.perf_counter() - t0
                kinds[preset] = torch.bincount((ref[6] >> 1) & 3, minlength=4).tolist()
            for name, x, y in zip(engine.ScenPaths._fields, ours, ref):
                err = max(err, max_abs_err(torch, x, y))
                check(torch.equal(x, y), f"K10 scengen_scan != plain: {preset} {n} x {a} {name}")
            for name in ("open", "high", "low", "close"):
                check(bool(torch.isfinite(getattr(engine.ScenPaths(*ours), name)).all()),
                      f"K10 non-finite {name}: {preset} {n} x {a}")
            n_cases += 1
    print(f"kernels: K10 equal to plain (torch.equal, the eight outputs) on {n_cases} cases (every "
          f"preset at {SCENGEN_BARS:,} x {SCENGEN_ASSETS} and at "
          f"{', '.join(f'{n} x {a}' for n, a in K10_EDGES)}, fx_timestamp_grid's Monday mask), "
          f"max abs err {err:g}; bars of each flag kind (none, drought, crash, both) at "
          f"{SCENGEN_BARS:,}: {kinds}")

    preset = "regime_mix"
    args, monday = inputs(preset, SCENGEN_BARS, SCENGEN_ASSETS)
    out = k10.scengen_scan(*args)
    moved = nbytes(*args[:10]) + nbytes(*out)
    ops = SCENGEN_BARS * (K10_BAR_OPS + SCENGEN_ASSETS * K10_ASSET_OPS)
    b_ms, b_by = bound(moved, ops, F32_FLOPS)
    clock = sm_clock_hz()
    serial_ms = SCENGEN_BARS * K10_CHAIN_CYCLES / clock * 1e3
    env_lib = _build.load_library("env")
    floor_ms = device_ms(torch, lambda: _build.check_launch(env_lib.gymfx_launch_floor(
        1, 32, 0, _build.stream_handle(dev)), "launch_floor"))
    ms = device_ms(torch, lambda: k10.scengen_scan(*args), reps=3, trials=7)
    plain_ms = statistics.median(plain_s.values()) * 1e3
    p = scenario_params(preset)
    engine.generate(p, key, SCENGEN_BARS, SCENGEN_ASSETS, monday)
    torch.cuda.synchronize()
    gen = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.generate(p, key, SCENGEN_BARS, SCENGEN_ASSETS, monday)
        torch.cuda.synchronize()
        gen.append(time.perf_counter() - t0)
    gen_ms = statistics.median(gen) * 1e3
    bars_per_s = SCENGEN_BARS * SCENGEN_ASSETS / gen_ms * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        k10.scengen_scan(*args)
    host = (time.perf_counter() - t0) / 20 * 1e6  # enqueued, not waited for
    torch.cuda.synchronize()
    report = ptxas_report(ptxas, lambda name: "scengen_scan" if "scengen_scan" in name else None)
    check(sorted(report) == ["scengen_scan"], f"K10 ptxas report lists {sorted(report)}")
    print(f"  K10 {SCENGEN_BARS:,} bars x {SCENGEN_ASSETS} assets ({preset}): {ms * 1e3:.1f} us on "
          f"the card (bytes bound {b_ms * 1e3:.2f} us by {b_by}: {moved / 1e6:.2f} MB, "
          f"{ops / 1e6:.1f}M f32 operations; serial floor {serial_ms * 1e3:.1f} us: "
          f"{K10_CHAIN_CYCLES} cycles a bar at {clock / 1e9:.3f} GHz; launch floor "
          f"{floor_ms * 1e3:.2f} us), plain {plain_ms:.1f} ms (host wall, median over the presets); "
          f"generate {gen_ms:.3f} ms, {bars_per_s:,.0f} bars/s (bench.py's bars x assets); tile "
          f"{k10.tile_bars(SCENGEN_ASSETS)} bars; wrapper host {host:.1f} us/call (20 calls "
          f"enqueued); ptxas {report['scengen_scan'].get('registers')} registers, "
          f"{report['scengen_scan'].get('frame')}")
    kernels["scengen_scan"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None, serial_floor_ms=serial_ms,
                                   launch_floor_ms=floor_ms, generate_ms=gen_ms,
                                   bars_per_s=bars_per_s, wrapper_host_us=host)
    results["k10"] = {"bars": SCENGEN_BARS, "assets": SCENGEN_ASSETS, "cases": n_cases,
                      "flag_kinds": kinds, "plain_s": plain_s, "moved_bytes": moved,
                      "sm_clock_hz": clock, "ptxas": report, **kernels["scengen_scan"]}


def check_kernels_k9_flags(torch, dev, kernels, results) -> None:
    """K9's flag route against its plain version (torch.equal, the five
    streams) at the venue's shape for every scenario, each env's bar flags
    drawn over all five FLAG bits; timed beside its bound (k9_work over
    each kind's envs with that kind's set), its plain version and K9's
    replay route on the same bars."""
    from gymfx_tpu_torch.lob.book import Messages
    from gymfx_tpu_torch.lob.scenarios import regime_flow_sets, regime_kind, scenario_flow_params
    from gymfx_tpu_torch.ops import cases, lob_flow

    gen = torch.Generator(device=dev).manual_seed(SEED)
    flags = torch.randint(0, 32, (N_ENVS,), generator=gen, device=dev, dtype=torch.int32)
    kind = regime_kind(flags)
    counts = torch.bincount(kind, minlength=4).tolist()
    check(all(c > 0 for c in counts), f"K9 flag case lacks a kind: {counts}")
    err = 0.0
    for scenario in cases.LOB_SCENARIOS:
        bars = cases.lob_flow_bars(N_ENVS, "int32", seed=2, device=dev)
        fp = scenario_flow_params(scenario)
        ours = lob_flow.bar_flow(SEED, *bars, K8_MSGS, fp, flags)
        ref = lob_flow.bar_flow_plain(SEED, *bars, K8_MSGS, fp, flags)
        torch.cuda.synchronize()
        for name, a, b in zip(ref._fields, ours, ref):
            err = max(err, max_abs_err(torch, a, b))
            check(torch.equal(a, b), f"K9 flag route != plain: {scenario} {name}")
    fp = scenario_flow_params(K8_SCENARIO)
    bars = cases.lob_flow_bars(N_ENVS, "int32", seed=0, device=dev)
    out = lob_flow.bar_flow(SEED, *bars, K8_MSGS, fp, flags)
    moved = nbytes(*bars) + nbytes(flags) + nbytes(*out)
    blocks = ops = 0
    for k, fp_k in enumerate(regime_flow_sets(fp, K8_MSGS)):
        rows = kind == k
        b_k, o_k = k9_work(torch, Messages(*(x[rows] for x in out)), fp_k)
        blocks, ops = blocks + b_k, ops + o_k
    b_ms, b_by = bound(moved, ops, INT32_OPS)
    ms = device_ms(torch, lambda: lob_flow.bar_flow(SEED, *bars, K8_MSGS, fp, flags))
    replay_ms = device_ms(torch, lambda: lob_flow.bar_flow(SEED, *bars, K8_MSGS, fp))
    plain_ms = device_ms(torch, lambda: lob_flow.bar_flow_plain(SEED, *bars, K8_MSGS, fp, flags),
                         reps=2, trials=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        lob_flow.bar_flow(SEED, *bars, K8_MSGS, fp, flags)
    host = (time.perf_counter() - t0) / 50 * 1e6  # enqueued, not waited for
    torch.cuda.synchronize()
    print(f"kernels: K9's flag route equal to plain (torch.equal, the five streams) for every "
          f"scenario at {N_ENVS} envs x {K8_MSGS} messages, envs of each kind (none, drought, "
          f"crash, both) {counts}; {ms * 1e3:.2f} us on the card against the replay route's "
          f"{replay_ms * 1e3:.2f} us on the same bars (bound {b_ms * 1e3:.2f} us by {b_by}: "
          f"{blocks:,} threefry blocks, {ops / 1e6:.1f}M int32 operations), plain "
          f"{plain_ms * 1e3:.1f} us (its four sets' streams drawn), wrapper host {host:.1f} "
          f"us/call (50 calls enqueued)")
    kernels["bar_flow_flags"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=None, replay_route_ms=replay_ms,
                                     wrapper_host_us=host)
    results["k9_flags"] = {"envs_by_kind": counts, "threefry_blocks": blocks, "operations": ops,
                           "moved_bytes": moved, **kernels["bar_flow_flags"]}


def scengen_phase(torch, dev, kernels, results, ptxas) -> None:
    """The scenario generator on the card (slice 18): K10 and K9's flag
    route against their plain versions; flagship-scengen-train (PPO at
    flagship width on a generated tape: K10 once, K1-K3 by name, graphed ==
    eager), its streamed compressed episode == the resident one; a
    curriculum of two scengen tapes; lob-scengen (the LOB venue's flow from
    the tape's flags, K9's flag route a step; a short-horizon rollout
    replay == the plain versions op by op) for two presets; config 5's
    population on a generated book and on a portfolio curriculum of two
    presets."""
    import json as json_mod

    from gymfx_tpu_torch.config.flagship import flagship_config, lob_config, portfolio_pbt_config
    from gymfx_tpu_torch.core import graphs
    from gymfx_tpu_torch.core.portfolio import PortfolioEnvironment
    from gymfx_tpu_torch.core.rollout import buy_hold_driver
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.data.feed import market_data_nbytes
    from gymfx_tpu_torch.ops import env_dynamics, lob_bar, lob_flow, lob_match, tape_decode, window_zscore
    from gymfx_tpu_torch.ops import scengen_scan as k10
    from gymfx_tpu_torch.train.pbt import _pbt_config_from, make_portfolio_pbt
    from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

    t_phase = time.perf_counter()
    out = results["scengen"] = {}
    check_kernels_k10(torch, dev, kernels, results, ptxas)
    check_kernels_k9_flags(torch, dev, kernels, results)
    csv = str(ROOT / "examples" / "data" / "eurusd_sample.csv")
    gen = dict(feed="scengen", scengen_bars=SCENGEN_TAPE_BARS, scengen_snap_to_tick=True)
    counted = (window_zscore.step_obs, env_dynamics.fill_brackets, env_dynamics.mark_reward,
               k10.scengen_scan, lob_match.process_stream, lob_bar.run_bar, lob_flow.bar_flow,
               tape_decode.decode_q16_block)
    runs = graphs.WARMUP + 1

    def zero():
        for fn in counted:
            fn.launches = 0
        lob_flow.bar_flow.flag_launches = 0

    def kinds(env):
        return torch.bincount((env.data.scen_flags >> 1) & 3, minlength=4).tolist()

    # ---- flagship-scengen-train: the main path on a generated tape
    label = "scengen train"
    config = flagship_config(csv, scengen_preset="regime_mix", **gen)
    zero()
    env = Environment(config)
    trainer = PPOTrainer(env, ppo_config_from(config))
    state, rows = train(torch, trainer, trainer.init_state(SEED), TRAIN_STEPS)
    launches = count_launches(counted)
    per_phase = {"step_obs": HORIZON, "fill_brackets": HORIZON, "mark_reward": HORIZON}
    # counted from the Environment's construction: the generation (K10) and
    # the trainer's reset obs (K1) once, then the phases at capture
    expected = {k: runs * per_phase.get(k, 0) for k in launches}
    expected.update(scengen_scan=1, step_obs=expected["step_obs"] + 1)
    check(launches == expected, f"{label}: launched {launches}, expected {expected}")
    kernels["scengen_scan"]["launches"] = launches["scengen_scan"]
    check(env.n_bars == SCENGEN_TAPE_BARS and env.data.scen_flags.device.type == "cuda",
          f"{label}: the generated tape")
    check_training(rows, label)
    summary = report_steps(rows, N_ENVS, HORIZON, label)
    traced, _ = replay_launches(torch, first_graphs(trainer), {"rollout": per_phase, "update": {}},
                                label)
    # a rollout phase replayed from its graph == the same phase op by op
    # (graphed_vs_eager's first check; the main phase runs all of it)
    a, b = copy_state(torch, state), copy_state(torch, state)
    ga, ra = trainer.rollout_phase(a)
    gb, rb = trainer._rollout_phase_eager(b)
    check_same(torch, ra, rb, f"{label} rollout phase (trajectory, bootstrap value)")
    check_same_state(torch, ga, gb, f"{label} rollout phase (env states, obs_vec)")
    print(f"  {label}: a rollout phase graphed == eager (torch.equal, the generator included)")
    print(f"  {label}: K10 {launches['scengen_scan']} launch (the generation of {env.n_bars:,} "
          f"bars), K1-K3 at capture {[launches[k] for k in per_phase]}; one replay by the "
          f"profiler trace {traced}; bars of each flag kind {kinds(env)}")
    out["train"] = dict(summary, launches_at_capture=launches, replay_launches=traced,
                        flag_kinds=kinds(env))
    del trainer, state, a, b, ga, gb, ra, rb

    # the same tape streamed in compressed shards == resident (data_compress
    # on a snapped tape: the int16 tick-delta wire format); one generation
    one = dict(config, num_envs=1)
    resident = Environment(one, dataset=env.dataset)
    per_bar = market_data_nbytes(resident.data) / SCENGEN_TAPE_BARS
    budget = (STREAM_SHARD_BARS + WINDOW + 1.5) * 2 * per_bar / 2**20 / 0.125
    ref = resident.rollout(buy_hold_driver(), STREAM_STEPS)
    zero()
    streamed = Environment(dict(one, stream_hbm_budget_mb=budget, data_compress="on"),
                           dataset=env.dataset)
    check(streamed.streaming and streamed.streamer.tape is not None,
          f"{label}: the compressed stream was not built")
    episode = streamed.rollout(buy_hold_driver(), STREAM_STEPS)
    check_episodes_equal(torch, episode, ref, f"{label}: compressed streamed episode vs resident")
    check(tape_decode.decode_q16_block.launches > 0, f"{label}: the compressed shards ran no K6")
    print(f"  {label}: a {STREAM_STEPS}-step episode streamed in compressed shards of "
          f"{streamed.streamer.shard_bars} bars == the resident episode (torch.equal); K6 "
          f"{tape_decode.decode_q16_block.launches} launches")
    out["stream"] = dict(shard_bars=streamed.streamer.shard_bars,
                         decode_launches=tape_decode.decode_q16_block.launches)
    del resident, streamed, env
    gc.collect()
    torch.cuda.empty_cache()

    # ---- a curriculum of two scengen tapes, compressed
    label = "scengen curriculum"
    config = flagship_config(csv, feed="curriculum", tapes=SCENGEN_TAPES,
                             scengen_bars=SCENGEN_TAPE_BARS, scengen_snap_to_tick=True,
                             data_compress="on", curriculum_seed=SCENGEN_CURRICULUM_SEED)
    zero()
    env = Environment(config)
    trainer = PPOTrainer(env, ppo_config_from(config))
    state, metrics = trainer.train(TRAIN_STEPS * N_ENVS * HORIZON, seed=SEED)
    picks = [i for _, i in env.curriculum.picks]
    launches = count_launches(counted)
    check(launches["scengen_scan"] == 2, f"{label}: {launches['scengen_scan']} generations")
    check(metrics["iterations"] == TRAIN_STEPS and len(picks) == TRAIN_STEPS, f"{label}: {picks}")
    check(set(picks) == {0, 1} and launches["decode_q16_block"] > 0,
          f"{label}: K6 {launches} for picks {picks}")
    check(all(math.isfinite(metrics[k]) for k in ("loss", "entropy")), f"{label}: {metrics}")
    print(f"  {label}: tapes {SCENGEN_TAPES} ({SCENGEN_TAPE_BARS:,} bars each, tape 1 compressed), "
          f"picks {picks}, launches {launches}, loss {metrics['loss']:.5f}")
    out["curriculum"] = dict(picks=picks, launches=launches)
    del trainer, state, env
    gc.collect()
    torch.cuda.empty_cache()

    # ---- lob-scengen: the LOB venue's flow from the tape's flags.  The first
    # preset trains at flagship-lob's horizon; the second runs a short-horizon
    # rollout phase, replayed from its graph, against the plain versions op by
    # op (the plain LOB phase runs the argsort engine)
    for preset, horizon in zip(SCENGEN_LOB_PRESETS, (HORIZON, SCENGEN_PLAIN_HORIZON)):
        label = f"lob-scengen {preset}"
        config = lob_config(csv, scengen_preset=preset, random_episode_start=True,
                            ppo_horizon=horizon, **gen)
        zero()
        env = Environment(config)
        check(env.cfg.lob_flow_from_scengen, f"{label}: the flow does not read the flags")
        trainer = PPOTrainer(env, ppo_config_from(config))
        per_phase = {"step_obs": horizon, "fill_brackets": 0, "mark_reward": horizon,
                     "process_stream": horizon, "run_bar": horizon, "bar_flow": horizon}
        if horizon == HORIZON:
            state, rows = train(torch, trainer, trainer.init_state(SEED), 2)
            check_training(rows, label)
            row = report_steps(rows, N_ENVS, horizon, label)
        else:
            t0 = time.perf_counter()
            inter, (traj, last_value) = trainer.rollout_phase(trainer.init_state(SEED))
            torch.cuda.synchronize()
            row = {"rollout_phase_s_with_capture": time.perf_counter() - t0}
        launches = count_launches(counted)
        # with random starts each rollout phase also builds the start bank's
        # obs (K1 once more a phase)
        expected = {k: runs * per_phase.get(k, 0) for k in launches}
        expected.update(scengen_scan=1, step_obs=runs * (horizon + 1) + 1)
        check(launches == expected, f"{label}: launched {launches}, expected {expected}")
        check(lob_flow.bar_flow.flag_launches == runs * horizon,
              f"{label}: K9's flag route launched {lob_flow.bar_flow.flag_launches} times")
        kernels["bar_flow_flags"].setdefault("launches", lob_flow.bar_flow.flag_launches)
        print(f"  {label}: bars of each flag kind {kinds(env)}; K9's flag route "
              f"{lob_flow.bar_flow.flag_launches} launches at capture; launches {launches}")
        if horizon != HORIZON:
            zero()
            with plain_lob_versions():
                t0 = time.perf_counter()
                ref_state, (ref_traj, ref_last) = trainer._rollout_phase_eager(
                    trainer.init_state(SEED))
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
            check(sum(count_launches(counted).values()) == 0,
                  f"{label}: the plain-version LOB phase launched a kernel")
            for key in ("obs", "action", "reward", "done", "logp", "value"):
                check(torch.equal(traj[key], ref_traj[key]), f"{label} vs plain versions: traj {key}")
            for field in ref_state.env_states._fields:
                check(torch.equal(getattr(inter.env_states, field),
                                  getattr(ref_state.env_states, field)),
                      f"{label} vs plain versions: env state {field}")
            check(torch.equal(last_value, ref_last), f"{label} vs plain versions: bootstrap value")
            row["plain_phase_s"] = plain_s
            print(f"  {label} (a rollout phase of horizon {horizon}, graphed) == plain versions "
                  f"op by op on the card (K1, K3, K5, K8, K9's flag route; torch.equal); plain "
                  f"phase {plain_s:.1f} s")
        out[label] = dict(row, launches_at_capture=launches, flag_kinds=kinds(env),
                          flag_launches=lob_flow.bar_flow.flag_launches)
        del trainer, env
        gc.collect()
        torch.cuda.empty_cache()

    # ---- config 5's shape on generated books, then a portfolio curriculum
    pairs = json_mod.dumps(list(SCENGEN_PAIRS))
    for label, over in (
            ("portfolio-scengen-pbt", dict(feed="scengen", scengen_preset="multi_asset_stress")),
            ("portfolio-scengen-curriculum", dict(
                feed="curriculum", tapes="scengen:multi_asset_stress,scengen:multi_asset_calm",
                curriculum_seed=SCENGEN_BOOKS_SEED))):
        config = portfolio_pbt_config(str(ROOT), scengen_pairs=pairs, **over)
        zero()
        env = PortfolioEnvironment(config)
        pbt = make_portfolio_pbt(dict(config), _pbt_config_from(config), env)
        pcfg = pbt.trainer.pcfg
        per_iter = pbt.pbt.population * pcfg.n_envs * pcfg.horizon
        t0 = time.perf_counter()
        result = pbt.train(2 * per_iter, seed=SEED)
        train_s = time.perf_counter() - t0
        launches = count_launches(counted)
        generations = 1 if env.curriculum is None else env.curriculum.num_tapes
        check(env.pairs == list(SCENGEN_PAIRS) and launches["scengen_scan"] == generations,
              f"{label}: pairs {env.pairs}, {launches['scengen_scan']} generations")
        check(launches["fill_brackets"] == launches["mark_reward"] == runs * pcfg.horizon,
              f"{label}: K2/K3 at capture {launches}")
        check(result["iterations"] == 2 and all(math.isfinite(x) for x in result["fitness"]),
              f"{label}: {result['iterations']} iterations, fitness {result['fitness']}")
        row = dict(iterations=result["iterations"], train_s=train_s,
                   env_steps_per_s=result["env_steps_per_sec"], launches=launches)
        if env.curriculum is not None:
            picks = [i for _, i in env.curriculum.picks]
            check(set(picks) == {0, 1}, f"{label}: picks {picks} miss a book")
            # the staging rows hold the last pick's book
            staged = pbt.trainer._rows[1].pair.close
            bound = env.curriculum._tape_data(picks[-1]).pair.close
            check(torch.equal(staged, bound), f"{label}: the staging rows are not the last pick")
            row["picks"] = picks
        out[label] = row
        print(f"  {label}: {result['iterations']} population steps of {pbt.pbt.population} x "
              f"{pcfg.n_envs} envs x {env.cfg.n_pairs} generated pairs ({env.n_bars:,} bars) in "
              f"{train_s:.1f} s (the first captures), {result['env_steps_per_sec']:,.0f} env "
              f"steps/s; launches {launches}{'; picks ' + str(row['picks']) if 'picks' in row else ''}")
        del pbt, env
        gc.collect()
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    out["seconds"] = phase_s
    check(phase_s <= SCENGEN_BUDGET_S, f"the scengen phase took {phase_s:.1f} s, over its "
          f"{SCENGEN_BUDGET_S:.0f} s budget")
    print(f"scengen: every check passed in {phase_s:.1f} s")


def check_kernels_k6_k7(torch, dev, kernels) -> None:
    """K6 and K7 on seeded cases; their times at the paths' shapes come
    with the curriculum, export and stream phases."""
    from gymfx_tpu_torch.ops import cases, tape_decode, window_zscore

    err6 = 0.0
    rows_cases = (1003, 1024, 1, TAPE_BARS + 3)
    for rows in rows_cases:
        delta, base, inv = (torch.from_numpy(x).to(dev) for x in cases.q16_case(SEED + rows, rows))
        ours = tape_decode.decode_q16_block(delta, base, inv)
        ref = tape_decode.decode_q16_plain(delta, base, inv)
        torch.cuda.synchronize()
        check(torch.equal(ours, ref), f"K6 decode_q16_block != plain at {tuple(delta.shape)}")
        err6 = max(err6, max_abs_err(torch, ours, ref))
    err7, n7 = 0.0, 0
    k7_cases = [(seed, window, f, "random", 0) for seed, window, f in
                ((0, 8, 3), (1, WINDOW, 5), (2, 16, 1))]
    # every step pattern (the export's 1..n leaves a ragged last tile) at
    # F 1, 3, 5, 7 and W 8, 32, 64; the features 4 bytes off alignment
    k7_cases += [(10 + i, window, f, steps, offset)
                 for i, (window, f) in enumerate((w, f) for w in (8, 32, 64) for f in (1, 3, 5, 7))
                 for steps in cases.K7_STEP_PATTERNS for offset in (0, 1)]
    for seed, window, f, steps, offset in k7_cases:
        args = [torch.from_numpy(x).to(dev)
                for x in cases.scaled_windows_case(seed, window=window, f=f, steps=steps)]
        if offset:
            buf = torch.empty(args[0].numel() + 4, device=dev)
            args[0] = buf[offset:offset + args[0].numel()].view(args[0].shape).copy_(args[0])
            check(args[0].data_ptr() % 16 == 4 * offset, "K7: the features are not 4 bytes off")
        for clip in (10.0, 0.0, 1.5):
            ours = window_zscore.batched_scaled_windows(*args, window=window, clip=clip)
            ref = window_zscore.reference_scaled_windows(*args, window=window, clip=clip)
            torch.cuda.synchronize()
            check(bits_equal(torch, ours, ref),
                  f"K7 batched_scaled_windows != plain (window {window}, F {f}, steps {steps}, "
                  f"offset {offset}, clip {clip})")
            err7 = max(err7, nan_abs_err(torch, ours, ref))
            n7 += 1
    # every CTA walking at least two tiles: the export's steps and turns
    # alternating staged tiles with scattered, clamped ones, F 3 and 5
    for f in (3, 5):
        feats, mean, std, neutral, export = (torch.from_numpy(x).to(dev) for x in
                                             cases.scaled_windows_case(f, n=K7_MANY_TILES,
                                                                       window=WINDOW, f=f,
                                                                       steps="export"))
        geometry = window_zscore._scaled_windows_plan(K7_MANY_TILES, WINDOW, f, feats.shape[0],
                                                      mean.shape[0], 10.0, dev)
        grid, tile, tiles = geometry[0], geometry[1], geometry[2]
        check(tiles >= 2 * grid, f"K7: {tiles} tiles do not give each of {grid} CTAs two")
        turns = torch.from_numpy(cases.scaled_windows_turn_steps(K7_MANY_TILES, tile, grid,
                                                                 seed=f)).to(dev)
        for offset in (0, 1):
            buf = torch.empty(feats.numel() + 4, device=dev)
            view = buf[offset:offset + feats.numel()].view(feats.shape).copy_(feats)
            for label, steps in (("export", export), ("turns", turns)):
                args = (view, mean, std, neutral, steps)
                ours = window_zscore.batched_scaled_windows(*args, window=WINDOW, clip=10.0)
                ref = window_zscore.reference_scaled_windows(*args, window=WINDOW, clip=10.0)
                torch.cuda.synchronize()
                check(bits_equal(torch, ours, ref),
                      f"K7 batched_scaled_windows != plain ({K7_MANY_TILES} {label} steps, F {f}, "
                      f"offset {offset}, {tiles} tiles on {grid} CTAs)")
                err7 = max(err7, nan_abs_err(torch, ours, ref))
                n7 += 1
                del ours, ref
    torch.cuda.empty_cache()
    print(f"kernels: K6 equal to plain on {len(rows_cases)} blocks (int16 extremes, divisors "
          f"1/60/1440/f32(1e5), ragged rows); K7 bitwise equal to plain on {n7} cases (NaN, "
          f"+-inf, neutral rows, steps 0 and n, the export's steps, clamped steps, F 1/3/5/7, "
          f"W 8/32/64, features 4 bytes off alignment, clip 10/0/1.5; {K7_MANY_TILES:,} steps "
          f"with every CTA walking two tiles or more)")
    kernels["decode_q16_block"] = dict(max_abs_err=err6)
    kernels["batched_scaled_windows"] = dict(max_abs_err=err7)


def make_tapes(tmp) -> dict:
    """The four tapes, written as CSVs: name -> path."""
    from gymfx_tpu_torch.ops import cases

    timestamps = cases.m1_week_grid(TAPE_BARS)
    paths = {}
    for i, (name, level) in enumerate(TAPE_LEVELS.items()):
        path = pathlib.Path(tmp) / f"{name}_m1.csv"
        cases.write_bar_csv(path, cases.tick_walk_columns(TAPE_BARS, seed=SEED + i, level=level),
                            timestamps)
        paths[name] = str(path)
    return paths


def count_launches(fns) -> dict:
    return {fn.__name__: fn.launches for fn in fns}


@contextlib.contextmanager
def plain_lob_versions():
    """The LOB path's kernel wrappers (K1, K3, K5, K8, K9) swapped for their
    plain versions while the block runs: a module function swapped after a
    capture does not reach a replay, so only eager phases see them."""
    from gymfx_tpu_torch.ops import env_dynamics, lob_bar, lob_flow, lob_match, window_zscore

    saved = (lob_match.process_stream, lob_bar.run_bar, env_dynamics.mark_reward,
             window_zscore.step_obs, lob_flow.bar_flow)
    lob_match.process_stream = lob_match.process_stream_plain
    lob_bar.run_bar = lob_bar.run_bar_plain
    lob_flow.bar_flow = lob_flow.bar_flow_plain
    env_dynamics.mark_reward = env_dynamics.mark_reward_plain
    window_zscore.step_obs = lambda win, mean, std, neutral, binary_mask=(), clip=10.0: \
        window_zscore.scale_feature_window(win, mean, std, neutral, binary_mask, clip)
    try:
        yield
    finally:
        (lob_match.process_stream, lob_bar.run_bar, env_dynamics.mark_reward,
         window_zscore.step_obs, lob_flow.bar_flow) = saved


def train(torch, trainer, state, steps: int, data=None):
    """``steps`` train steps through ``trainer.train_step`` (on the card:
    the rollout and update graphs, captured at the first), each timed;
    returns (state, per-step rows)."""
    rows = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, data)
        torch.cuda.synchronize()
        rows.append(dict(step_ms=(time.perf_counter() - t0) * 1e3,
                         metrics={k: float(v) for k, v in metrics.items()}))
    return state, rows


def copy_state(torch, state):
    """A train state's tensors cloned (PPO's TrainState or IMPALA's
    ImpalaState), with a generator of its own at the same state."""
    from gymfx_tpu_torch.core import graphs

    def one(x):
        if isinstance(x, torch.Generator):
            gen = torch.Generator(device=x.device)
            gen.set_state(x.get_state())
            return gen
        return graphs.clone_tree(x)

    return type(state)(*(one(x) for x in state))


def tensor_fields(torch, state) -> tuple:
    return tuple(x for x in state if not isinstance(x, torch.Generator))


def check_same(torch, a, b, what: str) -> None:
    """Every leaf of two trees torch.equal."""
    from gymfx_tpu_torch.resilience.guards import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    check(len(la) == len(lb), f"{what}: graphed and eager differ in structure")
    bad = [i for i, (x, y) in enumerate(zip(la, lb)) if not torch.equal(x, y)]
    check(not bad, f"{what}: graphed != eager (torch.equal) at leaves {bad[:8]} of {len(la)}")


def check_same_state(torch, a, b, what: str) -> None:
    check_same(torch, tensor_fields(torch, a), tensor_fields(torch, b), what)
    check(torch.equal(a.generator.get_state(), b.generator.get_state()),
          f"{what}: generator state graphed != eager")


def capture_seconds(trainer) -> dict:
    """Warm-up and capture seconds of each of the trainer's graphs."""
    return {f"{key[0]}{'' if i < 2 else i}": graph.capture_s
            for i, (key, graph) in enumerate(trainer._graphs.items())}


def first_graphs(trainer) -> dict:
    """The trainer's first graph of each kind (rollout, update)."""
    out = {}
    for key, graph in trainer._graphs.items():
        out.setdefault(key[0], graph)
    return out


def replay_kernel_names(torch, graph) -> list:
    """The kernels of one replay of ``graph`` (a core/graphs.PhaseGraph),
    by name from a torch.profiler trace (the replay overwrites the graph's
    static outputs).  The profiler stops TRACE_DRAIN_S after the replay
    ends, so that CUPTI can hand over the replay's last records."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.graph.replay()
        torch.cuda.synchronize()
        time.sleep(TRACE_DRAIN_S)
    return [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]


def replay_launches(torch, graphs_by_kind: dict, expected: dict, label: str) -> tuple:
    """One replay of the graph of each kind in ``expected`` (``graphs_by_kind``
    maps a kind to its PhaseGraph: a trainer's ``first_graphs``, or an
    episode chunk's graph), its kernels counted by name in a
    torch.profiler trace; each kernel of KERNEL_NAMES must launch as
    ``expected`` says, 0 where it says nothing.

    CUPTI can drop activity records from a trace of a replay of ~10^5
    kernels: a trace of one LOB rollout replay on an H100 lost the replay's
    last records and showed 63 of its 64 K1, K3 and K8 kernels.  So a
    trace whose counts fall short is taken again, up to TRACE_TRIES
    traces.  A replay launches the same kernels every time, so the trace
    that agrees is accepted only if every trace before it holds fewer
    kernels in all: those lost records, and a loss can only lower a count.
    A count above the expected one fails at once.
    Returns ({kind: {key: count, "all": kernels, "traces": kernels of each
    trace taken}}, {kind: names in the accepted trace})."""
    traced, names = {}, {}
    for kind, counts in expected.items():
        want = {k: counts.get(k, 0) for k in KERNEL_NAMES}
        tries = []
        for _ in range(TRACE_TRIES):
            got_names = replay_kernel_names(torch, graphs_by_kind[kind])
            got = {key: sum(pattern in n for n in got_names)
                   for key, pattern in KERNEL_NAMES.items()}
            tries.append((got, len(got_names)))
            check(all(got[k] <= want[k] for k in want),
                  f"{label}: one {kind} replay launched {got} (profiler trace), expected {want}")
            if got == want:
                break
        check(got == want, f"{label}: one {kind} replay launched {got} (profiler trace), "
              f"expected {want}; {len(tries)} traces {tries}")
        check(all(n < len(got_names) for _, n in tries[:-1]),
              f"{label}: {kind} traces {tries[:-1]} before the accepted one of "
              f"{len(got_names)} kernels did not lose records")
        traced[kind] = {**got, "all": len(got_names), "traces": [n for _, n in tries]}
        names[kind] = got_names
    return traced, names


def graphed_vs_eager(torch, trainer, state, data, label: str, steps: int = 3) -> dict:
    """From copies of ``state`` (its generator state included): one graphed
    rollout phase, one graphed update phase and ``train_many`` (k =
    ``steps``) against the same run op by op (``_rollout_phase_eager``,
    ``_update_phase_eager``), torch.equal on every output and on the
    generator state after; then each phase timed, graphed and eager, over
    ``steps`` steps (medians of steps 2 on), and the chain's rate."""
    sync = torch.cuda.synchronize
    n, h = phase_shape(trainer)
    a, b = copy_state(torch, state), copy_state(torch, state)
    ga, ra = trainer.rollout_phase(a, data)
    gb, rb = trainer._rollout_phase_eager(b, data)
    check_same(torch, ra, rb, f"{label} rollout phase (trajectory, bootstrap value)")
    check_same_state(torch, ga, gb, f"{label} rollout phase (env states, obs_vec)")
    ua, ma = trainer.update_phase(ga, ra, data)
    ub, mb = trainer._update_phase_eager(gb, rb, data)
    check_same_state(torch, ua, ub, f"{label} update phase (params, Adam state, quarantined envs)")
    check_same(torch, ma, mb, f"{label} update phase metrics")
    start = copy_state(torch, ub)
    many_in = copy_state(torch, start)
    sync()
    t0 = time.perf_counter()
    many, stacked = (trainer.train_many(many_in, steps) if data is None
                     else trainer.train_many_with_data(many_in, data, steps))
    sync()
    many_ms = (time.perf_counter() - t0) * 1e3
    ref, history, eager, graphed = copy_state(torch, start), [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        inter, rollout_out = trainer._rollout_phase_eager(ref, data)
        sync()
        t1 = time.perf_counter()
        ref, metrics = trainer._update_phase_eager(inter, rollout_out, data)
        sync()
        eager.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        history.append(metrics)
    check_same_state(torch, many, ref, f"{label} train_many (k = {steps}) vs {steps} eager steps")
    check_same(torch, stacked, {k: torch.stack([m[k] for m in history]) for k in stacked},
               f"{label} train_many metrics")
    s = copy_state(torch, start)
    for _ in range(steps):
        t0 = time.perf_counter()
        inter, rollout_out = trainer.rollout_phase(s, data)
        sync()
        t1 = time.perf_counter()
        s, _ = trainer.update_phase(inter, rollout_out, data)
        sync()
        graphed.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))

    def medians(rows):
        steady = rows[1:] or rows
        return (statistics.median(r for r, _ in steady), statistics.median(u for _, u in steady))

    g_r, g_u = medians(graphed)
    e_r, e_u = medians(eager)
    out = {
        "capture_s": capture_seconds(trainer),
        "graphed_rollout_ms": [r for r, _ in graphed], "graphed_update_ms": [u for _, u in graphed],
        "eager_rollout_ms": [r for r, _ in eager], "eager_update_ms": [u for _, u in eager],
        "train_many_ms": many_ms,
        "graphed_env_steps_per_s": n * h / (g_r + g_u) * 1e3,
        "eager_env_steps_per_s": n * h / (e_r + e_u) * 1e3,
        "train_many_env_steps_per_s": n * h * steps / many_ms * 1e3,
    }
    print(f"{label} graphed == eager on the card (torch.equal, generator state included): one "
          f"rollout phase, one update phase, train_many (k = {steps}) vs {steps} eager steps")
    print(f"  {label} capture s (warm-up and capture) "
          + ", ".join(f"{k} {v:.2f}" for k, v in out["capture_s"].items())
          + f"; rollout ms graphed {g_r:.2f} vs eager {e_r:.2f}, update ms graphed {g_u:.2f} vs "
          f"eager {e_u:.2f} (medians of steps 2-{steps}); env steps/s graphed "
          f"{out['graphed_env_steps_per_s']:,.0f} vs eager {out['eager_env_steps_per_s']:,.0f}; "
          f"train_many (k = {steps}) {many_ms:.1f} ms, "
          f"{out['train_many_env_steps_per_s']:,.0f} env steps/s")
    return out


def phase_shape(trainer) -> tuple:
    """(envs, steps a rollout phase) of a PPO or an IMPALA trainer."""
    if hasattr(trainer, "icfg"):
        return trainer.icfg.n_envs, trainer.icfg.unroll
    return trainer.pcfg.n_envs, trainer.pcfg.horizon


def check_training(rows, label: str,
                   keys=("loss", "policy_loss", "value_loss", "entropy", "grad_norm")) -> None:
    for i, row in enumerate(rows):
        m = row["metrics"]
        for key in keys:
            check(m[key] == m[key] and abs(m[key]) != float("inf"), f"{label} step {i}: {key} {m[key]}")
        check(m["nonfinite_skips"] == 0.0, f"{label} step {i}: {m['nonfinite_skips']} updates skipped")


def report_steps(rows, n_envs: int, horizon: int, label: str) -> dict:
    """Graphed train steps' rows: step ms (the first captures the graphs)."""
    steady = rows[1:] or rows
    step = statistics.median(r["step_ms"] for r in steady)
    summary = dict(step_ms=[r["step_ms"] for r in rows],
                   train_env_steps_per_s=n_envs * horizon / step * 1e3,
                   metrics=[r["metrics"] for r in rows])
    losses = ", ".join(f"{r['metrics']['loss']:.5f}" for r in rows)
    print(f"{label}: {len(rows)} graphed train steps of {horizon} steps x {n_envs} envs: "
          f"{', '.join(f'{r:.1f}' for r in summary['step_ms'])} ms (the first captures); "
          f"{summary['train_env_steps_per_s']:,.0f} env steps/s (median of steps 2-{len(rows)}); "
          f"losses {losses}")
    return summary


def main_phase(torch, kernels, results) -> None:
    from gymfx_tpu_torch.config.flagship import flagship_config
    from gymfx_tpu_torch.core import graphs
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.ops import (env_dynamics, fused_attention, lob_bar, lob_flow, lob_match,
                                     window_zscore)
    from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

    config = flagship_config(str(ROOT / "examples" / "data" / "eurusd_sample.csv"))
    check(config["num_envs"] == N_ENVS and config["ppo_horizon"] == HORIZON
          and config["window_size"] == WINDOW, "flagship config changed")
    env = Environment(config)
    check(env.device.type == "cuda", "Environment did not default to CUDA")
    trainer = PPOTrainer(env, ppo_config_from(config))
    check(trainer.obs_dim == 164, f"obs dim {trainer.obs_dim} != 164")
    state = trainer.init_state(SEED)
    start = {k: v.clone() for k, v in state.params.items()}
    torch.cuda.synchronize()
    counted = (window_zscore.step_obs, env_dynamics.fill_brackets, env_dynamics.mark_reward)
    for fn in (*counted, fused_attention.attention_forward, fused_attention.attention_backward,
               lob_match.process_stream, lob_bar.run_bar, lob_flow.bar_flow):
        fn.launches = 0
    state, rows = train(torch, trainer, state, TRAIN_STEPS)
    launches = count_launches(counted)
    # the counts move where a wrapper launches into the warm-ups and into
    # the capture; a replay moves none
    per_phase = {"step_obs": HORIZON, "fill_brackets": HORIZON, "mark_reward": HORIZON}
    runs = graphs.WARMUP + 1
    check(launches == {k: runs * v for k, v in per_phase.items()},
          f"main path launched {launches} at capture, expected {runs} x {per_phase}")
    for key, count in launches.items():
        kernels[key]["launches"] = count
    check(fused_attention.attention_forward.launches == 0, "the MLP path launched K4")
    check(lob_match.process_stream.launches == 0 == lob_bar.run_bar.launches
          == lob_flow.bar_flow.launches, "the bar venue launched K5, K8 or K9")
    check(sorted(k for k, *_ in trainer._graphs) == ["rollout", "update"],
          f"main path graphs {[k for k, *_ in trainer._graphs]}")
    check_training(rows, "main")
    check(any(not torch.equal(state.params[k], start[k]) for k in start), "the params did not move")
    for field in ("pos", "cash_delta", "equity_delta", "entry_price", "max_drawdown_pct"):
        check(bool(torch.isfinite(getattr(state.env_states, field)).all()), f"non-finite state {field}")
    trades = int(state.env_states.trade_count.sum())
    check(trades > 0, "the policy made no trade")
    state = copy_state(torch, state)
    summary = report_steps(rows, N_ENVS, HORIZON, "main path")
    traced, _ = replay_launches(
        torch, first_graphs(trainer), {"rollout": {**per_phase, "attention_forward": 0, "attention_backward": 0},
                         "update": {}}, "main path")
    print(f"  launches at capture {launches} ({runs} runs: {graphs.WARMUP} warm-ups and the "
          f"capture); one replay by the profiler trace {traced}; {trades} closed trades")

    # step 1's rollout phase, replayed from the graph, against the same
    # phase op by op with the plain versions on the card
    inter, (traj, last_value) = trainer.rollout_phase(trainer.init_state(SEED))
    check(tuple(traj["obs"].shape) == (HORIZON, N_ENVS, 164) and traj["obs"].dtype == torch.bfloat16,
          "trajectory obs shape/dtype")
    for key in ("obs", "logp", "value", "reward"):
        check(bool(torch.isfinite(traj[key]).all()), f"non-finite trajectory {key}")
    kernel_fns = (env_dynamics.fill_brackets, env_dynamics.mark_reward, window_zscore.step_obs)
    env_dynamics.fill_brackets = env_dynamics.fill_brackets_plain
    env_dynamics.mark_reward = env_dynamics.mark_reward_plain
    window_zscore.step_obs = lambda win, mean, std, neutral, binary_mask=(), clip=10.0: \
        window_zscore.scale_feature_window(win, mean, std, neutral, binary_mask, clip)
    try:
        t0 = time.perf_counter()
        ref_state, (ref_traj, ref_last) = trainer._rollout_phase_eager(trainer.init_state(SEED))
        torch.cuda.synchronize()
        plain_phase_s = time.perf_counter() - t0
    finally:
        env_dynamics.fill_brackets, env_dynamics.mark_reward, window_zscore.step_obs = kernel_fns
    check(count_launches(counted) == launches, "the plain-version phase launched a kernel")
    for key in ("obs", "action", "reward", "done", "logp", "value"):
        check(torch.equal(traj[key], ref_traj[key]), f"main path vs plain versions: traj {key}")
    for field in ref_state.env_states._fields:
        check(torch.equal(getattr(inter.env_states, field), getattr(ref_state.env_states, field)),
              f"main path vs plain versions: env state {field}")
    check(torch.equal(last_value, ref_last), "main path vs plain versions: bootstrap value")
    print(f"main path (graphed) == plain versions op by op on the card (rollout phase of step 1, "
          f"torch.equal); plain phase {plain_phase_s * 1e3:.1f} ms")
    compared = graphed_vs_eager(torch, trainer, state, None, "main path")
    results["main_path"] = {
        "n_envs": N_ENVS, "horizon": HORIZON, "window": WINDOW, "obs_dim": 164,
        "policy": "mlp 3x256 tanh bf16", "update": "1 epoch x 4 env-permuted minibatches",
        **summary, "plain_rollout_ms": plain_phase_s * 1e3, "launches_at_capture": launches,
        "replay_launches": traced, "graphed_vs_eager": compared, "closed_trades": trades,
    }


def long_phase(torch, kernels, results) -> None:
    from gymfx_tpu_torch.config.flagship import long_context_config
    from gymfx_tpu_torch.core import graphs
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.ops import env_dynamics, fused_attention, window_zscore
    from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

    config = long_context_config(str(ROOT / "examples" / "data" / "eurusd_sample.csv"))
    trainer = PPOTrainer(Environment(config), ppo_config_from(config))
    pcfg = trainer.pcfg
    n, horizon, mbs = pcfg.n_envs, pcfg.horizon, pcfg.minibatches
    layers = dict(pcfg.policy_kwargs)["n_layers"]
    check((n, horizon, trainer.env.cfg.window_size, pcfg.epochs) == (256, 64, 256, 1),
          "long-context config changed")
    state = trainer.init_state(SEED)
    torch.cuda.synchronize()
    counted = (window_zscore.step_obs, env_dynamics.fill_brackets, env_dynamics.mark_reward,
               fused_attention.attention_forward, fused_attention.attention_backward)
    for fn in counted:
        fn.launches = 0
    state, rows = train(torch, trainer, state, LONG_STEPS)
    launches = count_launches(counted)
    # per replay: (horizon + 1) policy forwards in the rollout, one per
    # minibatch in the update, each through every layer
    rollout = {"step_obs": horizon, "fill_brackets": horizon, "mark_reward": horizon,
               "attention_forward": layers * (horizon + 1), "attention_backward": 0}
    update = {"step_obs": 0, "fill_brackets": 0, "mark_reward": 0,
              "attention_forward": layers * mbs * pcfg.epochs,
              "attention_backward": layers * mbs * pcfg.epochs}
    check(rollout["attention_forward"] == 130 and update["attention_forward"] == 8
          and update["attention_backward"] == 8, "K4 launch arithmetic")
    runs = graphs.WARMUP + 1
    expected = {k: runs * (rollout[k] + update[k]) for k in rollout}
    check(launches == expected, f"long path launched {launches} at capture, expected {expected}")
    for key in ("attention_forward", "attention_backward"):
        kernels[key]["launches"] = launches[key]
    check_training(rows, "long")
    state = copy_state(torch, state)
    summary = report_steps(rows, n, horizon, "long path")
    traced, _ = replay_launches(torch, first_graphs(trainer), {"rollout": rollout, "update": update},
                                "long path")
    print(f"  launches at capture {launches} ({runs} runs); one replay by the profiler trace "
          f"{traced}")

    # one update phase from the saved state: replayed from a graph through
    # K4, and op by op through K4's plain versions on the card
    inter, rollout_out = trainer.rollout_phase(state)
    gen = torch.Generator(device=trainer.device).manual_seed(SEED)
    perms = torch.stack([torch.randperm(n, generator=gen, device=trainer.device)
                         for _ in range(pcfg.epochs)])
    trainer.update_phase(inter, rollout_out, permutations=perms)  # captures the hook's graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, k4_metrics = trainer.update_phase(inter, rollout_out, permutations=perms)
    torch.cuda.synchronize()
    k4_s = time.perf_counter() - t0
    before = count_launches(counted)
    saved = (fused_attention.attention_forward, fused_attention.attention_backward)
    fused_attention.attention_forward = fused_attention.attention_forward_plain
    fused_attention.attention_backward = fused_attention.attention_backward_plain
    try:
        t0 = time.perf_counter()
        _, plain_metrics = trainer._update_phase_eager(inter, rollout_out, permutations=perms)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        fused_attention.attention_forward, fused_attention.attention_backward = saved
    check(count_launches(counted) == before, "the plain-attention update launched a kernel")
    k4m = {k: float(v) for k, v in k4_metrics.items()}
    pm = {k: float(v) for k, v in plain_metrics.items()}
    check(k4m["nonfinite_skips"] == 0.0 == pm["nonfinite_skips"], "an update was skipped")
    for key, rtol, atol in (("loss", 1e-2, 0.0), ("value_loss", 1e-2, 0.0), ("entropy", 1e-3, 0.0),
                            ("policy_loss", 0.0, 1e-3), ("grad_norm", 5e-2, 0.0)):
        check(abs(k4m[key] - pm[key]) <= atol + rtol * abs(pm[key]),
              f"long update through K4 vs plain attention: {key} {k4m[key]} vs {pm[key]}")
    print(f"long update through K4 (graphed) vs plain attention (eager) on the card: "
          + ", ".join(f"{k} {k4m[k]:.6g} vs {pm[k]:.6g}"
                      for k in ("loss", "policy_loss", "value_loss", "entropy", "grad_norm"))
          + f"; update {k4_s * 1e3:.1f} ms vs {plain_s * 1e3:.1f} ms")
    compared = graphed_vs_eager(torch, trainer, state, None, "long path")
    results["long_context"] = {
        "n_envs": n, "horizon": horizon, "window": 256,
        "policy": "transformer_ring d_model 128, 4 heads, 2 layers, bf16",
        **summary, "launches_at_capture": launches, "replay_launches": traced,
        "k4_vs_plain_update": {"k4": k4m, "plain": pm},
        "k4_update_ms": k4_s * 1e3, "plain_update_ms": plain_s * 1e3,
        "graphed_vs_eager": compared,
    }


def lob_phase(torch, kernels, results) -> None:
    from gymfx_tpu_torch.config.flagship import lob_config
    from gymfx_tpu_torch.core import graphs
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.ops import env_dynamics, lob_bar, lob_flow, lob_match, window_zscore
    from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

    config = lob_config(str(ROOT / "examples" / "data" / "eurusd_sample.csv"))
    trainer = PPOTrainer(Environment(config), ppo_config_from(config))
    cfg, pcfg = trainer.env.cfg, trainer.pcfg
    check((pcfg.n_envs, pcfg.horizon, cfg.window_size, cfg.venue, cfg.lob_messages_per_bar,
           cfg.lob_depth_levels, cfg.lob_queue_slots, cfg.lob_scenario)
          == (N_ENVS, HORIZON, WINDOW, "lob", K8_MSGS, 24, LOB_SLOTS, K8_SCENARIO),
          "flagship-lob-train config changed")
    state = trainer.init_state(SEED)
    torch.cuda.synchronize()
    counted = (window_zscore.step_obs, env_dynamics.fill_brackets, env_dynamics.mark_reward,
               lob_match.process_stream, lob_bar.run_bar, lob_flow.bar_flow)
    for fn in counted:
        fn.launches = 0
    state, rows = train(torch, trainer, state, LOB_STEPS)
    launches = count_launches(counted)
    # per rollout phase; the update launches none of them.  The counts move
    # at the warm-ups and the capture, a replay moves none
    per_phase = {"step_obs": HORIZON, "fill_brackets": 0, "mark_reward": HORIZON,
                 "process_stream": HORIZON, "run_bar": HORIZON, "bar_flow": HORIZON}
    runs = graphs.WARMUP + 1
    check(launches == {k: runs * v for k, v in per_phase.items()},
          f"LOB path launched {launches} at capture, expected {runs} x {per_phase}")
    for key in ("process_stream", "lob_bar", "bar_flow"):
        kernels[key]["launches"] = launches["run_bar" if key == "lob_bar" else key]
    graphed = sorted(k for k, *_ in trainer._graphs)
    check(graphed == ["rollout", "update"], f"LOB venue graphs {graphed}")
    check_training(rows, "lob")
    summary = report_steps(rows, N_ENVS, HORIZON, "lob path")
    expected = {k.replace("run_bar", "lob_bar"): v for k, v in per_phase.items()}
    traced, names = replay_launches(torch, first_graphs(trainer), {"rollout": expected, "update": {}},
                                   "lob path")
    names = names["rollout"]
    gathers = sum(GATHER_KERNEL in n for n in names)
    engine = sum(any(k in n.lower() for k in ENGINE_KERNELS) and GATHER_KERNEL not in n
                 for n in names)
    check(engine == 0, f"a LOB rollout replay ran {engine} sort, scan or scatter kernels: "
          "the argsort engine is on the path")
    # the plain flow's threefry words are int64 elementwise kernels (bitwise
    # and, or, xor and the shifts): K9 leaves none
    int64_words = sum(("bitwise" in n.lower() or "shift" in n.lower()) and "long" in n
                      for n in names)
    check(int64_words == 0, f"a LOB rollout replay ran {int64_words} int64 bitwise or shift "
          "kernels: the plain flow is on the path")
    per_step = len(names) / HORIZON
    print(f"  launches at capture {launches} ({runs} runs); one replay by the profiler trace "
          f"{traced}: {per_step:.1f} kernels a step, {engine} sort, scan or scatter, "
          f"{int64_words} int64 bitwise or shift, {gathers} gathers")
    env_states = state.env_states
    for field in ("pos", "cash_delta", "equity_delta", "entry_price"):
        check(bool(torch.isfinite(getattr(env_states, field)).all()), f"LOB non-finite state {field}")
    trades = int(env_states.trade_count.sum())
    check(trades > 0, "the LOB policy closed no trade")
    partial = int(((env_states.pos.abs() % config["position_size"]) != 0).sum())
    state = copy_state(torch, state)

    # step 1's rollout phase, replayed from the graph, against the same
    # phase op by op with the plain versions of K1, K3, K5, K8 and K9 on the
    # card
    inter, (traj, last_value) = trainer.rollout_phase(trainer.init_state(SEED))
    for key in ("obs", "logp", "value", "reward"):
        check(bool(torch.isfinite(traj[key]).all()), f"LOB non-finite trajectory {key}")
    for fn in counted:
        fn.launches = 0
    with plain_lob_versions():
        t0 = time.perf_counter()
        ref_state, (ref_traj, ref_last) = trainer._rollout_phase_eager(trainer.init_state(SEED))
        torch.cuda.synchronize()
        plain_phase_s = time.perf_counter() - t0
    check(sum(count_launches(counted).values()) == 0, "the plain-version LOB phase launched a kernel")
    for key in ("obs", "action", "reward", "done", "logp", "value"):
        check(torch.equal(traj[key], ref_traj[key]), f"LOB path vs plain versions: traj {key}")
    for field in ref_state.env_states._fields:
        check(torch.equal(getattr(inter.env_states, field), getattr(ref_state.env_states, field)),
              f"LOB path vs plain versions: env state {field}")
    check(torch.equal(last_value, ref_last), "LOB path vs plain versions: bootstrap value")
    print(f"lob path (graphed) == plain versions op by op on the card (rollout phase of step 1, "
          f"torch.equal); plain phase {plain_phase_s * 1e3:.1f} ms; {trades} closed trades, "
          f"{partial} envs holding a partly exited position")
    compared = graphed_vs_eager(torch, trainer, state, None, "lob path")
    results["lob_path"] = {
        "config": "flagship-lob-train", "n_envs": N_ENVS, "horizon": HORIZON, "window": WINDOW,
        "lob": {"scenario": cfg.lob_scenario, "messages_per_bar": cfg.lob_messages_per_bar,
                "depth": cfg.lob_depth_levels, "slots": cfg.lob_queue_slots},
        **summary, "plain_rollout_ms": plain_phase_s * 1e3, "launches_at_capture": launches,
        "replay_launches": traced, "kernels_per_step": per_step, "engine_kernels": engine,
        "int64_word_kernels": int64_words,
        "closed_trades": trades, "graphed_phases": graphed, "graphed_vs_eager": compared,
    }


def baseline_phase(torch, kernels, results) -> None:
    """BASELINE.json's configurations 3 (PPO on the sharpe reward) and 4
    (IMPALA with the LSTM) at full width, from their graphs."""
    from gymfx_tpu_torch.config.flagship import baseline_sharpe_config, impala_lstm_config
    from gymfx_tpu_torch.core import graphs
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.ops import (env_dynamics, fused_attention, lob_bar, lob_flow, lob_match,
                                     window_zscore)
    from gymfx_tpu_torch.train.impala import ImpalaTrainer, impala_config_from
    from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

    csv = str(ROOT / "examples" / "data" / "eurusd_sample.csv")
    counted = (window_zscore.step_obs, env_dynamics.fill_brackets, env_dynamics.mark_reward)
    others = (fused_attention.attention_forward, fused_attention.attention_backward,
              lob_match.process_stream, lob_bar.run_bar, lob_flow.bar_flow)
    runs = graphs.WARMUP + 1
    out = {}
    for label, config in (("sharpe", baseline_sharpe_config(csv)), ("impala", impala_lstm_config(csv))):
        env = Environment(config)
        if label == "sharpe":
            trainer = PPOTrainer(env, ppo_config_from(config))
            check((trainer.pcfg.n_envs, trainer.pcfg.horizon, env.cfg.reward, env.cfg.sharpe_window,
                   env.cfg.strategy, trainer.pcfg.policy_dtype) == (4096, 32, "sharpe_reward", 64,
                                                                   "direct_atr_sltp", torch.float32),
                  "baseline-sharpe-atr-train config changed")
        else:
            trainer = ImpalaTrainer(env, impala_config_from(config))
            check((trainer.icfg.n_envs, trainer.icfg.unroll, env.cfg.reward, trainer.icfg.policy,
                   trainer.icfg.policy_dtype, trainer.policy.hidden)
                  == (4096, 64, "dd_penalized_reward", "lstm", torch.bfloat16, 256),
                  "baseline-impala-lstm-train config changed")
        n, horizon = phase_shape(trainer)
        state = trainer.init_state(SEED)
        torch.cuda.synchronize()
        for fn in (*counted, *others):
            fn.launches = 0
        env_dynamics.mark_reward.sharpe_launches = 0
        state, rows = train(torch, trainer, state, TRAIN_STEPS)
        launches = count_launches(counted)
        sharpe_launches = env_dynamics.mark_reward.sharpe_launches
        per_phase = {"step_obs": 0, "fill_brackets": horizon, "mark_reward": horizon}
        check(launches == {k: runs * v for k, v in per_phase.items()},
              f"baseline {label} launched {launches} at capture, expected {runs} x {per_phase}")
        check(sharpe_launches == (runs * horizon if label == "sharpe" else 0),
              f"baseline {label}: K3's sharpe path launched {sharpe_launches} times")
        check(all(fn.launches == 0 for fn in others), f"baseline {label} launched K4, K5, K8 or K9")
        if label == "sharpe":
            kernels["mark_reward_sharpe"]["launches"] = sharpe_launches
        check(sorted(k for k, *_ in trainer._graphs) == ["rollout", "update"],
              f"baseline {label} graphs {[k for k, *_ in trainer._graphs]}")
        check_training(rows, f"baseline {label}", keys=(
            ("loss", "policy_loss", "value_loss", "entropy", "grad_norm") if label == "sharpe"
            else ("loss", "policy_loss", "value_loss", "entropy", "mean_rho")))
        for field in ("pos", "cash_delta", "equity_delta", "reward_buffer"):
            check(bool(torch.isfinite(getattr(state.env_states, field)).all()),
                  f"baseline {label}: non-finite state {field}")
        state = copy_state(torch, state)
        summary = report_steps(rows, n, horizon, f"baseline {label}")
        traced, _ = replay_launches(torch, first_graphs(trainer),
                                    {"rollout": per_phase, "update": {}}, f"baseline {label}")
        print(f"  launches at capture {launches} (K3's sharpe path {sharpe_launches}; {runs} "
              f"runs); one replay by the profiler trace {traced}")
        compared = graphed_vs_eager(torch, trainer, state, None, f"baseline {label}")
        row = {"n_envs": n, "steps_a_phase": horizon, **summary, "launches_at_capture": launches,
               "sharpe_launches_at_capture": sharpe_launches, "replay_launches": traced,
               "graphed_vs_eager": compared}
        if label == "sharpe":
            inter, (traj, _) = trainer.rollout_phase(copy_state(torch, state))
            live = float((traj["reward"] != 0).to(torch.float32).mean())
            check(live > 0, "baseline sharpe: every reward of a rollout was 0")
            row["nonzero_reward_share"] = live
        else:
            # the learner's replay of the segment through the LSTM, forward
            # and backward with V-trace and the loss (the update phase but
            # its optimizer, guard and quarantine), replayed from a graph,
            # beside the graphed update phase it is part of
            inter, (traj, init_carry) = trainer.rollout_phase(copy_state(torch, state))
            replay_ms = device_ms(torch, lambda: trainer.loss_and_grads(
                inter.learner_params, traj, init_carry, inter.obs_vec), reps=3, trials=7)
            update_ms = statistics.median(compared["graphed_update_ms"][1:])
            row.update(learner_replay_graphed_ms=replay_ms, graphed_update_ms=update_ms,
                       learner_replay_share=replay_ms / update_ms)
            print(f"  IMPALA learner replay (LSTM over {horizon} steps x {n} envs, V-trace and "
                  f"the loss, forward and backward; device ms from graph replays): "
                  f"{replay_ms:.2f} ms, {replay_ms / update_ms:.0%} of the graphed update phase's "
                  f"{update_ms:.2f} ms")
        out[label] = row
    results["baseline"] = out


def chunk_launches(steps: int, chunk: int = 64) -> int:
    """A counted kernel's launches over a graphed episode of ``steps``
    steps that captures its chunk graphs: each chunk length's graph runs
    its body in the warm-ups and the capture, a replay moves no count."""
    from gymfx_tpu_torch.core import graphs

    lengths = {min(chunk, steps)} | ({steps % chunk} if steps > chunk else set())
    return (graphs.WARMUP + 1) * sum(lengths - {0})


def timed_episode(torch, env, driver, steps: int, **kw):
    """``env.rollout`` timed: ((state, outputs), ms a step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = env.rollout(driver, steps, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / steps


def check_episodes_equal(torch, a, b, what: str) -> None:
    """Two (state, outputs) episodes torch.equal, every output and every
    field of the final state."""
    (sa, oa), (sb, ob) = a, b
    check(sorted(oa) == sorted(ob), f"{what}: output keys")
    for key in oa:
        check(torch.equal(oa[key], ob[key]), f"{what}: {key}")
    for field in sa._fields:
        check(torch.equal(getattr(sa, field), getattr(sb, field)), f"{what}: final state {field}")


def episode_phase(torch, results) -> None:
    from gymfx_tpu_torch.config.flagship import flagship_config
    from gymfx_tpu_torch.core import rollout as rollout_mod
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.ops import env_dynamics, window_zscore

    config = flagship_config(str(ROOT / "examples" / "data" / "eurusd_sample.csv"))
    env = Environment(config)
    counted = (window_zscore.step_obs, env_dynamics.fill_brackets, env_dynamics.mark_reward)
    for fn in counted:
        fn.launches = 0
    graphed, graphed_ms = timed_episode(torch, env, rollout_mod.buy_hold_driver(), EPISODE_STEPS)
    state, out = graphed
    episode_launches = count_launches(counted)
    # K2 and K3 once per step of each chunk graph's warm-ups and capture;
    # K1 also once for the reset's obs
    at_capture = chunk_launches(EPISODE_STEPS)
    expected = {"step_obs": at_capture + 1, "fill_brackets": at_capture, "mark_reward": at_capture}
    check(episode_launches == expected, f"episode launched {episode_launches}, expected {expected}")
    capture_s = sum(g.capture_s for g in env.episode_graphs.graphs.values())
    replayed, replay_ms = timed_episode(torch, env, rollout_mod.buy_hold_driver(), EPISODE_STEPS)
    check(count_launches(counted) == {**expected, "step_obs": at_capture + 2},
          "a replayed episode launched a kernel outside its reset")
    eager, eager_ms = timed_episode(torch, env, rollout_mod.buy_hold_driver(), EPISODE_STEPS,
                                    eager=True)
    check_episodes_equal(torch, graphed, eager, "bar episode graphed vs eager")
    check_episodes_equal(torch, replayed, eager, "bar episode replayed vs eager")
    cpu_env = Environment(config, device="cpu")
    _, cpu_out = cpu_env.rollout(rollout_mod.buy_hold_driver(), EPISODE_STEPS)
    for key in ("equity_delta", "reward", "done", "pos_units"):
        check(torch.equal(out[key].cpu(), cpu_out[key]), f"buy_hold episode card vs CPU: {key}")
    final_equity = float(out["equity"][-1, 0])
    check(abs(final_equity - 10000.0) < 100.0, f"implausible final equity {final_equity}")
    print(f"episode: buy_hold, 1 env, {EPISODE_STEPS} steps: final equity {final_equity:.5f} "
          f"(graphed == eager on the card, card == CPU, torch.equal); launches {episode_launches} "
          f"(chunk graphs {sorted(k[0] for k in env.episode_graphs.graphs)}, captured); ms a step "
          f"graphed {replay_ms:.4f} (first run with capture {graphed_ms:.4f}), eager "
          f"{eager_ms:.4f}; capture s {capture_s:.2f}")
    results["episode"] = {"final_equity": final_equity, "steps": EPISODE_STEPS,
                          "graphed_ms_per_step": replay_ms, "first_run_ms_per_step": graphed_ms,
                          "eager_ms_per_step": eager_ms, "capture_s": capture_s}

    # the same on the LOB venue (flagship-lob-train: direct_fixed_sltp,
    # 40-lot entries), K5 seeding every step's books and K8 running its bar
    from gymfx_tpu_torch.config.flagship import lob_config
    from gymfx_tpu_torch.ops import lob_bar, lob_flow, lob_match

    config = lob_config(str(ROOT / "examples" / "data" / "eurusd_sample.csv"))
    counted = (*counted, lob_match.process_stream, lob_bar.run_bar, lob_flow.bar_flow)
    for fn in counted:
        fn.launches = 0
    lob_env = Environment(config)
    graphed, card_ms = timed_episode(torch, lob_env, rollout_mod.buy_hold_driver(),
                                     LOB_EPISODE_STEPS)
    state, out = graphed
    episode_launches = count_launches(counted)
    at_capture = chunk_launches(LOB_EPISODE_STEPS)
    expected = {"step_obs": at_capture + 1, "fill_brackets": 0,
                "mark_reward": at_capture, "process_stream": at_capture,
                "run_bar": at_capture, "bar_flow": at_capture}
    check(episode_launches == expected, f"LOB episode launched {episode_launches}, expected {expected}")
    eager, eager_ms = timed_episode(torch, lob_env, rollout_mod.buy_hold_driver(),
                                    LOB_EPISODE_STEPS, eager=True)
    check_episodes_equal(torch, graphed, eager, "LOB episode graphed vs eager")
    t0 = time.perf_counter()
    _, cpu_out = Environment(config, device="cpu").rollout(rollout_mod.buy_hold_driver(),
                                                           LOB_EPISODE_STEPS)
    cpu_s = time.perf_counter() - t0
    check(sorted(out) == sorted(cpu_out), "LOB episode outputs differ in keys")
    for key in out:
        check(torch.equal(out[key].cpu(), cpu_out[key]), f"LOB buy_hold episode card vs CPU: {key}")
    trades = int(out["trade_count"][-1, 0])
    check(trades > 0, "the LOB episode closed no trade")
    final_equity = float(out["equity"][-1, 0])
    card_s = card_ms * LOB_EPISODE_STEPS / 1e3
    print(f"episode: LOB venue, buy_hold, 1 env, {LOB_EPISODE_STEPS} steps: final equity "
          f"{final_equity:.5f}, {trades} closed trades (graphed == eager on the card, card == "
          f"CPU, torch.equal, every output); launches {episode_launches}; {card_s:.1f} s on the "
          f"card with the capture, eager {eager_ms:.3f} ms a step, {cpu_s:.1f} s on the CPU")
    results["lob_episode"] = {"final_equity": final_equity, "closed_trades": trades,
                              "card_s": card_s, "eager_ms_per_step": eager_ms, "cpu_s": cpu_s}


def curriculum_phase(torch, dev, kernels, results, paths) -> None:
    from gymfx_tpu_torch.config.flagship import curriculum_config
    from gymfx_tpu_torch.core import graphs
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.data import compress as C
    from gymfx_tpu_torch.data import tapes as tapes_mod
    from gymfx_tpu_torch.ops import env_dynamics, tape_decode, window_zscore
    from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

    library = ",".join(f"file:{path}" for path in paths.values())
    config = curriculum_config(library, timeframe="M1", num_envs=N_ENVS)
    t0 = time.perf_counter()
    env = Environment(config)
    build_s = time.perf_counter() - t0
    sampler = env.curriculum
    check(env.cfg.n_bars == TAPE_BARS and sampler.num_tapes == len(paths), "curriculum library")
    check(sampler.tape(0) is None and all(sampler.tape(i) is not None for i in (1, 2, 3)),
          "tape 0 must be resident f32 and tapes 1-3 compressed")
    groups, decode_ms, ratios = {}, {}, {}
    for i in (1, 2, 3):
        tape = sampler.tape(i)
        groups[i] = len(C._q16_groups(tape.columns, [s.shape[1] for s in tape.slabs]))
        decoded = sampler._tape_data(i)
        plain = C.decode_shard_ref(tape, 0, device=dev)
        direct = tapes_mod.dataset_for_spec(config, sampler.specs[i]).build_market_data(
            device=dev, **env.md_kwargs)
        torch.cuda.synchronize()
        for name in direct._fields:
            if name == "row0":
                continue
            check(torch.equal(getattr(decoded, name), getattr(direct, name)),
                  f"curriculum tape {i}: decoded {name} != the direct f32 build")
            check(torch.equal(getattr(decoded, name), getattr(plain, name)),
                  f"curriculum tape {i}: decoded {name} != the plain-version decode")
        decode_ms[i] = event_ms(torch, lambda: sampler._tape_data(i))
        ratios[i] = tape.compression_ratio
        del decoded, plain, direct
    report = sampler.nbytes_report()
    print(f"curriculum: {sampler.num_tapes} tapes of {TAPE_BARS:,} M1 bars built in {build_s:.1f} s; "
          f"tapes 1-3 decoded by K6 equal the direct f32 build and the plain decode (torch.equal, "
          f"every field)")
    print(f"  codec_report (tape 1): {sampler.tape(1).codec_report()}")
    print(f"  compression ratio {', '.join(f'tape {i} {r:.3f}' for i, r in ratios.items())}; "
          f"nbytes_report {report}; q16 groups per tape {groups}; a pick's whole decode "
          f"{', '.join(f'{ms:.3f}' for ms in decode_ms.values())} ms")

    # K6 at a pick's largest group (tape 1, all of its bar-length q16 columns)
    tape = sampler.tape(1)
    arrs = C.shard_arrays(tape, 0)
    items = C._q16_groups(tape.columns, [s.shape[1] for s in tape.slabs])[0]
    slabs = [arrs["slabs"][s] for s, _ in items]
    bases = [arrs["bases"][s] for s, _ in items]
    inv = sampler._decoders[1].invs[0]
    delta, base = torch.stack(slabs), torch.stack(bases)
    ours = tape_decode.decode_q16_block(delta, base, inv)
    ref = tape_decode.decode_q16_plain(delta, base, inv)
    torch.cuda.synchronize()
    check(torch.equal(ours, ref), f"K6 != plain at the pick's group {tuple(delta.shape)}")
    b_ms, b_by = k6_bound(delta)
    k6 = kernels["decode_q16_block"]
    k6.update(
        max_abs_err=max(k6["max_abs_err"], max_abs_err(torch, ours, ref)),
        ms=device_ms(torch, lambda: tape_decode.decode_q16_block(delta, base, inv)),
        plain_ms=device_ms(torch, lambda: tape_decode.decode_q16_plain(delta, base, inv)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=list(delta.shape),
        stack_ms=device_ms(torch, lambda: torch.stack(slabs)),
        host_us=host_us(torch, lambda: tape_decode.decode_q16_block(delta, base, inv)),
    )
    print(f"  K6 at a pick's group {tuple(delta.shape)}: {k6['ms'] * 1e3:.2f} us/call on the card "
          f"(plain {k6['plain_ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us by {b_by}); the int16 "
          f"stack before it {k6['stack_ms'] * 1e3:.2f} us")
    del ours, ref, delta, base

    trainer = PPOTrainer(env, ppo_config_from(config))
    rows = []
    step = trainer.train_step

    def recording(state, data=None):
        t_start = time.perf_counter()
        state, metrics = step(state, data)
        torch.cuda.synchronize()
        rows.append(dict(ms=(time.perf_counter() - t_start) * 1e3,
                         metrics={k: float(v) for k, v in metrics.items()}))
        return state, metrics

    trainer.train_step = recording
    counted = (window_zscore.step_obs, env_dynamics.fill_brackets, env_dynamics.mark_reward,
               tape_decode.decode_q16_block, window_zscore.batched_scaled_windows)
    for fn in counted:
        fn.launches = 0
    state, metrics = trainer.train(CURRICULUM_SUPERSTEPS * N_ENVS * HORIZON, seed=SEED)
    launches = count_launches(counted)
    picks = [i for _, i in sampler.picks]
    # per replay: K1 once more in the rollout than K2 / K3 (the obs of the
    # random-start bank, one reset_at of every env) and once in the update
    # (the active tape's fresh reset for the quarantine); counted at capture
    # (the warm-ups and the capture), the decode once per compressed pick
    rollout = {"step_obs": HORIZON + 1, "fill_brackets": HORIZON, "mark_reward": HORIZON,
               "attention_forward": 0, "attention_backward": 0}
    update = {"step_obs": 1, "fill_brackets": 0, "mark_reward": 0,
              "attention_forward": 0, "attention_backward": 0}
    runs = graphs.WARMUP + 1
    expected = {"step_obs": runs * (HORIZON + 2), "fill_brackets": runs * HORIZON,
                "mark_reward": runs * HORIZON,
                "decode_q16_block": sum(groups.get(i, 0) for i in picks),
                "batched_scaled_windows": 0}
    check(len(picks) == CURRICULUM_SUPERSTEPS, f"{len(picks)} picks, expected {CURRICULUM_SUPERSTEPS}")
    check(any(i > 0 for i in picks), f"the seed picked no compressed tape: {picks}")
    check(launches == expected, f"curriculum training launched {launches}, expected {expected}")
    check(metrics["iterations"] == CURRICULUM_SUPERSTEPS, "curriculum iterations")
    check(sorted(k for k, *_ in trainer._graphs) == ["rollout", "update"],
          f"curriculum graphs {[k for k, *_ in trainer._graphs]}: one graph a phase for every tape")
    check_training(rows, "curriculum")
    kernels["decode_q16_block"]["launches"] = launches["decode_q16_block"]
    for key in ("obs_vec",):
        check(bool(torch.isfinite(getattr(state, key)).all()), f"curriculum non-finite {key}")
    state = copy_state(torch, state)
    traced, _ = replay_launches(torch, first_graphs(trainer), {"rollout": rollout, "update": update},
                                "curriculum")
    check(traced["rollout"]["step_obs"] + traced["update"]["step_obs"] == HORIZON + 2,
          "curriculum K1 a train step")
    labels = [sampler.specs[i].label.rsplit("/", 1)[-1] for i in picks]
    step_ms = ", ".join(f"{r['ms']:.1f}" for r in rows)
    losses = ", ".join(f"{r['metrics']['loss']:.5f}" for r in rows)
    print(f"curriculum: {CURRICULUM_SUPERSTEPS} supersteps (K=1) of {HORIZON} steps x {N_ENVS} envs, "
          f"picks {picks} ({', '.join(labels)}), each copied into the one staging tape; graphed "
          f"train steps {step_ms} ms (the first captures), {metrics['env_steps_per_sec']:,.0f} env "
          f"steps/s; losses {losses}; launches {launches} ({runs} runs at capture); one replay "
          f"by the profiler trace {traced}")

    # one rollout phase on a compressed tape: K6's decode and K1-K3 from the
    # graph, again op by op with the plain decode and the plain K1-K3
    i = next(i for i in picks if i > 0)
    traj_state, (traj, last) = trainer.rollout_phase(trainer.init_state(SEED), sampler._tape_data(i))
    kernel_fns = (env_dynamics.fill_brackets, env_dynamics.mark_reward, window_zscore.step_obs)
    env_dynamics.fill_brackets = env_dynamics.fill_brackets_plain
    env_dynamics.mark_reward = env_dynamics.mark_reward_plain
    window_zscore.step_obs = lambda win, mean, std, neutral, binary_mask=(), clip=10.0: \
        window_zscore.scale_feature_window(win, mean, std, neutral, binary_mask, clip)
    before = count_launches(counted)
    try:
        plain_tape = C.decode_shard_ref(sampler.tape(i), 0, device=dev)
        ref_state, (ref_traj, ref_last) = trainer._rollout_phase_eager(trainer.init_state(SEED),
                                                                       plain_tape)
        torch.cuda.synchronize()
    finally:
        env_dynamics.fill_brackets, env_dynamics.mark_reward, window_zscore.step_obs = kernel_fns
    check(count_launches(counted) == before, "the plain-version curriculum phase launched a kernel")
    for key in ("obs", "action", "reward", "done", "logp", "value"):
        check(torch.equal(traj[key], ref_traj[key]), f"curriculum tape {i} vs plain versions: traj {key}")
    for field in ref_state.env_states._fields:
        check(torch.equal(getattr(traj_state.env_states, field), getattr(ref_state.env_states, field)),
              f"curriculum tape {i} vs plain versions: env state {field}")
    check(torch.equal(last, ref_last), "curriculum vs plain versions: bootstrap value")
    print(f"curriculum: rollout phase on tape {i} (K6 decode, K1-K3, graphed) == plain decode and "
          f"plain versions op by op on the card (torch.equal)")
    compared = graphed_vs_eager(torch, trainer, state, sampler._tape_data(i), "curriculum")
    results["curriculum"] = {
        "config": "flagship-curriculum-train", "tapes": list(paths), "bars": TAPE_BARS,
        "build_s": build_s, "compression_ratio": ratios, "nbytes_report": report,
        "q16_groups": groups, "pick_decode_ms": decode_ms, "picks": picks,
        "train_step_ms": [r["ms"] for r in rows], "metrics": [r["metrics"] for r in rows],
        "env_steps_per_s": metrics["env_steps_per_sec"], "launches": launches,
        "replay_launches": traced, "graphed_vs_eager": compared,
        "k6_pick_group": {k: v for k, v in kernels["decode_q16_block"].items()},
    }


def export_phase(torch, kernels, results, paths, tmp) -> None:
    import numpy as np

    from gymfx_tpu_torch.app.main import export_scaled_features
    from gymfx_tpu_torch.config.flagship import FEATURE_COLUMNS, flagship_config
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.ops import window_zscore

    config = flagship_config(paths["eurusd"], timeframe="M1")
    env = Environment(config)
    n_steps = env.cfg.n_bars - 1
    path = pathlib.Path(tmp) / "scaled_windows.npz"
    window_zscore.batched_scaled_windows.launches = 0
    t0 = time.perf_counter()
    meta = export_scaled_features(env, config, n_steps, str(path))
    wall = time.perf_counter() - t0
    launches = window_zscore.batched_scaled_windows.launches
    check(launches == 1, f"the export launched K7 {launches} times")
    shape = [n_steps, WINDOW, len(FEATURE_COLUMNS)]
    check(meta["shape"] == shape, f"export shape {meta['shape']} != {shape}")
    saved = np.load(path)["scaled_windows"]
    d = env.data
    steps = torch.arange(1, n_steps + 1, dtype=torch.int32, device=d.close.device)
    clip = float(env.cfg.feature_clip or 0.0)
    args = (d.padded_features, d.feat_mean, d.feat_std, d.feat_neutral, steps)
    ref = window_zscore.reference_scaled_windows(*args, window=WINDOW, clip=clip)
    check(bits_equal(torch, torch.from_numpy(saved).to(ref.device), ref),
          "the exported windows != the plain version's")
    ours = window_zscore.batched_scaled_windows(*args, window=WINDOW, clip=clip)
    torch.cuda.synchronize()
    check(bits_equal(torch, ours, ref), "K7 != plain at the export's shape")
    err = nan_abs_err(torch, ours, ref)
    del ours, ref, saved
    # the output written once, features, moments, flags and steps read once;
    # a subtract, a divide, a select and the two-sided clip per element
    moved = 4 * n_steps * WINDOW * len(FEATURE_COLUMNS) + nbytes(*args)
    b_ms, b_by = bound(moved, 5 * n_steps * WINDOW * len(FEATURE_COLUMNS), F32_FLOPS)
    k7 = kernels["batched_scaled_windows"]
    k7.update(
        max_abs_err=max(k7["max_abs_err"], err), launches=launches,
        ms=device_ms(torch, lambda: window_zscore.batched_scaled_windows(*args, window=WINDOW, clip=clip),
                     reps=10, trials=11),
        plain_ms=event_ms(torch, lambda: window_zscore.reference_scaled_windows(*args, window=WINDOW,
                                                                                 clip=clip)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=shape, moved_bytes=moved,
    )
    # K7's launch floor at its grid, its wrapper's host time (at 64 steps
    # of the tape, where the device time lies under it), and this card's
    # yardstick for a write-bound pass: zeroing an output of the same size
    from gymfx_tpu_torch.ops import _build

    dev = d.padded_features.device
    geometry = window_zscore._scaled_windows_plan(n_steps, WINDOW, len(FEATURE_COLUMNS),
                                                  d.padded_features.shape[0],
                                                  d.feat_mean.shape[0], clip, dev)
    grid, smem = geometry[0], 2 * geometry[14]
    env_lib = _build.load_library()
    k7.update(
        grid=[grid, window_zscore.K7_THREADS, smem], tile=geometry[1],
        launch_floor_ms=device_ms(torch, lambda: _build.check_launch(env_lib.gymfx_launch_floor(
            grid, window_zscore.K7_THREADS, smem, _build.stream_handle(dev)), "launch_floor")),
        host_us=host_us(torch, lambda: window_zscore.batched_scaled_windows(
            *args[:4], steps[:64], window=WINDOW, clip=clip)),
    )
    out = torch.empty(shape, device=dev)
    k7["zero_ms"] = device_ms(torch, out.zero_, reps=10, trials=11)
    del out
    torch.cuda.empty_cache()
    size_mb = path.stat().st_size / 1e6
    path.unlink()
    print(f"export: {shape} f32 ({4 * np.prod(shape) / 1e6:.1f} MB) through 1 K7 launch, equal to "
          f"the plain version (bitwise); windows {meta['seconds']['windows']:.3f} s (K7, copy to the "
          f"host), save {meta['seconds']['save']:.3f} s ({size_mb:.1f} MB npz), {wall:.3f} s in all")
    print(f"  K7 at the export's shape: {k7['ms'] * 1e3:.1f} us/call on the card (plain "
          f"{k7['plain_ms'] * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us by {b_by}, {moved / 1e6:.1f} MB; "
          f"zeroing the output {k7['zero_ms'] * 1e3:.1f} us; launch floor "
          f"{k7['launch_floor_ms'] * 1e3:.2f} us at {grid} CTAs x {window_zscore.K7_THREADS} threads, "
          f"{smem} B shared, tiles of {k7['tile']}); wrapper host {k7['host_us']:.1f} us/call at 64 "
          f"steps")
    results["export"] = {"shape": shape, "seconds": meta["seconds"], "wall_s": wall,
                         "npz_mb": size_mb, "k7": dict(k7)}


def stream_phase(torch, kernels, results, paths) -> None:
    from gymfx_tpu_torch.config.flagship import flagship_config
    from gymfx_tpu_torch.core import graphs
    from gymfx_tpu_torch.core.rollout import buy_hold_driver
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.data import compress as C
    from gymfx_tpu_torch.data.feed import market_data_nbytes
    from gymfx_tpu_torch.ops import env_dynamics, tape_decode, window_zscore

    base = flagship_config(paths["eurusd"], timeframe="M1")
    resident = Environment(base)
    per_bar = market_data_nbytes(resident.data) / TAPE_BARS
    # budgets whose plans cut shards of STREAM_SHARD_BARS bars: two decoded
    # shards take half the uncompressed budget, an eighth of the compressed
    span = (STREAM_SHARD_BARS + WINDOW + 1.5) * 2 * per_bar / 2**20
    budgets = {"on": span / 0.125, "off": span}
    t0 = time.perf_counter()
    ref_state, ref = resident.rollout(buy_hold_driver(), STREAM_STEPS)
    torch.cuda.synchronize()
    resident_s = time.perf_counter() - t0
    del resident
    counted = (window_zscore.step_obs, env_dynamics.fill_brackets, env_dynamics.mark_reward,
               tape_decode.decode_q16_block)
    rows = {}
    for mode in ("on", "off"):
        env = Environment(dict(base, stream_hbm_budget_mb=budgets[mode], data_compress=mode))
        s = env.streamer
        check(env.streaming and s.shard_bars == STREAM_SHARD_BARS,
              f"stream {mode}: {s.shard_bars}-bar shards, expected {STREAM_SHARD_BARS}")
        check(mode == "off" or not s.tape_resident, "the compressed ring holds the whole tape")
        served = sum(1 for lo in s.starts if lo < STREAM_STEPS)
        groups = 0 if s.tape is None else len(
            C._q16_groups(s.tape.columns, [sl.shape[1] for sl in s.tape.slabs]))
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        state, out = env.rollout(buy_hold_driver(), STREAM_STEPS)
        torch.cuda.synchronize()
        episode_s = time.perf_counter() - t0
        launches = count_launches(counted)
        # each chunk length's graph counts in its warm-ups and capture; the
        # staging shard makes one graph serve every shard
        at_capture = (graphs.WARMUP + 1) * sum(k[0] for k in env.episode_graphs.graphs)
        expected = {"step_obs": at_capture + 1, "fill_brackets": at_capture,
                    "mark_reward": at_capture, "decode_q16_block": served * groups}
        check(launches == expected, f"stream {mode} launched {launches}, expected {expected}")
        check(sorted(out) == sorted(ref), f"stream {mode}: output keys")
        for key in ref:
            check(torch.equal(out[key], ref[key]), f"stream {mode} vs resident episode: {key}")
        for field in ref_state._fields:
            check(torch.equal(getattr(state, field), getattr(ref_state, field)),
                  f"stream {mode} vs resident episode: final state {field}")
        t0 = time.perf_counter()
        again = env.rollout(buy_hold_driver(), STREAM_STEPS)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eager = env.rollout(buy_hold_driver(), STREAM_STEPS, eager=True)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        check_episodes_equal(torch, (state, out), eager, f"stream {mode} graphed vs eager")
        check_episodes_equal(torch, again, eager, f"stream {mode} replayed vs eager")
        capture_s = sum(g.capture_s for g in env.episode_graphs.graphs.values())
        rows[mode] = dict(budget_mb=budgets[mode], shard_bars=s.shard_bars, num_shards=s.num_shards,
                          ring_shards=s.ring_shards, tape_resident=s.tape_resident,
                          shards_served=served, q16_groups=groups, episode_s=episode_s,
                          replay_episode_s=replay_s, eager_episode_s=eager_s, capture_s=capture_s,
                          launches=launches, compression_ratio=s.compression_ratio)
        print(f"stream {mode}: budget {budgets[mode]:.3f} MiB, shard_bars {s.shard_bars}, num_shards "
              f"{s.num_shards}, ring_shards {s.ring_shards}, tape_resident {s.tape_resident}; "
              f"buy_hold 1 env x {STREAM_STEPS} steps over {served} shards, graphed: {episode_s:.2f} s "
              f"with the capture ({capture_s:.2f} s), {replay_s:.2f} s replayed "
              f"({replay_s * 1e3 / STREAM_STEPS:.4f} ms a step), eager {eager_s:.2f} s "
              f"({eager_s * 1e3 / STREAM_STEPS:.4f} ms a step), resident {resident_s:.2f} s; == the "
              f"resident episode and graphed == eager (torch.equal, every output and the final "
              f"state); launches {launches}")
        if s.tape is not None:
            # K6 at a streamed shard's largest group
            arrs = C.shard_arrays(s.tape, 1)
            items = C._q16_groups(s.tape.columns, [sl.shape[1] for sl in s.tape.slabs])[0]
            delta = torch.stack([torch.as_tensor(arrs["slabs"][k]) for k, _ in items]).to(env.device)
            base_ = torch.stack([torch.as_tensor(arrs["bases"][k]) for k, _ in items]).to(env.device)
            inv = s._decoder.invs[0]
            ours = tape_decode.decode_q16_block(delta, base_, inv)
            check(torch.equal(ours, tape_decode.decode_q16_plain(delta, base_, inv)),
                  f"K6 != plain at a shard's group {tuple(delta.shape)}")
            b_ms, b_by = k6_bound(delta)
            rows[mode]["k6_shard_group"] = dict(
                shape=list(delta.shape), bound_ms=b_ms, bound_by=b_by,
                ms=device_ms(torch, lambda: tape_decode.decode_q16_block(delta, base_, inv)),
                plain_ms=device_ms(torch, lambda: tape_decode.decode_q16_plain(delta, base_, inv)))
            row = rows[mode]["k6_shard_group"]
            print(f"  K6 at a shard's group {tuple(delta.shape)}: {row['ms'] * 1e3:.2f} us/call "
                  f"(plain {row['plain_ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us by {b_by})")
        del env, state, out
    results["stream"] = {"steps": STREAM_STEPS, "resident_s": resident_s, **rows}


def cli_phase(torch, results, tmp) -> None:
    """The command line's PPO modes at flagship width (gymfx_tpu_torch/
    app/main.py): training with checkpoints, a resume, the policy mode,
    the evaluation episode's time and one chunk replay's kernels, and the
    diagnostic episodes graphed against eager; then IMPALA's training with
    a checkpoint and the policy mode on it."""
    from gymfx_tpu_torch.app.main import main as cli_main
    from gymfx_tpu_torch.config.flagship import flagship_config
    from gymfx_tpu_torch.core import rollout as rollout_mod
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.ops import cases
    from gymfx_tpu_torch.train import checkpoint as ckpt
    from gymfx_tpu_torch.train.common import build_train_eval_envs
    from gymfx_tpu_torch.train.ppo import PPOTrainer, greedy_policy_driver, evaluate, ppo_config_from

    tmp = pathlib.Path(tmp) / "cli"
    tmp.mkdir()
    tape = tmp / "eurusd_m1.csv"
    cases.write_bar_csv(tape, cases.tick_walk_columns(CLI_BARS, seed=SEED, level=1.10),
                        cases.m1_week_grid(CLI_BARS))
    config = flagship_config(str(tape), timeframe="M1", eval_split=0.25)
    cfg_file = tmp / "flagship.json"
    cfg_file.write_text(json.dumps(config))
    per_iter = N_ENVS * HORIZON
    eval_bars = CLI_BARS // 4

    def cli(name, *argv, cfg=cfg_file):
        t0 = time.perf_counter()
        out = cli_main(["--load_config", str(cfg), "--results_file", str(tmp / f"{name}.json"),
                        "--save_config", str(tmp / "saved_config.json"), "--quiet_mode", *argv])
        torch.cuda.synchronize()
        check(json.loads((tmp / f"{name}.json").read_text())
              == json.loads(json.dumps(out, default=str)), f"cli {name}: results file != summary")
        return out, time.perf_counter() - t0

    # 1. train: 3 iterations, a checkpoint after each
    full = tmp / "full"
    trained, train_s = cli("train", "--mode", "training", "--checkpoint_dir", str(full),
                           "--train_total_steps", str(CLI_ITERS * per_iter),
                           "--checkpoint_every", "1")
    for key in ("eval_scope", "eval_bars", "train_bars", "in_sample", "train_metrics",
                "checkpoint_dir", *CLI_SUMMARY_KEYS):
        check(key in trained, f"cli training results lack {key!r}")
    check(trained["eval_scope"] == "held_out" and trained["eval_bars"] == eval_bars
          and trained["train_bars"] == CLI_BARS - eval_bars,
          f"cli training: eval {trained['eval_bars']}, train {trained['train_bars']} bars")
    tm = trained["train_metrics"]
    check(tm["iterations"] == CLI_ITERS and tm["nonfinite_skips"] == 0.0
          and tm["last_checkpoint_step"] == CLI_ITERS * per_iter, f"cli train_metrics {tm}")
    for key in ("loss", "policy_loss", "value_loss", "entropy"):
        check(math.isfinite(tm[key]), f"cli training: {key} {tm[key]}")
    steps_on_disk = ckpt._list_steps(full)
    check(steps_on_disk == [i * per_iter for i in range(1, CLI_ITERS + 1)],
          f"cli checkpoint steps {steps_on_disk}")
    for step in steps_on_disk:
        check(ckpt.verify_checkpoint(str(full), step)[1] is not None,
              f"cli checkpoint step {step} has no digest")
    check(ckpt.read_metadata(str(full)).get("state_format") == "composite", "cli metadata")
    state_mb = (full / str(steps_on_disk[-1]) / "state.pt").stat().st_size / 2**20
    print(f"cli train: {CLI_ITERS} iterations of {N_ENVS} envs x {HORIZON} steps on "
          f"{CLI_BARS - eval_bars:,} bars, checkpoints {steps_on_disk} (digest-verified, "
          f"{state_mb:.1f} MiB a state), held-out eval on {eval_bars:,} bars: total_return "
          f"{trained['total_return']:.6g}, trades {trained['trades_total']}; in-sample "
          f"total_return {trained['in_sample']['total_return']:.6g}; {train_s:.1f} s")

    # 2. resume from the step-2 checkpoint for one iteration: the state
    # equals the uninterrupted run's step-3 state, leaf by leaf
    resumed = tmp / "resumed"
    resumed.mkdir()
    for step in steps_on_disk[:-1]:
        shutil.copytree(full / str(step), resumed / str(step))
        shutil.copy(full / f"digest_{step}.json", resumed)
    shutil.copy(full / "metadata.json", resumed)
    again, resume_s = cli("resume", "--mode", "training", "--checkpoint_dir", str(resumed),
                          "--train_total_steps", str(per_iter), "--checkpoint_every", "1",
                          "--resume_training", "true")
    check(ckpt._list_steps(resumed) == steps_on_disk, f"cli resume steps {ckpt._list_steps(resumed)}")
    final = f"{steps_on_disk[-1]}/state.pt"
    a = torch.load(full / final, weights_only=True)
    b = torch.load(resumed / final, weights_only=True)
    check(list(a) == list(b), "cli resume: state leaves differ")
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    check(not differ, f"cli resume != the uninterrupted run at {differ[:8]}")
    kinds = {k.split(".")[0] for k in a}
    check({"params", "opt_state", "generator", "env_states"} <= kinds, f"cli state leaves {kinds}")
    for key in CLI_SUMMARY_KEYS:
        check(again[key] == trained[key], f"cli resume held-out {key}: {again[key]} vs {trained[key]}")
    print(f"cli resume: step {steps_on_disk[-2]} + 1 iteration == the uninterrupted run (torch.equal "
          f"on all {len(a)} leaves: params, Adam state, env batch, obs inputs, generator state); "
          f"{resume_s:.1f} s")

    # 3. policy mode on the checkpoint reproduces the held-out summary
    policy, policy_s = cli("policy", "--mode", "inference", "--driver_mode", "policy",
                           "--checkpoint_dir", str(full), "--steps", str(eval_bars - 1))
    for key in CLI_SUMMARY_KEYS:
        check(policy[key] == trained[key], f"cli policy mode {key}: {policy[key]} vs {trained[key]}")
    check(policy["checkpoint_step"] == steps_on_disk[-1] and policy["mode"] == "inference"
          and policy["eval_scope"] == "held_out", "cli policy mode labels")
    print(f"cli policy: checkpoint step {policy['checkpoint_step']} reproduces the training run's "
          f"held-out summary ({len(CLI_SUMMARY_KEYS)} numbers equal); {policy_s:.1f} s")

    # 4. the evaluation episode: its time, graphed against eager, and the
    # kernels of one chunk replay
    _, eval_env = build_train_eval_envs(dict(config, ppo_minibatch_scheme="sample_permute"))
    trainer = PPOTrainer(eval_env, ppo_config_from(dict(config, ppo_minibatch_scheme="sample_permute")))
    params, _ = ckpt.load_params(str(full), template=trainer.params_template())
    timing = {}
    for run in ("first", "replayed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = evaluate(trainer, params)
        timing[run] = time.perf_counter() - t0
        for key in CLI_SUMMARY_KEYS:
            check(summary[key] == trained[key], f"cli evaluate ({run}) {key}")
    eval_graphs = eval_env.episode_graphs.graphs
    capture_s = sum(g.capture_s for g in eval_graphs.values())
    lengths = sorted(k[0] for k in eval_graphs)
    check(lengths == [(eval_bars - 1) % 64, 64], f"cli evaluation graphs {lengths}")
    driver, carry = greedy_policy_driver(trainer), (params, ())
    episodes = {}
    for eager in (False, True):
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        episodes[eager] = rollout_mod.rollout_chunked(
            eval_env.cfg, eval_env.params, eval_env.data, driver, CLI_EAGER_STEPS, gen,
            driver_carry=carry, cache=eval_env.episode_graphs, eager=eager)
        torch.cuda.synchronize()
        timing["eager" if eager else "graphed_2048"] = time.perf_counter() - t0
    check_episodes_equal(torch, episodes[False], episodes[True],
                         f"cli evaluation episode ({CLI_EAGER_STEPS} steps) graphed vs eager")
    chunk = next(g for k, g in eval_graphs.items() if k[0] == 64)
    traced, _ = replay_launches(torch, {"evaluation chunk": chunk},
                                {"evaluation chunk": {"step_obs": 64, "fill_brackets": 64,
                                                      "mark_reward": 64}}, "cli")
    eval_ms = timing["replayed"] * 1e3 / (eval_bars - 1)
    eager_ms = timing["eager"] * 1e3 / CLI_EAGER_STEPS
    print(f"cli evaluation episode: {eval_bars - 1:,} greedy steps of 1 env, {eval_ms:.4f} ms a "
          f"step replayed ({timing['first']:.2f} s the first time, with {capture_s:.2f} s of "
          f"capture for chunk graphs {lengths}); graphed {CLI_EAGER_STEPS} steps "
          f"{timing['graphed_2048'] * 1e3 / CLI_EAGER_STEPS:.4f} ms a step == eager "
          f"{eager_ms:.4f} ms a step (torch.equal); one 64-step chunk replay by the profiler "
          f"trace {traced['evaluation chunk']}")

    # 5. the diagnostic episodes through main, held to the eager episode
    diag = {}
    one_env = dict(config, num_envs=1)
    bh, bh_s = cli("buy_hold", "--mode", "inference", "--driver_mode", "buy_hold",
                   "--num_envs", "1", "--steps", str(CLI_BARS - 1))
    env = Environment(one_env)
    (bh_state, bh_out), bh_ms = timed_episode(torch, env, rollout_mod.buy_hold_driver(),
                                              CLI_BARS - 1)
    n_steps = int(rollout_mod.episode_step_count(bh_out)[0])
    check(bh["final_equity"] == float(bh_out["equity_delta"][n_steps - 1, 0].double())
          + config["initial_cash"], "cli buy_hold summary vs its episode")
    _, cpu_out = Environment(one_env, device="cpu").rollout(rollout_mod.buy_hold_driver(),
                                                            CLI_EAGER_STEPS)
    for key in cpu_out:
        check(torch.equal(bh_out[key][:CLI_EAGER_STEPS].cpu(), cpu_out[key]),
              f"cli buy_hold episode vs the CPU's first {CLI_EAGER_STEPS} steps: {key}")
    diag["buy_hold"] = dict(steps=CLI_BARS - 1, main_s=bh_s, graphed_ms_per_step=bh_ms,
                            final_equity=bh["final_equity"])
    rnd, rnd_s = cli("random", "--mode", "inference", "--driver_mode", "random",
                     "--num_envs", str(N_ENVS), "--steps", str(CLI_EAGER_STEPS))
    env = Environment(config)
    graphed, rnd_ms = timed_episode(torch, env, rollout_mod.random_driver(), CLI_EAGER_STEPS,
                                    n_envs=N_ENVS)
    eager, rnd_eager_ms = timed_episode(torch, env, rollout_mod.random_driver(), CLI_EAGER_STEPS,
                                        n_envs=N_ENVS, eager=True)
    check_episodes_equal(torch, graphed, eager, f"cli random {N_ENVS}-env episode graphed vs eager")
    finals = graphed[1]["equity_delta"][-1].double().cpu() / config["initial_cash"]
    check(rnd["batch"]["num_envs"] == N_ENVS
          and rnd["batch"]["mean_total_return"] == float(finals.numpy().mean()),
          "cli random batch statistics vs the episode")
    diag["random"] = dict(steps=CLI_EAGER_STEPS, n_envs=N_ENVS, main_s=rnd_s,
                          graphed_ms_per_step=rnd_ms, eager_ms_per_step=rnd_eager_ms,
                          batch=rnd["batch"])

    # 6. IMPALA through main: one iteration with a checkpoint, then the
    # policy mode on it reproduces the held-out summary
    from gymfx_tpu_torch.config.flagship import impala_lstm_config

    impala_cfg = tmp / "impala_config.json"
    impala_config = impala_lstm_config(str(tape), timeframe="M1", eval_split=0.25)
    impala_cfg.write_text(json.dumps(impala_config))
    impala_dir = tmp / "impala"
    impala_iter = impala_config["num_envs"] * impala_config["impala_unroll"]
    imp, imp_s = cli("impala", "--mode", "training", "--checkpoint_dir", str(impala_dir),
                     "--train_total_steps", str(impala_iter), "--checkpoint_every", "1",
                     cfg=impala_cfg)
    itm = imp["train_metrics"]
    check(itm["iterations"] == 1 and itm["nonfinite_skips"] == 0.0
          and itm["last_checkpoint_step"] == impala_iter and imp["eval_scope"] == "held_out",
          f"cli impala train_metrics {itm}")
    for key in ("loss", "policy_loss", "value_loss", "entropy", "mean_rho"):
        check(math.isfinite(itm[key]), f"cli impala: {key} {itm[key]}")
    check(ckpt._list_steps(impala_dir) == [impala_iter]
          and ckpt.read_metadata(str(impala_dir)).get("policy") == "lstm",
          "cli impala checkpoint")
    imp_policy, imp_policy_s = cli("impala_policy", "--mode", "inference", "--driver_mode", "policy",
                                   "--checkpoint_dir", str(impala_dir), "--steps",
                                   str(eval_bars - 1), cfg=impala_cfg)
    for key in CLI_SUMMARY_KEYS:
        check(imp_policy[key] == imp[key], f"cli impala policy mode {key}: {imp_policy[key]} vs "
              f"{imp[key]}")
    print(f"cli impala: 1 iteration of {impala_config['num_envs']} envs x "
          f"{impala_config['impala_unroll']} steps (LSTM bf16, dd_penalized_reward) with a "
          f"checkpoint, {itm['env_steps_per_sec']:,.0f} env steps/s with the capture; held-out "
          f"total_return {imp['total_return']:.6g}, trades {imp['trades_total']}; {imp_s:.1f} s; "
          f"--driver_mode policy reproduces the held-out summary ({len(CLI_SUMMARY_KEYS)} numbers "
          f"equal), {imp_policy_s:.1f} s")
    print(f"cli diagnostic: buy_hold 1 env x {CLI_BARS - 1:,} steps {bh_ms:.4f} ms a step graphed "
          f"(main {bh_s:.1f} s), first {CLI_EAGER_STEPS} == the CPU's; random {N_ENVS} envs x "
          f"{CLI_EAGER_STEPS} steps {rnd_ms:.4f} ms a step graphed vs {rnd_eager_ms:.4f} eager "
          f"(torch.equal; main {rnd_s:.1f} s), batch {rnd['batch']}")
    results["cli"] = {
        "bars": CLI_BARS, "eval_bars": eval_bars, "iterations": CLI_ITERS,
        "checkpoint_steps": steps_on_disk, "state_mib": state_mb, "train_s": train_s,
        "resume_s": resume_s, "policy_s": policy_s, "train_metrics": tm,
        "held_out": {k: trained[k] for k in CLI_SUMMARY_KEYS},
        "evaluation": {"steps": eval_bars - 1, "ms_per_step": eval_ms,
                       "first_s": timing["first"], "replayed_s": timing["replayed"],
                       "capture_s": capture_s, "chunk_graphs": lengths,
                       "eager_ms_per_step": eager_ms,
                       "graphed_2048_ms_per_step": timing["graphed_2048"] * 1e3 / CLI_EAGER_STEPS,
                       "chunk_replay_launches": traced["evaluation chunk"]},
        "diagnostic": diag,
        "impala": {"train_s": imp_s, "policy_s": imp_policy_s, "train_metrics": itm,
                   "held_out": {k: imp[k] for k in CLI_SUMMARY_KEYS}},
    }


# ---------------------------------------------------------------- portfolio
def check_kernels_k2_k3_rows(torch, dev, kernels) -> None:
    """K2 and K3 with a param row per env (a portfolio's pair rows):
    equal to their plain versions (torch.equal) at PORTFOLIO_ROWS rows
    with three distinct param rows (cases.PAIR_PARAM_ROWS), every K2 flag
    combination and both rewards; then both param forms timed at N_ENVS
    rows, and the per-row form at N_ENVS * 3."""
    from gymfx_tpu_torch.core.types import EnvConfig
    from gymfx_tpu_torch.ops import cases, env_dynamics

    def ledger(cfg, seed, n):
        fields, mark, bars, advance, rng = cases.ledger_case(seed, n)
        st = cases.ledger_state(cfg, {**fields, **mark}, dev)
        o, h, l, c, acc = (torch.from_numpy(bars[k]).to(dev) for k in ("o", "h", "l", "c", "accrual"))
        adv, mark_pred, live = (torch.from_numpy(x).to(dev) for x in
                                (advance, rng.random(n) < 0.7, rng.random(n) < 0.8))
        return st, (o, h, l, c, acc if cfg.financing_enabled else None), adv, mark_pred, live

    combos = 0
    for n in PORTFOLIO_ROWS:
        p = cases.row_params(cases.PAIR_PARAM_ROWS, n, dev)
        for flags in cases.FLAG_GRID:
            for reward in cases.REWARDS:
                cfg = cases.flag_config(flags, reward, WINDOW)
                st, (o, h, l, c, acc), adv, mark, live = ledger(cfg, 100 + combos, n)
                ref = env_dynamics.fill_brackets_plain(st, o, h, l, c, acc, adv, cfg, p)
                ours = env_dynamics.fill_brackets(st._replace(exec_diag=st.exec_diag.clone()),
                                                  o, h, l, c, acc, adv, cfg, p)
                for field in ref._fields:
                    check(torch.equal(getattr(ours, field), getattr(ref, field)),
                          f"K2 per-row params != plain at {n} rows: {field} {cfg}")
                ours_st, ours_r = env_dynamics.mark_reward(st, c, mark, live, cfg, p)
                ref_st, ref_r = env_dynamics.mark_reward_plain(st, c, mark, live, cfg, p)
                check(torch.equal(ours_r, ref_r), f"K3 per-row params != plain at {n} rows: reward")
                for field in env_dynamics.MARK_OUT_FIELDS:
                    check(torch.equal(getattr(ours_st, field), getattr(ref_st, field)),
                          f"K3 per-row params != plain at {n} rows: {field} {cfg}")
                combos += 1
    torch.cuda.synchronize()
    print(f"kernels: K2 and K3 with a param row per env equal to plain (torch.equal) on "
          f"{combos} cases ({list(PORTFOLIO_ROWS)} rows x {len(cases.FLAG_GRID)} flag "
          f"combinations x {len(cases.REWARDS)} rewards, {len(cases.PAIR_PARAM_ROWS)} distinct "
          f"param rows)")
    # both forms, back to back, at the flagship's flags
    cfg = EnvConfig(window_size=WINDOW)
    for key in ("fill_brackets", "mark_reward"):
        kernels[key]["param_rows"] = {}
    for n in (N_ENVS, N_ENVS * 3):
        st, (o, h, l, c, _), adv, mark, live = ledger(cfg, 7, n)
        forms = {"rows": cases.row_params(cases.PAIR_PARAM_ROWS, n, dev)}
        if n == N_ENVS:
            forms["shared"] = cases.env_params({**cases.PARAM_SETS["plain"], **cases.MARK_PARAMS}, dev)
        fields2 = [getattr(st, k) for k in env_dynamics.FILL_FLOAT_FIELDS
                   + env_dynamics.FILL_BOOL_FIELDS + env_dynamics.FILL_INT_FIELDS]
        moved2 = 2 * nbytes(*fields2) + nbytes(o, h, l, adv) + 2 * n * st.exec_diag.element_size()
        moved3 = nbytes(*(getattr(st, k) for k in env_dynamics.MARK_FLOAT_FIELDS), c, mark, live) \
            + nbytes(*(getattr(st, k) for k in env_dynamics.MARK_OUT_FIELDS), st.pos)
        for form, p in forms.items():
            par2 = len(env_dynamics.FILL_PARAM_FIELDS) * 4 * (n if form == "rows" else 1)
            par3 = len(env_dynamics.MARK_PARAM_FIELDS) * 4 * (n if form == "rows" else 1)
            b2 = bound(moved2 + par2, OPS_PER_ITEM["fill_brackets"] * n, F32_FLOPS)
            b3 = bound(moved3 + par3, OPS_PER_ITEM["mark_reward"] * n, F32_FLOPS)
            row2 = dict(
                n=n, ms=device_ms(torch, lambda: env_dynamics.fill_brackets(
                    st, o, h, l, c, None, adv, cfg, p)),
                plain_ms=device_ms(torch, lambda: env_dynamics.fill_brackets_plain(
                    st, o, h, l, c, None, adv, cfg, p)),
                bound_ms=b2[0], bound_by=b2[1])
            row3 = dict(
                n=n, ms=device_ms(torch, lambda: env_dynamics.mark_reward(st, c, mark, live, cfg, p)),
                plain_ms=device_ms(torch, lambda: env_dynamics.mark_reward_plain(
                    st, c, mark, live, cfg, p)),
                bound_ms=b3[0], bound_by=b3[1])
            for key, row in (("fill_brackets", row2), ("mark_reward", row3)):
                kernels[key]["param_rows"][f"{form}_{n}"] = row
                print(f"  {key} params {form} at N = {n:,}: {row['ms'] * 1e3:.2f} us/call "
                      f"(plain {row['plain_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f} "
                      f"us by {row['bound_by']})")


def check_portfolio_param_rows(torch) -> dict:
    """baseline-portfolio-pbt's env with per-pair commission and slippage
    (``portfolio_param_overrides``), so that K2 and K3 take those params
    as (R,) columns and the rest as 0-d values: 4 steps over 256 books
    (the PBT's 768 rows), one K2 and one K3 launch a step, every output
    equal to the CPU's plain step (torch.equal).  The kernels alone meet
    their plain versions at 24,576 rows too (check_kernels_k2_k3_rows).  (Config 5 itself sets no per-pair values: its pairs
    share every param, and its steps launch with no per-row column.)"""
    import numpy as np

    from gymfx_tpu_torch.config.flagship import portfolio_pbt_config
    from gymfx_tpu_torch.core.portfolio import PortfolioEnvironment
    from gymfx_tpu_torch.ops import env_dynamics
    from gymfx_tpu_torch.resilience.guards import tree_leaves

    config = portfolio_pbt_config(str(ROOT), portfolio_param_overrides={
        "EUR_USD": {"commission": 2e-5, "slippage": 1e-5},
        "GBP_USD": {"commission": 5e-5, "slippage": 3e-5}})
    envs = {d: PortfolioEnvironment(config, device=d) for d in ("cpu", "cuda")}
    k2k3 = (env_dynamics.fill_brackets, env_dynamics.mark_reward)
    rng = np.random.default_rng(SEED)
    out = {}
    for books in (PORTFOLIO_ROWS[0] // 3,):
        pair = envs["cuda"].rows(books)[0].pair
        per_row = sorted(k for k in env_dynamics.FILL_PARAM_FIELDS + env_dynamics.MARK_PARAM_FIELDS
                         if getattr(pair, k).dim() == 1)
        check(per_row == ["commission", "slippage"],
              f"portfolio param rows: per-row params {per_row}, expected commission and slippage")
        states = {d: envs[d].reset(books)[0] for d in envs}
        for _ in range(4):
            actions = torch.from_numpy(rng.integers(0, 4, (books, 3)))
            before = count_launches(k2k3)
            stepped = {d: envs[d].step(states[d], actions.to(d)) for d in envs}
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in count_launches(k2k3).items()}
            check(launched == {"fill_brackets": 1, "mark_reward": 1},
                  f"portfolio param rows: {launched} launches in a step of {books * 3} rows")
            for a, b in zip(tree_leaves(stepped["cpu"]), tree_leaves(stepped["cuda"])):
                check(torch.equal(a, b.cpu()),
                      f"portfolio param rows: a step of {books * 3} rows != the CPU's plain step")
            states = {d: stepped[d][0] for d in envs}
        out[books * 3] = per_row
    print(f"portfolio param rows: 4 env steps at {list(out)} rows with per-pair commission and "
          f"slippage (per-row columns {per_row}, the other params 0-d) equal to the CPU's plain "
          f"step (torch.equal, every leaf), one K2 and one K3 launch a step")
    return {"rows": list(out), "per_row_params": per_row, "steps": 4}


def pbt_steps(torch, pbt, state, fitness, iters: int, eager: bool):
    """``iters`` population steps with exploit/explore after each
    ``pbt.pbt.interval``-th, as PBTTrainer.train runs them (its rng from
    SEED + 1): (state, fitness, replacements, per-step rows)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    rows, replaced = [], []
    for it in range(iters):
        t0 = time.perf_counter()
        state, metrics = pbt.trainer.train_step(state, eager=eager)
        torch.cuda.synchronize()
        rows.append(dict(step_ms=(time.perf_counter() - t0) * 1e3,
                         metrics={k: v.tolist() for k, v in metrics.items()}))
        decay = pbt.pbt.fitness_decay
        fitness = decay * fitness + (1 - decay) * metrics["mean_reward"].cpu().numpy().astype(
            np.float64)
        if (it + 1) % pbt.pbt.interval == 0:
            state, fitness, who = pbt._exploit_explore(state, fitness, rng)
            replaced.append(who)
    return state, fitness, replaced, rows


def phase_ms(torch, trainer, state, runs: int = 3) -> tuple:
    """``runs`` graphed rollout and update phases of ``trainer`` from
    ``state``, each ending in a synchronize: (median rollout ms, median
    update ms, both of the runs after the first; [(rollout, update) ms])."""
    rows = []
    for _ in range(runs):
        t0 = time.perf_counter()
        inter, out = trainer.rollout_phase(state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _ = trainer.update_phase(inter, out)
        torch.cuda.synchronize()
        rows.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    return (statistics.median(r for r, _ in rows[1:]), statistics.median(u for _, u in rows[1:]),
            rows)


def portfolio_phase(torch, kernels, results) -> None:
    """baseline-portfolio-pbt at full size: 3 population steps with one
    exploit/explore graphed against eager (torch.equal), K2 and K3 64
    launches each in one rollout replay for the whole population, no
    capture after the first step, env steps/s through the phases and
    through PBTTrainer.train; the same population under the
    transformer_ring policy (K4's f32 route): one step graphed == eager,
    K4's launches by name, K4 f32 timed at the path's shapes."""
    import numpy as np
    import torch.nn.functional as F

    from gymfx_tpu_torch.config.flagship import portfolio_pbt_config
    from gymfx_tpu_torch.core.portfolio import PortfolioEnvironment
    from gymfx_tpu_torch.ops import cases, env_dynamics
    from gymfx_tpu_torch.ops import fused_attention as fa
    from gymfx_tpu_torch.train.pbt import _pbt_config_from, make_portfolio_pbt

    results["portfolio_param_rows"] = check_portfolio_param_rows(torch)
    config = portfolio_pbt_config(str(ROOT))
    env = PortfolioEnvironment(config)
    pbt = make_portfolio_pbt(dict(config), _pbt_config_from(config), env)
    tr = pbt.trainer
    pcfg, members, pairs = tr.pcfg, pbt.pbt.population, env.cfg.n_pairs
    rows_n = members * pcfg.n_envs * pairs
    label = "portfolio pbt"
    state0, fitness0 = pbt.init_population(SEED)
    k2k3 = (env_dynamics.fill_brackets, env_dynamics.mark_reward)
    before = count_launches(k2k3)
    t0 = time.perf_counter()
    ga, fa_, rep_a, rows_a = pbt_steps(torch, pbt, copy_state(torch, state0), fitness0.copy(), 3,
                                       eager=False)
    graphed_s = time.perf_counter() - t0
    at_capture = {k: v - before[k] for k, v in count_launches(k2k3).items()}
    check(tr.captures() == 2, f"{label}: {tr.captures()} graphs captured, expected 2")
    # captured at step 1: 3 warm-ups and the capture, 64 steps each; steps
    # 2 and 3 replay (launch nothing from the host)
    check(at_capture == {"fill_brackets": 4 * pcfg.horizon, "mark_reward": 4 * pcfg.horizon},
          f"{label}: K2/K3 launches at capture {at_capture}")
    before = count_launches(k2k3)
    t0 = time.perf_counter()
    gb, fb_, rep_b, rows_b = pbt_steps(torch, pbt, copy_state(torch, state0), fitness0.copy(), 3,
                                       eager=True)
    eager_s = time.perf_counter() - t0
    eager_launches = {k: v - before[k] for k, v in count_launches(k2k3).items()}
    check(eager_launches == {"fill_brackets": 3 * pcfg.horizon, "mark_reward": 3 * pcfg.horizon},
          f"{label}: eager K2/K3 launches {eager_launches}, expected one each a step")
    check(rep_a == rep_b and len(rep_a) == 1, f"{label}: replaced {rep_a} graphed, {rep_b} eager")
    check(np.array_equal(fa_, fb_), f"{label}: fitness {fa_} graphed, {fb_} eager")
    check_same_state(torch, ga, gb, f"{label} 3 population steps with an exploit/explore")
    traced, _ = replay_launches(torch, first_graphs(tr), {
        "rollout": {"fill_brackets": pcfg.horizon, "mark_reward": pcfg.horizon}, "update": {}},
        label)
    print(f"{label}: graphed == eager (torch.equal, generator included) over 3 population steps "
          f"of {members} members x {pcfg.n_envs} envs x {pairs} pairs ({rows_n} rows) with one "
          f"exploit/explore (replaced {rep_a[0]}); K2/K3 one launch a step for every row: "
          f"{traced['rollout']['fill_brackets']} and {traced['rollout']['mark_reward']} in one "
          f"rollout replay (profiler trace, {traced['rollout']['all']} kernels), "
          f"{traced['update']['all']} kernels in an update replay; 3 steps {graphed_s:.1f} s "
          f"graphed (the first captures), {eager_s:.1f} s eager")
    # the phases' times, graphed, from the state after those steps
    roll_ms, upd_ms, _ = phase_ms(torch, tr, ga)
    step_ms = statistics.median(r["step_ms"] for r in rows_a[1:])
    per_iter = members * pcfg.n_envs * pcfg.horizon
    t0 = time.perf_counter()
    result = pbt.train(int(config["train_total_steps"]), seed=SEED)
    train_s = time.perf_counter() - t0
    check(tr.captures() == 2, f"{label}: PBTTrainer.train captured again ({tr.captures()} graphs)")
    check(result["iterations"] == int(config["train_total_steps"]) // per_iter,
          f"{label}: {result['iterations']} iterations")
    check(all(math.isfinite(x) for x in result["fitness"]), f"{label}: fitness {result['fitness']}")
    results["portfolio_pbt"] = dict(
        rows=rows_n, graphed_steps=rows_a, eager_steps=rows_b, launches_at_capture=at_capture,
        replay_launches=traced, rollout_ms=roll_ms, update_ms=upd_ms, step_ms=step_ms,
        phases_env_steps_per_s=per_iter / (roll_ms + upd_ms) * 1e3,
        step_env_steps_per_s=per_iter / step_ms * 1e3,
        train_env_steps_per_s=result["env_steps_per_sec"], train_s=train_s,
        train_iterations=result["iterations"], replacements=result["replacements"],
        capture_s=capture_seconds(tr))
    print(f"{label}: rollout replay {roll_ms:.1f} ms, update replay {upd_ms:.1f} ms (medians of "
          f"2 of 3), train step {step_ms:.1f} ms: {per_iter / (roll_ms + upd_ms) * 1e3:,.0f} env "
          f"steps/s through the phases; PBTTrainer.train {result['iterations']} population steps "
          f"({result['total_env_steps']:,} env steps) {train_s:.1f} s, "
          f"{result['env_steps_per_sec']:,.0f} env steps/s, no capture; replacements "
          f"{result['replacements']}; {results['device']['nvidia_smi']}")
    del pbt, tr, ga, gb, state0
    gc.collect()
    torch.cuda.empty_cache()

    # ---- transformer_ring on the portfolio: K4's f32 window kernels
    from gymfx_tpu_torch.profile_attention import f32_window_probes

    config = portfolio_pbt_config(str(ROOT), policy="transformer_ring")
    pbt = make_portfolio_pbt(dict(config), _pbt_config_from(config), env)
    tr = pbt.trainer
    label = "portfolio ring"
    state0, _ = pbt.init_population(SEED)
    k4 = (fa.attention_forward, fa.attention_backward)
    before = count_launches(k4)
    ga, ma = tr.train_step(copy_state(torch, state0))
    torch.cuda.synchronize()
    at_capture = {k: v - before[k] for k, v in count_launches(k4).items()}
    gb, mb = tr.train_step(copy_state(torch, state0), eager=True)
    check_same_state(torch, ga, gb, f"{label} one population step")
    check_same(torch, ma, mb, f"{label} metrics")
    layers = len(tr.policy.encoder.layers)
    updates = pcfg.epochs * pcfg.minibatches
    fwd_roll = layers * (pcfg.horizon + 1)
    traced, names = replay_launches(torch, first_graphs(tr), {
        "rollout": {"fill_brackets": pcfg.horizon, "mark_reward": pcfg.horizon,
                    "attention_forward": fwd_roll},
        "update": {"attention_forward": layers * updates}}, label)
    f32_bwd = sum("attn_bwd_window" in n for n in names["update"])
    f32_fwd = sum("attn_fwd_window" in n for n in names["rollout"] + names["update"])
    check(f32_bwd == layers * updates, f"{label}: {f32_bwd} f32 backward kernels in an update replay")
    check(f32_fwd == fwd_roll + layers * updates, f"{label}: {f32_fwd} f32 forward kernels")
    print(f"{label}: one population step graphed == eager (torch.equal); K4 f32 in one rollout "
          f"replay {traced['rollout']['attention_forward']} forwards, in one update replay "
          f"{traced['update']['attention_forward']} forwards and {f32_bwd} backwards "
          f"(attn_fwd_window / attn_bwd_window by name); at capture {at_capture}")
    # the ring twin's phases, graphed, beside the transformer twin's above
    ring_roll, ring_upd, ring_rows = phase_ms(torch, tr, ga)
    print(f"{label}: rollout replay {ring_roll:.1f} ms, update replay {ring_upd:.1f} ms (medians of "
          f"2 of 3): {per_iter / (ring_roll + ring_upd) * 1e3:,.0f} env steps/s through the "
          f"phases; the transformer twin in this call {roll_ms:.1f} and {upd_ms:.1f} ms, "
          f"{per_iter / (roll_ms + upd_ms) * 1e3:,.0f} env steps/s")
    # K4's f32 window kernels at this path's shapes: the rollout's books
    # and an update minibatch's samples, members folded into the batch
    heads, d_model = tr.policy.encoder.layers[0].n_heads, tr.policy.encoder.pos_embed.shape[1]
    mb_samples = members * (pcfg.n_envs // pcfg.minibatches) * pcfg.horizon
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timed = {}
    for name, b in (("rollout", members * pcfg.n_envs), ("update", mb_samples)):
        shape = (b, env.cfg.window_size, heads, d_model // heads)
        check(fa.f32_kernels(shape) == "window", f"{label}: {shape} does not take the window kernels")
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
        bsz, s, h, d = shape
        pairs_qk = bsz * h * s * s
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # forward and dq/dk/dv against the plain versions and the
        # emulation, the backward repeated bitwise
        err, bwd_err = check_k4_case(torch, fa, cases, q, k, v, g, False)
        for key, e in (("forward", err), ("backward", bwd_err)):
            kernels[f"attention_{key}"]["max_abs_err"] = max(
                kernels[f"attention_{key}"]["max_abs_err"], e)
        leaves = [x.detach().clone().requires_grad_(True) for x in (qt, kt, vt)]
        lib_out = F.scaled_dot_product_attention(*leaves)
        gt = g.transpose(1, 2)
        fb, fby = bound(4 * nbytes(q), 4 * d * pairs_qk, F32_FLOPS)
        bb, bby = bound(7 * nbytes(q), 10 * d * pairs_qk, F32_FLOPS)
        probes = f32_window_probes(q, k, v, g)
        timed[name] = {
            "shape": list(shape),
            "forward": dict(ms=device_ms(torch, lambda: fa.attention_forward(q, k, v)),
                            plain_ms=event_ms(torch, lambda: fa.attention_forward_plain(q, k, v)),
                            library_ms=event_ms(torch, lambda: F.scaled_dot_product_attention(
                                qt, kt, vt), reps=10),
                            bound_ms=fb, bound_by=fby, max_abs_err=err,
                            skeleton_ms=probes["skeleton_forward_ms"],
                            launch_floor_ms=probes["launch_floor_forward_ms"],
                            grid=probes["grid_forward"],
                            host_us=host_us(torch, lambda: fa.attention_forward(q, k, v)),
                            earlier_us=K4_F32_EARLIER_US[name]["forward"]),
            "backward": dict(ms=device_ms(torch, lambda: fa.attention_backward(q, k, v, g)),
                             plain_ms=event_ms(torch, lambda: fa.attention_backward_plain(q, k, v, g)),
                             library_ms=event_ms(torch, lambda: torch.autograd.grad(
                                 lib_out, leaves, gt, retain_graph=True), reps=10),
                             bound_ms=bb, bound_by=bby, max_abs_err=bwd_err,
                             skeleton_ms=probes["skeleton_backward_ms"],
                             launch_floor_ms=probes["launch_floor_backward_ms"],
                             grid=probes["grid_backward"],
                             host_us=host_us(torch, lambda: fa.attention_backward(q, k, v, g)),
                             earlier_us=K4_F32_EARLIER_US[name]["backward"]),
        }
        for key in ("forward", "backward"):
            row = timed[name][key]
            print(f"  K4 f32 {key} at the portfolio {name} shape {shape}: {row['ms'] * 1e3:.1f} us "
                  f"(earlier, the streamed kernel: {row['earlier_us'][0]}-{row['earlier_us'][1]} us; "
                  f"plain {row['plain_ms'] * 1e3:.1f} us, SDPA {row['library_ms'] * 1e3:.1f} us, "
                  f"bound {row['bound_ms'] * 1e3:.1f} us by {row['bound_by']}; memory skeleton "
                  f"{row['skeleton_ms'] * 1e3:.1f} us, launch floor "
                  f"{row['launch_floor_ms'] * 1e3:.2f} us at {row['grid']}, wrapper host "
                  f"{row['host_us']:.1f} us)")
        del q, k, v, g, qt, kt, vt, leaves, lib_out, gt
    for key in ("forward", "backward"):
        kernels[f"attention_{key}"]["portfolio_f32"] = {
            name: dict(timed[name][key], shape=timed[name]["shape"]) for name in timed}
    kernels["attention_forward"]["portfolio_f32"]["launches"] = {
        "rollout_replay": traced["rollout"]["attention_forward"],
        "update_replay": traced["update"]["attention_forward"]}
    kernels["attention_backward"]["portfolio_f32"]["launches"] = {"update_replay": f32_bwd}
    results["portfolio_ring"] = dict(
        replay_launches=traced, at_capture=at_capture, capture_s=capture_seconds(tr), k4_f32=timed,
        rollout_ms=ring_roll, update_ms=ring_upd, phase_rows=ring_rows,
        phases_env_steps_per_s=per_iter / (ring_roll + ring_upd) * 1e3,
        transformer_rollout_ms=roll_ms, transformer_update_ms=upd_ms)
    del pbt, tr, ga, gb, state0
    gc.collect()
    torch.cuda.empty_cache()


def portfolio_cli_phase(torch, results, tmp) -> None:
    """The command line on the portfolio: ``main --trainer portfolio`` on
    portfolio-transformer-train for 2 iterations with a checkpoint each,
    ``--driver_mode policy`` on that checkpoint (the held-out summary
    again), and ``main --trainer pbt`` on baseline-portfolio-pbt with
    ``eval_split`` (the best member's held-out summary)."""
    from gymfx_tpu_torch.app.main import main as cli_main
    from gymfx_tpu_torch.config.flagship import portfolio_pbt_config, portfolio_transformer_config
    from gymfx_tpu_torch.train import checkpoint as ckpt

    tmp = pathlib.Path(tmp) / "portfolio_cli"
    tmp.mkdir()

    def cli(name, config, *argv):
        cfg_file = tmp / f"{name}_config.json"
        cfg_file.write_text(json.dumps(config))
        t0 = time.perf_counter()
        out = cli_main(["--load_config", str(cfg_file), "--results_file", str(tmp / f"{name}.json"),
                        "--save_config", str(tmp / "saved_config.json"), "--quiet_mode", *argv])
        torch.cuda.synchronize()
        check(json.loads((tmp / f"{name}.json").read_text())
              == json.loads(json.dumps(out, default=str)), f"cli {name}: results file != summary")
        return out, time.perf_counter() - t0

    config = portfolio_transformer_config(str(ROOT), eval_split=0.3)
    per_iter = config["num_envs"] * config["ppo_horizon"]
    ck = tmp / "portfolio_ck"
    trained, train_s = cli("portfolio_train", config, "--checkpoint_dir", str(ck),
                           "--train_total_steps", str(2 * per_iter), "--checkpoint_every", "1")
    check(trained["trainer"] == "portfolio_ppo" and trained["eval_scope"] == "held_out",
          f"cli portfolio: {trained.get('trainer')} {trained.get('eval_scope')}")
    tm = trained["train_metrics"]
    check(tm["iterations"] == 2 and tm["last_checkpoint_step"] == 2 * per_iter, f"cli portfolio {tm}")
    for key in ("loss", "policy_loss", "value_loss", "entropy"):
        check(math.isfinite(tm[key]), f"cli portfolio training: {key} {tm[key]}")
    steps_on_disk = ckpt._list_steps(ck)
    check(steps_on_disk == [per_iter, 2 * per_iter], f"cli portfolio checkpoint steps {steps_on_disk}")
    policy = dict(config, mode="inference", driver_mode="policy", policy=None)
    evaluated, eval_s = cli("portfolio_policy", policy, "--checkpoint_dir", str(ck),
                            "--steps", str(trained["eval_bars"] - 1))
    for key in CLI_SUMMARY_KEYS + ("pairs",):
        check(evaluated.get(key) == trained.get(key),
              f"cli portfolio policy mode: {key} {evaluated.get(key)} != training's {trained.get(key)}")
    print(f"cli portfolio: main --trainer portfolio (portfolio-transformer-train, "
          f"{config['num_envs']} envs x {config['ppo_horizon']} steps x 3 pairs) 2 iterations, "
          f"checkpoints {steps_on_disk}, held-out total_return {trained['total_return']:.6g} on "
          f"{trained['eval_bars']} bars, {tm['env_steps_per_sec']:,.0f} env steps/s, {train_s:.1f} s; "
          f"--driver_mode policy reproduces the held-out summary, {eval_s:.1f} s")
    # 4 population steps (2 exploit/explore): the portfolio phase trains
    # the full 12 through PBTTrainer.train
    config = portfolio_pbt_config(str(ROOT), eval_split=0.3)
    pbt_steps_n = 4 * config["pbt_population"] * config["num_envs"] * config["ppo_horizon"]
    out, pbt_s = cli("pbt_train", config, "--train_total_steps", str(pbt_steps_n))
    check(out["trainer"] == "pbt_portfolio" and out["eval_scope"] == "held_out"
          and "in_sample" in out, f"cli pbt: {out.get('trainer')} {out.get('eval_scope')}")
    pbt = out["pbt"]
    check(pbt["population"] == 4 and len(pbt["fitness"]) == 4 and 0 <= pbt["best_member"] < 4
          and pbt["iterations"] == 4, f"cli pbt: {pbt}")
    for key in CLI_SUMMARY_KEYS:
        check(key in out, f"cli pbt results lack {key!r}")
    print(f"cli pbt: main --trainer pbt (baseline-portfolio-pbt, eval_split 0.3) "
          f"{pbt['iterations']} population steps, {pbt['env_steps_per_sec']:,.0f} env steps/s, "
          f"best member {pbt['best_member']}, held-out total_return {out['total_return']:.6g}, "
          f"{pbt_s:.1f} s")
    results["portfolio_cli"] = dict(train_s=train_s, eval_s=eval_s, pbt_s=pbt_s,
                                    train_metrics=tm, pbt=pbt)


def configs_phase(torch, kernels, results, tmp) -> None:
    """The shipped configs through main on the card, the
    financed profile at flagship width, the GA graphed against eager and
    the portfolio with a profile per pair and financing."""
    import os

    import numpy as np

    from gymfx_tpu_torch.app.main import main as cli_main
    from gymfx_tpu_torch.config import DEFAULT_VALUES
    from gymfx_tpu_torch.config.flagship import lob_config
    from gymfx_tpu_torch.core import rollout as rollout_mod
    from gymfx_tpu_torch.core.portfolio import PortfolioEnvironment
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.ops import cases, env_dynamics
    from gymfx_tpu_torch.resilience.guards import tree_leaves
    from gymfx_tpu_torch.train import optimize

    tmp = pathlib.Path(tmp) / "configs"
    tmp.mkdir()
    out = results["configs"] = {}
    k2k3 = (env_dynamics.fill_brackets, env_dynamics.mark_reward)

    # 1. the shipped configs through main, from the checkout's root (their
    # paths are relative to it)
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        shipped = {}
        for name in SHIPPED_CONFIGS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = cli_main(["--load_config", f"examples/configs/{name}.json",
                                "--results_file", str(tmp / f"{name}.json"),
                                "--save_config", str(tmp / f"{name}_config.json"), "--quiet_mode"])
            torch.cuda.synchronize()
            shipped[name] = (summary, time.perf_counter() - t0)
    finally:
        os.chdir(cwd)
    fin, fin_s = shipped["inference_financed_profile"]
    check(math.isfinite(fin["final_equity"]) and fin["action_diagnostics"]["steps"] == 400,
          f"financed profile: {fin.get('final_equity')}")
    ga, ga_s = shipped["optimize_atr"]
    check(sorted(ga["best_params"]) == ["atr_period", "k_sl", "k_tp"]
          and math.isfinite(ga["best_rap"]) and len(ga["history"]) == 12
          and [s["atr_period"] for s in ga["atr_period_sweep"]] == [7, 14, 21, 30]
          and ga["population"] == 64, f"optimize_atr: {ga.get('best_params')}")
    xc, xc_s = shipped["inference_verified_execution"]
    xc = xc["execution_crosscheck"]
    check(xc.get("status") != "skipped" and xc["within_bound"]
          and xc["divergence"] <= xc["quantization_bound"] and xc["replay_fills"] > 20,
          f"verified execution: {xc}")
    print(f"configs: inference_financed_profile final balance {fin['final_equity']!r} "
          f"({fin_s:.2f} s); optimize_atr best_params {ga['best_params']}, best_rap "
          f"{ga['best_rap']!r}, selection_signal {ga['selection_signal']}, the best period's "
          f"wall {ga['wall_seconds']:.3f} s of which capture {ga['capture_seconds']:.3f} s, "
          f"main {ga_s:.2f} s for the 4 periods; inference_verified_execution divergence "
          f"{xc['divergence']!r} within its bound {xc['quantization_bound']!r}, "
          f"{xc['replay_fills']} replay fills ({xc_s:.2f} s)")
    out["shipped"] = {
        "financed_final_equity": fin["final_equity"], "financed_s": fin_s,
        "ga": {k: ga[k] for k in ("best_params", "best_rap", "selection_signal", "wall_seconds",
                                  "capture_seconds")} | {"main_s": ga_s},
        "verified": {k: xc[k] for k in ("divergence", "quantization_bound", "replay_fills",
                                        "scan_trades")} | {"main_s": xc_s},
    }

    # 2. the financed profile at flagship width over the cli phase's tape
    tape = tmp / "eurusd_m1.csv"
    cases.write_bar_csv(tape, cases.tick_walk_columns(CLI_BARS, seed=SEED, level=1.10),
                        cases.m1_week_grid(CLI_BARS))
    config = dict(DEFAULT_VALUES, input_data_file=str(tape), timeframe="M1",
                  execution_cost_profile=str(ROOT / PESSIMISTIC),
                  financing_rate_data_file=str(ROOT / RATES), position_size=1000.0,
                  initial_cash=100000.0, venue_quantization=True)
    env = Environment(config)
    check(env.cfg.financing_enabled and float(env.params.price_tick) > 0
          and float(env.params.min_qty) == 1.0, "financed config: financing or quantization off")
    accrual = env.data.rollover_accrual.cpu().numpy().astype(np.float64)
    rollover = np.flatnonzero(accrual)
    check(len(rollover) >= 20 and rollover[0] == 1320,
          f"financed tape: rollover bars {rollover[:4]} ({len(rollover)})")
    (state, trace), one_ms = timed_episode(torch, env, rollout_mod.buy_hold_driver(),
                                           BUY_HOLD_STEPS)
    bar = trace["bar_index"][:, 0].cpu().numpy().astype(np.int64) - 1
    pos = trace["pos_units"][:, 0].cpu().numpy().astype(np.float64)
    close = env.data.close.cpu().numpy().astype(np.float64)
    cash = trace["equity_delta"][:, 0].cpu().numpy().astype(np.float64) - pos * close[bar]
    step = np.arange(2, len(bar))
    moves = np.abs(np.diff(cash))[1:]
    expected = pos[step] * close[bar[step]] * accrual[bar[step]]
    moved = step[moves > 1e-2]
    want = step[expected != 0.0]
    check(len(want) == 5 and moved.tolist() == want.tolist(),
          f"financed buy_hold: cash moved at steps {moved[:6]}, rollover steps {want[:6]}")
    check(float(np.max(np.abs(moves[expected != 0.0] - np.abs(expected[expected != 0.0]))))
          < 1e-3, "financed buy_hold: a rollover's cash move is not the rate table's amount")

    wide = Environment(config)
    for fn in k2k3:
        fn.launches = 0
    graphed, graphed_ms = timed_episode(torch, wide, rollout_mod.random_driver(), FINANCED_STEPS,
                                        seed=SEED, n_envs=N_ENVS)
    launches = count_launches(k2k3)
    replayed, replay_ms = timed_episode(torch, wide, rollout_mod.random_driver(), FINANCED_STEPS,
                                        seed=SEED, n_envs=N_ENVS)
    eager, eager_ms = timed_episode(torch, wide, rollout_mod.random_driver(), FINANCED_STEPS,
                                    seed=SEED, n_envs=N_ENVS, eager=True)
    check_episodes_equal(torch, graphed, eager, "financed episode graphed vs eager")
    check_episodes_equal(torch, replayed, eager, "financed episode replayed vs eager")
    chunk = next(g for k, g in wide.episode_graphs.graphs.items() if k[0] == 64)
    traced, names = replay_launches(torch, {"financed chunk": chunk},
                                    {"financed chunk": {"fill_brackets": 64, "mark_reward": 64}},
                                    "configs")
    financed_k2 = sum("fill_brackets_kernel<false, true, false>" in n
                      for n in names["financed chunk"])
    check(financed_k2 == 64, f"financed chunk: {financed_k2} launches of K2's financing "
          "instantiation <false, true, false> by name, expected 64")
    # K2 alone on the first rollover bar at every env's state
    st = graphed[0]
    r = int(rollover[0])
    o, h, l, c = (getattr(wide.data, k)[r].expand(N_ENVS).contiguous()
                  for k in ("open", "high", "low", "close"))
    acc = wide.data.rollover_accrual[r].expand(N_ENVS).contiguous()
    adv = torch.ones(N_ENVS, dtype=torch.bool, device="cuda")
    cfg, params = wide.cfg, wide.params
    ref = env_dynamics.fill_brackets_plain(st, o, h, l, c, acc, adv, cfg, params)
    ours = env_dynamics.fill_brackets(st._replace(exec_diag=st.exec_diag.clone()),
                                      o, h, l, c, acc, adv, cfg, params)
    for field in ref._fields:
        check(torch.equal(getattr(ours, field), getattr(ref, field)),
              f"K2 financed at real rates != plain: {field}")
    check(bool((ref.cash_delta != st.cash_delta).any()), "K2 financed: no cash moved")
    fields2 = [getattr(st, k) for k in env_dynamics.FILL_FLOAT_FIELDS
               + env_dynamics.FILL_BOOL_FIELDS + env_dynamics.FILL_INT_FIELDS]
    moved2 = 2 * nbytes(*fields2) + nbytes(o, h, l, c, acc, adv) + 2 * N_ENVS * 4
    b2 = bound(moved2, OPS_PER_ITEM["fill_brackets"] * N_ENVS, F32_FLOPS)
    row = dict(n=N_ENVS, flags="<false, true, false> (financing), quantized",
               ms=device_ms(torch, lambda: env_dynamics.fill_brackets(
                   st, o, h, l, c, acc, adv, cfg, params)),
               plain_ms=device_ms(torch, lambda: env_dynamics.fill_brackets_plain(
                   st, o, h, l, c, acc, adv, cfg, params)),
               bound_ms=b2[0], bound_by=b2[1], chunk_replay_launches=financed_k2)
    kernels["fill_brackets"]["financed"] = row
    print(f"configs: financed profile (pessimistic_v1, the smoke rates, venue quantization) over "
          f"{CLI_BARS:,} M1 bars, {len(rollover)} rollover bars (first {r}): 1 env buy_hold "
          f"{BUY_HOLD_STEPS:,} steps {one_ms:.4f} ms a step, cash moved on exactly the {len(want)} "
          f"rollover steps by the table's amount; {N_ENVS:,} envs x {FINANCED_STEPS:,} steps "
          f"random: {launches} launches at capture, graphed {replay_ms:.4f} ms a step (first run "
          f"{graphed_ms:.4f}), eager {eager_ms:.4f} (graphed == eager, torch.equal); one chunk "
          f"replay {traced['financed chunk']}, K2<false, true, false> by name {financed_k2}; K2 "
          f"at the rollover bar == plain (torch.equal): {row['ms'] * 1e3:.2f} us/call (plain "
          f"{row['plain_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f} us by "
          f"{row['bound_by']})")
    out["financed"] = {"rollover_bars": len(rollover), "one_env_ms_per_step": one_ms,
                       "wide_ms_per_step": replay_ms, "wide_first_ms_per_step": graphed_ms,
                       "wide_eager_ms_per_step": eager_ms, "chunk_replay": traced,
                       "k2": row}

    # 3. the GA's population graphed against eager, tuning k_sl and
    # commission (a per-row column of K2's params) so that the candidates
    # score apart; a second generation's values are copied into the same
    # buffers and replayed
    opt_config = {**DEFAULT_VALUES,
                  **json.loads((ROOT / "examples" / "configs" / "optimize_atr.json").read_text()),
                  "input_data_file": str(ROOT / "examples" / "data" / "eurusd_sample.csv"),
                  "atr_period": 14, "optimize_params": GA_SCHEMA}
    ga_env = Environment(opt_config)
    schema = optimize.hparam_schema(opt_config)
    lo, hi = zip(*GA_SCHEMA.values())
    ga_ms, fits = {}, {}
    opts = {eager: optimize.Optimizer(ga_env, schema, population=64, episode_steps=500,
                                      eager=eager) for eager in (False, True)}
    for gen in range(2):
        pop = np.random.default_rng(SEED + gen).uniform(lo, hi, size=(64, 2))
        for run, eager in (("graphed", False), ("replayed", False), ("eager", True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fits[gen, run] = [x.clone() for x in opts[eager]._fitness(pop, 3)]
            torch.cuda.synchronize()
            ga_ms[f"{run} {gen}"] = (time.perf_counter() - t0) * 1e3
        for run in ("graphed", "replayed"):
            for name, a, b in zip(("rap", "total_return", "dd", "trades"), fits[gen, run],
                                  fits[gen, "eager"]):
                check(torch.equal(a, b), f"GA generation {gen} fitness {run} != eager: {name}")
        distinct = len(set(fits[gen, "eager"][0].tolist()))
        check(distinct > 1, f"GA generation {gen}: the 64 candidates' rap take {distinct} value")
    check(not torch.equal(fits[0, "graphed"][0], fits[1, "graphed"][0]),
          "GA: the second generation's fitness equals the first's")
    check(sorted(k[0] for k in ga_env.episode_graphs.graphs) == [52, 64],
          f"GA chunk graphs {sorted(ga_env.episode_graphs.graphs)}: recaptured")
    per_row = sorted(k for k in env_dynamics.FILL_PARAM_FIELDS
                     if getattr(opts[False]._episodes[3].params, k).dim() == 1)
    check(per_row == ["commission"], f"GA: K2's per-row params {per_row}")
    ga_chunk = next(g for k, g in ga_env.episode_graphs.graphs.items() if k[0] == 64)
    ga_traced, _ = replay_launches(torch, {"GA chunk": ga_chunk},
                                   {"GA chunk": {"fill_brackets": 64, "mark_reward": 64}},
                                   "configs GA")
    ga_capture = sum(g.capture_s for g in ga_env.episode_graphs.graphs.values())
    print(f"configs: GA population of 64 x 500 steps over {schema}: generation 0 graphed "
          f"{ga_ms['replayed 0']:.2f} ms (first {ga_ms['graphed 0']:.2f} ms with "
          f"{ga_capture:.2f} s of capture), eager {ga_ms['eager 0']:.2f} ms; generation 1 from "
          f"the same graphs {ga_ms['graphed 1']:.2f} ms; fitness graphed == eager in both "
          f"(torch.equal), {len(set(fits[0, 'eager'][0].tolist()))} and "
          f"{len(set(fits[1, 'eager'][0].tolist()))} distinct rap values, per-row {per_row}; "
          f"one chunk replay {ga_traced['GA chunk']}")
    out["ga_population"] = {"generation_ms": ga_ms, "capture_s": ga_capture,
                            "chunk_replay": ga_traced, "per_row_params": per_row}

    # 3b. the LOB venue with financing: the venue's plain accrual after its
    # kernels, graphed against eager, and against the same episode without
    # financing (the positions equal, the equity apart by the accrual on
    # the rollover step alone)
    lob_tape = tmp / "eurusd_lob.csv"
    cases.write_bar_csv(lob_tape, cases.tick_walk_columns(LOB_FIN_BARS, seed=SEED, level=1.10),
                        cases.m1_week_grid(LOB_FIN_BARS, start="2024-01-31T21:20"))
    lob_envs = {fin: Environment(lob_config(str(lob_tape), timeframe="M1", financing_enabled=fin,
                                            financing_rate_data_file=str(ROOT / RATES)))
                for fin in (True, False)}
    lob_acc = lob_envs[True].data.rollover_accrual.cpu().numpy().astype(np.float64)
    check(np.flatnonzero(lob_acc).tolist() == [40], f"LOB tape rollovers {np.flatnonzero(lob_acc)}")
    lob_run, lob_ms = {}, {}
    for run, fin, eager in (("graphed", True, False), ("eager", True, True),
                            ("unfinanced", False, True)):
        lob_run[run], lob_ms[run] = timed_episode(
            torch, lob_envs[fin], rollout_mod.random_driver(), LOB_FIN_STEPS, seed=SEED,
            n_envs=LOB_FIN_ENVS, eager=eager)
    check_episodes_equal(torch, lob_run["graphed"], lob_run["eager"],
                         "LOB financed episode graphed vs eager")
    fin_trace, plain_trace = lob_run["graphed"][1], lob_run["unfinanced"][1]
    check(torch.equal(fin_trace["pos_units"], plain_trace["pos_units"]),
          "LOB financed episode: positions differ from the unfinanced episode's")
    lbar = fin_trace["bar_index"].long() - 1
    lpos = fin_trace["pos_units"].double()
    lexpected = (lpos * lob_envs[True].data.close.double()[lbar] * lob_envs[True]
                 .data.rollover_accrual.double()[lbar]).cpu().numpy()
    gap = (fin_trace["equity_delta"].double() - plain_trace["equity_delta"].double()).cpu().numpy()
    jumps = np.diff(gap, axis=0, prepend=0.0)
    lob_steps = sorted(set(np.nonzero(lexpected)[0].tolist()))
    # an accrual is ~1e-3 on the venue's 40 units, a step's float32
    # ledger noise a few 1e-6
    check(len(lob_steps) == 1 and np.count_nonzero(np.abs(lexpected) > 2e-4) > LOB_FIN_ENVS // 4,
          f"LOB financed episode: rollover steps {lob_steps}, "
          f"{np.count_nonzero(lexpected)} envs holding")
    check(float(np.max(np.abs(jumps - lexpected))) < 5e-5,
          "LOB financed episode: the equity moved apart from the rollover's accrual")
    print(f"configs: LOB venue (flagship-lob-train's book) with financing, {LOB_FIN_ENVS:,} envs x "
          f"{LOB_FIN_STEPS} random steps over a tape whose rollover is bar 40: graphed == eager "
          f"(torch.equal), {np.count_nonzero(lexpected)} envs' equity moved by the accrual on step "
          f"{lob_steps[0]} alone against the unfinanced episode; {lob_ms['graphed']:.4f} ms a step "
          f"graphed with its capture, eager {lob_ms['eager']:.4f}")
    out["lob_financed"] = {"envs": LOB_FIN_ENVS, "steps": LOB_FIN_STEPS,
                           "rollover_step": lob_steps[0],
                           "envs_accrued": int(np.count_nonzero(lexpected)), "ms_per_step": lob_ms}

    # 4. the portfolio with a profile per pair and financing
    pess = json.loads((ROOT / PESSIMISTIC).read_text())
    files, start = {}, "2024-01-31T21:40"
    for i, (pair, level, tick) in enumerate((("EUR_USD", 1.10, 1e-5), ("GBP_USD", 1.27, 1e-5),
                                             ("USD_JPY", 148.0, 1e-3))):
        files[pair] = str(tmp / f"{pair}.csv")
        cases.write_bar_csv(files[pair], cases.tick_walk_columns(PAIR_BARS, seed=SEED + i,
                                                                 level=level, tick=tick),
                            cases.m1_week_grid(PAIR_BARS, start=start))
    pconfig = dict(DEFAULT_VALUES, portfolio_files=files, timeframe="M1", window_size=WINDOW,
                   financing_rate_data_file=str(ROOT / RATES), position_size=1000.0,
                   initial_cash=100000.0,
                   portfolio_profiles={"EUR_USD": pess,
                                       "GBP_USD": dict(pess, commission_rate_per_side=1e-4),
                                       "USD_JPY": dict(pess, full_spread_rate=6e-4)})
    penvs = {d: PortfolioEnvironment(pconfig, device=d) for d in ("cpu", "cuda")}
    pair = penvs["cuda"].rows(PAIR_BOOKS)[0].pair
    per_row = sorted(k for k in env_dynamics.FILL_PARAM_FIELDS if getattr(pair, k).dim() == 1)
    check(per_row == ["commission", "slippage"], f"per-pair profiles: per-row params {per_row}")
    stride = penvs["cuda"].data.stride
    pair_acc = penvs["cuda"].data.pair.rollover_accrual.cpu().numpy().reshape(3, stride)
    check([np.flatnonzero(a).tolist() for a in pair_acc] == [[20]] * 3
          and len({float(a[20]) for a in pair_acc}) == 3,
          "per-pair financing: each pair's accrual column must hold its own rate at bar 20")
    rng = np.random.default_rng(SEED)
    states = {d: penvs[d].reset(PAIR_BOOKS)[0] for d in penvs}
    for _ in range(PAIR_STEPS):
        actions = torch.from_numpy(rng.integers(0, 4, (PAIR_BOOKS, 3)))
        before = count_launches(k2k3)
        stepped = {d: penvs[d].step(states[d], actions.to(d)) for d in penvs}
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in count_launches(k2k3).items()}
        check(launched == {"fill_brackets": 1, "mark_reward": 1},
              f"per-pair profiles: {launched} launches in a step of {PAIR_BOOKS * 3} rows")
        for a, b in zip(tree_leaves(stepped["cpu"]), tree_leaves(stepped["cuda"])):
            check(torch.equal(a, b.cpu()), "per-pair profiles and financing: a step of "
                  f"{PAIR_BOOKS * 3} rows != the CPU's plain step")
        states = {d: stepped[d][0] for d in penvs}
    print(f"configs: portfolio with a profile per pair and financing, {PAIR_BOOKS} books x 3 "
          f"pairs for {PAIR_STEPS} steps over a rollover at bar 20 (per-row {per_row}, each "
          f"pair's accrual row): every leaf == the CPU's plain step (torch.equal), one K2 and "
          f"one K3 launch a step")
    out["portfolio_profiles"] = {"rows": PAIR_BOOKS * 3, "steps": PAIR_STEPS,
                                 "per_row_params": per_row}


def serve_config(**over) -> dict:
    from gymfx_tpu_torch.config import DEFAULT_VALUES

    config = dict(DEFAULT_VALUES)
    config.update(input_data_file=str(ROOT / "examples" / "data" / "eurusd_sample.csv"),
                  window_size=WINDOW, serve_max_batch_wait_ms=SERVE_WAIT_MS, seed=SEED)
    config.update(over)
    return config


def serve_rows(torch, bundle, n: int, seed: int):
    """``n`` request rows: the env's reset observation encoded, plus
    noise (bench_infer.py's request stream), on the host."""
    engine = bundle.engine
    base = bundle.encode(bundle.reset_obs)[0].cpu()
    gen = torch.Generator().manual_seed(seed)
    return base[None] + 0.01 * torch.randn((n, *engine.obs_shape), generator=gen).to(base.dtype)


def single_row(torch, engine, x, carry=()):
    """The policy on one row (M = 1) on the card, eagerly, from the
    engine's weights: (action, value, logits, carry) on the host."""
    dev = engine.device
    with torch.no_grad():
        x = x.to(dev)[None]
        if engine.recurrent:
            logits, value, c2 = torch.func.functional_call(
                engine.policy, engine.params, (x, tuple(c.to(dev)[None] for c in carry)))
        else:
            logits, value = torch.func.functional_call(engine.policy, engine.params, (x,))
            c2 = ()
    action = torch.argmax(logits, dim=-1).to(torch.int32)
    return (action[0].cpu(), value[0].cpu(), logits[0].cpu(), tuple(c[0].cpu() for c in c2))


def random_carries(torch, engine, n: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((n, *c.shape), generator=gen).to(c.dtype) for c in engine.initial_carry())


def check_exact_rows(torch, engine, rows, carries, label: str) -> int:
    """Every row of ``engine.decide_batch`` (exact mode) torch.equal to
    the single-row forward, carry included; returns the rows checked."""
    out = engine.decide_batch(rows, carries)
    n = rows.shape[0]
    check(out.action.shape == (n,), f"{label}: {tuple(out.action.shape)} actions for {n} rows")
    for i in range(n):
        carry = tuple(c[i] for c in carries) if engine.recurrent else ()
        a, v, lo, c2 = single_row(torch, engine, rows[i], carry)
        same = (torch.equal(out.action[i], a) and torch.equal(out.value[i], v)
                and torch.equal(out.actor_out[i], lo)
                and all(torch.equal(x[i], y) for x, y in zip(out.carry, c2)))
        check(same, f"{label}: row {i} of {n} != the single-row forward")
    return n


def serve_max_diff(torch, got, ref) -> float:
    """Largest |got - ref| over the largest |ref| (fields of a decision:
    logits, value, carry)."""
    err, big = 0.0, 1e-30
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        err = max(err, float((g - r).abs().max()))
        big = max(big, float(r.abs().max()))
    return err / big


def serve_phase(torch, kernels, results) -> None:
    """The serving stack on the card (module docstring, phase 17)."""
    import threading

    import numpy as np

    from gymfx_tpu_torch.config.flagship import flagship_config
    from gymfx_tpu_torch.core.graphs import WARMUP
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.ops import env_dynamics, fused_attention, window_zscore
    from gymfx_tpu_torch.serve import (
        BarFeaturizer,
        InferenceEngine,
        MicroBatcher,
        WeightSwapError,
        engine_from_config,
        make_host_encoder,
    )
    from gymfx_tpu_torch.train.policies import flatten_obs

    t_phase = time.perf_counter()
    out = results["serve"] = {"configs": {}}
    counted = (fused_attention.attention_forward, fused_attention.attention_backward,
               window_zscore.step_obs, env_dynamics.fill_brackets, env_dynamics.mark_reward)
    for fn in counted:
        fn.launches = 0

    # ---- 1. boot: the default ladder in matmul (auto) ----------------------
    bundles = {}
    for label, over in SERVE_CONFIGS.items():
        t0 = time.perf_counter()
        bundle = engine_from_config(serve_config(**over))
        boot_s = time.perf_counter() - t0
        engine = bundle.engine
        check(engine.batch_mode == "matmul", f"{label}: auto resolved to {engine.batch_mode}")
        check(engine.executable_count == len(engine.buckets) and engine.late_compiles == 0,
              f"{label}: {engine.executable_count} graphs, {engine.late_compiles} late")
        slots = engine.slot_cache is not None
        check(slots == ("serve_session_slots" in over), f"{label}: slot cache {slots}")
        bundles[label] = bundle
        row = {"policy": bundle.policy_name, "dtype": over.get("policy_dtype", "float32"),
               "obs_shape": list(engine.obs_shape), "buckets": list(engine.buckets),
               "boot_s": boot_s, "capture_s": engine.capture_s,
               "slot_capture_s": engine.slot_capture_s}
        out["configs"][label] = row
        print(f"serve: {label} booted in {boot_s:.2f} s ({bundle.policy_name}, obs "
              f"{engine.obs_shape}); capture s by bucket "
              + ", ".join(f"{b}: {s:.3f}" for b, s in engine.capture_s.items())
              + ("; slot ladder " + ", ".join(f"{b}: {s:.3f}" for b, s in
                                            engine.slot_capture_s.items()) if slots else ""))
    ring = bundles["serve-ring"].engine
    layers = ring.policy.encoder.layers.__len__()
    boot_k4 = fused_attention.attention_forward.launches
    # launches move only at capture: WARMUP + 1 runs of each graph's body
    check(boot_k4 == (WARMUP + 1) * layers * len(ring.buckets),
          f"serve boot launched K4's forward {boot_k4} times")
    traced, _ = replay_launches(
        torch, {b: g for b, g in ring._graphs.items()},
        {b: {"attention_forward": layers} for b in ring._graphs}, "serve ring replay")
    out["k4_forward_launches_at_boot"] = boot_k4
    out["k4_forward_replay_launches"] = {str(b): t["attention_forward"] for b, t in traced.items()}
    print(f"serve: K4 forward {boot_k4} launches at the ring ladder's capture; one replay of "
          f"each bucket by the profiler trace: {out['k4_forward_replay_launches']}")

    # ---- 2. exact mode at (1, 8, 64): torch.equal to the single-row forward --
    exact = {}
    for label, bundle in bundles.items():
        e = bundle.engine
        t0 = time.perf_counter()
        ex = InferenceEngine(e.policy, e.params, e.neutral_obs, buckets=SERVE_EXACT_BUCKETS,
                             batch_mode="exact", device=e.device)
        capture = time.perf_counter() - t0
        rows = serve_rows(torch, bundle, max(SERVE_EXACT_ROWS), seed=1)
        carries = random_carries(torch, e, rows.shape[0], seed=2) if e.recurrent else None
        checked = 0
        for n in SERVE_EXACT_ROWS:
            sub = tuple(c[:n] for c in carries) if carries is not None else None
            checked += check_exact_rows(torch, ex, rows[:n], sub, f"{label} exact n={n}")
        replay_ms = {}
        for b in SERVE_EXACT_BUCKETS:
            g = ex._graphs[b]
            replay_ms[b] = event_ms(torch, lambda: g.graph.replay(), reps=5, trials=5)
        check(ex.late_compiles == 0, f"{label}: exact engine captured late")
        exact[label] = ex
        out["configs"][label]["exact"] = {"capture_s": ex.capture_s, "replay_ms": replay_ms,
                                          "rows_checked": checked, "boot_s": capture}
        print(f"serve: {label} exact ladder {SERVE_EXACT_BUCKETS}: {checked} rows torch.equal "
              f"to the single-row forward (n = {SERVE_EXACT_ROWS}, chunked above 64"
              + (", non-zero carries, carry included" if e.recurrent else "") + "); capture s "
              + ", ".join(f"{b}: {s:.3f}" for b, s in ex.capture_s.items()) + "; replay ms "
              + ", ".join(f"{b}: {m:.4f}" for b, m in replay_ms.items()))
    ex_ring = exact["serve-ring"]
    traced, _ = replay_launches(torch, {8: ex_ring._graphs[8]},
                                {8: {"attention_forward": 8 * layers}}, "serve exact ring replay")
    print(f"serve: one exact replay of bucket 8 (ring) launched K4's forward "
          f"{traced[8]['attention_forward']} times (profiler trace)")

    # ---- 3. matmul mode: the largest difference -----------------------------
    for label, bundle in bundles.items():
        e = bundle.engine
        rows = serve_rows(torch, bundle, max(e.buckets), seed=3)
        carries = random_carries(torch, e, rows.shape[0], seed=4) if e.recurrent else None
        probe = 8
        alone = [single_row(torch, e, rows[i], tuple(c[i] for c in carries) if carries else ())
                 for i in range(probe)]
        vs_single, vs_b1 = 0.0, 0.0
        first = None
        for b in e.buckets:
            sub = tuple(c[:b] for c in carries) if carries is not None else None
            d = e.decide_batch(rows[:b], sub)
            for i in range(min(probe, b)):
                got = (d.actor_out[i], d.value[i], *(c[i] for c in (d.carry or ())))
                ref = (alone[i][2], alone[i][1], *alone[i][3])
                vs_single = max(vs_single, serve_max_diff(torch, got, ref))
                if first is None:
                    first = got
                elif i == 0:
                    vs_b1 = max(vs_b1, serve_max_diff(torch, got, first))
        dtype = SERVE_CONFIGS[label].get("policy_dtype", "float32")
        tol = SERVE_MATMUL_TOL[dtype]
        out["configs"][label]["matmul_rel_diff"] = {"vs_single_row": vs_single,
                                                    "vs_bucket_1": vs_b1, "tol": tol}
        print(f"serve: {label} matmul: largest difference / max|single-row| {vs_single:.3g} "
              f"against the single-row forward, {vs_b1:.3g} across buckets (tol {tol:.3g}, "
              f"{dtype})")
        check(vs_single <= tol and vs_b1 <= tol, f"{label}: matmul rows off by {vs_single}, "
              f"{vs_b1} > {tol}")

    # ---- 4. the featurizer against the env's obs (K1) at every step ---------
    fcfg = flagship_config(str(ROOT / "examples" / "data" / "eurusd_sample.csv"), seed=SEED)
    env = Environment(fcfg)
    cfg = env.cfg
    n_envs = int(fcfg["num_envs"])
    frame = env.dataset.frame
    closes = frame.columns[env.dataset.price_column]
    raw = np.stack([frame.columns[c] for c in fcfg["feature_columns"]], axis=1)
    k1_before = window_zscore.step_obs.launches
    t0 = time.perf_counter()
    state, obs = env.reset(n_envs)
    from gymfx_tpu_torch.train.policies import make_obs_spec

    spec = make_obs_spec(obs)
    host_encode = make_host_encoder("mlp", cfg.window_size, spec)
    sess = BarFeaturizer.from_environment(env).new_session()
    hold = torch.zeros(n_envs, dtype=torch.int32, device=env.device)
    steps = cfg.n_bars - 1
    for k in range(-1, steps):
        if k >= 0:
            state, obs, _r, _done, _info = env.step(state, hold)
        # reset consumes bar 0; the first step is the no-advance warm-up;
        # step k >= 1 moves to bar k
        if k != 0:
            bar = max(k, 0)
            sess.push(closes[bar], raw[bar])
        want = torch.from_numpy(host_encode(sess.obs(total_bars=cfg.n_bars))).to(env.device)
        got = flatten_obs(obs, spec)
        check(torch.equal(got, want.expand_as(got))
              and torch.equal(got[0].view(torch.int32), want.view(torch.int32)),
              f"serve featurizer: obs at step {k} != the env's (K1) on the card")
    feat_s = time.perf_counter() - t0
    k1 = window_zscore.step_obs.launches - k1_before
    check(k1 == steps + 1, f"serve featurizer: K1 launched {k1} times over {steps} steps")
    out["featurizer"] = {"steps": steps, "n_envs": n_envs, "k1_launches": k1, "seconds": feat_s}
    print(f"serve: featurizer obs == the env's at every one of {steps} steps + reset "
          f"({n_envs:,} envs of flagship_config, OHLCV features, rolling_zscore; K1 {k1} "
          f"launches; torch.equal after the host encode) in {feat_s:.2f} s")
    del env, state, obs
    torch.cuda.empty_cache()

    # ---- 5. the micro-batcher: sync and pipelined == decide_batch ----------
    mlp_bundle = bundles["serve-mlp"]
    ex_mlp = exact["serve-mlp"]
    rows = serve_rows(torch, mlp_bundle, SERVE_BATCH, seed=5)

    def load(batcher, answers):
        def client(cid):
            for j in range(SERVE_REQUESTS):
                i = (cid * SERVE_REQUESTS + j) % SERVE_BATCH
                answers[(cid, j)] = (i, batcher.submit(rows[i]).result(timeout=60))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in threads), "serve: a client thread hung")
        return time.perf_counter() - t0

    want = ex_mlp.decide_batch(rows)
    for pipeline in (False, True):
        answers = {}
        with MicroBatcher(ex_mlp, max_batch_wait_ms=SERVE_WAIT_MS, pipeline=pipeline) as mb:
            wall = load(mb, answers)
        check(len(answers) == SERVE_CLIENTS * SERVE_REQUESTS, "serve: requests lost")
        for (cid, j), (i, d) in answers.items():
            check(torch.equal(d.actor_out, want.actor_out[i]) and torch.equal(d.value, want.value[i])
                  and torch.equal(d.action, want.action[i]),
                  f"serve batcher (pipeline={pipeline}): client {cid} request {j} != decide_batch")
        kind = "pipelined" if pipeline else "sync"
        out[f"batcher_{kind}"] = {"requests": len(answers), "dispatches": mb.dispatches,
                                  "mean_batch": mb.coalesced_total / max(1, mb.dispatches),
                                  "wall_s": wall}
        print(f"serve: batcher ({kind}, exact MLP ladder): {len(answers)} answers == decide_batch "
              f"(torch.equal) in {mb.dispatches} dispatches, {wall:.2f} s")

    # ---- 6. LSTM session slots ---------------------------------------------
    lstm = bundles["serve-lstm-slots"]
    e = lstm.engine
    cache = e.slot_cache
    check(cache is not None and cache.slots == 1024, "serve: the LSTM has no 1,024-slot cache")
    sessions = [f"s{i}" for i in range(SERVE_SESSIONS)]
    hc = e.initial_carry_batch(SERVE_SESSIONS)
    for step in range(SERVE_SLOT_STEPS):
        obs_t = serve_rows(torch, lstm, SERVE_SESSIONS, seed=100 + step)
        h = e.decide_batch(obs_t, hc)
        s = e.decide_batch_slots(obs_t, sessions)
        hc = h.carry
        check(s.carry is None and torch.equal(s.action, h.action) and torch.equal(s.value, h.value)
              and torch.equal(s.actor_out, h.actor_out),
              f"serve slots: step {step} != host-carry threading")
        for i, sess_id in enumerate(sessions):
            mirror = cache.mirror_carry(sess_id)
            slot = cache.slot_of(sess_id)
            check(all(torch.equal(m, x[i]) and torch.equal(m, st[slot].cpu())
                      for m, x, st in zip(mirror, hc, cache.state)),
                  f"serve slots: mirror of {sess_id} at step {step} != host carry / device row")
    # two dispatches in flight, each on fresh sessions, resolved out of order
    a_rows = serve_rows(torch, lstm, SERVE_INFLIGHT, seed=200)
    b_rows = serve_rows(torch, lstm, SERVE_INFLIGHT, seed=201)
    fresh = e.initial_carry_batch(SERVE_INFLIGHT)
    ha = e.dispatch_async(a_rows, sessions=[f"a{i}" for i in range(SERVE_INFLIGHT)])
    hb = e.dispatch_async(b_rows, sessions=[f"b{i}" for i in range(SERVE_INFLIGHT)])
    db, da = hb.resolve(), ha.resolve()
    for got, r in ((da, a_rows), (db, b_rows)):
        ref = e.decide_batch(r, fresh)
        check(torch.equal(got.actor_out, ref.actor_out) and torch.equal(got.value, ref.value),
              "serve slots: an in-flight dispatch resolved to other rows")
    # host-carry staging: three dispatches in flight at one bucket (the
    # third rewrites the first's staging buffer)
    c_rows = serve_rows(torch, lstm, SERVE_INFLIGHT, seed=202)
    handles = [e.dispatch_async(r, fresh) for r in (a_rows, b_rows, c_rows)]
    for r, hnd in zip((a_rows, b_rows, c_rows), handles):
        ref = e.decide_batch(r, fresh)
        got = hnd.resolve()
        check(torch.equal(got.actor_out, ref.actor_out) and
              all(torch.equal(x, y) for x, y in zip(got.carry, ref.carry)),
              "serve staging: an in-flight host dispatch resolved to other rows")
    out["slots"] = {"sessions": SERVE_SESSIONS, "steps": SERVE_SLOT_STEPS, **e.slot_stats()}
    print(f"serve: LSTM slots (1,024): {SERVE_SESSIONS} sessions x {SERVE_SLOT_STEPS} steps == "
          f"host-carry threading (torch.equal), mirror == host carry == device rows after each "
          f"resolve; two slot dispatches and three host dispatches in flight resolved to their "
          f"own rows; {e.slot_stats()}")

    # ---- 7. bench_infer.py's three numbers for the MLP ----------------------
    import copy

    e = mlp_bundle.engine
    rows = serve_rows(torch, mlp_bundle, SERVE_BATCH, seed=6)
    # the sequential baseline: the pre-engine path, one eager batch-of-1
    # forward of the policy module and a host argmax a decision
    plain = copy.deepcopy(e.policy)
    plain.load_state_dict(e.params)

    def eager_decision(i):
        with torch.no_grad():
            logits, _value = plain(rows[i:i + 1].to(e.device))
        return int(torch.argmax(logits[0]))

    eager_decision(0)
    t0 = time.perf_counter()
    for i in range(SERVE_SEQ):
        eager_decision(i)
    seq_per_s = SERVE_SEQ / (time.perf_counter() - t0)
    # the engine's own batch-of-1 path (bucket 1's replay) a decision
    e.decide(rows[0])
    t0 = time.perf_counter()
    for i in range(SERVE_SEQ):
        int(e.decide(rows[i]).action)
    decide_per_s = SERVE_SEQ / (time.perf_counter() - t0)
    e.decide_batch(rows)
    t0 = time.perf_counter()
    for _ in range(SERVE_ITERS):
        e.decide_batch(rows)
    batched_per_s = SERVE_BATCH * SERVE_ITERS / (time.perf_counter() - t0)
    answers = {}
    gc.collect()  # the phase's garbage out of the measured load's way
    with MicroBatcher(e, max_batch_wait_ms=SERVE_WAIT_MS) as mb:
        load(mb, answers)
        records = mb.records
    # matmul answers against the exact ladder's (the single-row forward)
    want = ex_mlp.decide_batch(rows)
    worst = max(serve_max_diff(torch, (d.actor_out, d.value), (want.actor_out[i], want.value[i]))
                for i, d in answers.values())
    check(len(answers) == SERVE_CLIENTS * SERVE_REQUESTS
          and worst <= SERVE_MATMUL_TOL["float32"],
          f"serve batcher (matmul MLP): answers off the single-row forward by {worst}")
    lat_ms = np.asarray([r.latency_s for r in records]) * 1e3
    # where a request's time goes: queued until the worker picks it up,
    # the batching window, the dispatch to its resolve
    parts = {"queue": [r.t_pickup - r.t_enqueue for r in records],
             "window": [r.t_dispatch - r.t_pickup for r in records],
             "dispatch": [r.t_done - r.t_dispatch for r in records]}
    split = {k: {"p50_ms": float(np.percentile(v, 50)) * 1e3,
                 "p99_ms": float(np.percentile(v, 99)) * 1e3} for k, v in parts.items()}
    bench = {"sequential_per_s": seq_per_s, "engine_decide_per_s": decide_per_s,
             "decisions_per_s": batched_per_s,
             "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
             "latency_split": split,
             "batcher_dispatches": mb.dispatches, "batcher_rel_diff": worst,
             "mean_batch": mb.coalesced_total / max(1, mb.dispatches),
             "device": results["device"]["nvidia_smi"]}
    out["bench"] = bench
    print(f"serve: bench_infer.py's numbers for serve-mlp on {bench['device']}: sequential "
          f"batch-of-1 (eager module) {seq_per_s:,.1f} decisions/s over {SERVE_SEQ} (the "
          f"engine's decide, bucket 1's replay: {decide_per_s:,.1f}); decide_batch at "
          f"{SERVE_BATCH} x {SERVE_ITERS}: {batched_per_s:,.1f} decisions/s; batcher "
          f"({SERVE_CLIENTS} clients x {SERVE_REQUESTS}, {SERVE_WAIT_MS} ms) p50 "
          f"{bench['p50_ms']:.3f} ms, p99 {bench['p99_ms']:.3f} ms, {mb.dispatches} dispatches "
          f"of {bench['mean_batch']:.1f} requests; p50 / p99 ms "
          + ", ".join(f"{k} {v['p50_ms']:.3f} / {v['p99_ms']:.3f}" for k, v in split.items()))

    # ---- 8. swap_weights ----------------------------------------------------
    probe_rows = rows[:8]
    before = ex_mlp.decide_batch(probe_rows)
    gen = torch.Generator(device=ex_mlp.device).manual_seed(SEED + 7)
    new = {k: v + 0.05 * torch.randn(v.shape, generator=gen, device=v.device)
           for k, v in ex_mlp.params.items()}
    generation = ex_mlp.swap_weights(new)
    after = ex_mlp.decide_batch(probe_rows)
    check(not torch.equal(after.actor_out, before.actor_out), "serve swap: decisions unchanged")
    for i in range(probe_rows.shape[0]):
        check(torch.equal(after.actor_out[i], single_row(torch, ex_mlp, probe_rows[i])[2]),
              "serve swap: a row != the single-row forward on the new weights")
    bad = dict(new)
    name = next(iter(bad))
    bad[name] = bad[name][..., :-1]
    try:
        ex_mlp.swap_weights(bad)
        fail("serve swap: a mismatched swap was accepted")
    except WeightSwapError:
        pass
    again = ex_mlp.decide_batch(probe_rows)
    check(torch.equal(again.actor_out, after.actor_out) and ex_mlp.generation == generation,
          "serve swap: a rejected swap changed the decisions")
    late = {label: b.engine.late_compiles for label, b in bundles.items()}
    late.update({f"{label} exact": ex.late_compiles for label, ex in exact.items()})
    check(not any(late.values()), f"serve: late captures {late}")
    print(f"serve: swap_weights accepted (generation {generation}, decisions changed from the "
          f"next dispatch, == the single-row forward on the new weights), a mismatched one "
          f"raised WeightSwapError and changed nothing; late captures {late}")

    # ---- K4's forward at the serving shapes ------------------------------------
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k4 = {}
    for b in SERVE_K4_BATCHES:
        q, k, v = (torch.randn((b, WINDOW, 4, 32), generator=gen, device="cuda") for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pairs = b * 4 * WINDOW * WINDOW
        bms, bby = bound(4 * nbytes(q), 4 * 32 * pairs, F32_FLOPS)
        k4[b] = dict(ms=device_ms(torch, lambda: fused_attention.attention_forward(q, k, v)),
                     plain_ms=event_ms(torch, lambda: fused_attention.attention_forward_plain(q, k, v)),
                     library_ms=event_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                     bound_ms=bms, bound_by=bby)
    out["k4_forward_serving_shapes"] = {str(b): r for b, r in k4.items()}
    print("serve: K4 forward f32 at (B, 32, 4, 32): " + "; ".join(
        f"B {b}: {r['ms'] * 1e3:.2f} us (plain {r['plain_ms'] * 1e3:.2f}, SDPA "
        f"{r['library_ms'] * 1e3:.2f}, bound {r['bound_ms'] * 1e3:.3f} us by {r['bound_by']})"
        for b, r in k4.items()))

    launches = count_launches(counted)
    check(launches["attention_forward"] > 0 and launches["attention_backward"] == 0,
          f"serve path launches {launches}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"serve: phase launches {launches}; {out['seconds']:.1f} s (budget {SERVE_BUDGET_S} s)")
    check(out["seconds"] <= SERVE_BUDGET_S, f"serve phase took {out['seconds']:.1f} s")


def pbt_bar_steps(torch, pbt, state, fitness, iters: int, eager: bool):
    """``iters`` population steps of PBT over the bar venue with an
    exploit/explore after each ``pbt.pbt.interval``-th, as PBTTrainer.train
    runs them (its rng from SEED + 1), from the graphs or op by op:
    (state, fitness, replacements, per-step rows)."""
    import numpy as np

    tr = pbt.trainer
    rng = np.random.default_rng(SEED + 1)
    rows, replaced = [], []
    for it in range(iters):
        t0 = time.perf_counter()
        if eager:
            inter, out = tr._rollout_phase_eager(state)
            state, metrics = tr._update_phase_eager(inter, out)
        else:
            state, metrics = tr.train_step(state)
        torch.cuda.synchronize()
        rows.append(dict(step_ms=(time.perf_counter() - t0) * 1e3,
                         metrics={k: v.tolist() for k, v in metrics.items()}))
        decay = pbt.pbt.fitness_decay
        fitness = decay * fitness + (1 - decay) * metrics["mean_reward"].cpu().numpy().astype(
            np.float64)
        if (it + 1) % pbt.pbt.interval == 0:
            state, fitness, who = pbt._exploit_explore(state, fitness, rng)
            replaced.append(who)
    return state, fitness, replaced, rows


def pbt_population_equal(torch, config, label: str) -> dict:
    """One population step of ``config``'s PBT over the bar venue from its
    graphs against the same step op by op (torch.equal, generator
    included): (capture s by graph)."""
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.train.pbt import PBTTrainer, _pbt_config_from
    from gymfx_tpu_torch.train.ppo import ppo_config_from

    pbt = PBTTrainer(Environment(config), ppo_config_from(config), _pbt_config_from(config))
    tr = pbt.trainer
    state0, _ = pbt.init_population(SEED)
    ga, ma = tr.train_step(copy_state(torch, state0))
    inter, out = tr._rollout_phase_eager(copy_state(torch, state0))
    gb, mb = tr._update_phase_eager(inter, out)
    check_same_state(torch, ga, gb, f"{label} one population step")
    check_same(torch, ma, mb, f"{label} metrics")
    for key in ("loss", "entropy"):
        check(bool(torch.isfinite(ma[key]).all()), f"{label}: {key} {ma[key].tolist()}")
    print(f"{label}: one population step of {pbt.pbt.population} members x "
          f"{tr.pcfg.n_envs} envs x {tr.pcfg.horizon} steps graphed == eager (torch.equal, "
          f"generator included); losses {[round(x, 5) for x in ma['loss'].tolist()]}")
    return capture_seconds(tr)


def pbt_phase(torch, kernels, results) -> None:
    """PBT over the bar venue at flagship-train's width: 4 members x 8,192
    envs (32,768 env rows), window 32, horizon 64, the 3x256 bf16 MLP;
    3 population steps with an exploit/explore after the second, graphed
    against eager (torch.equal, generator included), no capture after the
    first step, K1-K3 64 launches each in one rollout replay for every
    row, the phases timed; then an LSTM and a transformer_ring population
    at a smaller depth, one step graphed == eager each."""
    import numpy as np

    from gymfx_tpu_torch.config.flagship import flagship_config
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.ops import env_dynamics, fused_attention, window_zscore
    from gymfx_tpu_torch.train.pbt import PBTTrainer, _pbt_config_from
    from gymfx_tpu_torch.train.ppo import ppo_config_from

    csv = str(ROOT / "examples" / "data" / "eurusd_sample.csv")
    config = flagship_config(csv, pbt_population=PBT_MEMBERS, pbt_interval=2)
    pbt = PBTTrainer(Environment(config), ppo_config_from(config), _pbt_config_from(config))
    tr = pbt.trainer
    pcfg, members, label = tr.pcfg, pbt.pbt.population, "pbt"
    rows_n = members * pcfg.n_envs
    check(tr.rows == rows_n == PBT_MEMBERS * N_ENVS, f"{label}: {tr.rows} env rows")
    state0, fitness0 = pbt.init_population(SEED)
    lrs = pbt.get_lrs(state0)
    counted = (window_zscore.step_obs, env_dynamics.fill_brackets, env_dynamics.mark_reward)
    before = count_launches(counted)
    t0 = time.perf_counter()
    ga, fa_, rep_a, rows_a = pbt_bar_steps(torch, pbt, copy_state(torch, state0),
                                           fitness0.copy(), 3, eager=False)
    graphed_s = time.perf_counter() - t0
    at_capture = {k: v - before[k] for k, v in count_launches(counted).items()}
    check(tr.captures() == 2, f"{label}: {tr.captures()} graphs captured after an exploit/explore, "
          "expected the first step's 2")
    # captured at step 1: 3 warm-ups and the capture, 64 steps each; steps 2
    # and 3 (after the exploit/explore copied into the static buffers) replay
    want = {k: 4 * pcfg.horizon for k in ("step_obs", "fill_brackets", "mark_reward")}
    check(at_capture == want, f"{label}: K1-K3 launches at capture {at_capture}, expected {want}")
    for key, count in at_capture.items():
        kernels[key]["pbt_launches_at_capture"] = count
    before = count_launches(counted)
    t0 = time.perf_counter()
    gb, fb_, rep_b, rows_b = pbt_bar_steps(torch, pbt, copy_state(torch, state0),
                                           fitness0.copy(), 3, eager=True)
    eager_s = time.perf_counter() - t0
    eager_launches = {k: v - before[k] for k, v in count_launches(counted).items()}
    check(eager_launches == {k: 3 * pcfg.horizon for k in want},
          f"{label}: eager K1-K3 launches {eager_launches}, expected one each a step")
    check(rep_a == rep_b and len(rep_a) == 1, f"{label}: replaced {rep_a} graphed, {rep_b} eager")
    check(np.array_equal(fa_, fb_), f"{label}: fitness {fa_} graphed, {fb_} eager")
    check_same_state(torch, ga, gb, f"{label} 3 population steps with an exploit/explore")
    for row in rows_a:
        for key in ("loss", "entropy", "grad_norm"):
            check(all(math.isfinite(x) for x in row["metrics"][key]), f"{label}: {key} {row}")
        check(sum(row["metrics"]["nonfinite_skips"]) == 0.0, f"{label}: updates skipped {row}")
    traced, _ = replay_launches(torch, first_graphs(tr), {"rollout": dict(
        step_obs=pcfg.horizon, fill_brackets=pcfg.horizon, mark_reward=pcfg.horizon),
        "update": {}}, label)
    for key in want:
        kernels[key]["pbt_replay_launches"] = traced["rollout"][key]
    roll_ms, upd_ms, phase_rows = phase_ms(torch, tr, ga)
    per_iter = rows_n * pcfg.horizon
    step_ms = statistics.median(r["step_ms"] for r in rows_a[1:])
    check(tr.captures() == 2, f"{label}: the phases captured again ({tr.captures()} graphs)")
    print(f"{label}: graphed == eager (torch.equal, generator included) over 3 population steps "
          f"of {members} members x {pcfg.n_envs} envs ({rows_n} env rows) x {pcfg.horizon} steps "
          f"with one exploit/explore (replaced {rep_a[0]}; learning rates {lrs.tolist()}); no "
          f"capture after the first step; K1-K3 one launch a step for every row: "
          f"{traced['rollout']} in one rollout replay (profiler trace), "
          f"{traced['update']['all']} kernels in an update replay; 3 steps {graphed_s:.1f} s "
          f"graphed (the first captures), {eager_s:.1f} s eager")
    print(f"{label}: rollout replay {roll_ms:.1f} ms, update replay {upd_ms:.1f} ms (medians of "
          f"2 of 3), population step {step_ms:.1f} ms: {per_iter / (roll_ms + upd_ms) * 1e3:,.0f} "
          f"env steps/s through the phases, {per_iter / step_ms * 1e3:,.0f} through train_step; "
          f"{results['device']['nvidia_smi']}")
    results["pbt"] = dict(
        members=members, n_envs=pcfg.n_envs, rows=rows_n, horizon=pcfg.horizon,
        graphed_steps=rows_a, eager_steps=rows_b, launches_at_capture=at_capture,
        replay_launches=traced, rollout_ms=roll_ms, update_ms=upd_ms, phase_rows=phase_rows,
        step_ms=step_ms, phases_env_steps_per_s=per_iter / (roll_ms + upd_ms) * 1e3,
        step_env_steps_per_s=per_iter / step_ms * 1e3, capture_s=capture_seconds(tr),
        graphed_s=graphed_s, eager_s=eager_s, replaced=rep_a)
    del pbt, tr, ga, gb, state0
    gc.collect()
    torch.cuda.empty_cache()
    # the command line: main --trainer pbt without portfolio_files (2
    # population steps, an exploit/explore, the best member checkpointed
    # and evaluated on held-out bars), then the policy mode on it
    from gymfx_tpu_torch.app.main import main as cli_main

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_pbt_"))
    try:
        (tmp / "pbt.json").write_text(json.dumps({**config, "pbt_interval": 1,
                                                  "eval_split": 0.3}))
        argv = ["--load_config", str(tmp / "pbt.json"), "--checkpoint_dir", str(tmp / "ckpt"),
                "--results_file", str(tmp / "out.json"), "--quiet_mode"]
        t0 = time.perf_counter()
        out = cli_main(argv + ["--mode", "training", "--trainer", "pbt",
                               "--train_total_steps", str(2 * per_iter)])
        cli_s = time.perf_counter() - t0
        check(out["pbt"]["iterations"] == 2 and len(out["pbt"]["replacements"]) == 1
              and out["eval_scope"] == "held_out" and math.isfinite(out["total_return"]),
              f"{label} cli: {out['pbt']['iterations']} iterations, {out['eval_scope']}")
        policy = cli_main(argv + ["--mode", "inference", "--driver_mode", "policy", "--steps",
                                  str(out["eval_bars"] - 1)])
        check(policy["checkpoint_step"] == 2 * per_iter and policy["eval_scope"] == "held_out"
              and policy["total_return"] == out["total_return"],
              f"{label} cli: policy mode {policy.get('checkpoint_step')}, "
              f"{policy.get('total_return')} vs {out['total_return']}")
        print(f"{label} cli: main --trainer pbt, 2 population steps of {members} x {pcfg.n_envs} "
              f"envs with an exploit/explore, the best member ({out['pbt']['best_member']}) "
              f"checkpointed and evaluated on {out['eval_bars']} held-out bars (total_return "
              f"{out['total_return']:.6g}) in {cli_s:.1f} s; the policy mode on its checkpoint "
              f"== the training summary")
        results["pbt"]["cli"] = dict(seconds=cli_s, best_member=out["pbt"]["best_member"],
                                     total_return=out["total_return"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # the recurrent and the ring policies' populations, at a smaller depth
    small = dict(pbt_population=PBT_MEMBERS, pbt_interval=2, num_envs=PBT_SMALL_ENVS,
                 ppo_horizon=PBT_SMALL_HORIZON)
    results["pbt"]["lstm_capture_s"] = pbt_population_equal(
        torch, flagship_config(csv, policy="lstm", policy_kwargs={"hidden": 128}, **small),
        "pbt lstm")
    k4 = (fused_attention.attention_forward, fused_attention.attention_backward)
    before = count_launches(k4)
    results["pbt"]["ring_capture_s"] = pbt_population_equal(
        torch, flagship_config(csv, policy="transformer_ring",
                               policy_kwargs={"d_model": 64, "n_heads": 4, "n_layers": 1},
                               **small), "pbt ring")
    ring_k4 = {k: v - before[k] for k, v in count_launches(k4).items()}
    check(ring_k4["attention_forward"] > 0 and ring_k4["attention_backward"] > 0,
          f"pbt ring: K4 launches {ring_k4}")
    results["pbt"]["ring_k4_launches"] = ring_k4
    gc.collect()
    torch.cuda.empty_cache()


def telemetry_phase(torch, kernels, results, tmp) -> None:
    """The trainers' telemetry, faults and logging at flagship width on a
    2^15-bar tape, and the serving instruments: ``train_from_config`` with
    every trainer telemetry key on, then off (the final states torch.equal
    to each other and to the bare loop of train steps; the ledger and the
    sink valid, the drained metrics the returned ones); the preemption
    drill and its resume bitwise to the uninterrupted run (the postmortem
    valid); env steps/s with every key and ``log_every`` on beside off, and
    the drain's host us a superstep; serve-mlp with instruments under a
    FlakyEngine burst, ``/metrics`` and ``/healthz`` scraped on loopback."""
    from gymfx_tpu_torch import telemetry as TT
    from gymfx_tpu_torch.config.flagship import flagship_config
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.ops import cases
    from gymfx_tpu_torch.resilience.faults import FlakyEngine, SimulatedPreemptionError
    from gymfx_tpu_torch.serve import batcher_from_config, engine_from_config
    from gymfx_tpu_torch.telemetry.device_stream import HostCopy
    from gymfx_tpu_torch.telemetry.http import scrape
    from gymfx_tpu_torch.telemetry.instruments import instruments_from_telemetry
    from gymfx_tpu_torch.train import checkpoint as ckpt
    from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from, train_from_config

    tmp = pathlib.Path(tmp) / "telemetry"
    tmp.mkdir()
    tape = tmp / "eurusd_m1.csv"
    cases.write_bar_csv(tape, cases.tick_walk_columns(CLI_BARS, seed=SEED + 3, level=1.10),
                        cases.m1_week_grid(CLI_BARS))
    per_iter = N_ENVS * HORIZON
    base = flagship_config(str(tape), timeframe="M1", train_total_steps=TELEMETRY_ITERS * per_iter,
                           checkpoint_every=1, seed=SEED)

    def keys(name):
        d = tmp / name
        return {"telemetry_enabled": True, "telemetry_jsonl": str(d / "t.jsonl"),
                "telemetry_spans": True, "telemetry_http_port": 0,
                "telemetry_ledger": str(d / "ledger.jsonl"),
                "telemetry_flight_recorder_dir": str(d / "pm")}

    def final_state(d, trainer):
        state, step = ckpt.load_checkpoint(str(d), template=trainer.init_state(SEED))
        check(step == TELEMETRY_ITERS * per_iter, f"telemetry: {d.name} final step {step}")
        return state

    # 1. every trainer key on, then off, through train_from_config
    t0 = time.perf_counter()
    on = train_from_config({**base, **keys("on"), "checkpoint_dir": str(tmp / "on" / "ckpt")})
    on_s = time.perf_counter() - t0
    off = train_from_config({**base, "checkpoint_dir": str(tmp / "off" / "ckpt")})
    trainer = PPOTrainer(Environment(base), ppo_config_from(base))
    s_on, s_off = final_state(tmp / "on" / "ckpt", trainer), final_state(tmp / "off" / "ckpt",
                                                                        trainer)
    check_same_state(torch, s_on, s_off, "telemetry on vs off (train_from_config)")
    check(TT.validate_ledger(str(tmp / "on" / "ledger.jsonl")) == [], "telemetry: ledger invalid")
    kinds = [r["kind"] for r in TT.ledger.read_ledger(str(tmp / "on" / "ledger.jsonl"))]
    check(kinds == ["run_start"] + ["superstep_dispatch", "checkpoint_write"] * TELEMETRY_ITERS
          + ["run_end"], f"telemetry: ledger kinds {kinds}")
    rows = [json.loads(r) for r in (tmp / "on" / "t.jsonl").read_text().splitlines()]
    drained = [r for r in rows if r["kind"] == "train_metrics"]
    check(len(drained) == TELEMETRY_ITERS and sum(r["kind"] == "span" for r in rows)
          == TELEMETRY_ITERS and rows[-1]["kind"] == "metrics_snapshot",
          f"telemetry: sink kinds {[r['kind'] for r in rows]}")
    tm = on["train_metrics"]
    check(all(drained[-1][k] == tm[k] for k in tm if k in drained[-1]) and drained[-1]["iter"]
          == TELEMETRY_ITERS, f"telemetry: drained {drained[-1]} != returned {tm}")
    check({k: v for k, v in tm.items() if k != "env_steps_per_sec"}
          == {k: v for k, v in off["train_metrics"].items() if k != "env_steps_per_sec"},
          "telemetry: the on and off runs' metrics differ")
    marks = rows[-1]["registry"]["gymfx_device_memory_bytes"]["samples"]
    check({s["labels"]["stat"] for s in marks} == {"bytes_in_use", "peak_bytes_in_use",
                                                   "bytes_limit", "largest_alloc_size"},
          f"telemetry: memory watermarks {marks}")
    print(f"telemetry: train_from_config at {N_ENVS} envs x {HORIZON} steps on {CLI_BARS:,} bars, "
          f"{TELEMETRY_ITERS} iterations with every trainer key on ({on_s:.1f} s) == off "
          f"(torch.equal final states, generator included); ledger valid ({len(kinds)} rows), "
          f"the sink's drained metrics == the returned ones")

    # 2. the bare loop of graphed train steps, no hooks around it
    state = trainer.init_state(SEED)
    for _ in range(TELEMETRY_ITERS):
        state, _ = trainer.train_step(state)
    check_same_state(torch, copy_state(torch, state), s_off, "telemetry off vs the bare loop")

    # 3. the preemption drill and its resume
    drill = tmp / "drill" / "ckpt"
    try:
        train_from_config({**base, **keys("drill"), "checkpoint_dir": str(drill),
                           "fault_profile": "preempt_at=2"})
        fail("telemetry: the preemption drill did not raise")
    except SimulatedPreemptionError as exc:
        check(exc.iteration == 2, f"telemetry: preempted at {exc.iteration}")
    bundles = sorted((tmp / "drill" / "pm").iterdir())
    check(len(bundles) == 1 and TT.validate_postmortem(str(bundles[0])) == [],
          f"telemetry: postmortem bundles {bundles}")
    manifest = json.loads((bundles[0] / "manifest.json").read_text())
    check(manifest["reason"] == "preemption" and manifest["frames"] == 2,
          f"telemetry: postmortem manifest {manifest['reason']}, {manifest['frames']} frames")
    train_from_config({**base, "checkpoint_dir": str(drill), "resume_training": True,
                       "train_total_steps": (TELEMETRY_ITERS - 2) * per_iter})
    check_same_state(torch, final_state(drill, trainer), s_off,
                     "telemetry: preempted at 2 and resumed vs uninterrupted")
    print(f"telemetry: preempt_at=2 raised after iteration 2 (its checkpoint on disk, postmortem "
          f"valid: {manifest['frames']} frames, rng_key {len(manifest['rng_key'])} bytes); the "
          f"resume == the uninterrupted run (torch.equal)")

    # 4. env steps/s: every key and log_every on beside off, in this call;
    # each drain's time split in place into its wait on the previous
    # superstep's copy event and its host parts
    from gymfx_tpu_torch.telemetry import device_stream as stream_mod
    from gymfx_tpu_torch.telemetry import mfu as mfu_mod

    drain, waits, wait_now, split, part_now = [], [], [0.0], [], {}
    real_get = HostCopy.get
    real_copy, real_marks = stream_mod.HostCopy, mfu_mod.device_memory_watermarks

    def timing(name, fn):
        def timed_fn(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                part_now[name] = part_now.get(name, 0.0) + time.perf_counter() - t0
        return timed_fn

    def timed_get(copy):
        t0 = time.perf_counter()
        if copy._event is not None:
            copy._event.synchronize()
        wait_now[0] += time.perf_counter() - t0
        return real_get(copy)

    def run(with_telemetry):
        if not with_telemetry:
            return trainer.train(TELEMETRY_RATE_ITERS * per_iter, seed=SEED)[1]
        t = TT.telemetry_from_config({**base, **keys(f"rate{len(rates)}")})
        real_stream = t.device_stream
        t.sink.append = timing("sink_row", t.sink.append)
        t.recorder.record_frame = timing("recorder_frame", t.recorder.record_frame)

        def device_stream(*a, **kw):
            stream = real_stream(*a, **kw)
            inner = stream.after_dispatch
            stream._printer = timing("console_line", stream._printer)

            def after_dispatch(*args):
                wait_now[0] = 0.0
                part_now.clear()
                t0 = time.perf_counter()
                inner(*args)
                drain.append(time.perf_counter() - t0)
                waits.append(wait_now[0])
                split.append(dict(part_now))

            stream.after_dispatch = after_dispatch
            return stream

        t.device_stream = device_stream
        printed = io.StringIO()
        try:
            with contextlib.redirect_stdout(printed):
                out = trainer.train(TELEMETRY_RATE_ITERS * per_iter, seed=SEED, log_every=1,
                                    telemetry=t)[1]
        finally:
            t.close()
        lines = printed.getvalue().splitlines()
        check([line.split(" {")[0] for line in lines]
              == [f"[ppo] iter {i}/{TELEMETRY_RATE_ITERS}"
                  for i in range(1, TELEMETRY_RATE_ITERS + 1)],
              f"telemetry: log_every=1 printed {lines[:3]}")
        return out

    rates = []
    HostCopy.get = timed_get
    stream_mod.HostCopy = timing("host_copy_enqueue", real_copy)
    mfu_mod.device_memory_watermarks = timing("memory_watermarks", real_marks)
    try:
        for with_telemetry in (False, True, False, True):
            rates.append((with_telemetry, run(with_telemetry)["env_steps_per_sec"]))
    finally:
        HostCopy.get = real_get
        stream_mod.HostCopy, mfu_mod.device_memory_watermarks = real_copy, real_marks
    on_rates = [r for w, r in rates if w]
    off_rates = [r for w, r in rates if not w]
    # the drain's host time a superstep: after_dispatch's time less its
    # wait on the previous superstep's copy event (the card's time), and
    # its parts in place (medians over the drains; "rest": the registry,
    # the numpy reads and the calls' own overhead)
    drain_host = [(d - w) * 1e6 for d, w in zip(drain, waits)]
    names = ("host_copy_enqueue", "sink_row", "recorder_frame", "console_line",
             "memory_watermarks")
    in_place_us = {name: statistics.median(row.get(name, 0.0) * 1e6 for row in split)
                   for name in names}
    in_place_us["rest"] = statistics.median(
        h - sum(row.get(name, 0.0) * 1e6 for name in names) for h, row in zip(drain_host, split))
    # the drain's parts a superstep: the allocator's watermarks and the
    # pinned copy's enqueue (a dispatch's metrics, as the drain gets them)
    from gymfx_tpu_torch.telemetry.mfu import device_memory_watermarks

    metrics = trainer.train_step(trainer.init_state(SEED))[1]
    host = HostCopy(metrics).get()
    newest = {k: float(v[-1]) for k, v in host.items()}
    sink = TT.JsonlSink(str(tmp / "parts.jsonl"))
    recorder = TT.FlightRecorder(str(tmp / "parts_pm"), k=8)
    parts_us = {"memory_watermarks": host_us(torch, device_memory_watermarks),
                "memory_stats_flat": host_us(torch, torch.cuda.memory_stats),
                "host_copy_enqueue": host_us(torch, lambda: HostCopy(metrics)),
                "host_copy_read": host_us(torch, lambda: HostCopy(metrics).get()),
                "sink_row": host_us(torch, lambda: sink.append({"kind": "train_metrics",
                                                                **newest})),
                "recorder_frame": host_us(torch, lambda: recorder.record_frame(
                    1, 1, {k: v.tolist() for k, v in host.items()})),
                "console_line": host_us(torch, lambda: f"[ppo] iter 1/8 {newest}")}
    torch.cuda.synchronize()
    results["telemetry"] = dict(
        iters=TELEMETRY_ITERS, rate_iters=TELEMETRY_RATE_ITERS, on_env_steps_per_s=on_rates,
        off_env_steps_per_s=off_rates, drain_us=[d * 1e6 for d in drain],
        drain_wait_us=[w * 1e6 for w in waits], drain_host_us=drain_host,
        drain_host_us_median=statistics.median(drain_host),
        drain_us_median=statistics.median(d * 1e6 for d in drain), on_s=on_s, parts_us=parts_us,
        in_place_us=in_place_us)
    print(f"telemetry: env steps/s with every trainer key and log_every=1 on "
          f"{[round(r) for r in on_rates]} beside off {[round(r) for r in off_rates]} "
          f"({TELEMETRY_RATE_ITERS} iterations each, off/on/off/on in this call); the drain "
          f"{statistics.median(d * 1e6 for d in drain):.1f} us a superstep in all, "
          f"{statistics.median(drain_host):.1f} us of host work past its wait on the previous "
          f"superstep's copy (medians of {len(drain)}); of it the allocator's watermarks "
          f"{parts_us['memory_watermarks']:.1f} us (torch.cuda.memory_stats alone "
          f"{parts_us['memory_stats_flat']:.1f}), the pinned copy's enqueue "
          f"{parts_us['host_copy_enqueue']:.1f} us, enqueue and read "
          f"{parts_us['host_copy_read']:.1f}, the sink's row {parts_us['sink_row']:.1f}, "
          f"the recorder's frame {parts_us['recorder_frame']:.1f}, the console line "
          f"{parts_us['console_line']:.1f} (200 calls each); in place, medians of the "
          f"drains: " + ", ".join(f"{k} {v:.1f}" for k, v in in_place_us.items()) + " us; "
          f"{results['device']['nvidia_smi']}")

    # 5. serving: serve-mlp with instruments under a FlakyEngine burst
    config = serve_config(telemetry_enabled=True, telemetry_http_port=0,
                          serve_breaker_threshold=0)
    bundle = engine_from_config(config)
    try:
        flaky = FlakyEngine(bundle.engine, plan=["exc", "ok", "slow:20", "exc", "ok"])
        instr = instruments_from_telemetry(bundle.telemetry)
        rows_in = serve_rows(torch, bundle, 8, SEED)
        outcomes = []
        with batcher_from_config(flaky, config, instruments=instr) as mb:
            for row in rows_in:
                try:
                    mb.submit(row).result(timeout=60)
                    outcomes.append("served")
                except Exception as exc:  # noqa: BLE001 - the injected failures
                    outcomes.append(type(exc).__name__)
            burst = [mb.submit(row) for row in rows_in]
            for f in burst:
                f.result(timeout=60)
        url = bundle.telemetry.server.url
        check(url.startswith("http://127.0.0.1:"), f"telemetry: the endpoint binds {url}")
        text = scrape(url + "/metrics")
        health = json.loads(scrape(url + "/healthz"))
        failed = outcomes.count("InjectedDispatchError")
        served = outcomes.count("served") + len(burst)
        for line in (f'gymfx_serve_requests_total{{batcher="serve",outcome="failed"}} {failed}',
                     f'gymfx_serve_requests_total{{batcher="serve",outcome="served"}} {served}',
                     f'gymfx_serve_dispatch_failures_total{{batcher="serve"}} {failed}',
                     'gymfx_serve_late_compiles_total{batcher="serve"} 0'):
            check(line in text, f"telemetry: /metrics lacks {line!r}")
        check(failed == 2 and health["late_compiles"] == 0 and health["status"] == "ok",
              f"telemetry: outcomes {outcomes}, /healthz {health}")
        families = sum(line.startswith("# TYPE") for line in text.splitlines())
        print(f"telemetry: serve-mlp with instruments under a FlakyEngine plan {flaky.history}: "
              f"{served} served, {failed} failed; /metrics on loopback {families} families, "
              f"/healthz {health}")
        results["telemetry"]["serve"] = dict(outcomes=outcomes, served=served, failed=failed,
                                             families=families, health=health)
    finally:
        bundle.telemetry.close()


def main() -> None:
    if not (ROOT / "gymfx_tpu_torch" / "csrc" / "env_kernels.cu").is_file():
        fail("gymfx_tpu_torch is not beside this script: run it from a checkout of the repo")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    results = {}
    t_start = time.perf_counter()

    # ---- 1. device -------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi_line)
    if "H100" not in name:
        print(f"note: the bounds use the H100 SXM's peaks, not those of {name}")
    results["device"] = {"name": name, "nvidia_smi": smi_line, "bandwidth_bytes_per_s": BANDWIDTH,
                         "f32_flops": F32_FLOPS, "bf16_tensor_flops": BF16_FLOPS}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----------------------------------------------------------
    from gymfx_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all(ptxas_verbose=True)
    build_s = time.perf_counter() - t0
    for lib_name, (path, compiler_out) in built.items():
        _build.load_library(lib_name)
        print(f"build: {path.name}")
        for line in compiler_out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: {len(built)} libraries in {build_s:.2f} s (one nvcc per source, in parallel)")
    results["build_s"] = build_s
    results["env_ptxas"] = env_ptxas(built["env"][1])
    check(len(results["env_ptxas"]) == 14, f"ptxas reported {len(results['env_ptxas'])} of the "
          "env library's 14 kernels (K1's two paths, 8 of K2, K3, the launch floor, K2's and "
          "K3's memory skeletons)")
    check(len(flow_ptxas(built["flow"][1])) == 1, "ptxas reported no K9 in the flow library")
    results["data_ptxas"] = data_ptxas(built["data"][1])
    check(len(results["data_ptxas"]) == 3, f"ptxas reported {len(results['data_ptxas'])} of the "
          "data library's 3 kernels (K6, K7's two instantiations)")
    results["attention_ptxas"] = attention_ptxas(built["attention"][1])
    check(len(results["attention_ptxas"]) == 16, f"ptxas reported {len(results['attention_ptxas'])} "
          "of K4's 16 f32 window kernels (forward and backward at windows 32, 64 x head dims 32, "
          "64, 96, 128)")
    for lib_name in ("env", "data", "attention"):
        for key, row in results[f"{lib_name}_ptxas"].items():
            print(f"  {lib_name} ptxas {key}: {row.get('registers')} registers; {row.get('frame')}")

    phase_s = results["phase_s"] = {"build": build_s}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        phase_s[name] = time.perf_counter() - t0

    # ---- 3. kernels against their plain versions ----------------------------
    dev = torch.device("cuda")
    kernels = {}
    timed("kernels K1-K3", check_kernels_k1_k3, torch, dev, kernels)
    timed("kernels K3 sharpe", check_kernels_k3_sharpe, torch, dev, kernels)
    timed("kernels K4", check_kernels_k4, torch, dev, kernels, results)
    timed("kernels K5", check_kernels_k5, torch, dev, kernels, results, built["lob"][1])
    timed("kernels K8", check_kernels_k8, torch, dev, kernels, results, built["lob"][1])
    timed("kernels K9", check_kernels_k9, torch, dev, kernels, results, built["flow"][1])
    timed("kernels K6-K7", check_kernels_k6_k7, torch, dev, kernels)
    timed("kernels K2-K3 rows", check_kernels_k2_k3_rows, torch, dev, kernels)

    # ---- 4. main: PPO training at flagship width ---------------------------
    timed("main", main_phase, torch, kernels, results)
    # ---- 5. long: PPO training in the long-context configuration ----------
    timed("long", long_phase, torch, kernels, results)
    # ---- 6. lob: PPO training on the LOB venue -----------------------------
    timed("lob", lob_phase, torch, kernels, results)
    # ---- 7. diagnostic episodes ---------------------------------------------
    timed("episode", episode_phase, torch, results)
    # ---- 11. baseline: BASELINE.json's configurations 3 and 4 ---------------
    timed("baseline", baseline_phase, torch, kernels, results)
    # ---- 14. portfolio: BASELINE.json's configuration 5 ---------------------
    timed("portfolio", portfolio_phase, torch, kernels, results)
    # ---- 19. pbt: PBT over the bar venue at flagship width -------------------
    timed("pbt", pbt_phase, torch, kernels, results)
    # ---- 17. serve: the serving stack --------------------------------------
    timed("serve", serve_phase, torch, kernels, results)
    torch.cuda.empty_cache()
    # ---- 18. scengen: the scenario generator on the card ---------------------
    timed("scengen", scengen_phase, torch, dev, kernels, results, built["scengen"][1])
    gc.collect()
    torch.cuda.empty_cache()
    # ---- 8-10. the data path: curriculum, export, stream --------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tapes_")
    try:
        t0 = time.perf_counter()
        paths = make_tapes(tmp)
        phase_s["tapes"] = time.perf_counter() - t0
        print(f"tapes: {len(paths)} M1 tapes of {TAPE_BARS:,} bars written in "
              f"{phase_s['tapes']:.1f} s")
        timed("curriculum", curriculum_phase, torch, dev, kernels, results, paths)
        torch.cuda.empty_cache()
        timed("export", export_phase, torch, kernels, results, paths, tmp)
        torch.cuda.empty_cache()
        timed("stream", stream_phase, torch, kernels, results, paths)
        torch.cuda.empty_cache()
        # ---- 12. cli: the command line's PPO and IMPALA modes -------------
        timed("cli", cli_phase, torch, results, tmp)
        # ---- 15. portfolio cli: the command line's portfolio and PBT modes
        timed("portfolio cli", portfolio_cli_phase, torch, results, tmp)
        # ---- 16. configs: the shipped configs, financing, the GA --------
        timed("configs", configs_phase, torch, kernels, results, tmp)
        # ---- 19. telemetry: the trainers' telemetry, faults, logging ------
        timed("telemetry", telemetry_phase, torch, kernels, results, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 13. summary --------------------------------------------------------
    summary = {"kernels": [
        {
            "name": key, "route": "cuda",
            "source": SOURCES.get(key, "gymfx_tpu_torch/csrc/env_kernels.cu"),
            "replaces": REPLACES[key], "launches": k["launches"], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        }
        for key, k in kernels.items()
    ]}
    results["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    results["seconds"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(f"chip_smoke: every phase passed in {results['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()) + ")")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
