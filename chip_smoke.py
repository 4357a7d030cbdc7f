#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gymfx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX and nothing
of the JAX package, builds the port's CUDA kernels from
``gymfx_tpu_torch/csrc`` with nvcc, and runs these phases in order; any
failure exits non-zero:

1. device   CUDA must be available; prints the card and
            ``nvidia-smi --query-gpu=name,power.limit``.
2. build    nvcc builds the five kernel libraries at once, one process
            per source: K1-K3, K6-K7 and K9 (sm_90a, -fmad=false), K4, K5
            with K8 (sm_90a), timed, with ptxas' register and spill
            report (and each env-, data- and flow-library kernel's
            registers and stack frame: K1's two paths, K2's 8
            instantiations, K3, K2's and K3's memory skeletons; K6, K7's
            two instantiations; K9).
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
            and mixed.  Beside K1-K3's times: the
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
            the bf16 kernels' shared memory.  Matmuls in the plain versions
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
            card: 400 bar-venue steps (K2 and K3 400 launches, K1 401: the
            reset builds an obs too) and 50 LOB-venue steps (K3, K5, K8
            and K9 50, K1 51, K2 none); each episode must equal the same
            episode on the CPU.
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
            episode of one env for 2,048 steps over 8 shards each, equal
            to the resident episode (torch.equal, every output and the
            final state); K6 timed at a shard's group.  The episode is cut
            to 2,048 steps for time (the eager one-env step is host-bound),
            the tape is at full size.
11. summary one JSON line {"kernels": [...]}, then the last line
            {"ok": true, "device": {...}}.

It also writes its numbers to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
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
REPLACES = {
    "step_obs": "gymfx_tpu/ops/window_zscore.py:193",
    "fill_brackets": "gymfx_tpu/ops/env_dynamics.py:234",
    "mark_reward": "gymfx_tpu/ops/env_dynamics.py:280",
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
}
SOURCES = {"attention_forward": "gymfx_tpu_torch/csrc/attention_kernels.cu",
           "attention_backward": "gymfx_tpu_torch/csrc/attention_kernels.cu",
           "process_stream": "gymfx_tpu_torch/csrc/lob_kernels.cu",
           "lob_bar": "gymfx_tpu_torch/csrc/lob_kernels.cu",
           "bar_flow": "gymfx_tpu_torch/csrc/flow_kernels.cu",
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
# the bf16 kernels against the emulation of their rounding points
# (gymfx_tpu_torch/ops/cases.py): only the order of the f32 sums differs,
# so the two round nearly the same value to bf16 once: at most one ulp of
# the largest element
EMULATION_TOL = 2.0 ** -7


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
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
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


def check_k4_case(torch, fa, cases, q, k, v, g, causal):
    """K4 forward and backward at one case against the plain versions
    and, in bf16, against the emulation, with the backward repeated
    bitwise; prints the case's line.  Returns (forward err, backward err)."""
    shape, dtype = tuple(q.shape), q.dtype
    bf16 = dtype == torch.bfloat16
    out = fa.attention_forward(q, k, v, causal)
    ref = fa.attention_forward_plain(q, k, v, causal)
    torch.cuda.synchronize()
    err, tol = max_abs_err(torch, out, ref), attention_tolerance(torch, ref)
    check(out.dtype == dtype and err <= tol,
          f"K4 forward != plain at {shape} {dtype} causal={causal}: {err} > {tol}")
    del ref
    emu_errs = []
    if bf16:
        emu = cases.attention_forward_emulated(q, k, v, causal)
        e, t = max_abs_err(torch, out, emu), EMULATION_TOL * float(emu.float().abs().max())
        check(e <= t, f"K4 forward != emulation at {shape} causal={causal}: {e} > {t}")
        emu_errs.append(e / float(emu.float().abs().max()))
        del emu
    grads = fa.attention_backward(q, k, v, g, causal)
    bwd_errs = []
    for name, ours, plain in zip("qkv", grads, fa.attention_backward_plain(q, k, v, g, causal)):
        e, t = max_abs_err(torch, ours, plain), attention_tolerance(torch, plain)
        check(ours.dtype == dtype and e <= t,
              f"K4 backward d{name} != plain at {shape} {dtype} causal={causal}: {e} > {t}")
        bwd_errs.append(e)
    if bf16:
        for name, ours, emu in zip("qkv", grads, cases.attention_backward_emulated(q, k, v, g, causal)):
            e, t = max_abs_err(torch, ours, emu), EMULATION_TOL * float(emu.float().abs().max())
            check(e <= t, f"K4 backward d{name} != emulation at {shape} causal={causal}: {e} > {t}")
            emu_errs.append(e / float(emu.float().abs().max()))
        again = fa.attention_backward(q, k, v, g, causal)
        check(all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(grads, again)),
              f"K4 backward is not deterministic at {shape} causal={causal}")
        del again
    del grads
    torch.cuda.synchronize()
    line = (f"  K4 {shape} {str(dtype).split('.')[-1]} causal={causal}, route {fa.ROUTES[dtype]}: "
            f"forward max err {err:.3g} (tol {tol:.3g}), backward max err {max(bwd_errs):.3g}")
    if bf16:
        smem = ", ".join(f"{k} {v}" for k, v in fa.bf16_kernel_smem(shape[-1]).items())
        line += (f"; vs emulation max err / max|emulation| {max(emu_errs):.3g} (tol "
                 f"{EMULATION_TOL:.3g}); backward bitwise equal over two calls; head dim "
                 f"{fa.padded_head_dim(shape[-1])}, dynamic shared memory (bytes): {smem}")
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
    """A TrainState's tensors cloned, with a generator of its own at the
    same state."""
    from gymfx_tpu_torch.core import graphs

    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return type(state)(*graphs.clone_tree(tuple(state[:4])), gen)


def check_same(torch, a, b, what: str) -> None:
    """Every leaf of two trees torch.equal."""
    from gymfx_tpu_torch.resilience.guards import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    check(len(la) == len(lb), f"{what}: graphed and eager differ in structure")
    bad = [i for i, (x, y) in enumerate(zip(la, lb)) if not torch.equal(x, y)]
    check(not bad, f"{what}: graphed != eager (torch.equal) at leaves {bad[:8]} of {len(la)}")


def check_same_state(torch, a, b, what: str) -> None:
    check_same(torch, tuple(a[:4]), tuple(b[:4]), what)
    check(torch.equal(a.generator.get_state(), b.generator.get_state()),
          f"{what}: generator state graphed != eager")


def capture_seconds(trainer) -> dict:
    """Warm-up and capture seconds of each of the trainer's graphs."""
    return {f"{key[0]}{'' if i < 2 else i}": graph.capture_s
            for i, (key, graph) in enumerate(trainer._graphs.items())}


def replay_kernel_names(torch, trainer, kind: str) -> list:
    """The kernels of one replay of the trainer's first graph of ``kind``,
    by name from a torch.profiler trace (the replay overwrites the graph's
    static outputs).  The profiler stops TRACE_DRAIN_S after the replay
    ends, so that CUPTI can hand over the replay's last records."""
    graph = next(g for key, g in trainer._graphs.items() if key[0] == kind)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.graph.replay()
        torch.cuda.synchronize()
        time.sleep(TRACE_DRAIN_S)
    return [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]


def replay_launches(torch, trainer, expected: dict, label: str) -> tuple:
    """One replay of the trainer's first graph of each kind in ``expected``,
    its kernels counted by name in a torch.profiler trace; each kernel of
    KERNEL_NAMES must launch as ``expected`` says, 0 where it says nothing.

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
            got_names = replay_kernel_names(torch, trainer, kind)
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
    n, h = trainer.pcfg.n_envs, trainer.pcfg.horizon
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
    many, stacked = trainer.train_many_with_data(many_in, data, steps)
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


def check_training(rows, label: str) -> None:
    for i, row in enumerate(rows):
        m = row["metrics"]
        for key in ("loss", "policy_loss", "value_loss", "entropy", "grad_norm"):
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
        torch, trainer, {"rollout": {**per_phase, "attention_forward": 0, "attention_backward": 0},
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
    traced, _ = replay_launches(torch, trainer, {"rollout": rollout, "update": update}, "long path")
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
    traced, names = replay_launches(torch, trainer, {"rollout": expected, "update": {}}, "lob path")
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
    kernel_fns = (lob_match.process_stream, lob_bar.run_bar, env_dynamics.mark_reward,
                  window_zscore.step_obs, lob_flow.bar_flow)
    lob_match.process_stream = lob_match.process_stream_plain
    lob_bar.run_bar = lob_bar.run_bar_plain
    lob_flow.bar_flow = lob_flow.bar_flow_plain
    env_dynamics.mark_reward = env_dynamics.mark_reward_plain
    window_zscore.step_obs = lambda win, mean, std, neutral, binary_mask=(), clip=10.0: \
        window_zscore.scale_feature_window(win, mean, std, neutral, binary_mask, clip)
    for fn in counted:
        fn.launches = 0
    try:
        t0 = time.perf_counter()
        ref_state, (ref_traj, ref_last) = trainer._rollout_phase_eager(trainer.init_state(SEED))
        torch.cuda.synchronize()
        plain_phase_s = time.perf_counter() - t0
    finally:
        (lob_match.process_stream, lob_bar.run_bar, env_dynamics.mark_reward,
         window_zscore.step_obs, lob_flow.bar_flow) = kernel_fns
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
    _, out = env.rollout(rollout_mod.buy_hold_driver(), EPISODE_STEPS)
    torch.cuda.synchronize()
    episode_launches = count_launches(counted)
    # K2 and K3 once per step; K1 once per step and once for the reset's obs
    expected = {"step_obs": EPISODE_STEPS + 1, "fill_brackets": EPISODE_STEPS,
                "mark_reward": EPISODE_STEPS}
    check(episode_launches == expected, f"episode launched {episode_launches}, expected {expected}")
    cpu_env = Environment(config, device="cpu")
    _, cpu_out = cpu_env.rollout(rollout_mod.buy_hold_driver(), EPISODE_STEPS)
    for key in ("equity_delta", "reward", "done", "pos_units"):
        check(torch.equal(out[key].cpu(), cpu_out[key]), f"buy_hold episode card vs CPU: {key}")
    final_equity = float(out["equity"][-1, 0])
    check(abs(final_equity - 10000.0) < 100.0, f"implausible final equity {final_equity}")
    print(f"episode: buy_hold, 1 env, {EPISODE_STEPS} steps: final equity {final_equity:.5f} "
          f"(card == CPU, torch.equal); launches {episode_launches}")
    results["episode_final_equity"] = final_equity

    # the same on the LOB venue (flagship-lob-train: direct_fixed_sltp,
    # 40-lot entries), K5 seeding every step's books and K8 running its bar
    from gymfx_tpu_torch.config.flagship import lob_config
    from gymfx_tpu_torch.ops import lob_bar, lob_flow, lob_match

    config = lob_config(str(ROOT / "examples" / "data" / "eurusd_sample.csv"))
    counted = (*counted, lob_match.process_stream, lob_bar.run_bar, lob_flow.bar_flow)
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    _, out = Environment(config).rollout(rollout_mod.buy_hold_driver(), LOB_EPISODE_STEPS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    episode_launches = count_launches(counted)
    expected = {"step_obs": LOB_EPISODE_STEPS + 1, "fill_brackets": 0,
                "mark_reward": LOB_EPISODE_STEPS, "process_stream": LOB_EPISODE_STEPS,
                "run_bar": LOB_EPISODE_STEPS, "bar_flow": LOB_EPISODE_STEPS}
    check(episode_launches == expected, f"LOB episode launched {episode_launches}, expected {expected}")
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
    print(f"episode: LOB venue, buy_hold, 1 env, {LOB_EPISODE_STEPS} steps: final equity "
          f"{final_equity:.5f}, {trades} closed trades (card == CPU, torch.equal, every output); "
          f"launches {episode_launches}; {card_s:.1f} s on the card, {cpu_s:.1f} s on the CPU")
    results["lob_episode"] = {"final_equity": final_equity, "closed_trades": trades,
                              "card_s": card_s, "cpu_s": cpu_s}


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
    traced, _ = replay_launches(torch, trainer, {"rollout": rollout, "update": update}, "curriculum")
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
        expected = {"step_obs": STREAM_STEPS + 1, "fill_brackets": STREAM_STEPS,
                    "mark_reward": STREAM_STEPS, "decode_q16_block": served * groups}
        check(launches == expected, f"stream {mode} launched {launches}, expected {expected}")
        check(sorted(out) == sorted(ref), f"stream {mode}: output keys")
        for key in ref:
            check(torch.equal(out[key], ref[key]), f"stream {mode} vs resident episode: {key}")
        for field in ref_state._fields:
            check(torch.equal(getattr(state, field), getattr(ref_state, field)),
                  f"stream {mode} vs resident episode: final state {field}")
        rows[mode] = dict(budget_mb=budgets[mode], shard_bars=s.shard_bars, num_shards=s.num_shards,
                          ring_shards=s.ring_shards, tape_resident=s.tape_resident,
                          shards_served=served, q16_groups=groups, episode_s=episode_s,
                          launches=launches, compression_ratio=s.compression_ratio)
        print(f"stream {mode}: budget {budgets[mode]:.3f} MiB, shard_bars {s.shard_bars}, num_shards "
              f"{s.num_shards}, ring_shards {s.ring_shards}, tape_resident {s.tape_resident}; "
              f"buy_hold 1 env x {STREAM_STEPS} steps over {served} shards in {episode_s:.1f} s "
              f"(resident {resident_s:.1f} s) == the resident episode (torch.equal, every output "
              f"and the final state); launches {launches}")
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
    for lib_name in ("env", "data"):
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
    timed("kernels K4", check_kernels_k4, torch, dev, kernels, results)
    timed("kernels K5", check_kernels_k5, torch, dev, kernels, results, built["lob"][1])
    timed("kernels K8", check_kernels_k8, torch, dev, kernels, results, built["lob"][1])
    timed("kernels K9", check_kernels_k9, torch, dev, kernels, results, built["flow"][1])
    timed("kernels K6-K7", check_kernels_k6_k7, torch, dev, kernels)

    # ---- 4. main: PPO training at flagship width ---------------------------
    timed("main", main_phase, torch, kernels, results)
    # ---- 5. long: PPO training in the long-context configuration ----------
    timed("long", long_phase, torch, kernels, results)
    # ---- 6. lob: PPO training on the LOB venue -----------------------------
    timed("lob", lob_phase, torch, kernels, results)
    # ---- 7. diagnostic episodes ---------------------------------------------
    timed("episode", episode_phase, torch, results)
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 8. summary ---------------------------------------------------------
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
