#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gymfx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX and nothing
of the JAX package, builds the port's CUDA kernels from
``gymfx_tpu_torch/csrc`` with nvcc, and runs these phases in order; any
failure exits non-zero:

1. device   CUDA must be available; prints the card and
            ``nvidia-smi --query-gpu=name,power.limit``.
2. build    nvcc builds K1-K3 (sm_90a, -fmad=false), timed, with ptxas'
            register report.
3. kernels  each kernel against its plain PyTorch version on the card at
            the main path's shapes (torch.equal): K1 at (8192, 32, 5) with
            NaN, ±inf, neutral envs and a binary mask; K2 and K3 at 8192
            envs over every combination of their static flags.  Times:
            device time per call from CUDA-graph replays (CUDA events,
            median of 21 replays of 20 calls), the wrapper's host time per
            call, and the bound: the larger of the bytes moved over the
            H100 SXM's 3.35 TB/s and the f32 operations over its 67
            TFLOP/s.
4. main     the PPO rollout phase at flagship width: 8,192 bar-venue envs,
            window 32, OHLCV features (F=5, obs dim 164), the 3x256 tanh
            MLP in bf16 with weights from torch.Generator(seed), horizon
            64, three phases.  The K1/K2/K3 launch counts must each rise by
            exactly 3 x 64, every output must be finite, and one phase
            re-run with the plain versions on the card must give the same
            env states, rewards and dones (torch.equal).
5. episode  Environment.rollout with the buy_hold driver, 1 env, 400
            steps on the card: the launch counts must be 400 for K2 and
            K3 and 401 for K1 (the reset builds an obs too), and the
            episode must equal the same episode on the CPU.
6. summary  one JSON line {"kernels": [...]}, then the last line
            {"ok": true, "device": {...}}.

It also writes its numbers to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
N_ENVS = 8192
WINDOW = 32
HORIZON = 64
PHASES = 3
EPISODE_STEPS = 400

# the H100 SXM data sheet: HBM3 bytes/s and f32 FLOP/s outside the tensor cores
BANDWIDTH, F32_FLOPS = 3.35e12, 67e12
# f32 arithmetic per element (K1) or per env (K2, K3), counted from the
# kernel source (compares and selects included): the operation side of
# the bound, which bytes outweigh for all three
OPS_PER_ITEM = {"step_obs": 8, "fill_brackets": 120, "mark_reward": 20}
REPLACES = {
    "step_obs": "gymfx_tpu/ops/window_zscore.py:193",
    "fill_brackets": "gymfx_tpu/ops/env_dynamics.py:234",
    "mark_reward": "gymfx_tpu/ops/env_dynamics.py:280",
}


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
    results["device"] = {"name": name, "nvidia_smi": smi_line,
                         "bandwidth_bytes_per_s": BANDWIDTH, "f32_flops": F32_FLOPS}

    # ---- 2. build ----------------------------------------------------------
    from gymfx_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, compiler_out = _build.build_library(ptxas_verbose=True)
    build_s = time.perf_counter() - t0
    _build.load_library()
    print(f"build: {path.name} in {build_s:.2f} s")
    for line in compiler_out.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    results["build_s"] = build_s

    from gymfx_tpu_torch.core import rollout as rollout_mod
    from gymfx_tpu_torch.config.flagship import FEATURE_COLUMNS, flagship_config
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.core.types import EnvConfig
    from gymfx_tpu_torch.ops import cases, env_dynamics, window_zscore
    from gymfx_tpu_torch.train.ppo import PPORollout, ppo_config_from

    dev = torch.device("cuda")
    kernels = {}

    def bound(key, moved, items):
        byte_ms = moved / BANDWIDTH * 1e3
        op_ms = OPS_PER_ITEM[key] * items / F32_FLOPS * 1e3
        return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")

    def on_card(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    # ---- 3. kernels against their plain versions ----------------------------
    n, w, f = N_ENVS, WINDOW, len(FEATURE_COLUMNS)
    win, mean, std, neutral = on_card(*cases.obs_case(SEED, n, w, f))
    err = 0.0
    for mask, clip in [((), 10.0), ((False, False, False, False, True), 1.5), ((), 0.0)]:
        ours = window_zscore.step_obs(win, mean, std, neutral, binary_mask=mask, clip=clip)
        ref = window_zscore.scale_feature_window(win, mean, std, neutral, mask, clip)
        torch.cuda.synchronize()
        check(torch.equal(ours, ref), f"K1 step_obs != plain (mask={mask}, clip={clip})")
        err = max(err, max_abs_err(torch, ours, ref))
    k1_ms = device_ms(torch, lambda: window_zscore.step_obs(win, mean, std, neutral))
    k1_plain = device_ms(torch, lambda: window_zscore.scale_feature_window(win, mean, std, neutral))
    k1_host = host_us(torch, lambda: window_zscore.step_obs(win, mean, std, neutral))
    b_ms, b_by = bound("step_obs", 2 * nbytes(win) + nbytes(mean, std, neutral), win.numel())
    kernels["step_obs"] = dict(max_abs_err=err, ms=k1_ms, plain_ms=k1_plain, bound_ms=b_ms,
                               bound_by=b_by, host_us=k1_host)

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
    torch.cuda.synchronize()
    print(f"kernels: K1 equal to plain on 3 mask/clip cases; K2 and K3 equal to plain on {combos} flag combinations")

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
    b_ms, b_by = bound("fill_brackets", moved2, n)
    kernels["fill_brackets"] = dict(
        max_abs_err=errs["fill_brackets"], ms=device_ms(torch, fill),
        plain_ms=device_ms(torch, fill_plain), bound_ms=b_ms, bound_by=b_by,
        host_us=host_us(torch, fill),
    )
    markf = lambda: env_dynamics.mark_reward(st, c, mark, live, cfg, p)  # noqa: E731
    mark_plain = lambda: env_dynamics.mark_reward_plain(st, c, mark, live, cfg, p)  # noqa: E731
    # eight fields, the close and two flags read; six fields and the reward written
    moved3 = nbytes(*(getattr(st, k) for k in env_dynamics.MARK_FLOAT_FIELDS), c, mark, live) \
        + nbytes(*(getattr(st, k) for k in env_dynamics.MARK_OUT_FIELDS), st.pos)
    b_ms, b_by = bound("mark_reward", moved3, n)
    kernels["mark_reward"] = dict(
        max_abs_err=errs["mark_reward"], ms=device_ms(torch, markf),
        plain_ms=device_ms(torch, mark_plain), bound_ms=b_ms, bound_by=b_by,
        host_us=host_us(torch, markf),
    )
    for key, k in kernels.items():
        print(f"  {key}: {k['ms'] * 1e3:.2f} us/call on the card (plain {k['plain_ms'] * 1e3:.2f} us, "
              f"bound {k['bound_ms'] * 1e3:.2f} us by {k['bound_by']} at {BANDWIDTH / 1e12:.2f} TB/s), "
              f"wrapper host {k['host_us']:.1f} us/call")

    # ---- 4. the main path: the PPO rollout phase at flagship width ---------
    config = flagship_config(str(ROOT / "examples" / "data" / "eurusd_sample.csv"))
    check(config["num_envs"] == N_ENVS and config["ppo_horizon"] == HORIZON
          and config["window_size"] == WINDOW, "flagship config changed")
    env = Environment(config)
    check(env.device.type == "cuda", "Environment did not default to CUDA")
    ro = PPORollout(env, ppo_config_from(config))
    check(ro.obs_dim == 164, f"obs dim {ro.obs_dim} != 164")
    state = ro.init_state(SEED)
    torch.cuda.synchronize()
    counted = (window_zscore.step_obs, env_dynamics.fill_brackets, env_dynamics.mark_reward)
    for fn in counted:
        fn.launches = 0
    phase_s, outputs = [], []
    for _ in range(PHASES):
        t0 = time.perf_counter()
        state, traj, last_value = ro.rollout_phase(state)
        torch.cuda.synchronize()
        phase_s.append(time.perf_counter() - t0)
        outputs.append((state, traj, last_value))
    launches = {fn.__name__: fn.launches for fn in counted}
    expected = PHASES * HORIZON
    for key, count in launches.items():
        check(count == expected, f"main path launched {key} {count} times, expected {expected}")
        kernels[key]["launches"] = count
    for s_, traj, lv in outputs:
        check(tuple(traj["obs"].shape) == (HORIZON, N_ENVS, 164) and traj["obs"].dtype == torch.bfloat16,
              "trajectory obs shape/dtype")
        for key in ("obs", "logp", "value", "reward"):
            check(bool(torch.isfinite(traj[key]).all()), f"non-finite trajectory {key}")
        check(bool(torch.isfinite(lv).all()), "non-finite bootstrap value")
        for field in ("pos", "cash_delta", "equity_delta", "entry_price", "max_drawdown_pct"):
            check(bool(torch.isfinite(getattr(s_.env_states, field)).all()), f"non-finite state {field}")
    trades = int(outputs[-1][0].env_states.trade_count.sum())
    check(trades > 0, "the policy made no trade")
    steady = statistics.median(phase_s[1:])
    print(f"main path: {PHASES} rollout phases of {HORIZON} steps x {N_ENVS} envs: "
          f"{', '.join(f'{s * 1e3:.1f}' for s in phase_s)} ms; "
          f"{N_ENVS * HORIZON / steady:,.0f} env steps/s (median of phases 2-{PHASES}); "
          f"launches {launches}; {trades} closed trades")

    # the same first phase with the plain versions on the card
    kernel_fns = (env_dynamics.fill_brackets, env_dynamics.mark_reward, window_zscore.step_obs)
    env_dynamics.fill_brackets = env_dynamics.fill_brackets_plain
    env_dynamics.mark_reward = env_dynamics.mark_reward_plain
    window_zscore.step_obs = lambda win, mean, std, neutral, binary_mask=(), clip=10.0: \
        window_zscore.scale_feature_window(win, mean, std, neutral, binary_mask, clip)
    try:
        t0 = time.perf_counter()
        ref_state, ref_traj, ref_last = ro.rollout_phase(ro.init_state(SEED))
        torch.cuda.synchronize()
        plain_phase_s = time.perf_counter() - t0
    finally:
        env_dynamics.fill_brackets, env_dynamics.mark_reward, window_zscore.step_obs = kernel_fns
    check({fn.__name__: fn.launches for fn in counted} == launches,
          "the plain-version phase launched a kernel")
    k_state, k_traj, k_last = outputs[0]
    for key in ("obs", "action", "reward", "done", "logp", "value"):
        check(torch.equal(k_traj[key], ref_traj[key]), f"main path vs plain versions: traj {key}")
    for field in ref_state.env_states._fields:
        check(torch.equal(getattr(k_state.env_states, field), getattr(ref_state.env_states, field)),
              f"main path vs plain versions: env state {field}")
    check(torch.equal(k_last, ref_last), "main path vs plain versions: bootstrap value")
    print(f"main path == plain versions on the card (phase 1, torch.equal); "
          f"plain phase {plain_phase_s * 1e3:.1f} ms")
    results["main_path"] = {
        "n_envs": N_ENVS, "horizon": HORIZON, "window": WINDOW, "features": f, "obs_dim": 164,
        "policy": "mlp 3x256 tanh bf16", "phase_ms": [s * 1e3 for s in phase_s],
        "env_steps_per_s": N_ENVS * HORIZON / steady, "plain_phase_ms": plain_phase_s * 1e3,
        "launches": launches, "closed_trades": trades,
    }

    # ---- 5. diagnostic episode ----------------------------------------------
    for fn in counted:
        fn.launches = 0
    _, out = env.rollout(rollout_mod.buy_hold_driver(), EPISODE_STEPS)
    torch.cuda.synchronize()
    episode_launches = {fn.__name__: fn.launches for fn in counted}
    # K2 and K3 once per step; K1 once per step and once for the reset's obs
    expected = {"step_obs": EPISODE_STEPS + 1, "fill_brackets": EPISODE_STEPS,
                "mark_reward": EPISODE_STEPS}
    check(episode_launches == expected,
          f"episode launched {episode_launches}, expected {expected}")
    cpu_env = Environment(config, device="cpu")
    _, cpu_out = cpu_env.rollout(rollout_mod.buy_hold_driver(), EPISODE_STEPS)
    for key in ("equity_delta", "reward", "done", "pos_units"):
        check(torch.equal(out[key].cpu(), cpu_out[key]), f"buy_hold episode card vs CPU: {key}")
    final_equity = float(out["equity"][-1, 0])
    check(abs(final_equity - 10000.0) < 100.0, f"implausible final equity {final_equity}")
    print(f"episode: buy_hold, 1 env, {EPISODE_STEPS} steps: final equity {final_equity:.5f} "
          f"(card == CPU, torch.equal); launches {episode_launches}")
    results["episode_final_equity"] = final_equity

    # ---- 6. summary ---------------------------------------------------------
    summary = {"kernels": [
        {
            "name": key, "route": "cuda", "source": "gymfx_tpu_torch/csrc/env_kernels.cu",
            "replaces": REPLACES[key], "launches": k["launches"], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
        }
        for key, k in kernels.items()
    ]}
    results["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
