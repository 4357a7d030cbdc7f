"""Where the rollout phase's time goes, on the card.

    python -m gymfx_tpu_torch.profile_rollout [--n_envs 8192 32768] [--horizon 64]

For each env count: the flagship configuration's PPO rollout phase
(config/flagship.py) is run once to warm up, timed over three phases
(host clock around work that ends in ``torch.cuda.synchronize``), then
run once more under ``torch.profiler`` with named ranges around the
policy forward, the action draw, the env transition, the obs build and
flatten, and the auto-reset.  It prints and writes to
``chiprun_out/profile_rollout.json``:

* env steps/s and ms per phase;
* device busy time (the union of CUDA kernel intervals) and the device's
  idle share of the profiled phase's wall time;
* CUDA kernel launches per env step, and device time by kernel group
  (the port's kernels K1-K3, the policy GEMMs, everything else);
* host time by range (the profiler's wall time summed per range);
* the device time of one env step with no host in the way: the policy
  forward, the env transition, the obs and the auto-reset (greedy
  actions, so no generator) captured once in a CUDA graph and replayed
  between CUDA events (median of 21 replays).

It needs a CUDA device and raises without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
from collections import defaultdict

import torch

from gymfx_tpu_torch import resolve_device
from gymfx_tpu_torch.config.flagship import flagship_config
from gymfx_tpu_torch.core import env as env_core
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.train import ppo

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANGES = ("policy", "sample", "transition", "build_obs", "flatten_obs", "masked_reset")
OUR_KERNELS = ("step_obs_kernel", "fill_brackets_kernel", "mark_reward_kernel")


def _ranged(name, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _kernel_group(name: str) -> str:
    for ours in OUR_KERNELS:
        if ours in name:
            return ours
    if any(key in name.lower() for key in ("gemm", "xmma", "cutlass", "cublas")):
        return "policy_gemm"
    return "other"


def _busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop
    return busy


def graphed_step_ms(ro, state) -> float:
    """Device ms of one rollout step replayed from a CUDA graph."""
    env, cfg = ro.env, ro.env.cfg

    def step():
        logits, _ = ro.policy(state.obs_vec)
        st2, _, done, _ = env_core.transition(cfg, env.params, env.data, state.env_states,
                                              torch.argmax(logits, dim=1))
        obs2 = ppo.flatten_obs(env_core.build_obs(st2, env.data, cfg, env.params), ro.obs_spec)
        return (ppo.masked_reset(done, ro._reset_state, st2),
                ppo.masked_reset(done, ro._reset_vec, obs2))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    times = []
    for _ in range(21):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def profile_at(n_envs: int, horizon: int, device: torch.device) -> dict:
    config = flagship_config(str(ROOT / "examples" / "data" / "eurusd_sample.csv"),
                             num_envs=n_envs, ppo_horizon=horizon)
    ro = ppo.PPORollout(Environment(config, device=device), ppo.ppo_config_from(config))
    state = ro.init_state(0)
    state = ro.rollout_phase(state)[0]
    torch.cuda.synchronize()
    phase_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        state = ro.rollout_phase(state)[0]
        torch.cuda.synchronize()
        phase_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = graphed_step_ms(ro, state)

    saved = {name: getattr(mod, name) for mod, name in
             ((env_core, "transition"), (env_core, "build_obs"), (ppo, "flatten_obs"),
              (ppo, "masked_reset"), (ppo, "sample_categorical"))}
    env_core.transition = _ranged("transition", saved["transition"])
    env_core.build_obs = _ranged("build_obs", saved["build_obs"])
    ppo.flatten_obs = _ranged("flatten_obs", saved["flatten_obs"])
    ppo.masked_reset = _ranged("masked_reset", saved["masked_reset"])
    ppo.sample_categorical = _ranged("sample", saved["sample_categorical"])
    forward = ro.policy.forward
    ro.policy.forward = _ranged("policy", forward)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            ro.rollout_phase(state)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for name, fn in saved.items():
            setattr(env_core if name in ("transition", "build_obs") else ppo, name, fn)
        ro.policy.forward = forward

    intervals, by_group, launches = [], defaultdict(float), defaultdict(int)
    host_us = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            intervals.append((ev.time_range.start, ev.time_range.end))
            group = _kernel_group(ev.name)
            by_group[group] += ev.time_range.elapsed_us()
            launches[group] += 1
        elif ev.name in RANGES:
            host_us[ev.name] += ev.time_range.elapsed_us()
    busy = _busy_us(intervals)
    steady = sorted(phase_ms)[1]
    return {
        "n_envs": n_envs,
        "horizon": horizon,
        "phase_ms": phase_ms,
        "env_steps_per_s": n_envs * horizon / (steady / 1e3),
        "eager_step_ms": steady / horizon,
        "graphed_step_device_ms": step_ms,
        "profiled_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3 if intervals else None,
        "device_idle_share": (1 - busy / wall_us) if intervals else None,
        "kernel_launches_per_step": {k: v / horizon for k, v in launches.items()},
        "device_ms_by_group": {k: v / 1e3 for k, v in by_group.items()},
        "host_ms_by_range": {k: v / 1e3 for k, v in host_us.items()},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_envs", type=int, nargs="+", default=[8192])
    ap.add_argument("--horizon", type=int, default=64)
    args = ap.parse_args(argv)
    device = resolve_device()
    rows = [profile_at(n, args.horizon, device) for n in args.n_envs]
    for row in rows:
        print(json.dumps(row))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_rollout.json").write_text(json.dumps(
        {"device": torch.cuda.get_device_name(0), "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
