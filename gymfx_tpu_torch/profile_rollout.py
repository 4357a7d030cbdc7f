"""Where the rollout and update phases' time goes, on the card, eager
and replayed from their CUDA graphs.

    python -m gymfx_tpu_torch.profile_rollout
        [--config flagship|long|lob|sharpe|impala] [--n_envs 8192 32768]
        [--horizon 64]

For each env count: the configuration's PPO rollout phase
(config/flagship.py: ``flagship_config``, ``long_context_config``,
``lob_config`` on the LOB venue or ``baseline_sharpe_config``, PPO on the
sharpe reward) or, for ``impala`` (``impala_lstm_config``), its IMPALA
rollout phase, is run once to warm up, timed over three
phases (host clock around work that ends in ``torch.cuda.synchronize``),
then run once more under ``torch.profiler`` with named ranges around the
policy forward, the action draw, the env transition, the obs build and
encoding, and the auto-reset; on the LOB venue also around the five
stages of ``lob/venue.execute_bar`` inside the transition: ``lob_seed``
(the books seeded through K5), ``lob_flow`` (the bar's flow messages,
K9), ``lob_orders`` (the agent's int32 inputs), ``lob_bar``
(the bar's book work, K8) and ``lob_fills`` (the open and exit fills).  The update phase on that rollout's trajectory likewise, with
ranges around GAE, the minibatch gathers, the loss forward, the loss and
its gradients (forward and ``autograd.grad``), the optimizer, the guard's
finite check and selects, and the quarantine; for IMPALA, the learner's
replay of the segment through the LSTM and V-trace in place of GAE and
the minibatches.  Then both phases from
their CUDA graphs (train/ppo.py): the capture's seconds, three timed
replays and one profiled replay.  It
prints and writes to ``chiprun_out/profile_rollout_<config>.json``:

* env steps/s and ms per phase, eager and graphed;
* device busy time (the union of CUDA kernel intervals) and the device's
  idle share of the profiled phase's wall time, eager and graphed;
* CUDA kernel launches per env step (rollout) or per phase (update), and
  device time by kernel group (the port's kernels K1-K5, K8, K9, the policy
  GEMMs, everything else) and the kernels by name (``kernels_by_name``:
  launches and device ms), so a replay's split shows what leads;
* host time by range (the profiler's wall time summed per range; nested
  ranges count inside their parent too) and device time by range (the
  kernels each range launched, the backward's apart: autograd runs it on
  its own thread), and the kernels that took the most device time;
* the device time of one env step with no host in the way: the policy
  forward, the env transition, the obs and the auto-reset (greedy
  actions, so no generator) captured once in a CUDA graph and replayed
  between CUDA events (median of 21 replays).

It needs a CUDA device and raises without one.
"""
from __future__ import annotations

import argparse
import functools
import gc
import json
import pathlib
import subprocess
import time
from collections import defaultdict

import torch

from gymfx_tpu_torch import resolve_device
from gymfx_tpu_torch.config.flagship import (
    baseline_sharpe_config,
    flagship_config,
    impala_lstm_config,
    lob_config,
    long_context_config,
)
from gymfx_tpu_torch.core import env as env_core
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.lob import venue
from gymfx_tpu_torch.ops import lob_bar
from gymfx_tpu_torch.train import impala, ppo

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = {"flagship": flagship_config, "long": long_context_config, "lob": lob_config,
           "sharpe": baseline_sharpe_config, "impala": impala_lstm_config}
RANGES = ("policy", "sample", "transition", "build_obs", "encode_obs", "masked_reset",
          "lob_seed", "lob_flow", "lob_orders", "lob_bar", "lob_fills")
UPDATE_RANGES = ("gae", "take", "loss_forward", "loss_and_grads", "optimizer",
                 "apply_updates", "guard_finite", "guard_select", "quarantine", "masked_reset",
                 "learner_replay", "vtrace")
TOP_KERNELS = 12
# kernel-name prefixes: K1 (both paths), K2, K3, K4 forward and backward, K5, K8, K9
OUR_KERNELS = ("step_obs", "fill_brackets_kernel", "mark_reward_kernel", "attn_fwd", "attn_bwd",
               "lob_stream_kernel", "lob_bar_kernel", "bar_flow_kernel")
# (module, attribute, range name) of every function the profile ranges
RANGED = (
    (env_core, "transition", "transition"), (env_core, "build_obs", "build_obs"),
    (ppo, "masked_reset", "masked_reset"), (ppo, "sample_categorical", "sample"),
    (venue, "seed_book", "lob_seed"), (venue, "bar_flow", "lob_flow"),
    (venue, "bar_orders", "lob_orders"), (lob_bar, "run_bar", "lob_bar"),
    (venue, "bar_fills", "lob_fills"),
    (ppo, "apply_updates", "apply_updates"), (ppo, "tree_all_finite", "guard_finite"),
    (ppo, "select_tree", "guard_select"), (ppo, "quarantine_mask", "quarantine"),
    (impala, "masked_reset", "masked_reset"), (impala, "apply_updates", "apply_updates"),
    (impala, "tree_all_finite", "guard_finite"), (impala, "select_tree", "guard_select"),
    (impala, "quarantine_mask", "quarantine"),
)


def _ranged(name, fn):
    @functools.wraps(fn)  # a wrapper's launch count travels with it
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
    """Device ms of one rollout step replayed from a CUDA graph (PPO's
    state or IMPALA's, whose actors act with their stale params)."""
    env, cfg = ro.env, ro.env.cfg
    params = state.actor_params if isinstance(state, impala.ImpalaState) else state.params

    def step():
        logits, _, _ = ro.policy_step(params, state.obs_vec, state.policy_carry)
        st2, _, done, _ = env_core.transition(cfg, env.params, env.data, state.env_states,
                                              torch.argmax(logits, dim=1))
        obs2 = ro._encode(env_core.build_obs(st2, env.data, cfg, env.params))
        return (ppo.masked_reset(done, ro._reset_state, st2),
                ppo.masked_reset(done, ro._reset_vec, obs2))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc.collect()  # no cyclic collection mid-capture (core/graphs.PhaseGraph)
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            step()
    finally:
        gc.enable()
    times = []
    for _ in range(21):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _timed(fn, reps: int = 3):
    """ms of ``reps`` calls of ``fn``, each ended by a synchronize."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _profiled(fn, ro, per: int) -> dict:
    """One call of ``fn`` under ``torch.profiler`` with the named ranges:
    its wall time, the device's busy and idle share, and launches (per
    ``per``), device time and host time by group and range."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in RANGED]
    for (mod, attr, fn_), (_, _, label) in zip(saved, RANGED):
        setattr(mod, attr, _ranged(label, fn_))
    methods = {name: label for name, label in (
        ("_encode", "encode_obs"), ("_gae", "gae"), ("_loss", "loss_forward"),
        ("loss_and_grads", "loss_and_grads"), ("_learner_replay", "learner_replay"),
        ("_vtrace", "vtrace")) if hasattr(ro, name)}
    kept = {name: getattr(ro, name) for name in methods}
    forward, update = ro.policy.forward, ro.optimizer.update
    plan = ppo.minibatch_plan

    def ranged_plan(*args, **kwargs):
        n_perm, mb, take = plan(*args, **kwargs)
        return n_perm, mb, _ranged("take", take)

    for name, label in methods.items():
        setattr(ro, name, _ranged(label, kept[name]))
    ro.policy.forward = _ranged("policy", forward)
    ro.optimizer.update = _ranged("optimizer", update)
    ppo.minibatch_plan = ranged_plan
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for mod, attr, fn_ in saved:
            setattr(mod, attr, fn_)
        for name, value in kept.items():
            setattr(ro, name, value)
        ro.policy.forward, ro.optimizer.update = forward, update
        ppo.minibatch_plan = plan

    intervals, by_group, launches, count = [], defaultdict(float), defaultdict(int), defaultdict(int)
    host_us, device_us, by_name = defaultdict(float), defaultdict(float), defaultdict(float)
    ranges = set(RANGES) | set(UPDATE_RANGES)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.name in ranges:
            continue  # a range's own span on the device timeline, no kernel
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            intervals.append((ev.time_range.start, ev.time_range.end))
            group = _kernel_group(ev.name)
            by_group[group] += ev.time_range.elapsed_us()
            by_name[ev.name] += ev.time_range.elapsed_us()
            count[ev.name] += 1
            launches[group] += 1
        elif ev.name in ranges:
            host_us[ev.name] += ev.time_range.elapsed_us()
            device_us[ev.name] += ev.device_time_total
        elif ev.name.startswith("autograd::engine::evaluate_function"):
            # the backward runs on autograd's device thread, outside the
            # ranges of the thread that called autograd.grad
            device_us["backward"] += ev.device_time_total
    busy = _busy_us(intervals)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return {
        "profiled_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3 if intervals else None,
        "device_idle_share": (1 - busy / wall_us) if intervals else None,
        "kernel_launches_per": {k: v / per for k, v in launches.items()},
        "device_ms_by_group": {k: v / 1e3 for k, v in by_group.items()},
        "host_ms_by_range": {k: v / 1e3 for k, v in host_us.items()},
        "device_ms_by_range": {k: v / 1e3 for k, v in device_us.items()},
        "top_kernels_ms": {name: us / 1e3 for name, us in top},
        "kernels_by_name": {name: {"launches_per": count[name] / per, "ms": us / 1e3}
                            for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])},
    }


def profile_at(n_envs, horizon, device: torch.device, config_name: str = "flagship") -> dict:
    """One row: ``n_envs`` envs and a horizon (the IMPALA unroll) of
    ``horizon`` steps (None: the configuration's own)."""
    over = {} if n_envs is None else {"num_envs": n_envs}
    if horizon is not None:
        over["impala_unroll" if config_name == "impala" else "ppo_horizon"] = horizon
    config = CONFIGS[config_name](str(ROOT / "examples" / "data" / "eurusd_sample.csv"), **over)
    n_envs = config["num_envs"]
    env = Environment(config, device=device)
    if config_name == "impala":
        return _impala_row(impala.ImpalaTrainer(env, impala.impala_config_from(config)), config)
    horizon = config["ppo_horizon"]
    ro = ppo.PPOTrainer(env, ppo.ppo_config_from(config))
    state = ro.init_state(0)
    state = ro._rollout_phase_eager(state)[0]
    torch.cuda.synchronize()
    holder = [state]

    def eager_rollout():
        holder[0] = ro._rollout_phase_eager(holder[0])[0]

    phase_ms = _timed(eager_rollout)
    step_ms = graphed_step_ms(ro, holder[0])
    rollout = _profiled(lambda: ro._rollout_phase_eager(holder[0]), ro, horizon)
    steady = sorted(phase_ms)[1]
    row = {
        "config": config_name, "n_envs": n_envs, "horizon": horizon,
        "phase_ms": phase_ms, "env_steps_per_s": n_envs * horizon / (steady / 1e3),
        "eager_step_ms": steady / horizon, "graphed_step_device_ms": step_ms,
        **rollout,
    }

    # the update phase on one trajectory, eager
    inter, rollout_out = ro._rollout_phase_eager(ro.init_state(1))
    ro._update_phase_eager(inter, rollout_out)
    row["update_eager"] = {
        "phase_ms": _timed(lambda: ro._update_phase_eager(inter, rollout_out)),
        **_profiled(lambda: ro._update_phase_eager(inter, rollout_out), ro, 1),
    }

    # both phases replayed from their graphs
    gen = inter.generator
    graph = ro._rollout_graphed(inter, None, {})

    def replay_rollout():
        ro._replay(graph, None, gen)

    ms = _timed(replay_rollout)
    row["rollout_graphed"] = {
        "capture_s": graph.capture_s, "phase_ms": ms,
        "env_steps_per_s": n_envs * horizon / (sorted(ms)[1] / 1e3),
        **_profiled(replay_rollout, ro, horizon),
    }
    inputs = dict(params=inter.params, opt_state=inter.opt_state, env_states=inter.env_states,
                  obs_vec=inter.obs_vec, policy_carry=inter.policy_carry, traj=rollout_out[0],
                  last_value=rollout_out[1])
    graph = ro._update_graphed(inputs, None, gen)

    def replay_update():
        ro._replay(graph, None, gen)

    row["update_graphed"] = {"capture_s": graph.capture_s, "phase_ms": _timed(replay_update),
                             **_profiled(replay_update, ro, 1)}
    return row


def _impala_row(tr, config) -> dict:
    """profile_at's row for the IMPALA trainer: its rollout and update
    phases, eager and replayed from their graphs."""
    n_envs, unroll = tr.icfg.n_envs, tr.icfg.unroll
    holder = [tr._rollout_phase_eager(tr.init_state(0))[0]]
    torch.cuda.synchronize()

    def eager_rollout():
        holder[0] = tr._rollout_phase_eager(holder[0])[0]

    phase_ms = _timed(eager_rollout)
    steady = sorted(phase_ms)[1]
    row = {
        "config": "impala", "n_envs": n_envs, "horizon": unroll, "phase_ms": phase_ms,
        "env_steps_per_s": n_envs * unroll / (steady / 1e3), "eager_step_ms": steady / unroll,
        "graphed_step_device_ms": graphed_step_ms(tr, holder[0]),
        **_profiled(lambda: tr._rollout_phase_eager(holder[0]), tr, unroll),
    }
    inter, rollout_out = tr._rollout_phase_eager(tr.init_state(1))
    tr._update_phase_eager(inter, rollout_out)
    row["update_eager"] = {
        "phase_ms": _timed(lambda: tr._update_phase_eager(inter, rollout_out)),
        **_profiled(lambda: tr._update_phase_eager(inter, rollout_out), tr, 1),
    }
    gen = inter.generator
    graph = tr._rollout_graphed(inter, {})

    def replay_rollout():
        tr._replay(graph, None, gen)

    ms = _timed(replay_rollout)
    row["rollout_graphed"] = {
        "capture_s": graph.capture_s, "phase_ms": ms,
        "env_steps_per_s": n_envs * unroll / (sorted(ms)[1] / 1e3),
        **_profiled(replay_rollout, tr, unroll),
    }
    graph = tr._update_graphed(tr._update_inputs(inter, rollout_out), gen)

    def replay_update():
        tr._replay(graph, None, gen)

    row["update_graphed"] = {"capture_s": graph.capture_s, "phase_ms": _timed(replay_update),
                             **_profiled(replay_update, tr, 1)}
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="flagship")
    ap.add_argument("--n_envs", type=int, nargs="+", default=[None],
                    help="env counts (default: the configuration's own)")
    ap.add_argument("--horizon", type=int, default=None,
                    help="the rollout's steps (default: the configuration's own)")
    args = ap.parse_args(argv)
    device = resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    rows = [profile_at(n, args.horizon, device, args.config) for n in args.n_envs]
    for row in rows:
        print(json.dumps(row))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_rollout_{args.config}.json").write_text(json.dumps(
        {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
