"""Where the wall time of a Gymnasium shell step and of a serving
``decide_batch`` goes, on the card.

    python -m gymfx_tpu_torch.profile_host [--steps 300] [--iters 200]

* The shell (``gym_env.GymFxEnv`` over flagship-train's config cut to
  400 bars, discrete and continuous) and the vector env
  (``vector_env.GymFxVectorEnv``, 8,192 envs): the wall ms of a step
  beside the device ms of its graph's replay (CUDA events, median of 21
  replays), and ``cProfile``'s host functions over ``--steps`` steps
  (own time a step, the most expensive first).
* serve-mlp and serve-mlp-continuous (``serve.engine_from_config`` at
  the default ladder): ``decide_batch`` of 1,024 rows, the two engines
  timed in turns (discrete, continuous, continuous, discrete; ``--iters``
  calls each), the device ms of the bucket's replay, and ``cProfile``'s
  host functions of the calls.

It prints one JSON line and writes it to ``chiprun_out/profile_host.json``.
It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import math
import pathlib
import pstats
import statistics
import subprocess
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSV = str(ROOT / "examples" / "data" / "eurusd_sample.csv")
TOP = 12


def replay_ms(graph, trials: int = 21) -> float:
    """The median device ms of ``trials`` replays of a PhaseGraph."""
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_functions(profile: cProfile.Profile, calls: int) -> list:
    """The ``TOP`` functions of most own time: [name, own µs a call of the
    profiled loop, total µs a call]."""
    stats = pstats.Stats(profile)
    rows = []
    for (path, line, name), (_, _, own, total, _) in stats.stats.items():
        where = f"{pathlib.Path(path).name}:{line}({name})" if line else name
        rows.append([where, own * 1e6 / calls, total * 1e6 / calls])
    rows.sort(key=lambda r: -r[1])
    return [[w, round(o, 2), round(t, 2)] for w, o, t in rows[:TOP]]


def profile_shell(steps: int) -> dict:
    from gymfx_tpu_torch.config.flagship import flagship_config
    from gymfx_tpu_torch.gym_env import GymFxEnv
    from gymfx_tpu_torch.vector_env import GymFxVectorEnv

    out = {}
    for mode in ("discrete", "continuous"):
        shell = GymFxEnv(flagship_config(CSV, action_space_mode=mode, max_rows=400))
        script = ([(1, 0, 0, 2, 2, 0, 1, 1, 0, 0)[i % 10] for i in range(steps)]
                  if mode == "discrete" else
                  [np.float32([0.9 * math.sin(0.7 * i)]) for i in range(steps)])
        shell.reset(seed=0)
        shell.step(script[0])  # captures
        t0 = time.perf_counter()
        for a in script[1:]:
            shell.step(a)
        wall = (time.perf_counter() - t0) * 1e3 / (steps - 1)
        shell.reset(seed=0)
        profile = cProfile.Profile()
        profile.enable()
        for a in script[1:]:
            shell.step(a)
        profile.disable()
        program = shell._program
        out[mode] = {"ms_a_step": wall, "replay_ms": replay_ms(program.graph),
                     "graph_outputs": len(program._layout[1]) if program._layout else None,
                     "host_functions": host_functions(profile, steps - 1)}
    vec = GymFxVectorEnv(flagship_config(CSV, max_rows=48), 8192)
    rng = np.random.default_rng(0)
    actions = [rng.integers(0, 3, 8192) for _ in range(64)]
    vec.reset(seed=0)
    vec.step(actions[0])
    t0 = time.perf_counter()
    for a in actions[1:]:
        vec.step(a)
    wall = (time.perf_counter() - t0) * 1e3 / 63
    profile = cProfile.Profile()
    profile.enable()
    for a in actions[1:]:
        vec.step(a)
    profile.disable()
    out["vector"] = {"ms_a_step": wall, "replay_ms": replay_ms(vec._program.graph),
                     "host_functions": host_functions(profile, 63)}
    return out


def profile_serving(iters: int) -> dict:
    from gymfx_tpu_torch.config import DEFAULT_VALUES
    from gymfx_tpu_torch.serve import engine_from_config

    engines, rows = {}, {}
    for label, mode in (("serve-mlp", "discrete"), ("serve-mlp-continuous", "continuous")):
        config = dict(DEFAULT_VALUES, input_data_file=CSV, window_size=32, seed=0,
                      policy="mlp", action_space_mode=mode)
        bundle = engine_from_config(config)
        engines[label] = bundle.engine
        base = bundle.encode(bundle.reset_obs)[0].cpu()
        gen = torch.Generator().manual_seed(6)
        rows[label] = base[None] + 0.01 * torch.randn((1024, *bundle.engine.obs_shape),
                                                      generator=gen).to(base.dtype)
        bundle.engine.decide_batch(rows[label])
    rates = {label: [] for label in engines}
    for label in ("serve-mlp", "serve-mlp-continuous", "serve-mlp-continuous", "serve-mlp"):
        engine = engines[label]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.decide_batch(rows[label])
        rates[label].append(1024 * iters / (time.perf_counter() - t0))
    out = {}
    for label, engine in engines.items():
        profile = cProfile.Profile()
        profile.enable()
        for _ in range(iters):
            engine.decide_batch(rows[label])
        profile.disable()
        bucket = engine.bucket_for(1024)
        out[label] = {"decisions_per_s": rates[label], "bucket": bucket,
                      "replay_ms": replay_ms(engine._graphs[bucket]),
                      "ms_a_call": 1024 / statistics.mean(rates[label]) * 1e3,
                      "host_functions": host_functions(profile, iters)}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300, help="shell steps profiled")
    ap.add_argument("--iters", type=int, default=200, help="decide_batch calls an engine")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_host needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"device": smi, "shell": profile_shell(args.steps),
              "serving": profile_serving(args.iters)}
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    line = json.dumps(result)
    (outdir / "profile_host.json").write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
