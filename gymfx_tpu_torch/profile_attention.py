"""Where K4's time goes, on the card, at the policies' shapes.

    python -m gymfx_tpu_torch.profile_attention [--batch 4096 256] [--f32_batch 4096 256]

For each batch B of (B, 256, 4, 32) bf16 windows (the long-context
policy's update, B = 4096, and rollout, B = 256): random q, k, v and a
cotangent from a seeded generator, then device times per call from CUDA
graph replays (CUDA events, median of 11 replays of 20 calls):

* K4's forward (``attention_forward``) and backward
  (``attention_backward``), and each CUDA kernel's own time inside them
  from ``torch.profiler`` (the dQ and dK/dV kernels apart);
* the forward's memory skeleton (``csrc/attention_probe.cu``, built
  here on first use; no path runs it): the same
  grid and copies with no arithmetic, the query tile alone in and out,
  and with every K/V tile through the same ring; the bytes the skeleton
  moves through L2 into the SMs beside the bytes of device memory;
* ``Tensor.copy_`` of q (the card's copy rate on these bytes), and
  ``scaled_dot_product_attention`` forward and autograd backward at the
  same shape (the library yardstick; between CUDA events, median of 5
  runs of 10 calls).

For each batch B of (B, 32, 4, 32) f32 windows (transformer_ring's
default run: the update minibatch of baseline-portfolio-pbt's ring twin,
B = 4096, and its rollout, B = 256): K4's f32 window kernels
(``attn_fwd_window`` / ``attn_bwd_window``) and, from the same probe
library, their memory skeletons (the kernels' grid, dynamic shared
memory and copies, no arithmetic: q, k, v in and o out; q, k, v, dO in
and dq, dk, dv out) and launch floors (an empty kernel at the same grid,
block and shared memory), with ``copy_`` and SDPA as above.

With ``--portfolio_ring N`` it runs baseline-portfolio-pbt's
``transformer_ring`` twin (``config/flagship.portfolio_pbt_config``,
seed 0): one population train step that captures both phase graphs,
then N graphed rollout and update phases timed on the host clock (each
ending in ``torch.cuda.synchronize``), and one more of each under
``torch.profiler``: the phase's device time in all kernels and in K4's.

With ``--rollout_phases N`` it also runs the long-context configuration
(``config/flagship.long_context_config`` on the example CSV, seed 0):
one train step to warm up, then N rollout phases timed on the host clock
(each ending in ``torch.cuda.synchronize``), and one more under
``torch.profiler``: the phase's device time in all kernels and in K4's,
and so the device's idle share of the phase.

It prints one JSON line per measurement and writes them to
``chiprun_out/profile_attention.json``.  It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

from gymfx_tpu_torch.ops import _build
from gymfx_tpu_torch.ops import fused_attention as fa

ROOT = pathlib.Path(__file__).resolve().parent.parent
WINDOW, HEADS, HEAD_DIM, ROWS = 256, 4, 32, 64


def graph_ms(fn, reps: int = 20, trials: int = 11) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA
    graph, replayed ``trials`` times between CUDA events; the median."""
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


def event_ms(fn, reps: int = 10, trials: int = 5) -> float:
    """Time of one ``fn()`` between CUDA events, without a graph (for
    autograd): the median of ``trials`` runs of ``reps`` calls."""
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


def kernel_ms(fn, calls: int = 10) -> dict:
    """Device ms per call of each CUDA kernel that ``fn()`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {_kernel_name(ev.key): ev.device_time_total / calls / 1e3
            for ev in prof.key_averages() if ev.device_time_total > 0}


def _kernel_name(key: str) -> str:
    """``attn_fwd_tc<32, 4, 1>`` from a profiler key such as ``void
    (anonymous namespace)::attn_fwd_tc<32, 4, 1>(...)``."""
    if ">(" not in key:
        return key
    return (key.split(">(")[0] + ">").split("::")[-1]


def profile(batch: int, seed: int = 0) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (batch, WINDOW, HEADS, HEAD_DIM)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(4))
    probe = _build.load_library("attention_probe")
    out = torch.empty_like(q)

    def skeleton(kv: int):  # on the current stream, the capture's inside a graph
        _build.check_launch(probe.gymfx_attn_probe_skeleton(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), batch, WINDOW, HEADS, kv,
            torch.cuda.current_stream().cuda_stream), "attn_probe_skeleton")

    operand = q.numel() * q.element_size()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    leaves = [x.detach().clone().requires_grad_(True) for x in (qt, kt, vt)]
    lib_out = F.scaled_dot_product_attention(*leaves)
    row = {
        "shape": list(shape), "dtype": "bfloat16",
        "forward_ms": graph_ms(lambda: fa.attention_forward(q, k, v)),
        "backward_ms": graph_ms(lambda: fa.attention_backward(q, k, v, g)),
        "forward_kernels_ms": kernel_ms(lambda: fa.attention_forward(q, k, v)),
        "backward_kernels_ms": kernel_ms(lambda: fa.attention_backward(q, k, v, g)),
        "skeleton_q_in_o_out_ms": graph_ms(lambda: skeleton(0)),
        "skeleton_with_kv_ring_ms": graph_ms(lambda: skeleton(1)),
        # device memory: q, k, v read and o written once; into the SMs:
        # each 64-query CTA reads q's tile and every K/V tile of its (b, h)
        "skeleton_device_memory_bytes": 4 * operand,
        "skeleton_l2_to_sm_bytes": operand * (2 + 2 * WINDOW // ROWS),
        "copy_ms": graph_ms(lambda: out.copy_(q)),
        "copy_bytes": 2 * operand,
        "sdpa_forward_ms": event_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
    }
    gt = g.transpose(1, 2)
    row["sdpa_backward_ms"] = event_ms(
        lambda: torch.autograd.grad(lib_out, leaves, gt, retain_graph=True))
    return row


def f32_window_probes(q, k, v, g) -> dict:
    """K4's f32 window kernels on contiguous (B, 32, H, 32) f32 q, k, v
    and cotangent g beside their memory skeletons and launch floors:
    device ms per call from CUDA graph replays."""
    b, s, h, d = q.shape
    if (s, d) != (32, HEAD_DIM) or not all(x.is_contiguous() for x in (q, k, v, g)):
        raise ValueError(f"the f32 window probes take contiguous (B, 32, H, 32); got {tuple(q.shape)}")
    probe = _build.load_library("attention_probe")
    outs = [torch.empty_like(q) for _ in range(3)]

    def skeleton(bwd: int):
        _build.check_launch(probe.gymfx_attn_probe_f32_window(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), *(o.data_ptr() for o in outs),
            b, h, bwd, torch.cuda.current_stream().cuda_stream), "attn_probe_f32_window")

    smem = fa.f32_window_kernel_smem(s, d)
    row = {"forward_ms": graph_ms(lambda: fa.attention_forward(q, k, v)),
           "backward_ms": graph_ms(lambda: fa.attention_backward(q, k, v, g)),
           "skeleton_forward_ms": graph_ms(lambda: skeleton(0)),
           "skeleton_backward_ms": graph_ms(lambda: skeleton(1)), "smem": smem}
    for key in ("forward", "backward"):
        warps = smem[f"{key} warps"]
        grid = -(-b * h // warps)
        row[f"launch_floor_{key}_ms"] = graph_ms(lambda: _build.check_launch(
            probe.gymfx_attn_probe_floor(grid, 32 * warps, smem[key],
                                         torch.cuda.current_stream().cuda_stream), "attn_probe_floor"))
        row[f"grid_{key}"] = [grid, 32 * warps, smem[key]]
    return row


def profile_f32(batch: int, seed: int = 0) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (batch, 32, HEADS, HEAD_DIM)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev) for _ in range(4))
    out = torch.empty_like(q)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    leaves = [x.detach().clone().requires_grad_(True) for x in (qt, kt, vt)]
    lib_out = F.scaled_dot_product_attention(*leaves)
    gt = g.transpose(1, 2)
    row = {"shape": list(shape), "dtype": "float32", **f32_window_probes(q, k, v, g),
           "forward_kernels_ms": kernel_ms(lambda: fa.attention_forward(q, k, v)),
           "backward_kernels_ms": kernel_ms(lambda: fa.attention_backward(q, k, v, g)),
           "copy_ms": graph_ms(lambda: out.copy_(q)),
           "copy_bytes": 2 * q.numel() * q.element_size(),
           "sdpa_forward_ms": event_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
           "sdpa_backward_ms": event_ms(
               lambda: torch.autograd.grad(lib_out, leaves, gt, retain_graph=True))}
    return row


def _phase_device_ms(fn) -> tuple:
    """(device ms in all kernels, in K4's) of one ``fn()``, from a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.5)  # CUPTI hands over a replay's last records late
    events = prof.key_averages()
    return (out, sum(ev.device_time_total for ev in events) / 1e3,
            sum(ev.device_time_total for ev in events if "attn_" in ev.key) / 1e3)


def portfolio_ring_phases(phases: int, seed: int = 0) -> dict:
    """Wall and device time of the graphed phases of baseline-portfolio-
    pbt's transformer_ring twin (K4's f32 route at (256, 32, 4, 32) and
    (4096, 32, 4, 32))."""
    from gymfx_tpu_torch.config.flagship import portfolio_pbt_config
    from gymfx_tpu_torch.core.portfolio import PortfolioEnvironment
    from gymfx_tpu_torch.train.pbt import _pbt_config_from, make_portfolio_pbt

    config = portfolio_pbt_config(str(ROOT), policy="transformer_ring")
    env = PortfolioEnvironment(config)
    pbt = make_portfolio_pbt(dict(config), _pbt_config_from(config), env)
    tr = pbt.trainer
    state, _ = pbt.init_population(seed)
    state, _ = tr.train_step(state)
    torch.cuda.synchronize()
    rollout, update = [], []
    for _ in range(phases):
        t0 = time.perf_counter()
        inter, out = tr.rollout_phase(state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _ = tr.update_phase(inter, out)
        torch.cuda.synchronize()
        rollout.append((t1 - t0) * 1e3)
        update.append((time.perf_counter() - t1) * 1e3)
    (inter, out), roll_dev, roll_k4 = _phase_device_ms(lambda: tr.rollout_phase(state))
    _, upd_dev, upd_k4 = _phase_device_ms(lambda: tr.update_phase(inter, out))
    pcfg = tr.pcfg
    steps = pbt.pbt.population * pcfg.n_envs * pcfg.horizon
    roll_ms, upd_ms = statistics.median(rollout), statistics.median(update)
    return {"config": "portfolio_pbt_config(policy=transformer_ring)", "rollout_ms": rollout,
            "update_ms": update, "rollout_median_ms": roll_ms, "update_median_ms": upd_ms,
            "phases_env_steps_per_s": steps / (roll_ms + upd_ms) * 1e3,
            "rollout_device_ms": roll_dev, "rollout_k4_device_ms": roll_k4,
            "update_device_ms": upd_dev, "update_k4_device_ms": upd_k4}


def rollout_phases(phases: int, seed: int = 0) -> dict:
    """Wall and device time of the long-context rollout phase."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from gymfx_tpu_torch.config.flagship import long_context_config
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

    config = long_context_config(str(ROOT / "examples" / "data" / "eurusd_sample.csv"))
    trainer = PPOTrainer(Environment(config), ppo_config_from(config))
    state = trainer.init_state(seed)
    state, _ = trainer.update_phase(*trainer.rollout_phase(state))
    torch.cuda.synchronize()
    wall = []
    for _ in range(phases):
        t0 = time.perf_counter()
        trainer.rollout_phase(state)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.rollout_phase(state)
        torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device_ms = sum(ev.device_time_total for ev in events) / 1e3
    k4_ms = sum(ev.device_time_total for ev in events if "attn_" in ev.key) / 1e3
    return {"config": "long_context_config", "rollout_wall_ms": wall,
            "rollout_wall_median_ms": statistics.median(wall),
            "profiled_phase_wall_ms": profiled_ms, "profiled_phase_device_ms": device_ms,
            "profiled_phase_k4_device_ms": k4_ms,
            "device_idle_share": 1.0 - device_ms / profiled_ms}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="*", default=[4096, 256])
    ap.add_argument("--f32_batch", type=int, nargs="*", default=[4096, 256])
    ap.add_argument("--rollout_phases", type=int, default=0)
    ap.add_argument("--portfolio_ring", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_attention needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    rows = []
    for batch in args.batch:
        row = {"device": smi, **profile(batch)}
        rows.append(row)
        print(json.dumps(row))
    for batch in args.f32_batch:
        row = {"device": smi, **profile_f32(batch)}
        rows.append(row)
        print(json.dumps(row))
    if args.portfolio_ring:
        row = {"device": smi, **portfolio_ring_phases(args.portfolio_ring)}
        rows.append(row)
        print(json.dumps(row))
    if args.rollout_phases:
        row = {"device": smi, **rollout_phases(args.rollout_phases)}
        rows.append(row)
        print(json.dumps(row))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_attention.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
