"""K1: the per-step scaled feature window (the rollout's policy input).

Replaces ``gymfx_tpu/ops/window_zscore.py::fused_step_obs``.  The kernel
is ``step_obs_kernel`` in ``csrc/env_kernels.cu``; beside it here is its
plain PyTorch version, :func:`scale_feature_window`, op for op the JAX
package's ``core/obs.scale_feature_window``: neutral envs to zero ->
binary-mask columns pass raw -> clip to ±clip (only when clip > 0) ->
nan_to_num -> f32.  nan_to_num maps NaN to 0 and ±inf to ±clip, as the
JAX package's ``clip or 0.0`` does: 0 when clip is 0, and a negative
clip keeps its own value.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from gymfx_tpu_torch.ops import _build


def scale_feature_window(win, mean, std, neutral, binary_mask: Tuple[bool, ...] = (),
                         clip: float = 10.0):
    """Plain version: (N, W, F) window, (N, F) moments, (N,) neutral flags."""
    scaled = torch.where(
        neutral[:, None, None], 0.0, (win - mean[:, None, :]) / std[:, None, :]
    )
    if any(binary_mask):
        mask = torch.tensor(binary_mask, dtype=torch.bool, device=win.device)
        scaled = torch.where(mask[None, None, :], win, scaled)
    if clip and clip > 0:
        scaled = torch.clamp(scaled, -clip, clip)
    scaled = torch.nan_to_num(scaled, nan=0.0, posinf=clip or 0.0, neginf=-(clip or 0.0))
    return scaled.to(torch.float32)


@functools.lru_cache(maxsize=8)
def _mask_tensor(binary_mask: Tuple[bool, ...], device: torch.device):
    return torch.tensor(binary_mask, dtype=torch.uint8, device=device)


def step_obs(win, mean, std, neutral, *, binary_mask: Tuple[bool, ...] = (),
             clip: float = 10.0):
    """The scaled (N, W, F) f32 policy input: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if win.device.type == "cpu":
        return scale_feature_window(win, mean, std, neutral, binary_mask, clip)
    if win.device.type != "cuda":
        raise ValueError(f"step_obs: unsupported device {win.device}")
    n, w, f = win.shape
    _build.require(win, "step_obs: win", torch.float32, (n, w, f), win.device)
    _build.require(mean, "step_obs: mean", torch.float32, (n, f), win.device)
    _build.require(std, "step_obs: std", torch.float32, (n, f), win.device)
    _build.require(neutral, "step_obs: neutral", torch.bool, (n,), win.device)
    if len(binary_mask) not in (0, f):
        raise ValueError(f"step_obs: binary_mask has {len(binary_mask)} entries for {f} features")
    out = torch.empty_like(win)
    if out.numel() == 0:
        return out
    mask = _mask_tensor(tuple(bool(m) for m in binary_mask), win.device) if any(binary_mask) else None
    lib = _build.load_library()
    _build.check_launch(
        lib.gymfx_step_obs(
            win.data_ptr(), mean.data_ptr(), std.data_ptr(), neutral.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            n, w, f, float(clip),
            torch.cuda.current_stream(win.device).cuda_stream,
        ),
        "step_obs",
    )
    step_obs.launches += 1
    return out


step_obs.launches = 0
