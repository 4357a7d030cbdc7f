"""K1: the per-step scaled feature window (the rollout's policy input),
and K7: scaled feature windows for a batch of steps (the export).

Replaces ``gymfx_tpu/ops/window_zscore.py::fused_step_obs``.  The kernel
is ``step_obs_kernel`` in ``csrc/env_kernels.cu``; beside it here is its
plain PyTorch version, :func:`scale_feature_window`, op for op the JAX
package's ``core/obs.scale_feature_window``: neutral envs to zero ->
binary-mask columns pass raw -> clip to ±clip (only when clip > 0) ->
nan_to_num -> f32.  nan_to_num maps NaN to 0 and ±inf to ±clip, as the
JAX package's ``clip or 0.0`` does: 0 when clip is 0, and a negative
clip keeps its own value.

K7 replaces ``gymfx_tpu/ops/window_zscore.py::batched_scaled_windows``
(pallas body ``_kernel``).  The kernel is ``scaled_windows_kernel`` in
``csrc/data_kernels.cu``; its plain version is
:func:`reference_scaled_windows`, the JAX package's function of the same
name: for each step ``s`` the window ``padded_features[s : s+W]``, then
``where(neutral[s], 0, (win - mean[s]) / std[s])``, then the clip when
clip > 0.  No binary passthrough and no nan_to_num (the export adds the
passthrough on the host).  Window starts clamp to ``[0, rows - W]`` as
``dynamic_slice`` clamps them, moment rows to ``[0, n]`` as XLA's gather
clamps.

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


def reference_scaled_windows(padded_features, feat_mean, feat_std, feat_neutral, steps, *,
                             window: int, clip: float = 10.0):
    """Plain version of K7: (n + W, F) features, (n + 1, F) moments,
    (n + 1,) neutral flags and (B,) steps -> (B, W, F) f32."""
    s = steps.long()
    start = torch.clamp(s, 0, padded_features.shape[0] - window)
    row = torch.clamp(s, 0, feat_mean.shape[0] - 1)
    win = padded_features[start[:, None] + torch.arange(window, device=s.device)]
    scaled = torch.where(
        feat_neutral[row][:, None, None], 0.0,
        (win - feat_mean[row][:, None, :]) / feat_std[row][:, None, :],
    )
    if clip > 0:
        scaled = torch.clamp(scaled, -clip, clip)
    return scaled


def batched_scaled_windows(padded_features, feat_mean, feat_std, feat_neutral, steps, *,
                           window: int, clip: float = 10.0):
    """Scaled feature windows for a batch of steps, (B, window, F) f32:
    the kernel on CUDA tensors, the plain version on CPU tensors.  Like
    the JAX function it refuses a window that is not a multiple of 8."""
    if window % 8 != 0:
        raise ValueError("window must be a multiple of 8 (TPU sublane tiling)")
    device = padded_features.device
    if device.type == "cpu":
        return reference_scaled_windows(padded_features, feat_mean, feat_std, feat_neutral,
                                        steps, window=window, clip=clip)
    if device.type != "cuda":
        raise ValueError(f"batched_scaled_windows: unsupported device {device}")
    rows, f = padded_features.shape
    m = feat_mean.shape[0]
    if rows < window or m < 1:
        raise ValueError(f"batched_scaled_windows: {rows} feature rows, {m} moment rows "
                         f"for a window of {window}")
    b = steps.shape[0]
    name = "batched_scaled_windows"
    _build.require(padded_features, f"{name}: padded_features", torch.float32, (rows, f), device)
    _build.require(feat_mean, f"{name}: feat_mean", torch.float32, (m, f), device)
    _build.require(feat_std, f"{name}: feat_std", torch.float32, (m, f), device)
    _build.require(feat_neutral, f"{name}: feat_neutral", torch.bool, (m,), device)
    _build.require(steps, f"{name}: steps", torch.int32, (b,), device)
    out = torch.empty((b, window, f), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    lib = _build.load_library("data")
    _build.check_launch(
        lib.gymfx_scaled_windows(
            padded_features.data_ptr(), feat_mean.data_ptr(), feat_std.data_ptr(),
            feat_neutral.data_ptr(), steps.data_ptr(), out.data_ptr(), b, window, f, rows, m,
            float(clip), torch.cuda.current_stream(device).cuda_stream,
        ),
        name,
    )
    batched_scaled_windows.launches += 1
    return out


batched_scaled_windows.launches = 0
