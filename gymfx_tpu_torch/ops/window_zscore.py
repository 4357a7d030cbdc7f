"""K1: the per-step scaled feature window (the rollout's policy input),
and K7: scaled feature windows for a batch of steps (the export).

Replaces ``gymfx_tpu/ops/window_zscore.py::fused_step_obs``.  The kernel
has two tilings in ``csrc/env_kernels.cu``: ``step_obs_rows_kernel`` for
F = 5 windows whose rows fill whole groups of 4 on 16-byte aligned
pointers (the flagship's), ``step_obs_kernel`` (blocks of whole envs)
for every other shape and alignment; :func:`step_obs` picks one per call
from a launch plan built once per shape (``ops/cases.py`` models both
tilings on the CPU).  Beside it here is its
plain PyTorch version, :func:`scale_feature_window`, op for op the JAX
package's ``core/obs.scale_feature_window``: neutral envs to zero ->
binary-mask columns pass raw -> clip to ±clip (only when clip > 0) ->
nan_to_num -> f32.  nan_to_num maps NaN to 0 and ±inf to ±clip, as the
JAX package's ``clip or 0.0`` does: 0 when clip is 0, and a negative
clip keeps its own value.

K7 replaces ``gymfx_tpu/ops/window_zscore.py::batched_scaled_windows``
(pallas body ``_kernel``).  The kernel is ``scaled_windows_kernel`` in
``csrc/data_kernels.cu``: persistent CTAs walk tiles of consecutive batch
entries, staging each tile's moments and, where its window starts run
consecutively (the export's steps), the union of its windows in shared
memory, one tile ahead; a launch plan built once per shape
(:func:`scaled_windows_tile`, :func:`_scaled_windows_plan`) sizes the
tiles, and ``ops/cases.scaled_windows_tiling`` models the tiling on the
CPU.  Its plain version is
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

import ctypes
import functools
import struct
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


# K1's launch (csrc/env_kernels.cu).  Env blocks (path 0, any shape):
# CTAs of K1_THREADS threads each take a block of whole envs, K1_VECTORS
# float4 a thread in flight a pass; the env block is the largest of
# K1_ENV_BLOCKS whose faces fit one pass (1 when a single face does not).
# Row groups (path 1, F == K1_ROW_FEATURES, W a multiple of K1_ROW_GROUP,
# both pointers 16-byte aligned): each of K1_ROW_THREADS threads a CTA
# takes K1_ROW_GROUP rows of one env
K1_THREADS = 256
K1_VECTORS = 2
K1_ENV_BLOCKS = (1, 2, 4, 8, 16, 32, 64)
K1_SMEM_LIMIT = 48 * 1024  # the staged moments: 9 bytes an (env, feature)
K1_ROW_FEATURES = 5
K1_ROW_THREADS = 128
K1_ROW_GROUP = 4
_K1_CONSTANTS = (K1_THREADS, K1_VECTORS, K1_ROW_FEATURES, K1_ROW_THREADS, K1_ROW_GROUP, 14)


def magic(d: int) -> Tuple[int, int, int]:
    """(lo, hi, shift) with ``(umulhi(j, lo) + (j if hi else 0)) >> shift
    == j // d`` for every 0 <= j < 2^31: m = ceil(2^(32 + l) / d) with
    l = ceil(log2 d), split into its low 32 bits and its bit 32."""
    if d < 1:
        raise ValueError(f"magic: divisor {d}")
    shift = (d - 1).bit_length()
    m = -(-(1 << (32 + shift)) // d)
    assert m < 1 << 33
    return m & 0xFFFFFFFF, m >> 32, shift


def magic_div(j, lo: int, hi: int, shift: int):
    """The kernel's ``magic_div`` on ints or int64 numpy arrays."""
    return (((j * lo) >> 32) + (j if hi else 0)) >> shift


def env_block(w: int, f: int) -> int:
    """Envs a path-0 CTA takes at a time for (W, F) faces."""
    fit = [b for b in K1_ENV_BLOCKS if b * w * f <= 4 * K1_THREADS * K1_VECTORS]
    return fit[-1] if fit else 1


def step_obs_geometry(n: int, w: int, f: int, sm_count: int, blocks_per_sm: int):
    """(env block, grid) of K1's env-block path at (n, w, f): the grid
    covers every SM ``blocks_per_sm`` deep, or every env block if there
    are fewer."""
    eb = env_block(w, f)
    if eb * w * f >= 1 << 31:
        raise ValueError(f"step_obs: a face of {w} x {f} is over 2^31 elements")
    if eb * f * 9 > K1_SMEM_LIMIT:
        raise ValueError(f"step_obs: {f} features do not fit the staged moments")
    return eb, max(1, min(-(-n // eb), sm_count * blocks_per_sm))


def row_groups(n: int, w: int, f: int) -> int:
    """Row groups of K1's path 1 at (n, w, f), 0 where it does not apply."""
    if f != K1_ROW_FEATURES or w % K1_ROW_GROUP or n * w // K1_ROW_GROUP >= 1 << 31:
        return 0
    return n * w // K1_ROW_GROUP


def row_grid(groups: int, sm_count: int, blocks_per_sm: int) -> int:
    return max(1, min(-(-groups // K1_ROW_THREADS), sm_count * blocks_per_sm))


def _as_c_int(x: int) -> int:
    return x - (1 << 32) if x >= 1 << 31 else x


def _launch_ints(path, env_block_, grid, div_f, div_wf, mask_bits, n, w, f, clip):
    """csrc/env_kernels.cu ObsGeometry as a C int array."""
    clip_bits = struct.unpack("<i", struct.pack("<f", clip))[0]
    return (ctypes.c_int * 14)(path, env_block_, grid, *map(_as_c_int, div_f),
                               *map(_as_c_int, div_wf), mask_bits, n, w, f, clip_bits)


@functools.lru_cache(maxsize=64)
def _step_obs_plan(n: int, w: int, f: int, device: torch.device,
                   binary_mask: Tuple[bool, ...], clip: float):
    """The launches of K1 at one shape and clip, built once: (env-block
    geometry, row-group geometry or None, mask pointer, mask tensor kept
    alive); each geometry a C int array (csrc/env_kernels.cu ObsGeometry)."""
    if n >= 1 << 31:
        raise ValueError(f"step_obs: {n} envs")
    lib = _build.load_library()
    constants = (ctypes.c_int * 6)()
    lib.gymfx_step_obs_constants(constants)
    if tuple(constants) != _K1_CONSTANTS:
        raise RuntimeError("step_obs: launch geometry does not match the kernel source")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = [lib.gymfx_step_obs_blocks_per_sm(0, env_block(w, f) * f * 9),
              lib.gymfx_step_obs_blocks_per_sm(1, 0)]
    if min(per_sm) < 1:
        raise RuntimeError("step_obs: no CTA of the kernel fits an SM")
    eb, grid = step_obs_geometry(n, w, f, sms, per_sm[0])
    blocks = _launch_ints(0, eb, grid, magic(f), magic(w * f), 0, n, w, f, clip)
    rows, groups = None, row_groups(n, w, f)
    if groups:
        mask_bits = sum(1 << k for k, m in enumerate(binary_mask) if m)
        rows = _launch_ints(1, 0, row_grid(groups, sms, per_sm[1]), (0, 0, 0),
                            magic(w // K1_ROW_GROUP), mask_bits, n, w, f, clip)
    mask = torch.tensor(binary_mask, dtype=torch.uint8, device=device) if any(binary_mask) else None
    return blocks, rows, (None if mask is None else mask.data_ptr()), mask


def step_obs(win, mean, std, neutral, *, binary_mask: Tuple[bool, ...] = (),
             clip: float = 10.0):
    """The scaled (N, W, F) f32 policy input: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    device = win.device
    if device.type == "cpu":
        return scale_feature_window(win, mean, std, neutral, binary_mask, clip)
    if device.type != "cuda":
        raise ValueError(f"step_obs: unsupported device {device}")
    n, w, f = win.shape
    f32 = torch.float32
    _build.require(win, "step_obs: win", f32, (n, w, f), device)
    _build.require(mean, "step_obs: mean", f32, (n, f), device)
    _build.require(std, "step_obs: std", f32, (n, f), device)
    _build.require(neutral, "step_obs: neutral", torch.bool, (n,), device)
    if not isinstance(binary_mask, tuple):
        binary_mask = tuple(binary_mask)
    if len(binary_mask) not in (0, f):
        raise ValueError(f"step_obs: binary_mask has {len(binary_mask)} entries for {f} features")
    out = torch.empty_like(win)
    if n * w * f == 0:
        return out
    blocks, rows, mask_ptr, _ = _step_obs_plan(n, w, f, device, binary_mask, clip)
    src, dst = win.data_ptr(), out.data_ptr()
    _build.check_launch(
        _build.load_library().gymfx_step_obs(
            src, mean.data_ptr(), std.data_ptr(), neutral.data_ptr(), mask_ptr, dst,
            blocks if rows is None or (src | dst) & 15 else rows, _build.stream_handle(device),
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


# K7's launch (csrc/data_kernels.cu scaled_windows_kernel): persistent
# CTAs of K7_THREADS threads, each holding two tile buffers in at most
# K7_SMEM_LIMIT bytes of shared memory.  A tile is up to K7_TILES[0]
# (at most one step a thread) consecutive batch entries; the largest
# tile whose buffers fit with the window span staged is taken (down to
# K7_MIN_STAGED_TILE), else the largest without it.  F = K7_TEMPLATE_F
# is compiled in; any other F takes magic numbers
K7_THREADS = 256
K7_TEMPLATE_F = 5
K7_TILES = (256, 128, 64, 32, 16, 8, 4, 2, 1)
K7_MIN_STAGED_TILE = 8
K7_SMEM_LIMIT = 48 * 1024
_K7_CONSTANTS = (K7_THREADS, K7_TEMPLATE_F, 18)


def scaled_windows_buffer(tile: int, w: int, f: int, staged: bool) -> Tuple[int, int]:
    """(span floats, bytes) of one K7 tile buffer: the window span when
    staged (T + W - 1 rows after up to 3 floats of lead, in whole
    float4s), the (mean, std) pairs of T x F, and each step's window
    start, moment row and neutral flag; the bytes in whole 16."""
    span = -(-(3 + (tile + w - 1) * f) // 4) * 4 if staged else 0
    return span, -(-(4 * span + 8 * tile * f + 12 * tile) // 16) * 16


def scaled_windows_tile(w: int, f: int) -> Tuple[int, int, int]:
    """(tile, span floats, buffer bytes) of K7 at window ``w`` and ``f``
    features: the largest staged tile of at least K7_MIN_STAGED_TILE
    entries whose two buffers fit K7_SMEM_LIMIT, else the largest
    unstaged one."""
    for staged, tiles in ((True, [t for t in K7_TILES if t >= K7_MIN_STAGED_TILE]),
                          (False, K7_TILES)):
        for tile in tiles:
            span, size = scaled_windows_buffer(tile, w, f, staged)
            if 2 * size <= K7_SMEM_LIMIT:
                return tile, span, size
    raise ValueError(f"batched_scaled_windows: {f} features do not fit the staged moments")


def scaled_windows_grid(b: int, tile: int, sm_count: int, blocks_per_sm: int) -> Tuple[int, int]:
    """(tiles, grid) of K7: the fewest rounds of tiles that at most
    ``blocks_per_sm`` CTAs on every SM can walk, and the fewest CTAs that
    walk them in that many rounds, so that every CTA takes the same
    number of tiles, give or take one."""
    tiles = -(-b // tile)
    rounds = -(-tiles // (sm_count * blocks_per_sm))
    return tiles, -(-tiles // rounds)


@functools.lru_cache(maxsize=64)
def _scaled_windows_plan(b: int, w: int, f: int, rows: int, m: int, clip: float,
                         device: torch.device):
    """K7's launch at one shape and clip, built once: a WinGeometry
    (csrc/data_kernels.cu) as a C int array."""
    if max(b, rows, m) + K7_TILES[0] >= 1 << 31:
        raise ValueError(f"batched_scaled_windows: {b} steps, {rows} feature rows, {m} moment rows")
    tile, span, size = scaled_windows_tile(w, f)
    fq = w * f // 4
    if tile * fq >= 1 << 31:
        raise ValueError(f"batched_scaled_windows: a tile of {tile} faces of {w} x {f} is over 2^31")
    lib = _build.load_library("data")
    constants = (ctypes.c_int * 3)()
    lib.gymfx_scaled_windows_constants(constants)
    if tuple(constants) != _K7_CONSTANTS:
        raise RuntimeError("batched_scaled_windows: launch geometry does not match the kernel source")
    per_sm = lib.gymfx_scaled_windows_blocks_per_sm(int(f == K7_TEMPLATE_F), 2 * size)
    if per_sm < 1:
        raise RuntimeError("batched_scaled_windows: no CTA of the kernel fits an SM")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles, grid = scaled_windows_grid(b, tile, sms, per_sm)
    clip_bits = struct.unpack("<i", struct.pack("<f", clip))[0]
    return (ctypes.c_int * _K7_CONSTANTS[2])(
        grid, tile, tiles, b, w, f, fq, *map(_as_c_int, magic(fq)), *map(_as_c_int, magic(f)),
        span, size, rows - w, m - 1, clip_bits)


def batched_scaled_windows(padded_features, feat_mean, feat_std, feat_neutral, steps, *,
                           window: int, clip: float = 10.0):
    """Scaled feature windows for a batch of steps, (B, window, F) f32:
    the kernel on CUDA tensors, the plain version on CPU tensors.  Like
    the JAX function it refuses a window that is not a multiple of 8.
    On CUDA tensors it also refuses, with ValueError, F over 3,070 (two
    buffers of one step's (mean, std) pairs must fit the kernel's 48 KB
    of shared memory), B, feature rows or moment rows of 2^31 - 256 or
    more, and a tile's output of 2^33 floats or more (its int32 quad
    index); the plain version and the JAX function take them."""
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
    geometry = _scaled_windows_plan(b, window, f, rows, m, float(clip), device)
    _build.check_launch(
        _build.load_library("data").gymfx_scaled_windows(
            padded_features.data_ptr(), feat_mean.data_ptr(), feat_std.data_ptr(),
            feat_neutral.data_ptr(), steps.data_ptr(), out.data_ptr(), geometry,
            _build.stream_handle(device),
        ),
        name,
    )
    batched_scaled_windows.launches += 1
    return out


batched_scaled_windows.launches = 0
