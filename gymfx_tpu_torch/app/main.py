"""The offline scaled-feature export.

The port of ``gymfx_tpu/app/main.py::_export_scaled_features``
(:184-240): :func:`export_scaled_features` materializes an episode's
scaled feature windows ``(n_steps, window, F)`` for steps ``1..n_steps``
in one call of K7 (``ops/window_zscore.batched_scaled_windows``: the
kernel on the card, its plain version on the CPU), passes the binary
columns through on the host with the obs path's clip and nan_to_num,
exactly as the JAX function does, and writes them with
``np.savez_compressed`` (``scaled_windows``, ``feature_columns``).  The
scaled columns get no nan_to_num, as in the JAX function.

The rest of the JAX module, the command line, comes with ROADMAP Queue 1
item 18.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from gymfx_tpu_torch.ops.window_zscore import batched_scaled_windows


def export_scaled_features(env, config: Dict[str, Any], n_steps: int, path: str) -> Dict[str, Any]:
    """Write the scaled feature windows of steps ``1..n_steps`` of
    ``env``'s resident tape to ``path`` (.npz).  Returns the JAX
    function's summary (``path``, ``shape``, ``columns``) plus
    ``seconds``: host seconds for the windows (K7, the copy to the host
    and the binary passthrough) and for the save, apart."""
    cfg = env.cfg
    data = env.require_resident_data("export_scaled_features")
    if cfg.n_features == 0:
        raise ValueError(
            "export_scaled_features requires feature_columns in the config "
            "(the scaled windows ARE the feature-window preprocessor's "
            "output)"
        )
    w = cfg.window_size
    clip = float(cfg.feature_clip or 0.0)
    t0 = time.perf_counter()
    steps = torch.arange(1, n_steps + 1, dtype=torch.int32, device=data.padded_features.device)
    windows = batched_scaled_windows(
        data.padded_features, data.feat_mean, data.feat_std, data.feat_neutral, steps,
        window=w, clip=clip,
    )
    arr = windows.cpu().numpy()  # a fresh f32 array: the binary columns are written into it
    if any(cfg.binary_mask):
        # binary passthrough columns carry raw values, exactly like the
        # obs path, still under its clip and nan_to_num clamp
        raw = np.asarray(data.padded_features.cpu().numpy(), np.float32)
        steps_np = np.arange(1, n_steps + 1)
        for j, is_bin in enumerate(cfg.binary_mask):
            if is_bin:
                col = sliding_window_view(raw[:, j], w)[steps_np]
                if clip > 0:
                    col = np.clip(col, -clip, clip)
                arr[:, :, j] = np.nan_to_num(col, nan=0.0, posinf=clip, neginf=-clip)
    t1 = time.perf_counter()
    columns = [str(c) for c in (env.config.get("feature_columns") or [])]
    np.savez_compressed(path, scaled_windows=arr, feature_columns=np.asarray(columns))
    t2 = time.perf_counter()
    return {"path": path, "shape": list(arr.shape), "columns": columns,
            "seconds": {"windows": t1 - t0, "save": t2 - t1}}
