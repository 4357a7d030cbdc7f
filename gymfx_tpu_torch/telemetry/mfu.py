"""Analytic MFU and device-memory accounting: the port of
``gymfx_tpu/telemetry/mfu.py``.

The FLOP model is the JAX package's (:28-68), a closed-form per-train-
step count from the policy's parameter shapes:

  * every 2-D parameter ``(m, n)`` is a GEMM costing ``2·m·n`` FLOPs
    per sample (per token for token policies) — biases/norms are
    rounding errors against the GEMMs and are ignored;
  * self-attention adds ``4·W²·d_model`` per layer per sample
    (``QKᵀ`` and ``A·V``, ``2·W²·d`` each) for window length ``W``;
  * one train step = rollout forwards over ``num_envs · horizon``
    samples + update passes at the standard ``3×`` forward cost
    (forward + backward) over the same samples, ``update_epochs``
    times.

The peak comes from the card's name: the H100 SXM's dense bf16 tensor-
core rate (989 TFLOP/s, the figure ``chip_smoke.py`` bounds its kernels
with); None for any other device.  The memory readings come from
PyTorch's caching allocator (``torch.cuda.memory_stats_as_nested_dict``;
``memory_stats`` flattens the same dict in Python on every call) and the
device properties, under the JAX package's stat labels:

  ``bytes_in_use``        ``allocated_bytes.all.current``
  ``peak_bytes_in_use``   ``allocated_bytes.all.peak``
  ``bytes_limit``         the card's total memory
                          (``get_device_properties().total_memory``)
  ``largest_alloc_size``  ``reserved_bytes.all.peak`` (the allocator
                          reports no largest single allocation; its
                          peak reservation bounds it)

None where the device is not CUDA.  Both are host-side allocator
queries that never synchronize the card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

# dense bf16 tensor-core peak by card name (the H100 SXM5; the PCIe card
# and others are not listed, and read None)
PEAK_BF16_FLOPS = {"H100 80GB HBM3": 989e12, "H100 SXM": 989e12}


def param_flops_per_sample(params: Any, *, tokens: int = 1) -> float:
    """``2·m·n`` summed over every 2-D tensor of ``params`` (a dict of
    tensors, or an iterable of them), times the ``tokens`` each sample
    pushes through the trunk (1 for flat-obs policies, the window length
    for token policies)."""
    leaves = params.values() if isinstance(params, dict) else params
    total = 0.0
    for leaf in leaves:
        shape = getattr(leaf, "shape", ())
        if len(shape) == 2:
            total += 2.0 * float(shape[0]) * float(shape[1])
    return total * float(tokens)


def attention_flops_per_sample(window: int, d_model: int,
                               n_layers: int) -> float:
    """The activation-activation matmuls parameter counting misses:
    ``QKᵀ`` + ``A·V`` = ``4·W²·d`` per layer."""
    return 4.0 * float(n_layers) * float(window) ** 2 * float(d_model)


def analytic_train_step_flops(
    params: Any,
    *,
    num_envs: int,
    horizon: int,
    update_epochs: int = 1,
    tokens: int = 1,
    window: int = 0,
    d_model: int = 0,
    n_layers: int = 0,
) -> float:
    """Closed-form FLOPs of ONE fused rollout+update train step."""
    fwd = param_flops_per_sample(params, tokens=tokens)
    if n_layers and window and d_model:
        fwd += attention_flops_per_sample(window, d_model, n_layers)
    samples = float(num_envs) * float(horizon)
    rollout = samples * fwd
    update = 3.0 * samples * fwd * float(max(1, update_epochs))
    return rollout + update


# ---------------------------------------------------------------------------
def _cuda(device: Any) -> Optional[torch.device]:
    """``device`` as a CUDA device (the current one by default), or None
    where it is not one or no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    return device if device.type == "cuda" else None


def hw_flops_peak(device: Any = None) -> Optional[float]:
    """Dense bf16 peak FLOPs/sec of the card by its name; None when the
    name is not in the table (or the device is not CUDA)."""
    dev = _cuda(device)
    if dev is None:
        return None
    name = torch.cuda.get_device_name(dev)
    return next((peak for key, peak in PEAK_BF16_FLOPS.items() if key in name), None)


def device_memory_bytes(device: Any = None) -> Optional[int]:
    """``bytes_in_use`` from the caching allocator, or None off CUDA."""
    marks = device_memory_watermarks(device)
    return None if marks is None else marks.get("bytes_in_use")


# the allocator stats worth a per-superstep gauge, in the JAX package's
# labels; peak_bytes_in_use is the watermark an out-of-memory postmortem
# wants
MEMORY_WATERMARK_KEYS = (
    "bytes_in_use",
    "peak_bytes_in_use",
    "bytes_limit",
    "largest_alloc_size",
)

_TORCH_STATS = {
    "bytes_in_use": ("allocated_bytes", "all", "current"),
    "peak_bytes_in_use": ("allocated_bytes", "all", "peak"),
    "largest_alloc_size": ("reserved_bytes", "all", "peak"),
}


def device_memory_watermarks(device: Any = None) -> Optional[Dict[str, int]]:
    """The allocator watermarks as ``{label: int}`` under the JAX
    package's labels (the mapping in the module docstring), or None off
    CUDA."""
    dev = _cuda(device)
    if dev is None:
        return None
    try:
        stats = torch.cuda.memory_stats_as_nested_dict(dev)
        out = {}
        for label, (kind, pool, stat) in _TORCH_STATS.items():
            value = stats.get(kind, {}).get(pool, {}).get(stat)
            if value is not None:
                out[label] = int(value)
        out["bytes_limit"] = int(torch.cuda.get_device_properties(dev).total_memory)
    except Exception:
        return None
    return {key: out[key] for key in MEMORY_WATERMARK_KEYS if key in out} or None


def mfu_report(
    flops_per_step: Optional[float],
    step_time_s: Optional[float],
    device: Any = None,
) -> Dict[str, Any]:
    """Analytic FLOPs, hardware peak, their ratio and device memory:
    every key always present, null where the device cannot say."""
    peak = hw_flops_peak(device)
    util = None
    if flops_per_step and peak and step_time_s and step_time_s > 0:
        util = (flops_per_step / step_time_s) / peak
    return {
        "analytic_flops_per_step": (
            float(flops_per_step) if flops_per_step else None
        ),
        "hw_flops_peak": peak,
        "mfu_analytic": round(util, 5) if util is not None else None,
        "device_memory_bytes": device_memory_bytes(device),
    }
