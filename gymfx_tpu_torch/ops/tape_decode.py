"""K6: the fused int16 tick-delta decode of a compressed tape block.

Replaces ``gymfx_tpu/ops/tape_decode.py::decode_q16_block`` (pallas body
``_decode_kernel``).  The kernel is ``q16_decode_kernel`` in
``csrc/data_kernels.cu``; beside it here is its plain PyTorch version,
:func:`decode_q16_plain`, the arithmetic of the JAX package's
``data/compress.decode_q16_ref``: ``(base_i32 + delta_i16 -> i32) -> f32
/ inv_f32``, elementwise.  The plain version divides by the ``inv``
tensor: CUDA PyTorch turns a division by a host scalar into a multiply
by its reciprocal, which costs the last bit.

:func:`decode_q16_block` keeps the JAX function's layout, a stacked
(C, rows) block, and dispatches by device: a CPU block runs the plain
version, a CUDA block launches the kernel or raises.
"""
from __future__ import annotations

import torch

from gymfx_tpu_torch.ops import _build


def decode_q16_plain(delta, base, inv):
    """Plain version: (C, rows) int16, (C,) int32, (C,) f32 -> (C, rows) f32."""
    return (base[:, None] + delta.to(torch.int32)).to(torch.float32) / inv[:, None]


def decode_q16_block(delta, base, inv):
    """The f32 view of a stacked q16 block, ``(base + delta) / inv`` per
    column: the kernel on CUDA tensors, the plain version on CPU tensors."""
    device = delta.device
    if device.type == "cpu":
        return decode_q16_plain(delta, base, inv)
    if device.type != "cuda":
        raise ValueError(f"decode_q16_block: unsupported device {device}")
    c, rows = delta.shape
    _build.require(delta, "decode_q16_block: delta", torch.int16, (c, rows), device)
    _build.require(base, "decode_q16_block: base", torch.int32, (c,), device)
    _build.require(inv, "decode_q16_block: inv", torch.float32, (c,), device)
    out = torch.empty((c, rows), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    # 16-byte accesses when every row starts on a 16-byte boundary
    vectorized = int(rows % 8 == 0 and delta.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _build.load_library("data")
    _build.check_launch(
        lib.gymfx_q16_decode(
            delta.data_ptr(), base.data_ptr(), inv.data_ptr(), out.data_ptr(), c, rows,
            vectorized, torch.cuda.current_stream(device).cuda_stream,
        ),
        "decode_q16_block",
    )
    decode_q16_block.launches += 1
    return out


decode_q16_block.launches = 0
