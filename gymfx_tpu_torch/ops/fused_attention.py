"""K4: fused window attention for the token policies, forward and backward.

Replaces ``gymfx_tpu/ops/fused_attention.py::fused_window_attention``
(forward ``_forward_batched`` / Pallas ``_kernel``, backward
``_backward_batched`` / Pallas ``_bwd_kernel``, tied by a
``custom_vjp``).  The kernels are ``attn_fwd_kernel`` and
``attn_bwd_kernel`` in ``csrc/attention_kernels.cu``; the module docstring
there gives their design and what bounds them.

Beside each kernel is its plain PyTorch version, the oracle:

* :func:`attention_forward_plain` follows ``_kernel``: f32 cast, scores
  times the scale, ``-inf`` causal mask, max-subtract, exp, PV, divide
  by the row sum;
* :func:`attention_backward_plain` follows ``_bwd_kernel`` formula by
  formula (recompute P normalised, dV = PᵀdO, dP = dO Vᵀ, delta =
  rowsum(dP∘P), dS = P(dP - delta)·scale, dQ = dS K, dK = dSᵀQ); it is
  not autograd of the forward.

The plain versions contract with ``torch.einsum``; the kernel path calls
no library (no SDPA, cuDNN, cuBLAS or ``torch.matmul``).

:class:`FusedWindowAttention` is the ``torch.autograd.Function``: its
forward calls :func:`attention_forward` and saves q, k and v (not P), its
backward calls :func:`attention_backward`.  Dispatch is by device: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel or
raises.  Layout is the JAX package's ``(B, S, H, D)``, read by the kernels
through strides.
"""
from __future__ import annotations

import ctypes
import math

import torch

from gymfx_tpu_torch.ops import _build

# the JAX package's bound for whole-window attention; longer windows are
# the sequence-parallel backends' (ROADMAP.md Queue 1 item 17)
MAX_FUSED_WINDOW = 1024
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scores(qf, kf, scale: float, causal: bool):
    """(B, H, Sq, Sk) f32 scores q·k × scale, ``-inf`` above the diagonal
    when causal."""
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        s = scores.shape[-1]
        keep = torch.ones((s, s), dtype=torch.bool, device=scores.device).tril()
        scores = torch.where(keep, scores, -math.inf)
    return scores


def attention_forward_plain(q, k, v, causal: bool = False):
    """Plain version of the forward: (B, S, H, D) in, (B, S, H, D) out in
    q's dtype, f32 inside."""
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    scores = _scores(qf, kf, 1.0 / math.sqrt(q.shape[-1]), causal)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    num = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    out = num / p.sum(dim=-1).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def attention_backward_plain(q, k, v, g, causal: bool = False):
    """Plain version of the backward: (dq, dk, dv) for the cotangent
    ``g`` of the forward's output, each (B, S, H, D) in q's dtype."""
    qf, kf, vf, gf = (x.to(torch.float32) for x in (q, k, v, g))
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _scores(qf, kf, scale, causal)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check(name: str, q, *others) -> None:
    """Raise unless the kernels take these (B, S, H, D) tensors."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, S, H, D); got shape {tuple(q.shape)}")
    for x in others:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name}: q, k, v (and the cotangent) must share shape, dtype and "
                f"device; got {tuple(x.shape)} {x.dtype} {x.device} against "
                f"{tuple(q.shape)} {q.dtype} {q.device}"
            )
    _, s, _, d = q.shape
    if q.dtype not in _DTYPE_CODES or s > MAX_FUSED_WINDOW or d > MAX_HEAD_DIM or q.numel() == 0:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes float32 or bfloat16, 1 <= S <= "
            f"{MAX_FUSED_WINDOW} and D <= {MAX_HEAD_DIM}; got {q.dtype}, shape {tuple(q.shape)}"
        )


def _strides(*tensors) -> ctypes.Array:
    flat = [s for t in tensors for s in t.stride()]
    return (ctypes.c_longlong * len(flat))(*flat)


def attention_forward(q, k, v, causal: bool = False):
    """K4 forward on (B, S, H, D) tensors: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return attention_forward_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_forward: unsupported device {q.device}")
    _check("attention_forward", q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library("attention")
    _build.check_launch(
        lib.gymfx_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _strides(q, k, v),
            _DTYPE_CODES[q.dtype], b, s, h, d, int(bool(causal)), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        ),
        "attention_forward",
    )
    attention_forward.launches += 1
    return out


attention_forward.launches = 0


def attention_backward(q, k, v, g, causal: bool = False):
    """K4 backward: (dq, dk, dv) on (B, S, H, D) tensors; the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, g, causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_backward: unsupported device {q.device}")
    _check("attention_backward", q, k, v, g)
    b, s, h, d = q.shape
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    lib = _build.load_library("attention")
    _build.check_launch(
        lib.gymfx_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, g),
            _DTYPE_CODES[q.dtype], b, s, h, d, int(bool(causal)), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        ),
        "attention_backward",
    )
    attention_backward.launches += 1
    return dq, dk, dv


attention_backward.launches = 0


class FusedWindowAttention(torch.autograd.Function):
    """softmax(QKᵀ/√D)V on (B, S, H, D) with the K4 backward as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = bool(causal)
        ctx.save_for_backward(q, k, v)
        return attention_forward(q, k, v, ctx.causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, g, ctx.causal)
        return dq, dk, dv, None


def fused_window_attention(q, k, v, *, causal: bool = False):
    """Exact attention for (..., W, H, D) q/k/v, any leading batch dims,
    differentiable through the K4 backward.  Returns (..., W, H, D) in the
    input dtype.  Windows beyond ``MAX_FUSED_WINDOW`` raise, as in the
    JAX package."""
    *batch, s, h, d = q.shape
    if s > MAX_FUSED_WINDOW:
        raise ValueError(
            f"fused_window_attention takes windows up to {MAX_FUSED_WINDOW}; a "
            f"window of {s} belongs to the ring/Ulysses sequence-parallel backends"
        )
    flat = lambda x: x.reshape(-1, s, h, d)  # noqa: E731
    out = FusedWindowAttention.apply(flat(q), flat(k), flat(v), bool(causal))
    return out.reshape(*batch, s, h, d)
