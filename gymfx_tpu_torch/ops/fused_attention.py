"""K4: fused window attention for the token policies, forward and backward.

Replaces ``gymfx_tpu/ops/fused_attention.py::fused_window_attention``
(forward ``_forward_batched`` / Pallas ``_kernel``, backward
``_backward_batched`` / Pallas ``_bwd_kernel``, tied by a
``custom_vjp``).  The kernels are in ``csrc/attention_kernels.cu``, whose
header gives their design and what bounds them.  Two routes, chosen by
dtype before the launch (:data:`ROUTES`):

* bfloat16, the policies' route: ``attn_fwd_tc`` forward and
  ``attn_bwd_dq_tc`` + ``attn_bwd_dkdv_tc`` backward, flash-style on the
  tensor cores (bf16 operands, f32 accumulation).  The dQ kernel leaves
  per-row statistics in an f32 (2, B, H, S) scratch
  (:func:`stats_scratch`, allocated on every backward call) that the
  dK/dV kernel reads.
* float32, f32 FMA on the CUDA cores (the route's 1e-4 tolerance rules
  out TF32), two pairs of kernels chosen by the window alone
  (:func:`f32_kernels`): up to :data:`F32_WINDOW` keys ``attn_fwd_window``
  / ``attn_bwd_window``, one warp per (b, h) with its whole window in
  shared memory, one-pass softmax and 5 products a pair in the backward
  (every default-dtype ``transformer_ring`` run: window 32); longer
  windows ``attn_fwd_kernel`` / ``attn_bwd_kernel``, which stream key
  tiles.  The window kernels read the head dim padded to a multiple of
  32 (:func:`prepare_f32_window`).

Beside the kernels is their plain PyTorch version, the oracle:

* :func:`attention_forward_plain` follows ``_kernel``: f32 cast, scores
  times the scale, ``-inf`` causal mask, max-subtract, exp, PV, divide
  by the row sum;
* :func:`attention_backward_plain` follows ``_bwd_kernel`` formula by
  formula (recompute P normalised, dV = PᵀdO, dP = dO Vᵀ, delta =
  rowsum(dP∘P), dS = P(dP - delta)·scale, dQ = dS K, dK = dSᵀQ); it is
  not autograd of the forward.

The plain versions contract with ``torch.einsum``; the kernel path calls
no library (no SDPA, cuDNN, cuBLAS or ``torch.matmul``).
``gymfx_tpu_torch/ops/cases.py`` emulates the bf16 kernels' rounding
points, and the f32 window kernels' sums in their order, in plain torch.

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
    if q.dtype not in ROUTES or s > MAX_FUSED_WINDOW or d > MAX_HEAD_DIM or q.numel() == 0:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes float32 or bfloat16, 1 <= S <= "
            f"{MAX_FUSED_WINDOW} and D <= {MAX_HEAD_DIM}; got {q.dtype}, shape {tuple(q.shape)}"
        )


def _strides(*tensors, dims: int = 4) -> ctypes.Array:
    flat = [st for t in tensors for st in t.stride()[:dims]]
    return (ctypes.c_longlong * len(flat))(*flat)


# the kernels each dtype goes to
ROUTES = {torch.bfloat16: "tensor-core bf16", torch.float32: "CUDA-core f32"}
LOG2E = 1.4426950408889634


# the f32 window kernels: the longest window they take, and the multiple
# their head dim is padded to (one 32-column register tile of a warp)
F32_WINDOW = 64
F32_WINDOW_DIM = 32


def f32_kernels(shape) -> str:
    """The f32 kernels a (B, S, H, D) call launches, from its window S
    alone (they take every D up to 128): ``"window"`` (``attn_fwd_window``
    / ``attn_bwd_window``) for S <= :data:`F32_WINDOW`, where a warp holds
    a (b, h)'s whole window in shared memory, ``"streamed"``
    (``attn_fwd_kernel`` / ``attn_bwd_kernel``) above, where it does not."""
    return "window" if shape[1] <= F32_WINDOW else "streamed"


def padded_head_dim(d: int, multiple: int = 16) -> int:
    """The head dim the tensor-core kernels run at: ``d`` rounded up to a
    multiple of 16 (the depth of one bf16 ``mma``); the f32 window
    kernels' with ``multiple`` :data:`F32_WINDOW_DIM`."""
    return -(-int(d) // multiple) * multiple


def _aligned_for_kernel(x, dp: int):
    """``x`` as the tensor-core and f32 window kernels read it: last
    stride 1, the b, s and h strides and the pointer on 16 bytes, the
    head dim ``dp``."""
    d = x.shape[-1]
    if d != dp:
        # into a new contiguous tensor: F.pad keeps the input's memory
        # format, which for some strided views puts d off the unit stride
        padded = x.new_zeros((*x.shape[:-1], dp))
        padded[..., :d] = x
        x = padded
    per16 = 16 // x.element_size()
    if (x.stride(-1) != 1 or x.data_ptr() % 16
            or any(st % per16 for st in x.stride()[:3])):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _prepare(tensors, multiple: int):
    dp = padded_head_dim(tensors[0].shape[-1], multiple)
    return tuple(_aligned_for_kernel(x, dp) for x in tensors), 1.0 / math.sqrt(tensors[0].shape[-1])


def prepare_bf16(*tensors):
    """The (B, S, H, D) bf16 tensors as the tensor-core route hands them
    to its kernels, and the scale.  Two copies can happen, neither on the
    policies' path (contiguous q, k, v and cotangent, D = 32):

    * D that is not a multiple of 16 is zero-padded to
      :func:`padded_head_dim` (one copy of each tensor, into a contiguous
      one, whatever the input's strides); the scale stays
      1/√D of the original D, the zero columns add nothing to q·k, and
      the caller slices the outputs back to D;
    * a tensor whose last stride is not 1, or whose b, s or h stride or
      pointer is not 16-byte aligned, is copied contiguous.

    Returns (tensors, scale)."""
    return _prepare(tensors, 16)


def prepare_f32_window(*tensors):
    """The (B, S, H, D) f32 tensors as the window kernels take them, and
    the scale: as :func:`prepare_bf16`, with D zero-padded to a multiple
    of :data:`F32_WINDOW_DIM` (a zero column adds exactly 0 to every f32
    sum).  The ring policies' contiguous q, k, v and cotangent at D = 32
    are read in place; any other layout is copied."""
    return _prepare(tensors, F32_WINDOW_DIM)


def stats_scratch(b: int, s: int, h: int, device):
    """The bf16 backward's f32 scratch: two (B, H, S) planes, per query
    row lse = m + log2 l (in the log2 domain of the scaled scores) and
    delta = rowsum(dP∘P), written by the dQ kernel, read by the dK/dV
    kernel."""
    return torch.empty((2, b, h, s), dtype=torch.float32, device=device)


def f32_window_kernel_smem(window: int, head_dim: int) -> dict:
    """Dynamic shared memory, in bytes, and warps of a CTA of the f32
    window kernels a call at this window and head dim launches (asked of
    the kernel library, so it builds it)."""
    out = (ctypes.c_int * 4)()
    dp = padded_head_dim(head_dim, F32_WINDOW_DIM)
    _build.check_launch(_build.load_library("attention").gymfx_attn_f32_window_smem(
        window, dp, out), "f32_window_kernel_smem")
    return {"forward": out[0], "forward warps": out[1], "backward": out[2],
            "backward warps": out[3]}


def bf16_kernel_smem(head_dim: int) -> dict:
    """Dynamic shared memory, in bytes, of the tensor-core kernels a bf16
    call at this head dim launches (asked of the kernel library, so it
    builds it): the forward, the dQ and the dK/dV kernel."""
    out = (ctypes.c_int * 3)()
    dp = padded_head_dim(head_dim)
    _build.check_launch(_build.load_library("attention").gymfx_attn_bf16_smem(dp, out),
                        "bf16_kernel_smem")
    return {"forward": out[0], "backward dQ": out[1], "backward dK/dV": out[2]}


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def attention_forward(q, k, v, causal: bool = False):
    """K4 forward on (B, S, H, D) tensors: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return attention_forward_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_forward: unsupported device {q.device}")
    _check("attention_forward", q, k, v)
    b, s, h, d = q.shape
    lib = _build.load_library("attention")
    if q.dtype == torch.float32 and f32_kernels(q.shape) == "streamed":
        out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
        rc = lib.gymfx_attn_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _strides(q, k, v),
            b, s, h, d, int(bool(causal)), 1.0 / math.sqrt(d), _stream(q))
    else:
        bf16 = q.dtype == torch.bfloat16
        (q, k, v), scale = prepare_bf16(q, k, v) if bf16 else prepare_f32_window(q, k, v)
        dp = q.shape[-1]
        out = torch.empty((b, s, h, dp), dtype=q.dtype, device=q.device)
        launch = lib.gymfx_attn_fwd_bf16 if bf16 else lib.gymfx_attn_fwd_f32_window
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    _strides(q, k, v, dims=3), b, s, h, dp, int(bool(causal)),
                    scale * LOG2E if bf16 else scale, _stream(q))
        out = out[..., :d] if dp != d else out
    _build.check_launch(rc, "attention_forward")
    attention_forward.launches += 1
    return out


attention_forward.launches = 0


def attention_backward(q, k, v, g, causal: bool = False):
    """K4 backward: (dq, dk, dv) on (B, S, H, D) tensors; the kernels on
    CUDA tensors (two launches for bf16, one for f32; the count is of
    calls), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, g, causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_backward: unsupported device {q.device}")
    _check("attention_backward", q, k, v, g)
    b, s, h, d = q.shape
    lib = _build.load_library("attention")
    if q.dtype == torch.float32 and f32_kernels(q.shape) == "streamed":
        dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
        rc = lib.gymfx_attn_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _strides(q, k, v, g), b, s, h, d, int(bool(causal)),
            1.0 / math.sqrt(d), _stream(q))
    else:
        bf16 = q.dtype == torch.bfloat16
        (q, k, v, g), scale = prepare_bf16(q, k, v, g) if bf16 else prepare_f32_window(q, k, v, g)
        dp = q.shape[-1]
        dq, dk, dv = (torch.empty((b, s, h, dp), dtype=q.dtype, device=q.device) for _ in range(3))
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr())
        if bf16:
            rc = lib.gymfx_attn_bwd_bf16(
                *ptrs, stats_scratch(b, s, h, q.device).data_ptr(), _strides(q, k, v, g, dims=3),
                b, s, h, dp, int(bool(causal)), scale, scale * LOG2E, _stream(q))
        else:
            rc = lib.gymfx_attn_bwd_f32_window(
                *ptrs, _strides(q, k, v, g, dims=3), b, s, h, dp, int(bool(causal)), scale,
                _stream(q))
        if dp != d:
            dq, dk, dv = dq[..., :d], dk[..., :d], dv[..., :d]
    _build.check_launch(rc, "attention_backward")
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
