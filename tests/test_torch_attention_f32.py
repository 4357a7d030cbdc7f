"""K4's f32 window kernels (``attn_fwd_window`` / ``attn_bwd_window``): their
arithmetic on the CPU, and the wrapper's choice of kernels and preparation.

* The kernels' arithmetic, emulated in plain torch
  (``ops/cases.attention_f32_window_forward_emulated`` /
  ``..._backward_emulated``: every dot product one fmaf per term in the
  kernel's order, a row's max, sum and delta as its quad forms them),
  within the card's f32 tolerance of the plain versions, 1e-4 x
  max|plain|, on every case of ``cases.ATTENTION_F32_WINDOW_CASES`` at B
  <= 2 (the ring twin's (B, 32, 4, 32), windows 1, 17, 33, 50 and 64,
  head dims 16 to 128, causal and not).
* At (8, 32, 4, 32) the emulation against the JAX package's Pallas
  kernel in interpret mode and ``jax.grad`` through its custom VJP:
  float32 atol 2e-6 forward and 2e-5 backward, the tolerances
  tests/test_torch_attention.py holds the plain versions to.
* The emulation's sums are the kernel's: a row's sum in quad order and
  a dot product in increasing index, each checked against a loop written
  out, and different (in the last bits) from the plain einsum.
* The choice of f32 kernels is a function of the window alone: (B, 32,
  4, 32) takes the window kernels, every window above 64 the streamed
  kernels, and every (window, padded head dim) the window route can hand
  the library is one it instantiates (read from the source).
* The wrapper's preparation: D padded to a multiple of 32 with the
  original scale, aligned views read in place, the rest copied.

The CUDA kernels against the plain versions and this emulation:
tests/test_torch_cuda.py.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.ops.fused_attention import fused_window_attention as jax_fused

from gymfx_tpu_torch.ops import cases
from gymfx_tpu_torch.ops import fused_attention as fa

from test_torch_parity import to_np, x64_off

SOURCE = pathlib.Path(fa.__file__).resolve().parent.parent / "csrc" / "attention_kernels.cu"
CARD_TOL = 1e-4  # the card tests' f32 tolerance, x max|plain|


def _qkvg(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(4))


def _ids(x):
    return "x".join(map(str, x)) if isinstance(x, tuple) else str(x)


@pytest.mark.parametrize("shape,causal", cases.ATTENTION_F32_WINDOW_CASES, ids=_ids)
def test_f32_window_emulation_within_card_tolerance_of_plain(shape, causal):
    shape = (min(shape[0], 2), *shape[1:])
    q, k, v, g = _qkvg(shape, seed=sum(shape))
    out = cases.attention_f32_window_forward_emulated(q, k, v, causal)
    ref = fa.attention_forward_plain(q, k, v, causal)
    assert out.dtype == torch.float32 and out.shape == shape
    assert float((out - ref).abs().max()) <= CARD_TOL * float(ref.abs().max())
    emulated = cases.attention_f32_window_backward_emulated(q, k, v, g, causal)
    for name, ours, plain in zip("qkv", emulated, fa.attention_backward_plain(q, k, v, g, causal)):
        assert ours.dtype == torch.float32 and ours.shape == shape
        assert float((ours - plain).abs().max()) <= CARD_TOL * float(plain.abs().max()), f"d{name}"


@pytest.mark.parametrize("causal", [False, True])
def test_f32_window_emulation_matches_the_pallas_kernel_in_interpret_mode(causal):
    shape = (8, 32, 4, 32)
    q, k, v, g = _qkvg(shape, seed=11 + causal)
    with x64_off():
        jq, jk, jv, jg = (jnp.asarray(to_np(x)) for x in (q, k, v, g))
        ref = np.asarray(jax_fused(jq, jk, jv, causal=causal, interpret=True))

        def loss(q, k, v):
            return jnp.sum(jax_fused(q, k, v, causal=causal, interpret=True) * jg)

        grads = [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]
    out = cases.attention_f32_window_forward_emulated(q, k, v, causal)
    np.testing.assert_allclose(to_np(out), ref, atol=2e-6)
    emulated = cases.attention_f32_window_backward_emulated(q, k, v, g, causal)
    for name, ours, r in zip("qkv", emulated, grads):
        np.testing.assert_allclose(to_np(ours), r, atol=2e-5, err_msg=f"d{name}")


def test_f32_window_emulation_sums_in_the_kernel_order():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 37)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 37)).astype(np.float32))
    parts = []
    for c in range(4):  # lane c of a row's quad: keys j % 4 == c in increasing j
        acc = torch.zeros(5)
        for j in range(c, 37, 4):
            acc = acc + x[:, j]
        parts.append(acc)
    assert torch.equal(cases._row_sum(x), (parts[0] + parts[1]) + (parts[2] + parts[3]))
    acc = torch.zeros(5, dtype=torch.float64)
    for j in range(37):  # one fmaf per term: exact product, one rounding a step
        acc = (acc + x[:, j].double() * w[:, j].double()).float().double()
    assert torch.equal(cases._fma_sum(x, w, 1), acc.float())
    # the order is visible: the kernel's sums are not the plain einsum's bits
    q, k, v, _ = _qkvg((2, 32, 4, 32), seed=5)
    assert not torch.equal(cases.attention_f32_window_forward_emulated(q, k, v),
                           fa.attention_forward_plain(q, k, v))


@pytest.mark.parametrize("shape,kernels", [
    ((4096, 32, 4, 32), "window"),
    ((256, 32, 4, 32), "window"),
    ((2, 1, 1, 1), "window"),
    ((2, 64, 3, 128), "window"),
    ((2, 65, 3, 32), "streamed"),
    ((64, 256, 4, 32), "streamed"),
    ((1, 1024, 1, 8), "streamed"),
])
def test_f32_kernels_by_window(shape, kernels):
    assert fa.f32_kernels(shape) == kernels
    assert fa.f32_kernels((1, *shape[1:3], 128)) == kernels  # the head dim does not choose


def test_every_shape_the_f32_route_accepts_has_an_instantiated_kernel():
    """Every (B, S, H, D) that ``_check`` accepts in f32 reaches a kernel:
    up to the source's kWindowMax a (window, padded head dim) pair that
    GYMFX_FOR_EACH_WINDOW instantiates, above it the streamed kernels, which
    take every S <= 1024 and D <= 128."""
    text = SOURCE.read_text()
    window_max = int(re.search(r"constexpr int kWindowMax = (\d+);", text).group(1))
    macro = re.search(r"#define GYMFX_FOR_EACH_WINDOW\(X\)(.*?)\n\n", text, re.S).group(1)
    instantiated = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", macro)}
    assert window_max == fa.F32_WINDOW and len(instantiated) == 8
    for s in (1, 2, 17, 31, 32, 33, 50, 63, 64, 65, 100, 1023, 1024):
        for d in range(1, fa.MAX_HEAD_DIM + 1):
            q = torch.zeros((1, s, 1, d))
            fa._check("attention_forward", q, q, q)
            if fa.f32_kernels(q.shape) == "window":
                dp = fa.padded_head_dim(d, fa.F32_WINDOW_DIM)
                assert (32 if s <= 32 else 64, dp) in instantiated, (s, d)
            else:
                assert 64 < s <= fa.MAX_FUSED_WINDOW and d <= fa.MAX_HEAD_DIM


def _views(x):
    b, s, h, d = x.shape
    wide = torch.zeros((b, s, h, d + 4))
    wide[..., :d] = x
    flat = torch.zeros(x.numel() + 1)
    flat[1:] = x.reshape(-1)
    return {
        "contiguous": x,
        "heads_outer": x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3),
        "rows_in_wider": wide[..., :d],
        "d_outermost": x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2),
        "pointer_off_16": flat[1:].view(x.shape),
        "rows_off_16": torch.zeros((b, s, h, d + 2))[..., :d].copy_(x),
    }


@pytest.mark.parametrize("layout,in_place", [
    ("contiguous", True), ("heads_outer", True), ("rows_in_wider", True),
    ("d_outermost", False), ("pointer_off_16", False), ("rows_off_16", False),
])
@pytest.mark.parametrize("d", [32, 24, 72])
def test_f32_window_preparation_reads_aligned_views_in_place_and_copies_the_rest(layout, in_place, d):
    (x,) = _qkvg((2, 33, 3, d), seed=d)[:1]
    y = _views(x)[layout]
    assert torch.equal(y, x)
    (z,), scale = fa.prepare_f32_window(y)
    dp = fa.padded_head_dim(d, fa.F32_WINDOW_DIM)
    assert z.shape == (2, 33, 3, dp) and scale == 1.0 / np.sqrt(d)
    assert z.stride(-1) == 1 and z.data_ptr() % 16 == 0 and all(st % 4 == 0 for st in z.stride()[:3])
    assert torch.equal(z[..., :d], x) and not z[..., d:].any()
    assert (z is y) == (in_place and d == dp)
    if d != dp:
        assert z.is_contiguous()
