"""K4: the port's plain attention forward and backward against the JAX package.

* Forward: ``attention_forward_plain`` (and ``fused_window_attention``,
  the autograd Function, which takes it on a CPU tensor) against
  ``gymfx_tpu.ops.fused_attention.fused_window_attention(interpret=True)``
  and ``parallel.ring_attention.full_attention`` on the JAX test's cases
  (tests/test_ops.py:165-177).  float32, atol 2e-6, as the JAX test holds
  the Pallas kernel to ``full_attention``: both sides compute f32 scores,
  exp and sums, in different orders.
* Backward: ``attention_backward_plain`` and the Function's gradients
  against ``jax.grad`` through the Pallas custom VJP (its fused backward
  kernel in interpret mode).  float32, atol 2e-5, the JAX test's
  tolerance for the same comparison.
* bfloat16: both sides compute in f32 and round the result once, so they
  differ by at most one bf16 ulp of an element: atol 2^-7 x max|ref|.
* Windows above 1024 raise; the kernel's argument checks.
* The bf16 tensor-core kernels' arithmetic, emulated in plain torch
  (``ops/cases.py``: P and dS rounded to bf16 before their products, f32
  sums, row statistics and delta), within the card's tolerance of the
  plain versions, 2^-6 x max|plain|, on every bf16 case of the card tests
  at B <= 2, causal and not.
* The wrapper's preparation of bf16 inputs: D padded to a multiple of 16
  with the original scale and sliced back, unaligned or strided inputs
  copied contiguous and aligned ones left alone, a unit d stride from
  any view (a padded one included), the route per dtype and the shape of
  the backward's statistics scratch.

The CUDA kernels against these plain versions: tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.ops.fused_attention import fused_window_attention as jax_fused
from gymfx_tpu.parallel.ring_attention import full_attention

from gymfx_tpu_torch.ops import cases
from gymfx_tpu_torch.ops import fused_attention as fa
from gymfx_tpu_torch.train.policies import dense_window_attention

from test_torch_parity import to_np, x64_off


def _qkv(shape, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(n))


@pytest.mark.parametrize("shape,causal", [
    ((256, 4, 32), False),
    ((64, 4, 32), True),
    ((8, 128, 4, 32), False),
])
def test_plain_forward_matches_pallas_interpret_and_full_attention(shape, causal):
    q, k, v = _qkv(shape)
    with x64_off():
        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
        ref = np.asarray(jax_fused(jq, jk, jv, causal=causal, interpret=True))
        ref_full = np.asarray(full_attention(jq, jk, jv, causal=causal))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    batched = (lambda x: x) if len(shape) == 4 else (lambda x: x[None])
    plain = fa.attention_forward_plain(batched(tq), batched(tk), batched(tv), causal)
    ours = fa.fused_window_attention(tq, tk, tv, causal=causal)
    assert ours.shape == shape and ours.dtype == torch.float32
    np.testing.assert_allclose(to_np(plain).reshape(shape), ref, atol=2e-6)
    np.testing.assert_allclose(to_np(ours), ref, atol=2e-6)
    np.testing.assert_allclose(to_np(ours), ref_full, atol=2e-6)


def _jax_grads(q, k, v, g, causal, dtype=jnp.float32):
    with x64_off():
        jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
        jg = jnp.asarray(g).astype(dtype)

        def loss(q, k, v):
            out = jax_fused(q, k, v, causal=causal, interpret=True)
            return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

        return [np.asarray(x.astype(jnp.float32)) for x in jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]


@pytest.mark.parametrize("shape,causal", [((2, 32, 2, 16), False), ((1, 64, 4, 32), True)])
def test_plain_backward_and_autograd_match_the_pallas_custom_vjp(shape, causal):
    q, k, v, g = _qkv(shape, seed=3, n=4)
    ref = _jax_grads(q, k, v, g, causal)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    plain = fa.attention_backward_plain(tq, tk, tv, tg, causal)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = fa.fused_window_attention(*leaves, causal=causal)
    auto = torch.autograd.grad((out * tg).sum(), leaves)
    for name, p, a, r in zip("qkv", plain, auto, ref):
        np.testing.assert_allclose(to_np(p), r, atol=2e-5, err_msg=f"plain d{name}")
        np.testing.assert_allclose(to_np(a), r, atol=2e-5, err_msg=f"autograd d{name}")


def test_bfloat16_forward_and_backward_within_one_ulp():
    shape = (2, 48, 2, 16)
    q, k, v, g = _qkv(shape, seed=5, n=4)
    with x64_off():
        jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
        ref_out = np.asarray(jax_fused(jq, jk, jv, causal=True, interpret=True).astype(jnp.float32))
    ref_grads = _jax_grads(q, k, v, g, True, jnp.bfloat16)
    tq, tk, tv, tg = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g))
    out = fa.attention_forward_plain(tq, tk, tv, True)
    assert out.dtype == torch.bfloat16
    grads = fa.attention_backward_plain(tq, tk, tv, tg, True)
    for ours, ref in zip((out, *grads), (ref_out, *ref_grads)):
        assert ours.dtype == torch.bfloat16
        np.testing.assert_allclose(to_np(ours), ref, atol=2.0 ** -7 * np.abs(ref).max())


def test_windows_above_1024_raise():
    q = torch.zeros((1, 1025, 1, 4))
    with pytest.raises(ValueError, match="1024"):
        fa.fused_window_attention(q, q, q)
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        dense_window_attention(q, q, q)
    ok = torch.zeros((2, 1024, 1, 4))
    assert fa.fused_window_attention(ok, ok, ok).shape == ok.shape


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    q, k, v, g = (torch.from_numpy(x) for x in _qkv((2, 16, 2, 8), n=4))
    before = (fa.attention_forward.launches, fa.attention_backward.launches)
    assert torch.equal(fa.attention_forward(q, k, v), fa.attention_forward_plain(q, k, v))
    for a, b in zip(fa.attention_backward(q, k, v, g), fa.attention_backward_plain(q, k, v, g)):
        assert torch.equal(a, b)
    assert (fa.attention_forward.launches, fa.attention_backward.launches) == before


@pytest.mark.parametrize("shape,dtype,exc", [
    ((2, 16, 2, 8), torch.float64, NotImplementedError),
    ((1, 1025, 1, 8), torch.float32, NotImplementedError),
    ((1, 16, 1, 129), torch.float32, NotImplementedError),
    ((16, 2, 8), torch.float32, ValueError),
])
def test_kernel_argument_checks(shape, dtype, exc):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(exc):
        fa._check("attention_forward", q, q, q)
    with pytest.raises(ValueError, match="share shape"):
        fa._check("attention_forward", torch.zeros((1, 4, 1, 8)), torch.zeros((1, 4, 1, 4)))


def _bf16(shape, seed, n=4):
    return tuple(torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(shape, seed=seed, n=n))


def _rel_err(ours, ref):
    return float((ours.float() - ref.float()).abs().max()) / float(ref.float().abs().max())


CARD_TOL = 2.0 ** -6  # the card tests' bf16 tolerance, x max|plain|


@pytest.mark.parametrize("shape,causal", cases.ATTENTION_BF16_CASES,
                         ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else str(x))
def test_tensor_core_emulation_within_card_tolerance_of_plain(shape, causal):
    shape = (min(shape[0], 2), *shape[1:])
    q, k, v, g = _bf16(shape, seed=sum(shape))
    out = cases.attention_forward_emulated(q, k, v, causal)
    assert out.dtype == torch.bfloat16 and out.shape == shape
    assert _rel_err(out, fa.attention_forward_plain(q, k, v, causal)) <= CARD_TOL
    emulated = cases.attention_backward_emulated(q, k, v, g, causal)
    for name, ours, plain in zip("qkv", emulated, fa.attention_backward_plain(q, k, v, g, causal)):
        assert ours.dtype == torch.bfloat16 and ours.shape == shape
        assert _rel_err(ours, plain) <= CARD_TOL, f"d{name}"


def test_emulation_rounds_p_per_key_tile_against_the_running_max():
    """The forward emulation's tiles matter: rounding P against the
    running max of each 64-key tile differs (by bf16 rounding) from
    rounding it against the row max, and equals it when one tile holds
    the window."""
    q, k, v = _bf16((2, 160, 2, 32), seed=11, n=3)
    k = k * 4  # wide score spread: later tiles raise the running max
    tiled = cases.attention_forward_emulated(q, k, v)
    p = torch.exp2(cases._log2_scores(q, k, False, 32 ** -0.5))
    p = p / p.amax(dim=-1, keepdim=True)
    one_tile = torch.einsum("bhqk,bkhd->bqhd", cases._bf16_round(p), v.float()) / p.sum(-1).transpose(1, 2)[..., None]
    assert not torch.equal(tiled, one_tile.to(torch.bfloat16))
    assert _rel_err(tiled, one_tile) <= CARD_TOL
    short = tuple(x[:, :64] for x in (q, k, v))
    p = torch.exp2(cases._log2_scores(short[0], short[1], False, 32 ** -0.5))
    m = p.amax(dim=-1, keepdim=True)
    single = torch.einsum("bhqk,bkhd->bqhd", cases._bf16_round(p / m), short[2].float()) / (p / m).sum(-1).transpose(1, 2)[..., None]
    assert torch.equal(cases.attention_forward_emulated(*short), single.to(torch.bfloat16))


def test_head_dim_padding_keeps_the_original_scale_and_slices_back():
    shape = (2, 40, 2, 24)
    q, k, v, g = _bf16(shape, seed=7)
    (pq, pk, pv, pg), scale = fa.prepare_bf16(q, k, v, g)
    assert fa.padded_head_dim(24) == pq.shape[-1] == 32 and scale == 1.0 / np.sqrt(24)
    for x, px in zip((q, k, v, g), (pq, pk, pv, pg)):
        assert px.is_contiguous() and torch.equal(px[..., :24], x)
        assert not px[..., 24:].any()
    out = cases.attention_forward_emulated(pq, pk, pv, True, scale=scale)[..., :24]
    assert _rel_err(out, cases.attention_forward_emulated(q, k, v, True)) <= 2.0 ** -7
    assert _rel_err(out, fa.attention_forward_plain(q, k, v, True)) <= CARD_TOL
    padded = cases.attention_backward_emulated(pq, pk, pv, pg, True, scale=scale)
    for ours, plain in zip(padded, fa.attention_backward_plain(q, k, v, g, True)):
        assert not ours[..., 24:].any()
        assert _rel_err(ours[..., :24], plain) <= CARD_TOL


def _strided_views(x):
    """(B, S, H, D) views of ``x``'s values laid out otherwise in memory."""
    b, s, h, d = x.shape
    return {
        "d_outermost": x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2),  # (B, H, D, S) storage
        "heads_outer": x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3),
        "s_outer": x.permute(1, 0, 2, 3).contiguous().permute(1, 0, 2, 3),
        "pointer_off_16": torch.cat([torch.zeros(1, dtype=x.dtype), x.reshape(-1)])[1:].view(x.shape),
    }


@pytest.mark.parametrize("layout", ["d_outermost", "heads_outer", "s_outer", "pointer_off_16"])
@pytest.mark.parametrize("d", [24, 40, 32])
def test_bf16_preparation_hands_the_kernels_unit_d_stride_from_any_view(layout, d):
    """Whatever the input's strides, what reaches the kernels has a unit
    d stride, b, s and h strides and a pointer on 16 bytes, the padded
    head dim, the input's values and zeros past D."""
    (x,) = _bf16((2, 70, 3, d), seed=d, n=1)
    y = _strided_views(x)[layout]
    assert torch.equal(y, x)
    (z,), scale = fa.prepare_bf16(y)
    dp = fa.padded_head_dim(d)
    assert z.shape == (2, 70, 3, dp) and scale == 1.0 / np.sqrt(d)
    assert z.stride(-1) == 1 and z.data_ptr() % 16 == 0
    assert all(st % 8 == 0 for st in z.stride()[:3])
    assert torch.equal(z[..., :d], x) and not z[..., d:].any()
    if d != dp:
        assert z.is_contiguous()
    out = cases.attention_forward_emulated(z, z, z, True, scale=scale)[..., :d]
    assert _rel_err(out, fa.attention_forward_plain(x, x, x, True)) <= CARD_TOL


@pytest.mark.parametrize("d,dp", [(1, 16), (16, 16), (17, 32), (24, 32), (32, 32), (100, 112), (128, 128)])
def test_padded_head_dim(d, dp):
    assert fa.padded_head_dim(d) == dp


def test_bf16_preparation_copies_only_what_the_kernels_cannot_read():
    (x,) = _bf16((2, 16, 3, 32), seed=1, n=1)
    assert fa.prepare_bf16(x)[0][0] is x  # the policies' contiguous q, k, v: no copy
    heads_outer = x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    assert fa.prepare_bf16(heads_outer)[0][0] is heads_outer  # strided, aligned: read in place
    dims_outer = x.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2)  # last stride 3
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    flat[1:] = x.reshape(-1)
    shifted = flat[1:].view(x.shape)  # contiguous, pointer 2 bytes past 16
    wide = torch.zeros((2, 16, 3, 36), dtype=torch.bfloat16)
    wide[..., :32] = x
    narrow_rows = wide[..., :32]  # h stride 36 elements: rows not on 16 bytes
    for y in (dims_outer, shifted, narrow_rows):
        (z,), _ = fa.prepare_bf16(y)
        assert z is not y and z.is_contiguous() and z.data_ptr() % 16 == 0
        assert torch.equal(z, x)


def test_routes_by_dtype_and_the_statistics_scratch():
    assert fa.ROUTES[torch.bfloat16] == "tensor-core bf16"
    assert fa.ROUTES[torch.float32] == "CUDA-core f32"
    assert set(fa.ROUTES) == {torch.bfloat16, torch.float32}
    with pytest.raises(NotImplementedError):
        fa._check("attention_forward", *(torch.zeros((1, 4, 1, 8), dtype=torch.float16),) * 3)
    stats = fa.stats_scratch(3, 77, 2, torch.device("cpu"))
    assert stats.shape == (2, 3, 2, 77) and stats.dtype == torch.float32
    assert stats[0].shape == (3, 2, 77)  # lse, then delta: one (B, H, S) plane each
