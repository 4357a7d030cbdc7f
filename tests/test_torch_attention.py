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

The CUDA kernels against these plain versions: tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.ops.fused_attention import fused_window_attention as jax_fused
from gymfx_tpu.parallel.ring_attention import full_attention

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
