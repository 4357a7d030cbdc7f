"""The threefry-2x32 counter PRNG of ``jax.random``, batched over keys.

The LOB flow (lob/flow.py) draws every message from ``jax.random``
threefry streams, so the port reproduces those bits exactly: the
installed JAX's ``threefry_seed``, ``threefry_2x32``, the fold-like
``split`` and the iota-counter ``random_bits`` of
``jax_threefry_partitionable=True`` (the default), ``_uniform`` (float32)
and ``_randint`` (int32, two 32-bit draws folded by a modulus).

A key is an ``(..., 2)`` tensor holding two uint32 words, so one call
draws for a whole batch of keys (one per env).  PyTorch has no usable
uint32 arithmetic on CUDA, so the words live in int64 tensors masked to
32 bits after every add and shift; the device is the keys' own.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000  # the bits of float32 1.0


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function (20 rounds) on broadcastable int64
    tensors of uint32 words; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def PRNGKey(seed: int, device=None):
    """``jax.random.PRNGKey(jnp.uint32(seed))``: the words (0, seed mod 2^32)."""
    # built on the device from an iota (no host copy: capturable in a CUDA graph)
    return torch.arange(2, dtype=torch.int64, device=device) * (int(seed) & _MASK)


def fold_in(key, data):
    """``jax.random.fold_in`` of each key with uint32 ``data`` (broadcast
    against the key batch): the block function of the count (0, data)."""
    if not isinstance(data, torch.Tensor):  # a tensor is used as it is: no host copy
        data = torch.as_tensor(data, device=key.device)
    data = data.to(torch.int64) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def _counted(key, n: int):
    """The block function of the counts (0, i), i < n, under each key:
    two (..., n) words (``iota_2x32_shape`` of a 1-D shape)."""
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0, None], key[..., 1, None], torch.zeros_like(count), count)


def split(key, num: int = 2):
    """``jax.random.split``: (..., num, 2) keys."""
    return torch.stack(_counted(key, num), dim=-1)


def random_bits(key, n: int):
    """32 random bits per entry, (..., n) int64 in [0, 2^32)."""
    y1, y2 = _counted(key, n)
    return y1 ^ y2


def uniform(key, n: int):
    """``jax.random.uniform(key, (n,))`` in float32: (..., n) in [0, 1)."""
    return bits_to_uniform(random_bits(key, n))


def bits_to_uniform(bits):
    """``_uniform``'s map of 32 random bits to float32 in [0, 1): the top
    23 bits as the mantissa of a float in [1, 2), minus 1."""
    return ((bits >> 9) | _ONE_F32_BITS).to(torch.int32).view(torch.float32) - 1.0


def randint(key, n: int, minval: int, maxval: int):
    """``jax.random.randint(key, (n,), minval, maxval, dtype=jnp.int32)``
    for int32 bounds: (..., n) int32."""
    k = split(key, 2)
    return bits_to_randint(random_bits(k[..., 0, :], n), random_bits(k[..., 1, :], n),
                           minval, maxval)


def randint_constants(minval: int, maxval: int):
    """``_randint``'s (span, multiplier) for int32 [minval, maxval): the
    modulus and (2^16 mod span)^2 mod span, host integers."""
    span = (int(maxval) - int(minval)) & _MASK if maxval > minval else 1
    return span, (((2 ** 16 % span) ** 2) & _MASK) % span


def bits_to_randint(higher, lower, minval: int, maxval: int):
    """``_randint``'s fold of two 32-bit draws (from the two halves of
    ``split(key)``) into [minval, maxval): int32."""
    span, multiplier = randint_constants(minval, maxval)
    # uint32 arithmetic: each product and sum wraps mod 2^32, as in JAX
    offset = ((((higher % span) * multiplier) & _MASK) + lower % span) & _MASK
    value = (int(minval) + offset % span) & _MASK
    return torch.where(value >= 2 ** 31, value - 2 ** 32, value).to(torch.int32)
