"""Policy networks: the discrete actor-critics, their Gaussian twins for
continuous actions, and the obs encodings.

The port of ``gymfx_tpu/train/policies.py``: the obs spec and
``flatten_obs`` (:23-56), ``dense_window_attention`` (:59-77),
``MLPPolicy`` (:84-106), ``LSTMPolicy`` (:109-137), ``RingTransformerEncoder`` and
``RingTransformerPolicy`` in single-device mode (:189-314),
``tokens_from_obs`` and ``make_obs_encoder`` (:354-379), the Gaussian
twins ``ContinuousMLPPolicy``, ``GaussianValueHead``,
``ContinuousLSTMPolicy`` and ``ContinuousRingTransformerPolicy`` with
``normal_logp`` / ``sample_normal`` / ``gaussian_entropy`` (:382-523), and
``TOKEN_POLICIES`` / ``policy_kwargs_for`` / ``make_trainer_policy`` /
``make_policy`` (:444-580).  Every function takes a batch: a leading
env (or sample) axis that the JAX package adds with ``vmap``.

Each module computes like its flax twin:

* Dense layers in ``dtype`` cast inputs, weights and biases to it; the
  logits and value heads are float32.  Parameters are float32 master
  weights.  The GEMMs are ``torch.nn.functional.linear`` (cuBLAS on the
  card), as the JAX package left them to XLA.
* LayerNorm is flax's: epsilon 1e-6, statistics in float32 as
  E[x²] - E[x]² (``use_fast_variance``), scale and bias in float32, the
  output cast to ``dtype``.
* GELU is the tanh approximation (``nn.gelu``).  The positional
  embedding is a float32 parameter cast to ``dtype`` before the add; the
  mean pool over tokens runs in ``dtype``.

A Gaussian twin returns ``((mu, log_std), value)``: a tanh float32 mean
of a Normal over the Box(-1, 1, (1,)) action, a state-independent
float32 ``log_std`` parameter (initialised to -0.5) broadcast to the
mean's shape, and a float32 value, both heads over the trunk's output
promoted to float32 (flax's ``Dense(dtype=f32)``).  The env thresholds
the sampled value into hold / long / short (core/env.py).

Attention goes through K4 (``ops/fused_attention.py``) for every window
up to 1024, kernel on the card and plain version on the CPU.  The
sequence-parallel modes (a ``seq_axis``) come with ROADMAP.md Queue 1
item 17.  ``transformer_continuous`` is the ring encoder's twin, as in
the JAX package (K4, not flax's multi-head attention).  The flax
``TransformerPolicy`` (:140-179) attends through flax's
``MultiHeadDotProductAttention``, which no Pallas kernel computes: its
port is plain torch ops (:func:`flax_attention`).

Every module may also be applied with member-stacked params (each
parameter with a leading population axis P, the input (P, ...)): the
dense layers then run as one batched GEMM (:func:`_dense`) and K4 takes
the members folded into its batch, so a population's policies are one
forward.

The LSTM follows flax's ``OptimizedLSTMCell`` (flax 0.12.3) at its
rounding points: the input part ``x @ W_i`` and the hidden part
``h @ W_h + b_h`` of the four gates are each a dense output in ``dtype``
(the product rounded, then the bias added and rounded), summed in
``dtype``; gates ``i, f, o`` are sigmoids and ``g`` a tanh, ``c' = f·c +
i·g`` and ``h' = o·tanh(c')``, with the carry ``(c, h)`` kept in
``dtype``.  XLA may keep f32 between those bf16 ops inside a fusion, so
in bf16 the two packages agree within a tolerance the tests state.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from gymfx_tpu_torch.core.types import not_ported
from gymfx_tpu_torch.ops.fused_attention import MAX_FUSED_WINDOW, fused_window_attention


class ObsSpec(NamedTuple):
    """Static layout of a batched Dict observation: sorted keys, each
    block's per-env shape and flat size."""

    keys: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    total_size: int


def make_obs_spec(obs: Dict[str, Any]) -> ObsSpec:
    """Derive the flattening spec from one batched obs dict (leading env axis)."""
    keys = tuple(sorted(obs.keys()))
    shapes = tuple(tuple(int(s) for s in obs[k].shape[1:]) for k in keys)
    sizes = tuple(math.prod(shape) if shape else 1 for shape in shapes)
    return ObsSpec(keys, shapes, sizes, sum(sizes))


def flatten_obs(obs: Dict[str, Any], spec: Optional[ObsSpec] = None):
    """Batched Dict obs -> (N, obs_dim) float32, in sorted key order."""
    keys = spec.keys if spec is not None else tuple(sorted(obs.keys()))
    parts = [obs[k].reshape(obs[k].shape[0], -1).to(torch.float32) for k in keys]
    return torch.cat(parts, dim=1)


def tokens_from_obs(obs: Dict[str, Any], window: int, spec: Optional[ObsSpec] = None,
                    min_dims: int = 2):
    """Batched Dict obs -> (N, window, token_dim) float32 tokens, in sorted
    key order: a block of at least ``min_dims`` dims whose first per-env
    dim is the window gives per-bar columns; every other block is
    flattened and broadcast along the window.  A portfolio's window blocks
    are (window, I) a book, so it passes ``min_dims=3``: a shape test on
    the first per-env axis alone would misfire when n_pairs == window."""
    keys = spec.keys if spec is not None else tuple(sorted(obs.keys()))
    cols = []
    for k in keys:
        v = obs[k]
        n = v.shape[0]
        if v.dim() >= min_dims and v.shape[1] == window:
            cols.append(v.reshape(n, window, -1).to(torch.float32))
        else:
            flat = v.reshape(n, -1).to(torch.float32)
            cols.append(flat[:, None, :].expand(n, window, flat.shape[1]))
    return torch.cat(cols, dim=-1)


# policies whose inputs are (window, token_dim) token sequences
TOKEN_POLICIES = ("transformer", "transformer_ring", "transformer_ulysses")


def is_token_policy(name: str) -> bool:
    return name in TOKEN_POLICIES


def make_obs_encoder(policy_name: str, window: int, spec: ObsSpec):
    """The obs -> policy-input encoding: tokens for the token policies, the
    flat vector otherwise, both through the static ``spec``."""
    if is_token_policy(policy_name):
        return lambda obs: tokens_from_obs(obs, window, spec)
    return lambda obs: flatten_obs(obs, spec)


def dense_window_attention(q, k, v):
    """Single-device attention for the token policies on (..., W, H, D):
    K4 for every window up to ``MAX_FUSED_WINDOW`` (the kernel on CUDA
    tensors, its plain version on CPU tensors)."""
    window = q.shape[-3]
    if window > MAX_FUSED_WINDOW:
        raise not_ported(
            f"attention over a window of {window} (> {MAX_FUSED_WINDOW}: the "
            "ring/Ulysses sequence-parallel backends)", 17,
        )
    return fused_window_attention(q, k, v)


def _dense(x, layer: nn.Linear, dtype):
    """``layer`` applied in ``dtype``.  Applied with member-stacked params
    (a leading member axis P on the weight, (P, out, in), and on ``x``,
    (P, ..., in): a population's policies), one batched GEMM for all
    members."""
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    if w.dim() == 2:
        return F.linear(x, w, b)
    p = w.shape[0]
    y = torch.baddbmm(b[:, None, :], x.reshape(p, -1, x.shape[-1]), w.transpose(1, 2))
    return y.reshape(*x.shape[:-1], w.shape[1])


def _member_view(param, x, dims: int):
    """``param`` (of ``dims`` dims, or member-stacked with a leading
    (P,) more) shaped to broadcast against ``x`` (P, ..., param's dims)."""
    if param.dim() == dims:
        return param
    return param.view(param.shape[0], *([1] * (x.dim() - param.dim())), *param.shape[1:])


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm(dtype=...): float32 statistics, epsilon 1e-6."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.epsilon = epsilon

    def forward(self, x, dtype):
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.epsilon) * _member_view(self.weight, x32, 1)
        return ((x32 - mean) * mul + _member_view(self.bias, x32, 1)).to(dtype)


class MLPPolicy(nn.Module):
    """3-layer MLP actor-critic: (N, obs_dim) -> (logits (N, A), value (N,))."""

    def __init__(self, obs_dim: int, n_actions: int = 3,
                 hidden: Sequence[int] = (256, 256, 256), dtype=torch.float32):
        super().__init__()
        widths = [int(obs_dim), *[int(h) for h in hidden]]
        self.hidden = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:])
        )
        self.logits = nn.Linear(widths[-1], n_actions)
        self.value = nn.Linear(widths[-1], 1)
        self.dtype = dtype

    def trunk(self, x):
        """The tanh hidden layers, in the policy dtype."""
        x = x.to(self.dtype)
        for layer in self.hidden:
            x = torch.tanh(_dense(x, layer, self.dtype))
        return x

    def forward(self, x):
        x = self.trunk(x).to(torch.float32)
        return _dense(x, self.logits, torch.float32), _dense(x, self.value, torch.float32).squeeze(-1)


class LSTMPolicy(nn.Module):
    """Recurrent actor-critic: a tanh dense embedding, flax's optimized
    LSTM cell, float32 logits and value heads.  ``forward(x, carry)``
    maps (N, obs_dim) inputs and an ``(c, h)`` carry of (N, hidden) to
    (logits (N, A), value (N,), new carry).

    The cell's gate kernels are stacked in flax's order ``i, f, g, o``:
    ``cell_i`` holds ``ii, if, ig, io`` (no bias), ``cell_h`` holds
    ``hi, hf, hg, ho`` with their biases (convert.lstm_params_from_flax)."""

    recurrent = True

    def __init__(self, obs_dim: int, n_actions: int = 3, hidden: int = 256,
                 dtype=torch.float32):
        super().__init__()
        self.hidden = int(hidden)
        self.embed = nn.Linear(int(obs_dim), self.hidden)
        self.cell_i = nn.Linear(self.hidden, 4 * self.hidden, bias=False)
        self.cell_h = nn.Linear(self.hidden, 4 * self.hidden)
        self.logits = nn.Linear(self.hidden, n_actions)
        self.value = nn.Linear(self.hidden, 1)
        self.dtype = dtype

    def initial_carry(self, batch: int, device=None):
        """``(c, h)`` zeros of (batch, hidden) in the policy dtype: two
        distinct buffers."""
        shape = (int(batch), self.hidden)
        return (torch.zeros(shape, dtype=self.dtype, device=device),
                torch.zeros(shape, dtype=self.dtype, device=device))

    def cell(self, x, carry):
        """The embedding and one step of the cell: the new ``(c, h)``."""
        dt = self.dtype
        x = torch.tanh(_dense_rounded(x.to(dt), self.embed, dt))
        c, h = carry
        dense_h = _dense_rounded(h, self.cell_h, dt)
        dense_i = torch.matmul(x, self.cell_i.weight.to(dt).transpose(-1, -2))
        zi, zf, zg, zo = (dense_h + dense_i).chunk(4, dim=-1)
        i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
        g = torch.tanh(zg)
        new_c = f * c + i * g
        return new_c, o * torch.tanh(new_c)

    def forward(self, x, carry):
        new_c, new_h = self.cell(x, carry)
        y = new_h.to(torch.float32)
        return (_dense(y, self.logits, torch.float32), _dense(y, self.value, torch.float32).squeeze(-1),
                (new_c, new_h))


def _dense_rounded(x, layer: nn.Linear, dtype):
    """flax Dense in ``dtype``: the product in ``dtype``, then the bias
    added in ``dtype`` (two roundings where F.linear may fuse them).
    Member-stacked params ((P, out, in) weights, ``x`` (P, ..., in)) make
    the product one batched GEMM."""
    w = layer.weight.to(dtype)
    if w.dim() == 2:
        return torch.matmul(x, w.t()) + layer.bias.to(dtype)
    p = w.shape[0]
    y = torch.bmm(x.reshape(p, -1, x.shape[-1]), w.transpose(1, 2)).reshape(*x.shape[:-1], w.shape[1])
    return y + _member_view(layer.bias.to(dtype), y, 1)


def is_recurrent(policy: nn.Module) -> bool:
    """Whether ``policy`` threads a carry (``forward(x, carry)``)."""
    return getattr(policy, "recurrent", False)


class TransformerBlock(nn.Module):
    """One pre-norm transformer layer: LayerNorm, the q/k/v projections to
    (H, Dh) with biases, ``attention`` over (..., W, H, Dh), the output
    projection and a residual add; LayerNorm, the 4x GELU MLP and a
    residual add.  ``attention`` is K4 (``dense_window_attention``) in
    RingTransformerEncoder and flax's multi-head attention
    (``flax_attention``) in TransformerPolicy's trunk."""

    def __init__(self, d_model: int, n_heads: int, attention):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of n_heads {n_heads}")
        self.n_heads, self.attention = n_heads, attention
        self.ln1 = LayerNorm(d_model)
        # flax DenseGeneral((H, Dh)) kernels (d_model, H, Dh) as (H*Dh, d_model) weights
        self.q, self.k, self.v = (nn.Linear(d_model, d_model) for _ in range(3))
        # flax DenseGeneral(d_model, axis=(-2, -1)) kernel (H, Dh, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.ln2 = LayerNorm(d_model)
        self.fc1 = nn.Linear(d_model, 4 * d_model)
        self.fc2 = nn.Linear(4 * d_model, d_model)

    def forward(self, x, dtype):
        y = self.ln1(x, dtype)
        heads = (self.n_heads, y.shape[-1] // self.n_heads)
        q, k, v = (_dense(y, lin, dtype).unflatten(-1, heads) for lin in (self.q, self.k, self.v))
        a = self.attention(q, k, v)
        x = x + _dense(a.flatten(-2), self.out, dtype)
        y = F.gelu(_dense(self.ln2(x, dtype), self.fc1, dtype), approximate="tanh")
        return x + _dense(y, self.fc2, dtype)


class RingTransformerEncoder(nn.Module):
    """The transformer trunk over (..., window, token_dim) tokens, returning
    the mean-pooled (..., d_model) embedding (single-device mode).  Its
    layers attend through ``attention``: K4, or ``flax_attention`` for the
    trunk of the JAX package's ``TransformerPolicy`` (policies.py
    :140-179)."""

    def __init__(self, token_dim: int, window: int = 32, d_model: int = 128, n_heads: int = 4,
                 n_layers: int = 2, dtype=torch.float32, seq_axis: Optional[str] = None,
                 seq_shards: int = 1, sp_backend: str = "ring",
                 attention=dense_window_attention):
        super().__init__()
        if sp_backend not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp_backend {sp_backend!r} (expected 'ring' or 'ulysses')")
        if seq_axis is not None or int(seq_shards) != 1:
            raise not_ported(f"sequence-parallel attention (seq_axis={seq_axis!r}, "
                             f"seq_shards={seq_shards})", 17)
        self.dtype = dtype
        self.embed = nn.Linear(int(token_dim), d_model)
        self.pos_embed = nn.Parameter(torch.zeros(int(window), d_model))
        self.layers = nn.ModuleList(TransformerBlock(d_model, n_heads, attention)
                                    for _ in range(n_layers))
        self.norm = LayerNorm(d_model)

    def forward(self, tokens):
        dt = self.dtype
        x = _dense(tokens.to(dt), self.embed, dt)
        x = x + _member_view(self.pos_embed, x, 2).to(dt)
        for layer in self.layers:
            x = layer(x, dt)
        return self.norm(x, dt).mean(dim=-2)


def flax_attention(q, k, v):
    """The core of flax ``nn.MultiHeadDotProductAttention`` (self-attention,
    no mask, no dropout) on (..., W, H, Dh) in plain torch ops: the query
    divided by sqrt(Dh) rounded to its dtype, the scores
    ``einsum("...qhd,...khd->...hqk")``, a softmax in that dtype and the
    weighted values.  No Pallas kernel computes this attention in the JAX
    package."""
    # jnp.sqrt(depth).astype(dtype): the divisor rounded to dtype first
    depth = float(torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32).to(q.dtype))
    w = _softmax(torch.einsum("...qhd,...khd->...hqk", q / depth, k))
    return torch.einsum("...hqk,...khd->...qhd", w, v)


def _softmax(x):
    """``jax.nn.softmax`` at its rounding points in ``x``'s dtype: the
    shift, the exponential and the quotient each rounded, the sum
    accumulated in float32 and rounded (torch's own softmax rounds once)."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True, dtype=torch.float32).to(x.dtype)


class TransformerPolicy(nn.Module):
    """The JAX package's ``TransformerPolicy``: attention over the
    observation window (BASELINE config 5), float32 logits and value
    heads on the pooled embedding.  Its positional embedding has one row
    per token, so the policy is built for one window."""

    def __init__(self, token_dim: int, window: int, n_actions: int = 3, d_model: int = 128,
                 n_heads: int = 4, n_layers: int = 2, dtype=torch.float32):
        super().__init__()
        self.encoder = RingTransformerEncoder(token_dim, window, d_model, n_heads, n_layers,
                                              dtype, attention=flax_attention)
        self.logits = nn.Linear(d_model, n_actions)
        self.value = nn.Linear(d_model, 1)

    def forward(self, tokens):
        pooled = self.encoder(tokens).to(torch.float32)
        return _dense(pooled, self.logits, torch.float32), \
            _dense(pooled, self.value, torch.float32).squeeze(-1)


class RingTransformerPolicy(nn.Module):
    """Actor-critic over RingTransformerEncoder: float32 logits and value
    heads on the pooled embedding."""

    def __init__(self, token_dim: int, n_actions: int = 3, dtype=torch.float32, **kw):
        super().__init__()
        self.encoder = RingTransformerEncoder(token_dim, dtype=dtype, **kw)
        d_model = self.encoder.pos_embed.shape[1]
        self.logits = nn.Linear(d_model, n_actions)
        self.value = nn.Linear(d_model, 1)

    def forward(self, tokens):
        pooled = self.encoder(tokens).to(torch.float32)
        return _dense(pooled, self.logits, torch.float32), \
            _dense(pooled, self.value, torch.float32).squeeze(-1)


# ---------------------------------------------------------------------------
# The Gaussian action distribution: one definition for every trainer (PPO's
# ratio and entropy, IMPALA's V-trace weights), each in its input's dtype
HALF_LOG_2PI = 0.9189385332046727         # 0.5 * ln(2*pi)
GAUSS_ENTROPY_CONST = 1.4189385332046727  # 0.5 * ln(2*pi*e)


def normal_logp(x, mu, log_std):
    """The Normal(mu, exp(log_std)) log-density of ``x``, in ``x``'s dtype."""
    z = (x - mu) / torch.exp(log_std)
    return -0.5 * (z * z) - log_std - HALF_LOG_2PI


def sample_normal(generator: torch.Generator, dist):
    """A reparameterised draw from a ``(mu, log_std)`` pair in mu's dtype,
    from ``generator``'s normal stream."""
    mu, log_std = dist
    eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    return mu + torch.exp(log_std) * eps


def gaussian_entropy(log_std, dim=None):
    """The mean differential entropy of the diagonal Normal (over ``dim``,
    every axis when None)."""
    h = GAUSS_ENTROPY_CONST + log_std
    return torch.mean(h) if dim is None else torch.mean(h, dim=dim)


def _gaussian_head(module: nn.Module, feat):
    """``module``'s ``mu``, ``log_std`` and ``value`` on the features
    ``feat`` promoted to float32: ((mu, log_std) each (...,), value (...,))."""
    feat = feat.to(torch.float32)
    mu = torch.tanh(_dense(feat, module.mu, torch.float32))
    log_std = _member_view(module.log_std, mu, 1).expand(mu.shape).squeeze(-1)
    return (mu.squeeze(-1), log_std), _dense(feat, module.value, torch.float32).squeeze(-1)


class GaussianValueHead(nn.Module):
    """The continuous actor-critic head over a trunk's features: a tanh
    float32 mean, the state-independent float32 ``log_std`` and the float32
    value.  ``forward(feat)`` -> ((mu, log_std) each (...,), value (...,))."""

    def __init__(self, features: int):
        super().__init__()
        self.mu = nn.Linear(int(features), 1)
        self.log_std = nn.Parameter(torch.full((1,), -0.5))
        self.value = nn.Linear(int(features), 1)

    def forward(self, feat):
        return _gaussian_head(self, feat)


class ContinuousMLPPolicy(MLPPolicy):
    """The Gaussian twin of :class:`MLPPolicy`: its trunk, then the head's
    layers as the flax module's own (``Dense_n`` the mean, ``log_std``,
    ``Dense_{n+1}`` the value; not a ``GaussianValueHead``, as in the JAX
    package, which keeps that module's checkpoint structure)."""

    continuous = True

    def __init__(self, obs_dim: int, hidden: Sequence[int] = (256, 256, 256),
                 dtype=torch.float32):
        super().__init__(obs_dim, hidden=hidden, dtype=dtype)
        del self.logits, self.value
        width = self.hidden[-1].out_features
        self.mu = nn.Linear(width, 1)
        self.log_std = nn.Parameter(torch.full((1,), -0.5))
        self.value = nn.Linear(width, 1)

    def forward(self, x):
        return _gaussian_head(self, self.trunk(x))


class ContinuousLSTMPolicy(LSTMPolicy):
    """The Gaussian twin of :class:`LSTMPolicy`: its embedding and cell,
    then a :class:`GaussianValueHead` on the new hidden state.
    ``forward(x, carry)`` -> ((mu, log_std), value, new carry)."""

    continuous = True

    def __init__(self, obs_dim: int, hidden: int = 256, dtype=torch.float32):
        super().__init__(obs_dim, hidden=hidden, dtype=dtype)
        del self.logits, self.value
        self.head = GaussianValueHead(self.hidden)

    def forward(self, x, carry):
        new_c, new_h = self.cell(x, carry)
        dist, value = self.head(new_h)
        return dist, value, (new_c, new_h)


class ContinuousRingTransformerPolicy(nn.Module):
    """The Gaussian twin over :class:`RingTransformerEncoder` (K4): every
    attention policy's continuous form (``transformer``,
    ``transformer_ring``, ``transformer_ulysses``)."""

    continuous = True

    def __init__(self, token_dim: int, dtype=torch.float32, **kw):
        super().__init__()
        self.encoder = RingTransformerEncoder(token_dim, dtype=dtype, **kw)
        self.head = GaussianValueHead(self.encoder.pos_embed.shape[1])

    def forward(self, tokens):
        return self.head(self.encoder(tokens))


def is_continuous(policy: nn.Module) -> bool:
    """Whether ``policy`` is a Gaussian twin (its first output a
    ``(mu, log_std)`` pair, not logits)."""
    return getattr(policy, "continuous", False)


def policy_kwargs_for(name: str, kwargs: Dict[str, Any], window: int) -> Dict[str, Any]:
    """Trainer-side kwarg resolution: the ring policies need the window
    for their positional embeddings."""
    kwargs = dict(kwargs)
    if name in TOKEN_POLICIES:
        kwargs.setdefault("window", window)
    return kwargs


def make_policy(name: str, in_dim: int, *, continuous: bool = False,
                dtype=torch.float32, kwargs: Optional[Dict[str, Any]] = None) -> nn.Module:
    """The policy ``name`` over inputs of width ``in_dim`` (the flat obs
    size, or the token width of a token policy).  Without a seq axis
    ``transformer_ring`` and ``transformer_ulysses`` are the same module.
    ``continuous=True`` (or a ``<name>_continuous`` name) gives the
    Gaussian twin; a name without one raises the JAX package's
    ``ValueError``."""
    kwargs = dict(kwargs or {})
    if continuous and not name.endswith("_continuous"):
        name = f"{name}_continuous"
    if name == "mlp_continuous":
        return ContinuousMLPPolicy(in_dim, hidden=tuple(kwargs.pop("hidden", (256, 256, 256))),
                                   dtype=dtype, **kwargs)
    if name == "lstm_continuous":
        return ContinuousLSTMPolicy(in_dim, dtype=dtype, **kwargs)
    if name in ("transformer_continuous", "transformer_ring_continuous"):
        return ContinuousRingTransformerPolicy(in_dim, dtype=dtype, **kwargs)
    if name == "transformer_ulysses_continuous":
        return ContinuousRingTransformerPolicy(in_dim, dtype=dtype, sp_backend="ulysses",
                                               **kwargs)
    if name == "mlp":
        return MLPPolicy(in_dim, hidden=tuple(kwargs.pop("hidden", (256, 256, 256))),
                         dtype=dtype, **kwargs)
    if name == "lstm":
        return LSTMPolicy(in_dim, dtype=dtype, **kwargs)
    if name == "transformer":
        return TransformerPolicy(in_dim, dtype=dtype, **kwargs)
    if name == "transformer_ring":
        return RingTransformerPolicy(in_dim, dtype=dtype, **kwargs)
    if name == "transformer_ulysses":
        return RingTransformerPolicy(in_dim, dtype=dtype, sp_backend="ulysses", **kwargs)
    raise ValueError(f"unknown policy {name!r}")


def make_trainer_policy(name: str, in_dim: int, *, continuous: bool, dtype,
                        kwargs: Dict[str, Any], window: int) -> nn.Module:
    """The one policy-construction path of the trainers (and the serving
    engine): the Gaussian twin in continuous mode."""
    return make_policy(name, in_dim, continuous=continuous, dtype=dtype,
                       kwargs=policy_kwargs_for(name, kwargs, window))
