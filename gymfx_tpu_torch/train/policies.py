"""Policy networks: the discrete MLP actor-critic and the obs flattening.

The port of ``gymfx_tpu/train/policies.py`` lines 23-56 and 84-106.
:class:`MLPPolicy` computes like the flax module: the hidden layers in
``dtype`` (inputs, weights and biases cast to it, tanh in it), the
logits and value heads in float32.  Parameters are float32 master
weights.  The hidden GEMMs are ``torch.nn.functional.linear`` (cuBLAS on
the card), as the JAX package left them to XLA.  Other policy families
come with ROADMAP.md Queue 1 item 11.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from gymfx_tpu_torch.core.types import not_ported


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

    def forward(self, x):
        x = x.to(self.dtype)
        for layer in self.hidden:
            x = torch.tanh(F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype)))
        x = x.to(torch.float32)
        return self.logits(x), self.value(x).squeeze(-1)


def make_policy(name: str, obs_dim: int, *, continuous: bool = False,
                dtype=torch.float32, kwargs: Optional[Dict[str, Any]] = None) -> MLPPolicy:
    """The trainer policy for ``name``: only the discrete ``mlp`` is ported."""
    if name != "mlp" or continuous:
        raise not_ported(f"policy {name!r}{' (continuous actions)' if continuous else ''}", 11)
    kwargs = dict(kwargs or {})
    return MLPPolicy(obs_dim, hidden=tuple(kwargs.pop("hidden", (256, 256, 256))),
                     dtype=dtype, **kwargs)
