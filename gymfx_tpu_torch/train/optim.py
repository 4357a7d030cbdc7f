"""The PPO optimizer: clip-by-global-norm, then Adam, as plain functions.

The port of ``optax.chain(optax.clip_by_global_norm(max_grad_norm),
optax.adam(lr, mu_dtype=opt_state_dtype))`` (``gymfx_tpu/train/ppo.py``
:260-264), following optax 0.2.6's ``clip_by_global_norm`` and
``scale_by_adam`` step by step:

    g_norm = sqrt(sum of every leaf's sum of squares)
    g      = g                       if g_norm < max_norm
             g / g_norm * max_norm   otherwise
    mu     = (1 - b1) g + b1 mu      (f32; stored cast to mu_dtype)
    nu     = (1 - b2) g**2 + b2 nu   (f32)
    count  = count + 1               (int32, saturating)
    update = -lr * (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count) + eps_root) + eps)

with b1 0.9, b2 0.999, eps 1e-8, eps_root 0.  Params and ``nu`` stay
float32; only ``mu`` may be stored in bfloat16 (the master-weight rule of
``resolve_optimizer_state_dtype``).  ``torch.optim.Adam`` is not used:
it places eps differently and cannot store ``mu`` in bfloat16.  Trees are
dicts of tensors; nothing syncs the host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]
_INT32_MAX = 2 ** 31 - 1


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32
    mu: Tree             # first moment, in mu_dtype
    nu: Tree             # second moment, float32


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x * x) for x in tree.values()))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """(clipped grads, pre-clip global norm)."""
    g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    return {k: torch.where(trigger, g, g / g_norm * max_norm) for k, g in grads.items()}, g_norm


class ClipAdam:
    """``clip_by_global_norm(max_grad_norm)`` then ``adam(lr, mu_dtype)``."""

    def __init__(self, lr: float, max_grad_norm: float, mu_dtype=torch.float32,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0):
        self.lr, self.max_grad_norm, self.mu_dtype = float(lr), float(max_grad_norm), mu_dtype
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        # the decay meets the stored moment in its dtype, as JAX's weakly
        # typed float does: against a bf16 mu, b1 rounds to bf16 first.
        # Built once, on the host: a 0-d CPU tensor enters a CUDA kernel as
        # a scalar argument, so an update allocates nothing on the host
        # (nothing inside a CUDA graph's capture)
        self._b1_mu = torch.tensor(b1, dtype=mu_dtype)

    def init(self, params: Tree) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(p, dtype=self.mu_dtype) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    def update(self, grads: Tree, state: AdamState) -> Tuple[Tree, AdamState, torch.Tensor]:
        """(updates, new state, pre-clip gradient global norm)."""
        b1, b2 = self.b1, self.b2
        grads, g_norm = clip_by_global_norm(grads, self.max_grad_norm)
        mu = {k: (1 - b1) * g + state.mu[k] * self._b1_mu for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k] for k, g in grads.items()}
        count = torch.where(state.count < _INT32_MAX, state.count + 1, state.count)
        c = count.to(torch.float32)
        corr1, corr2 = 1 - b1 ** c, 1 - b2 ** c
        updates = {
            k: -self.lr * ((mu[k] / corr1) / (torch.sqrt(nu[k] / corr2 + self.eps_root) + self.eps))
            for k in grads
        }
        new_state = AdamState(count, {k: m.to(self.mu_dtype) for k, m in mu.items()}, nu)
        return updates, new_state, g_norm


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
