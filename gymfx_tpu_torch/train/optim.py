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

A population (train/pbt.py) keeps its hyperparameters on the device, the
port of ``optax.inject_hyperparams`` (``gymfx_tpu/train/pbt.py:57-90``):
:class:`HyperAdamState` holds ``learning_rate``, ``clip_eps`` and
``ent_coef`` as float32 tensors of shape (P,), one value per member,
beside the moments of member-stacked params (each leaf with a leading
(P,) axis).  :meth:`ClipAdam.update_members` clips each member's
gradients by that member's own global norm and scales its step by its
own rate; the loss reads ``clip_eps`` and ``ent_coef`` from the same
state.  A replayed CUDA graph reads their values at replay time, so a
change of a member's values (exploit/explore) is a copy into the state,
never a recapture.
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


class HyperAdamState(NamedTuple):
    count: torch.Tensor  # (P,) int32, one count a member
    mu: Tree             # member-stacked first moments, in mu_dtype
    nu: Tree             # member-stacked second moments, float32
    hyper: Tree          # learning_rate, clip_eps, ent_coef: (P,) float32


def _per_member(x, like):
    """A (P,) tensor shaped to broadcast against a (P, ...) leaf."""
    return x.view(-1, *([1] * (like.dim() - 1)))


def member_global_norms(tree: Tree) -> torch.Tensor:
    """(P,) global norms of a member-stacked tree, one per member."""
    return torch.sqrt(sum(torch.sum((x * x).reshape(x.shape[0], -1), dim=1)
                          for x in tree.values()))


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
        g_norm = global_norm(grads)
        updates, count, mu, nu = self._step(grads, g_norm, state.count, state.mu, state.nu,
                                            self.lr, lambda x, like: x)
        return updates, AdamState(count, mu, nu), g_norm

    def init_members(self, params: Tree, hyper: Dict[str, float]) -> HyperAdamState:
        """Zero moments for member-stacked ``params`` and every member's
        hyperparameters set to ``hyper``'s values."""
        p = next(iter(params.values()))
        members, device = p.shape[0], p.device
        return HyperAdamState(
            count=torch.zeros(members, dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(x, dtype=self.mu_dtype) for k, x in params.items()},
            nu={k: torch.zeros_like(x) for k, x in params.items()},
            hyper={k: torch.full((members,), float(v), dtype=torch.float32, device=device)
                   for k, v in hyper.items()},
        )

    def update_members(self, grads: Tree, state: HyperAdamState):
        """:meth:`update` for each member of member-stacked
        ``grads``: (updates, new state, (P,) pre-clip global norms)."""
        g_norm = member_global_norms(grads)
        updates, count, mu, nu = self._step(grads, g_norm, state.count, state.mu, state.nu,
                                            state.hyper["learning_rate"], _per_member)
        return updates, HyperAdamState(count, mu, nu, state.hyper), g_norm

    def _step(self, grads: Tree, g_norm, count, mu: Tree, nu: Tree, lr, per):
        """The clip and the Adam step of :meth:`update` and
        :meth:`update_members`: ``per(x, leaf)`` shapes a per-member
        value (the norm, the count's corrections, the rate) to broadcast
        against ``leaf``.  (updates, count, mu in mu_dtype, nu)."""
        b1, b2 = self.b1, self.b2
        trigger = g_norm < self.max_grad_norm
        grads = {k: torch.where(per(trigger, g), g, g / per(g_norm, g) * self.max_grad_norm)
                 for k, g in grads.items()}
        mu = {k: (1 - b1) * g + mu[k] * self._b1_mu for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * nu[k] for k, g in grads.items()}
        count = torch.where(count < _INT32_MAX, count + 1, count)
        c = count.to(torch.float32)
        corr1, corr2 = 1 - b1 ** c, 1 - b2 ** c
        updates = {
            k: -per(lr, m) * ((m / per(corr1, m))
                              / (torch.sqrt(nu[k] / per(corr2, m) + self.eps_root) + self.eps))
            for k, m in mu.items()
        }
        return updates, count, {k: m.to(self.mu_dtype) for k, m in mu.items()}, nu


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
