"""Shared trainer helpers (the port of ``gymfx_tpu/train/common.py``'s
``masked_reset``; the update-phase helpers come with ROADMAP.md Queue 1
item 6)."""
from __future__ import annotations

import torch


def masked_reset(done, fresh, cur):
    """Where ``done`` ((N,) bool), replace each env's entry of ``cur``
    with ``fresh``'s (a tensor or a NamedTuple of tensors; ``fresh``
    broadcasts over the env axis, so a single-env (1, ...) reset state
    serves every env)."""

    def one(f, c):
        return torch.where(done.view(-1, *([1] * (c.dim() - 1))), f, c)

    if isinstance(cur, tuple):
        return type(cur)(*(one(f, c) for f, c in zip(fresh, cur)))
    return one(fresh, cur)
