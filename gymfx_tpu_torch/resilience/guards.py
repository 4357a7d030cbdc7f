"""Non-finite train-step guards: the port of ``gymfx_tpu/resilience/guards.py``
(``tree_all_finite``, ``select_tree``, ``quarantine_mask``, :28-83; the
host-side ``NonFiniteDivergenceError`` and ``SkipMonitor``, :86-146).

A tree here is a tensor, a dict, or a tuple / NamedTuple of trees.  The
guard's decision stays a device tensor: ``tree_all_finite`` returns a
0-d bool tensor and ``select_tree`` is ``torch.where`` on it, so a
guarded update never syncs the host; ``SkipMonitor`` reads the guard's
counters on the host, one dispatch late (resilience/loop.py).  A
population (train/pbt.py) decides member by member:
``member_all_finite`` and ``select_members``, the JAX package's guard
under its population ``vmap``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *items) for items in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *items) for items in zip(tree, *rest))
    return fn(tree, *rest)


def _float_leaves(tree: Any) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor) and x.is_floating_point()]


def tree_all_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every element of every floating leaf is finite
    (integer and bool leaves cannot hold NaN and are skipped); on the
    tree's device (the CPU for a tree with no tensor)."""
    leaves = _float_leaves(tree)
    if not leaves:
        tensors = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
        return torch.ones((), dtype=torch.bool, device=tensors[0].device if tensors else "cpu")
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()


def select_tree(pred, new_tree: Any, old_tree: Any) -> Any:
    """Per-leaf ``where(pred, new, old)`` with a 0-d ``pred``: the update
    is taken when True, the last-good tree kept bit for bit when False."""
    return tree_map(lambda n, o: torch.where(pred, n, o), new_tree, old_tree)


def member_all_finite(tree: Any) -> torch.Tensor:
    """(P,) bool: whether each member's slice of a member-stacked tree
    (every floating leaf with a leading (P,) axis) is all finite."""
    leaves = _float_leaves(tree)
    return torch.stack([torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)
                        for x in leaves]).all(dim=0)


def select_members(pred, new_tree: Any, old_tree: Any) -> Any:
    """:func:`select_tree` member by member: ``pred`` ((P,) bool) picks
    each member's slice (the leading axis of every leaf) from
    ``new_tree`` or ``old_tree``."""
    return tree_map(lambda n, o: torch.where(pred.view(-1, *([1] * (n.dim() - 1))), n, o),
                    new_tree, old_tree)


def quarantine_mask(tree: Any, *, env_axis: int = 1, mode: str = "nonfinite") -> torch.Tensor:
    """Per-env poison mask over the floating leaves of ``tree``: True
    where any value of that env (index along ``env_axis``) is bad.
    ``mode='nonfinite'`` flags NaN and ±inf (trajectory outputs);
    ``mode='nan'`` flags NaN only (carried env state, whose peak/min/max
    trackers hold ±inf sentinels by design)."""
    if mode == "nonfinite":
        is_bad = lambda x: ~torch.isfinite(x)  # noqa: E731
    elif mode == "nan":
        is_bad = torch.isnan
    else:
        raise ValueError(f"mode must be 'nonfinite' or 'nan', got {mode!r}")
    masks = []
    for x in _float_leaves(tree):
        bad = is_bad(x).movedim(env_axis, 0)
        masks.append(bad.reshape(bad.shape[0], -1).any(dim=1))
    if not masks:
        raise ValueError("quarantine_mask needs at least one floating leaf")
    out = masks[0]
    for m in masks[1:]:
        out = out | m
    return out


class NonFiniteDivergenceError(RuntimeError):
    """Training diverged: every update in N consecutive steps was
    non-finite.  Carries the last metrics snapshot for the post-mortem."""

    def __init__(self, message: str, metrics: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.metrics = dict(metrics or {})


class SkipMonitor:
    """Host-side divergence watchdog for the trainer loops.

    ``update(metrics)`` after every train step; a step whose skipped
    update count reaches its total update count (``nonfinite_skips`` >=
    ``guard_updates``) advances the consecutive counter, any usable
    step resets it, and ``max_consecutive`` fully-skipped steps in a
    row raise :class:`NonFiniteDivergenceError` with a diagnostic —
    params are provably stale at that point, so continuing only burns
    the allocation.
    """

    def __init__(self, max_consecutive: int = 10):
        if int(max_consecutive) < 1:
            raise ValueError(
                f"max_consecutive must be >= 1, got {max_consecutive}"
            )
        self.max_consecutive = int(max_consecutive)
        self.consecutive = 0
        self.total_skips = 0
        self.total_poisoned_env_resets = 0

    def update(self, metrics: Dict[str, Any], *, step: Optional[int] = None) -> None:
        skips = int(metrics.get("nonfinite_skips", 0))
        total = int(metrics.get("guard_updates", 0))
        self.total_skips += skips
        self.total_poisoned_env_resets += int(
            metrics.get("poisoned_env_resets", 0)
        )
        if total > 0 and skips >= total:
            self.consecutive += 1
        else:
            self.consecutive = 0
        if self.consecutive >= self.max_consecutive:
            at = f" at iteration {step}" if step is not None else ""
            raise NonFiniteDivergenceError(
                f"training diverged{at}: all {total} updates were "
                f"non-finite for {self.consecutive} consecutive steps "
                f"({self.total_skips} updates skipped in total, "
                f"{self.total_poisoned_env_resets} envs quarantine-reset); "
                "params/opt-state are the last finite values — inspect "
                "the data feed for NaN/inf contamination or lower the "
                "learning rate, then resume from the latest checkpoint",
                metrics={k: _to_float(v) for k, v in metrics.items()},
            )


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
