"""Host-side per-superstep resilience hooks of the PPO loop: the port of
``gymfx_tpu/resilience/loop.py``'s ``ResilientLoop`` (:37-262) for one
device.

  * the SkipMonitor divergence watchdog, run ONE DISPATCH LATE: the guard
    counters of superstep ``s`` are read on the host only after superstep
    ``s + 1`` has been issued, so the card's queue never drains for the
    watchdog.  The counters it holds are new tensors, never a graph's
    static outputs (``PPOTrainer`` stacks a superstep's metrics on the
    device), so the next replay does not overwrite them;
  * periodic checkpointing every ``checkpoint_every`` iterations, with the
    cumulative step count (``step_offset`` + env steps) so a resumed run
    keeps advancing past the loaded step;
  * on sustained divergence, a diagnostic checkpoint of the last finite
    params, then :class:`NonFiniteDivergenceError`.

The JAX loop's run ledger, flight recorder, profiler capture, delayed
loggers, preemption drill and mesh faults come with ROADMAP Queue 1 items
10 and 17; ``PPOTrainer.train`` raises when one is asked for.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from gymfx_tpu_torch.resilience.guards import NonFiniteDivergenceError, SkipMonitor

GUARD_METRIC_KEYS = ("nonfinite_skips", "guard_updates", "poisoned_env_resets")

# state_fn: () -> (full state to checkpoint, params)
StateFn = Callable[[], Tuple[Any, Any]]


class ResilientLoop:
    """Call :meth:`after_superstep` once per dispatch and :meth:`finish`
    after the loop; raises :class:`NonFiniteDivergenceError` on sustained
    divergence (after saving a diagnostic checkpoint when a checkpoint dir
    is configured)."""

    def __init__(
        self,
        *,
        steps_per_iter: int,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        step_offset: int = 0,
        checkpoint_metadata: Optional[Dict[str, Any]] = None,
        max_consecutive_skips: int = 10,
        checkpoint_keep: int = 0,
    ):
        self.steps_per_iter = int(steps_per_iter)
        self.checkpoint_dir = str(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_every = int(checkpoint_every or 0)
        self.step_offset = int(step_offset or 0)
        self.checkpoint_metadata = checkpoint_metadata
        self.monitor = (
            SkipMonitor(max_consecutive_skips)
            if int(max_consecutive_skips or 0) > 0
            else None
        )
        # newest-N checkpoint retention (0 = keep everything); the
        # resume-entry step is always protected
        self.checkpoint_keep = int(checkpoint_keep or 0)
        self.last_checkpoint_step: Optional[int] = None
        # (it_start, k, guard metrics stacked on a leading (k,) axis)
        self._pending: Optional[Tuple[int, int, Dict[str, Any]]] = None

    def _save(self, state_fn: StateFn, step: int) -> None:
        from gymfx_tpu_torch.train.checkpoint import save_checkpoint

        state, params = state_fn()
        save_checkpoint(
            self.checkpoint_dir, state, step=step,
            metadata=self.checkpoint_metadata, params=params,
            keep=self.checkpoint_keep, protect=(self.step_offset,),
        )
        self.last_checkpoint_step = step

    def _check_pending(self, state_fn: StateFn) -> None:
        if self.monitor is None or self._pending is None:
            return
        it_start, k, guard_metrics = self._pending
        self._pending = None
        # one host read a superstep: each counter a (k,) tensor
        keys = list(guard_metrics)
        rows = torch.stack([guard_metrics[key].reshape(-1) for key in keys]).tolist()
        try:
            for j in range(k):
                self.monitor.update({key: row[j] for key, row in zip(keys, rows)},
                                    step=it_start + j)
        except NonFiniteDivergenceError:
            # params are still the last finite values (the in-graph guard
            # kept them): persist them for the post-mortem or a resume
            if self.checkpoint_dir:
                self._save(state_fn, self.step_offset + (it_start + k) * self.steps_per_iter)
            raise

    def after_superstep(self, it_start: int, k: int, metrics: Dict[str, Any],
                        state_fn: StateFn) -> None:
        """Call once after dispatching iterations ``[it_start, it_start +
        k)``; ``metrics`` holds the guard counters stacked on a leading
        ``(k,)`` axis.  Checkpoints land on the first superstep boundary
        at or after each ``checkpoint_every`` multiple."""
        it_end = it_start + k
        if self.monitor is not None:
            self._check_pending(state_fn)
            self._pending = (it_start, k, {key: metrics[key] for key in GUARD_METRIC_KEYS
                                           if key in metrics})
        if (
            self.checkpoint_dir
            and self.checkpoint_every > 0
            and it_end // self.checkpoint_every > it_start // self.checkpoint_every
        ):
            self._save(state_fn, self.step_offset + it_end * self.steps_per_iter)

    def finish(self, state_fn: StateFn) -> None:
        """Flush the one-dispatch-late watchdog after the loop ends."""
        self._check_pending(state_fn)
