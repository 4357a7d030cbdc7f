"""Host-side per-superstep resilience hooks of the trainer loops: the
port of ``gymfx_tpu/resilience/loop.py``'s ``ResilientLoop`` (:37-262)
for one device.

  * the SkipMonitor divergence watchdog, run ONE DISPATCH LATE: the guard
    counters of superstep ``s`` are copied to pinned host memory right
    after ``s`` is dispatched (telemetry/device_stream.HostCopy: a
    non-blocking copy with a CUDA event behind it), and read only after
    superstep ``s + 1`` has been issued, waiting on that event alone, so
    the card's queue never drains for the watchdog.  The counters are new
    tensors, never a graph's static outputs (the trainers stack a
    superstep's metrics on the device), so the next replay does not
    overwrite them;
  * periodic checkpointing every ``checkpoint_every`` iterations, with the
    cumulative step count (``step_offset`` + env steps) so a resumed run
    keeps advancing past the loaded step;
  * on sustained divergence, a diagnostic checkpoint of the last finite
    params, then :class:`NonFiniteDivergenceError`;
  * the simulated preemption (``fault_profile``'s ``preempt_at``): after
    the iteration's checkpoint, :class:`SimulatedPreemptionError`;
  * the delayed metric drains (``loggers``: DelayedLogger /
    DeviceMetricStream) flushed on every exit path, and the run ledger's
    and flight recorder's rows and dumps (``ledger``, ``recorder``);
  * the managed profiler capture (``profiler``,
    telemetry/profiler.ProfilerSession): :meth:`ResilientLoop.
    begin_superstep` opens the window of a due superstep before its
    dispatch, :meth:`ResilientLoop.after_superstep` closes it (one
    synchronize) and writes the capture bundle.

The JAX loop's mesh faults come with ROADMAP.md Queue 1 item 17; the
trainers raise when one is asked for.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from gymfx_tpu_torch.resilience.faults import SimulatedPreemptionError
from gymfx_tpu_torch.resilience.guards import NonFiniteDivergenceError, SkipMonitor
from gymfx_tpu_torch.telemetry.device_stream import COUNTER_KEYS as GUARD_METRIC_KEYS
from gymfx_tpu_torch.telemetry.device_stream import HostCopy

# state_fn: () -> (full state to checkpoint, params)
StateFn = Callable[[], Tuple[Any, Any]]


class ResilientLoop:
    """Call :meth:`after_superstep` once per dispatch and :meth:`finish`
    after the loop; raises :class:`NonFiniteDivergenceError` on sustained
    divergence (after saving a diagnostic checkpoint when a checkpoint dir
    is configured) and :class:`SimulatedPreemptionError` at the injected
    kill point (after the iteration's checkpoint, so the drill resumes
    from it)."""

    def __init__(
        self,
        *,
        steps_per_iter: int,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        step_offset: int = 0,
        checkpoint_metadata: Optional[Dict[str, Any]] = None,
        max_consecutive_skips: int = 10,
        preempt_at: Optional[int] = None,
        loggers: Tuple[Any, ...] = (),
        ledger: Any = None,
        recorder: Any = None,
        profiler: Any = None,
        checkpoint_keep: int = 0,
    ):
        self.steps_per_iter = int(steps_per_iter)
        self.checkpoint_dir = str(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_every = int(checkpoint_every or 0)
        self.step_offset = int(step_offset or 0)
        self.checkpoint_metadata = checkpoint_metadata
        self.preempt_at = None if preempt_at is None else int(preempt_at)
        self.monitor = (
            SkipMonitor(max_consecutive_skips)
            if int(max_consecutive_skips or 0) > 0
            else None
        )
        # delayed metric drains tied to this loop's lifetime: they hold
        # their newest snapshot one dispatch behind, so every abort path
        # below flushes them, or the final superstep's metrics are lost
        self.loggers = tuple(loggers)
        # run-forensics taps (both optional, neither raises): the ledger
        # records lifecycle events, the flight recorder dumps its
        # postmortem bundle on the abort paths
        self.ledger = ledger
        self.recorder = recorder
        # the managed profiler capture: the loop owns the cadence
        self.profiler = profiler
        # newest-N checkpoint retention (0 = keep everything); the
        # resume-entry step is always protected
        self.checkpoint_keep = int(checkpoint_keep or 0)
        self.last_checkpoint_step: Optional[int] = None
        # (it_start, k, the guard counters' HostCopy)
        self._pending: Optional[Tuple[int, int, HostCopy]] = None

    def _flush_loggers(self) -> None:
        for logger in self.loggers:
            try:
                logger.finish()
            except Exception:
                # a telemetry drain failure must not mask the abort (or
                # break a clean finish)
                pass

    def _save(self, state_fn: StateFn, step: int) -> None:
        from gymfx_tpu_torch.train.checkpoint import save_checkpoint

        state, params = state_fn()
        save_checkpoint(
            self.checkpoint_dir, state, step=step,
            metadata=self.checkpoint_metadata, params=params,
            keep=self.checkpoint_keep, protect=(self.step_offset,),
        )
        self.last_checkpoint_step = step
        if self.ledger is not None:
            self.ledger.record("checkpoint_write", step=int(step))

    def _check_pending(self, state_fn: StateFn) -> None:
        if self.monitor is None or self._pending is None:
            return
        it_start, k, copy = self._pending
        self._pending = None
        # one host read a superstep, waiting on its copy's event alone:
        # each counter a (k,) array
        host = copy.get()
        try:
            for j in range(k):
                self.monitor.update({key: arr[j] for key, arr in host.items()},
                                    step=it_start + j)
        except NonFiniteDivergenceError:
            # params are still the last finite values (the in-graph guard
            # kept them): persist them for the post-mortem or a resume
            if self.checkpoint_dir:
                self._save(state_fn, self.step_offset + (it_start + k) * self.steps_per_iter)
            self._flush_loggers()
            if self.ledger is not None:
                self.ledger.record("divergence", it=int(it_start + k))
            if self.recorder is not None:
                self.recorder.dump("divergence", extra={"it": int(it_start + k)})
            raise

    def begin_superstep(self, it_start: int, k: int = 1) -> bool:
        """Open a profiler capture window when the cadence says the
        dispatch of ``[it_start, it_start + k)`` is due; returns whether a
        capture is open.  False at once without a profiler."""
        if self.profiler is None:
            return False
        return self.profiler.start_capture(it_start, k)

    def after_superstep(self, it_start: int, k: int, metrics: Dict[str, Any],
                        state_fn: StateFn) -> None:
        """Call once right after dispatching iterations ``[it_start,
        it_start + k)``; ``metrics`` holds the guard counters stacked on a
        leading ``(k,)`` axis (0-d tensors when ``k == 1``).  Checkpoints
        land on the first superstep boundary at or after each
        ``checkpoint_every`` multiple, and the simulated preemption fires
        on the first boundary reaching ``preempt_at``."""
        it_end = it_start + k
        if self.ledger is not None:
            self.ledger.record("superstep_dispatch", it_start=int(it_start), k=int(k))
        if self.profiler is not None and self.profiler.capturing:
            # close the window begin_superstep opened (never raises),
            # before the watchdog, so that an abort still gets its bundle
            self.profiler.finish_capture()
        if self.monitor is not None:
            # this superstep's copy is enqueued before the previous one is read
            pending = (it_start, k, HostCopy({key: metrics[key] for key in GUARD_METRIC_KEYS
                                              if key in metrics}))
            self._check_pending(state_fn)
            self._pending = pending
        if (
            self.checkpoint_dir
            and self.checkpoint_every > 0
            and it_end // self.checkpoint_every > it_start // self.checkpoint_every
        ):
            self._save(state_fn, self.step_offset + it_end * self.steps_per_iter)
        if self.preempt_at is not None and it_end >= self.preempt_at:
            self._flush_loggers()
            if self.ledger is not None:
                self.ledger.record("preemption", it=int(it_end))
            if self.recorder is not None:
                self.recorder.dump("preemption", extra={"it": int(it_end)})
            raise SimulatedPreemptionError(it_end)

    def finish(self, state_fn: StateFn) -> None:
        """Flush the delayed loggers, then the one-dispatch-late watchdog
        (which may still raise), after the loop ends."""
        self._flush_loggers()
        self._check_pending(state_fn)
