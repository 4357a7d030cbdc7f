"""On-device metric streams, drained host-side one dispatch late: the
port of ``gymfx_tpu/telemetry/device_stream.py``.

The trainers already stack every per-iteration metric, guard counters
included, on a leading ``(k,)`` axis on the device (``train_many``);
those stacks are new tensors, never a CUDA graph's static outputs, so a
later replay does not overwrite them.  :class:`DeviceMetricStream` is
the host half: it holds each dispatch's metrics and only reads them
after the next dispatch has been issued, so telemetry never drains the
card's queue.  One drain per dispatch feeds

  * the ``log_every`` console line (:class:`DelayedLogger`, the JAX
    package's line character for character);
  * a :class:`~gymfx_tpu_torch.telemetry.registry.MetricsRegistry`:
    guard counters summed over the superstep into
    ``gymfx_train_*_total`` counters, every other scalar as a newest-
    value ``gymfx_train_metric`` gauge, plus iteration/env-step progress
    counters and the allocator's watermarks
    (``gymfx_device_memory_bytes{stat=...}``, telemetry/mfu.py, a host-
    side query);
  * an optional JSONL sink row per drained dispatch;
  * an optional :class:`~gymfx_tpu_torch.telemetry.flight_recorder.
    FlightRecorder` frame.

The late read (:class:`HostCopy`).  The JAX drain is one
``jax.device_get`` of superstep *s*'s stack after *s + 1* is issued,
which waits for *s*'s buffers only.  On one CUDA stream a plain read of
*s* (``.tolist()``, ``.cpu()``) waits for everything enqueued before it,
*s + 1* included.  So the copy of *s*'s metrics into pinned host memory
is enqueued right after *s* is dispatched, before *s + 1*, with a CUDA
event recorded behind it, and the drain waits on that event alone.

With no registry, sink or recorder and ``log_every=0`` the stream holds
nothing and the training loop is exactly the one without telemetry.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

# per-iteration guard counters: summed over the superstep axis when
# drained (everything else is reported as a newest-value gauge)
COUNTER_KEYS = ("nonfinite_skips", "guard_updates", "poisoned_env_resets")


class HostCopy:
    """A dict of metrics copied to the host behind the work that made
    them.  On a CUDA device the constructor enqueues, on the current
    stream, one copy per dtype into pinned host memory
    (``copy_(non_blocking=True)`` of the dtype's leaves concatenated) and
    records an event behind the copies; :meth:`get` waits on that event
    alone.  CPU tensors and plain numbers are read as they are."""

    def __init__(self, metrics: Dict[str, Any]):
        self._keys = sorted(metrics)
        self._values = {key: metrics[key] for key in self._keys}
        self._event = None
        self._groups = []
        cuda = [key for key in self._keys
                if isinstance(self._values[key], torch.Tensor) and self._values[key].is_cuda]
        if not cuda:
            return
        by_dtype = defaultdict(list)
        for key in cuda:
            by_dtype[self._values[key].dtype].append(key)
        for dtype, keys in by_dtype.items():
            leaves = [self._values[key].detach().reshape(-1) for key in keys]
            flat = leaves[0] if len(leaves) == 1 else torch.cat(leaves)
            host = torch.empty(flat.shape, dtype=dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            self._groups.append((keys, [x.numel() for x in leaves], host))
        self._event = torch.cuda.Event()
        self._event.record()

    def get(self) -> Dict[str, np.ndarray]:
        """Every metric as a flat numpy array, keys sorted (the JAX
        package's ``device_get`` of a dict sorts them too)."""
        if self._event is not None:
            self._event.synchronize()
        out = {}
        for keys, sizes, host in self._groups:
            for key, part in zip(keys, np.split(host.numpy(), np.cumsum(sizes)[:-1])):
                out[key] = part
        for key in self._keys:
            if key not in out:
                value = self._values[key]
                if isinstance(value, torch.Tensor):
                    value = value.detach().numpy()
                out[key] = np.ravel(np.asarray(value))
        return {key: out[key] for key in self._keys}


class DeviceMetricStream:
    def __init__(
        self,
        tag: str,
        *,
        iters: int,
        log_every: int = 0,
        registry: Any = None,
        sink: Any = None,
        steps_per_iter: Optional[int] = None,
        printer: Callable[[str], None] = print,
        recorder: Any = None,
    ):
        self.tag = str(tag)
        self.every = int(log_every or 0)
        self.iters = int(iters)
        self.registry = registry
        self.sink = sink
        self.recorder = recorder
        self.steps_per_iter = (
            None if steps_per_iter is None else int(steps_per_iter)
        )
        self._printer = printer
        # (it_end, k, the dispatch's HostCopy, want_print)
        self._held: Optional[Tuple[int, int, HostCopy, bool]] = None
        self._counters = self._gauge = self._iters_ctr = self._steps_ctr = None
        self._mem_gauge = None
        if registry is not None:
            self._mem_gauge = registry.gauge(
                "gymfx_device_memory_bytes",
                "Device allocator watermark sampled per drained "
                "superstep (memory_stats)",
                labels=("algo", "stat"),
            )
            self._counters = {
                key: registry.counter(
                    f"gymfx_train_{key}_total",
                    f"Cumulative train-step {key} (summed per superstep)",
                    labels=("algo",),
                )
                for key in COUNTER_KEYS
            }
            self._gauge = registry.gauge(
                "gymfx_train_metric",
                "Newest per-iteration training scalar by metric name",
                labels=("algo", "metric"),
            )
            self._iters_ctr = registry.counter(
                "gymfx_train_iterations_total",
                "Training iterations drained through telemetry",
                labels=("algo",),
            )
            self._steps_ctr = registry.counter(
                "gymfx_train_env_steps_total",
                "Environment steps drained through telemetry",
                labels=("algo",),
            )

    # ------------------------------------------------------------------
    def after_dispatch(self, it_start: int, k: int,
                       metrics: Dict[str, Any]) -> None:
        """Call right after dispatching iterations
        ``[it_start, it_start + k)``; ``metrics`` is the dispatch's
        metrics dict — per-iteration values stacked on a leading ``(k,)``
        axis, or 0-d tensors when ``k == 1``.  Their copy to the host is
        enqueued here, then the previous dispatch is drained."""
        want_print = bool(
            self.every
            and (it_start + k) // self.every > it_start // self.every
        )
        held = None
        if (want_print or self.registry is not None
                or self.sink is not None or self.recorder is not None):
            held = (it_start + k, k, HostCopy(metrics), want_print)
        self._flush()
        self._held = held

    def finish(self) -> None:
        """Flush the last held dispatch after (or when aborting) the
        loop — ResilientLoop calls this on every exit path so the final
        superstep's metrics are never silently dropped."""
        self._flush()

    # ------------------------------------------------------------------
    def _flush(self) -> None:
        if self._held is None:
            return
        it_end, k, copy, want_print = self._held
        self._held = None
        host = copy.get()
        newest = {
            key: float(arr[-1]) for key, arr in host.items() if arr.size
        }
        if want_print:
            self._printer(
                f"[{self.tag}] iter {it_end}/{self.iters} {newest}"
            )
        if self.recorder is not None:
            self.recorder.record_frame(
                it_end, k,
                {key: arr.tolist() for key, arr in host.items()},
            )
        if self.registry is not None:
            for key, ctr in self._counters.items():
                arr = host.get(key)
                if arr is not None and arr.size:
                    ctr.inc(float(arr.sum()), algo=self.tag)
            for key, value in newest.items():
                if key not in COUNTER_KEYS:
                    self._gauge.set(value, algo=self.tag, metric=key)
            self._iters_ctr.inc(float(k), algo=self.tag)
            if self.steps_per_iter is not None:
                self._steps_ctr.inc(
                    float(k * self.steps_per_iter), algo=self.tag
                )
            from gymfx_tpu_torch.telemetry.mfu import device_memory_watermarks

            watermarks = device_memory_watermarks()
            if watermarks:
                for stat, value in watermarks.items():
                    self._mem_gauge.set(
                        float(value), algo=self.tag, stat=stat
                    )
        if self.sink is not None:
            self.sink.append({
                "kind": "train_metrics",
                "algo": self.tag,
                "iter": it_end,
                "iters": self.iters,
                **newest,
            })


class DelayedLogger(DeviceMetricStream):
    """One-dispatch-delayed ``log_every`` console logging: the stream
    with telemetry off.  The snapshot for iteration ``i`` is copied to
    the host behind its dispatch and printed only after the next
    dispatch is in flight."""

    def __init__(self, tag: str, log_every: int, iters: int):
        super().__init__(tag, iters=iters, log_every=log_every)
