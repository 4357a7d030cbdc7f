"""Lightweight span/trace API for the host-side hot paths: the port of
``gymfx_tpu/telemetry/spans.py``.

``Tracer.span("train/superstep", k=4)`` times a region and

  * when a ``torch.profiler`` session is recording, enters
    ``torch.profiler.record_function`` (the port's
    ``jax.profiler.TraceAnnotation``): the region then shows up on the
    trace's timeline beside the kernels it launched.  A span wraps a
    whole phase or superstep on the host; none runs inside a captured
    CUDA graph's body (a replay is one launch, so the graph's kernels
    fall inside the span that replays it);
  * records a structured host span — name, start, duration, attrs,
    trace/parent ids from a thread-local stack — into a bounded ring,
    an optional :class:`~gymfx_tpu.telemetry.registry.MetricsRegistry`
    histogram (``gymfx_span_seconds{span=...}``) and an optional JSONL
    sink.

A disabled tracer (``Tracer(enabled=False)`` or the module-level
:func:`span` with no tracer configured) returns a shared no-op context
manager: the off path costs one attribute check and allocates nothing.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

# span durations range from sub-ms dispatches to multi-second
# supersteps; widen the default latency edges accordingly
SPAN_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = (
        "tracer", "name", "attrs", "span_id", "parent_id", "trace_id",
        "t0", "_annotation",
    )

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = next(tracer._ids)
        self.parent_id: Optional[int] = None
        self.trace_id: Optional[int] = None
        self.t0 = 0.0
        self._annotation = None

    def __enter__(self):
        stack = self.tracer._stack()
        if stack:
            self.parent_id = stack[-1].span_id
            self.trace_id = stack[-1].trace_id
        else:
            self.trace_id = self.span_id
        stack.append(self)
        if self.tracer._annotation_cls is not None:
            try:
                self._annotation = self.tracer._annotation_cls(self.name)
                self._annotation.__enter__()
            except Exception:
                self._annotation = None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        if self._annotation is not None:
            try:
                self._annotation.__exit__(*exc)
            except Exception:
                pass
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.tracer._record(self, dur, error=exc[0] is not None)
        return False


class Tracer:
    """Span recorder; one per Telemetry bundle (or standalone in tests)."""

    def __init__(
        self,
        *,
        enabled: bool = True,
        registry: Any = None,
        sink: Any = None,
        keep: int = 4096,
        use_profiler_annotation: bool = True,
    ):
        self.enabled = bool(enabled)
        self.registry = registry
        self.sink = sink
        self.records: Deque[Dict[str, Any]] = deque(maxlen=int(keep))
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._hist = None
        if registry is not None:
            self._hist = registry.histogram(
                "gymfx_span_seconds",
                "Host-side span durations by span name",
                labels=("span",),
                buckets=SPAN_BUCKETS,
            )
        self._annotation_cls = _profiler_annotation if use_profiler_annotation else None

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs: Any):
        """Context manager timing one region; no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, str(name), attrs)

    def _record(self, span: _Span, dur_s: float, *, error: bool) -> None:
        row = {
            "kind": "span",
            "span": span.name,
            "dur_ms": dur_s * 1e3,
            "span_id": span.span_id,
            "trace_id": span.trace_id,
            "parent_id": span.parent_id,
        }
        if span.attrs:
            row["attrs"] = span.attrs
        if error:
            row["error"] = True
        self.records.append(row)
        if self._hist is not None:
            self._hist.observe(dur_s, span=span.name)
        if self.sink is not None:
            self.sink.append(row)


def _profiler_annotation(name: str):
    """``torch.profiler.record_function(name)`` while a profiler session
    records, else a no-op context (outside a session the annotation would
    cost an allocation a span and record nothing)."""
    import torch

    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL_SPAN


_DISABLED = Tracer(enabled=False, use_profiler_annotation=False)


def null_tracer() -> Tracer:
    """The shared disabled tracer (for default arguments)."""
    return _DISABLED
