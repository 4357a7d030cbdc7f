"""Host-side metrics registry: counters, gauges, fixed-bucket
histograms with label support.

The port of ``gymfx_tpu/telemetry/registry.py`` (its mesh binding,
``register_mesh_health``, comes with the mesh, ROADMAP.md Queue 1 item
17).  The one shared metric surface for train, serve and resilience
telemetry.  Everything here is plain Python, no torch import, no device
traffic: the trainers stack their metrics on the device
(telemetry/device_stream.py) and only the already-fetched host values
land here.

Thread-safety: instrument updates take a per-family lock (the serving
path increments from the batcher worker, client threads and the HTTP
scrape thread concurrently); registration takes the registry lock.
Registration is idempotent — asking for an existing name with the same
kind/labels returns the existing instrument, a mismatch raises loudly
(two subsystems silently sharing one name with different shapes is a
dashboard corruption bug).

Gauges support callbacks (:meth:`Gauge.set_function`) so externally
owned state — queue depths, breaker states, retry-budget spend — is
read at scrape time instead of mirrored on every mutation.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# histogram default: request-latency shaped, in seconds (Prometheus
# convention); callers with different dynamics pass their own edges
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)

_VALID_KINDS = ("counter", "gauge", "histogram")


def _label_key(label_names: Tuple[str, ...], labels: Dict[str, str]) -> Tuple[str, ...]:
    if tuple(sorted(labels)) != tuple(sorted(label_names)):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared label names "
            f"{sorted(label_names)}"
        )
    return tuple(str(labels[name]) for name in label_names)


class _Family:
    """Base of the three instrument kinds: name, help text, declared
    label names and the per-label-set value store."""

    kind = "abstract"

    def __init__(self, name: str, help: str, label_names: Sequence[str]):
        self.name = str(name)
        self.help = str(help)
        self.label_names = tuple(str(n) for n in label_names)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        return _label_key(self.label_names, labels)

    def samples(self) -> List[Tuple[Tuple[str, ...], Any]]:
        """Point-in-time [(label_values, value)] sorted by label values
        (deterministic exposition order)."""
        with self._lock:
            items = list(self._values.items())
        return sorted(items, key=lambda kv: kv[0])


class Counter(_Family):
    """Monotonically increasing total.  ``inc`` only accepts
    non-negative amounts — a decreasing counter is always a bug."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))


class Gauge(_Family):
    """Point-in-time value; ``set_function`` registers a zero-arg
    callback evaluated at scrape time (for externally owned state)."""

    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            cur = self._values.get(key, 0.0)
            if callable(cur):
                raise ValueError(
                    f"gauge {self.name}{dict(labels)} is callback-backed"
                )
            self._values[key] = float(cur) + float(amount)

    def set_function(self, fn: Callable[[], float], **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = fn

    def value(self, **labels: str) -> float:
        with self._lock:
            raw = self._values.get(self._key(labels), 0.0)
        return float(raw() if callable(raw) else raw)

    def samples(self) -> List[Tuple[Tuple[str, ...], Any]]:
        out = []
        for key, raw in super().samples():
            if callable(raw):
                try:
                    raw = float(raw())
                except Exception:
                    continue  # a dead callback must not kill the scrape
            out.append((key, raw))
        return out


class _HistogramState:
    __slots__ = ("bucket_counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * n_buckets  # cumulative at exposition
        self.sum = 0.0
        self.count = 0


class Histogram(_Family):
    """Fixed-bucket histogram: ``observe(v)`` lands in the FIRST bucket
    whose upper edge is ``>= v`` (Prometheus ``le`` semantics); values
    above the last edge count only toward the implicit +Inf bucket."""

    kind = "histogram"

    def __init__(self, name: str, help: str, label_names: Sequence[str],
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        edges = tuple(float(b) for b in buckets)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(
                f"histogram {name} buckets must be non-empty and strictly "
                f"increasing, got {buckets!r}"
            )
        self.buckets = edges

    def observe(self, value: float, **labels: str) -> None:
        value = float(value)
        key = self._key(labels)
        with self._lock:
            state = self._values.get(key)
            if state is None:
                state = self._values[key] = _HistogramState(len(self.buckets))
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    state.bucket_counts[i] += 1
                    break
            state.sum += value
            state.count += 1

    def snapshot(self, **labels: str) -> Dict[str, Any]:
        """{"buckets": {le: cumulative_count}, "sum": s, "count": n}."""
        with self._lock:
            state = self._values.get(self._key(labels))
            if state is None:
                return {
                    "buckets": {e: 0 for e in self.buckets}, "sum": 0.0,
                    "count": 0,
                }
            cum, out = 0, {}
            for edge, c in zip(self.buckets, state.bucket_counts):
                cum += c
                out[edge] = cum
            return {"buckets": out, "sum": state.sum, "count": state.count}


class MetricsRegistry:
    """Get-or-create factory and collection point for metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # ------------------------------------------------------------------
    def _get_or_create(self, cls, name: str, help: str,
                       labels: Sequence[str], **kw) -> Any:
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.label_names}, "
                        f"requested {cls.kind} with labels {tuple(labels)}"
                    )
                return existing
            family = cls(name, help, labels, **kw)
            self._families[name] = family
            return family

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labels, buckets=buckets
        )

    # ------------------------------------------------------------------
    def families(self) -> List[_Family]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready {name: {kind, help, samples}} — the JSONL sink row
        shape and the /healthz metric mirror."""
        out: Dict[str, Any] = {}
        for fam in self.families():
            samples = []
            if fam.kind == "histogram":
                for key, state in fam.samples():
                    cum, buckets = 0, {}
                    for edge, c in zip(fam.buckets, state.bucket_counts):
                        cum += c
                        buckets[str(edge)] = cum
                    samples.append({
                        "labels": dict(zip(fam.label_names, key)),
                        "buckets": buckets,
                        "sum": state.sum,
                        "count": state.count,
                    })
            else:
                for key, value in fam.samples():
                    samples.append({
                        "labels": dict(zip(fam.label_names, key)),
                        "value": value,
                    })
            out[fam.name] = {
                "kind": fam.kind, "help": fam.help, "samples": samples,
            }
        return out


# ---------------------------------------------------------------------------
_BREAKER_STATE_CODE = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


def register_resilience(
    registry: MetricsRegistry,
    *,
    monitor: Any = None,
    budget: Any = None,
    breaker: Any = None,
    name: str = "default",
) -> None:
    """Bind the existing resilience counter sets — SkipMonitor guard
    trips, RetryBudget spend, CircuitBreaker state — into ``registry``
    as callback gauges, so ``/healthz``, ``/metrics`` and
    ``MicroBatcher.health()`` read the SAME live objects instead of
    three privately mirrored counter sets.

    ``name`` labels the binding (several breakers/budgets can coexist:
    the live transport's and the serving dispatch's)."""
    if monitor is not None:
        g = registry.gauge(
            "gymfx_resilience_skip_monitor_consecutive",
            "Consecutive fully-skipped train steps (SkipMonitor)",
            labels=("name",),
        )
        g.set_function(lambda m=monitor: float(m.consecutive), name=name)
        g2 = registry.gauge(
            "gymfx_resilience_skip_monitor_skips_total",
            "Total non-finite updates skipped (SkipMonitor)",
            labels=("name",),
        )
        g2.set_function(lambda m=monitor: float(m.total_skips), name=name)
        g3 = registry.gauge(
            "gymfx_resilience_quarantine_resets_total",
            "Total poisoned-env quarantine resets (SkipMonitor)",
            labels=("name",),
        )
        g3.set_function(
            lambda m=monitor: float(m.total_poisoned_env_resets), name=name
        )
    if budget is not None:
        g = registry.gauge(
            "gymfx_resilience_retry_budget_used",
            "Retry tokens spent out of the run-level budget",
            labels=("name",),
        )
        g.set_function(lambda b=budget: float(b.used), name=name)
        g2 = registry.gauge(
            "gymfx_resilience_retry_budget_remaining",
            "Retry tokens remaining in the run-level budget",
            labels=("name",),
        )
        g2.set_function(lambda b=budget: float(b.remaining), name=name)
    if breaker is not None:
        g = registry.gauge(
            "gymfx_resilience_breaker_state",
            "Circuit breaker state (0=closed, 1=half_open, 2=open)",
            labels=("name",),
        )
        g.set_function(
            lambda b=breaker: _BREAKER_STATE_CODE.get(b.state, -1.0),
            name=name,
        )
        g2 = registry.gauge(
            "gymfx_resilience_breaker_trips_total",
            "Closed->open circuit breaker transitions",
            labels=("name",),
        )
        g2.set_function(lambda b=breaker: float(b.trip_count), name=name)
        g3 = registry.gauge(
            "gymfx_resilience_breaker_failures",
            "Consecutive recorded failures inside the breaker",
            labels=("name",),
        )
        g3.set_function(lambda b=breaker: float(b.failures), name=name)


def resilience_snapshot(registry: MetricsRegistry) -> Dict[str, Any]:
    """The ``gymfx_resilience_*`` slice of the registry as plain floats,
    merged into ``/healthz`` and ``MicroBatcher.health()`` consumers so
    every surface reports the one registry-backed view."""
    out: Dict[str, Any] = {}
    for fam in registry.families():
        if not fam.name.startswith("gymfx_resilience_"):
            continue
        for key, value in fam.samples():
            short = fam.name[len("gymfx_resilience_"):]
            suffix = "" if key in ((), ("default",)) else "_" + "_".join(key)
            out[short + suffix] = value
    return out
