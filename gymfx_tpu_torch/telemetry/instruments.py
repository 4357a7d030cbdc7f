"""Serving-path instruments: the registry-backed view of a
MicroBatcher and the decision service (the port of
``gymfx_tpu/telemetry/instruments.py``).

``ServeInstruments`` owns every serve-side metric family so the batcher
stays free of metric-name string literals; the batcher calls the
``on_*`` hooks from its existing counter sites (all no-cost when no
instruments object is injected — the off path keeps the plain-int
counters it always had).  Queue pressure is NOT mirrored per mutation:
:meth:`bind_batcher` registers callback gauges that read the live
batcher at scrape time.
"""
from __future__ import annotations

from typing import Any, Optional

# batch sizes are powers-of-two-ish bucket ladders; request stage
# latencies reuse the default request-shaped edges
BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


class ServeInstruments:
    def __init__(self, registry: Any, *, slo: Any = None,
                 name: str = "serve", replica: Optional[str] = None):
        self.registry = registry
        self.slo = slo
        self.name = str(name)
        # the replica label is OPT-IN: with replica=None every family
        # keeps its original ("batcher", ...) label names and exposition
        # is byte-for-byte the single-engine serving path (a registry
        # rejects re-declaring a family with different label names, so
        # fleet and non-fleet instruments must not share a registry)
        self.replica = None if replica is None else str(replica)
        extra = () if self.replica is None else ("replica",)
        self._base = {"batcher": self.name}
        if self.replica is not None:
            self._base["replica"] = self.replica
        self.requests = registry.counter(
            "gymfx_serve_requests_total",
            "Requests resolved by terminal outcome",
            labels=("batcher", "outcome") + extra,
        )
        self.shed = registry.counter(
            "gymfx_serve_shed_total",
            "Requests shed by admission control, by shed reason",
            labels=("batcher", "reason") + extra,
        )
        self.deadline = registry.counter(
            "gymfx_serve_deadline_miss_total",
            "Requests failed past their deadline, by detection phase",
            labels=("batcher", "phase") + extra,
        )
        self.breaker_open = registry.counter(
            "gymfx_serve_breaker_open_total",
            "Requests failed fast by an open dispatch circuit breaker",
            labels=("batcher",) + extra,
        )
        self.failures = registry.counter(
            "gymfx_serve_dispatch_failures_total",
            "Engine dispatches that raised (whole batch failed)",
            labels=("batcher",) + extra,
        )
        self.dispatches = registry.counter(
            "gymfx_serve_dispatches_total",
            "Engine dispatches completed",
            labels=("batcher",) + extra,
        )
        self.batch_size = registry.histogram(
            "gymfx_serve_batch_size",
            "Real requests coalesced per engine dispatch",
            labels=("batcher",) + extra,
            buckets=BATCH_SIZE_BUCKETS,
        )
        self.h_queue = registry.histogram(
            "gymfx_serve_enqueue_to_pickup_seconds",
            "submit() to worker pickup (queue wait)",
            labels=("batcher",) + extra,
        )
        self.h_window = registry.histogram(
            "gymfx_serve_pickup_to_dispatch_seconds",
            "worker pickup to engine dispatch (batching window)",
            labels=("batcher",) + extra,
        )
        self.h_dispatch = registry.histogram(
            "gymfx_serve_dispatch_seconds",
            "engine dispatch to response resolution",
            labels=("batcher",) + extra,
        )
        self.h_latency = registry.histogram(
            "gymfx_serve_latency_seconds",
            "submit() to response resolution (end-to-end)",
            labels=("batcher",) + extra,
        )

    # -- batcher hook points (called from MicroBatcher when injected) --
    def on_shed(self, reason: str, n: int = 1) -> None:
        self.shed.inc(n, reason=reason, **self._base)
        self.requests.inc(n, outcome="shed", **self._base)
        if self.slo is not None:
            for _ in range(n):
                self.slo.observe("shed")

    def on_deadline_miss(self, phase: str, n: int = 1) -> None:
        self.deadline.inc(n, phase=phase, **self._base)
        self.requests.inc(n, outcome="deadline_miss", **self._base)
        if self.slo is not None:
            for _ in range(n):
                self.slo.observe("deadline_miss")

    def on_breaker_open(self, n: int = 1) -> None:
        self.breaker_open.inc(n, **self._base)
        self.requests.inc(n, outcome="breaker_open", **self._base)
        if self.slo is not None:
            for _ in range(n):
                self.slo.observe("breaker_open")

    def on_dispatch_failure(self, n: int = 1) -> None:
        self.failures.inc(1, **self._base)
        self.requests.inc(n, outcome="failed", **self._base)
        if self.slo is not None:
            for _ in range(n):
                self.slo.observe("failed")

    def on_batch_complete(self, records) -> None:
        """``records`` — the dispatch's RequestRecord rows (one per
        served request, shared pickup/dispatch/done stamps)."""
        rows = list(records)
        if not rows:
            return
        self.dispatches.inc(1, **self._base)
        self.batch_size.observe(float(len(rows)), **self._base)
        for r in rows:
            self.requests.inc(1, outcome="served", **self._base)
            self.h_queue.observe(
                max(0.0, r.t_pickup - r.t_enqueue), **self._base
            )
            self.h_window.observe(
                max(0.0, r.t_dispatch - r.t_pickup), **self._base
            )
            self.h_dispatch.observe(
                max(0.0, r.t_done - r.t_dispatch), **self._base
            )
            self.h_latency.observe(r.latency_s, **self._base)
            if self.slo is not None:
                self.slo.observe("served", latency_s=r.latency_s)

    # ------------------------------------------------------------------
    def bind_batcher(self, batcher: Any) -> None:
        """Register scrape-time callback gauges over the live batcher
        (queue depth, in-flight count, breaker state) and the rolling
        SLO gauges when an SLO window is attached."""
        extra = () if self.replica is None else ("replica",)
        depth = self.registry.gauge(
            "gymfx_serve_queue_depth",
            "Requests currently queued (read at scrape time)",
            labels=("batcher",) + extra,
        )
        # len() on a deque is atomic under the GIL: safe without the
        # batcher lock, and a scrape must never contend with dispatch
        depth.set_function(
            lambda b=batcher: float(len(b._pending)), **self._base
        )
        inflight = self.registry.gauge(
            "gymfx_serve_inflight",
            "Batches currently inside an engine dispatch",
            labels=("batcher",) + extra,
        )
        inflight.set_function(
            lambda b=batcher: float(b._inflight), **self._base
        )
        if batcher.max_queue is not None:
            cap = self.registry.gauge(
                "gymfx_serve_queue_capacity",
                "Configured admission-control queue bound",
                labels=("batcher",) + extra,
            )
            cap.set(float(batcher.max_queue), **self._base)
        engine = getattr(batcher, "engine", None)
        if engine is not None and hasattr(engine, "late_compiles"):
            late = self.registry.gauge(
                "gymfx_serve_late_compiles_total",
                "Engine compiles AFTER boot (a warm serving path scrapes "
                "0 forever; monotonic, read at scrape time)",
                labels=("batcher",) + extra,
            )
            # the port's engine counts a bucket graph captured after boot
            # in its capture hook (serve/engine.py, next to on_compile);
            # read through the batcher at scrape time, so the gauge
            # follows whichever engine the batcher dispatches to
            late.set_function(
                lambda b=batcher: float(
                    getattr(b.engine, "late_compiles", 0)
                ),
                **self._base,
            )
        if engine is not None and getattr(engine, "slot_cache", None) is not None:
            # device-resident sessions (serve/slots.py): scrape-time
            # callbacks through batcher.engine so the gauges follow the
            # active engine across blue/green flips, like late_compiles
            slot_specs = (
                ("gymfx_serve_slot_resident",
                 "Sessions resident in the device slot cache",
                 lambda e: float(len(e.slot_cache))),
                ("gymfx_serve_slot_evictions_total",
                 "LRU slot evictions (evicted sessions restart from the "
                 "initial carry; monotonic, read at scrape time)",
                 lambda e: float(e.slot_cache.evictions)),
                ("gymfx_serve_slot_decisions_total",
                 "Decisions served through the fused slot ladder "
                 "(monotonic, read at scrape time)",
                 lambda e: float(getattr(e, "slot_decisions", 0))),
                ("gymfx_serve_slot_mirror_bytes_total",
                 "Carry bytes fetched for the one-dispatch-late host "
                 "mirror (monotonic, read at scrape time)",
                 lambda e: float(getattr(e, "mirror_fetch_bytes", 0))),
            )
            for gname, help_text, reader in slot_specs:
                gauge = self.registry.gauge(
                    gname, help_text, labels=("batcher",) + extra
                )
                gauge.set_function(
                    lambda b=batcher, r=reader: (
                        r(b.engine)
                        if getattr(b.engine, "slot_cache", None) is not None
                        else 0.0
                    ),
                    **self._base,
                )
        if batcher.breaker is not None:
            from gymfx_tpu_torch.telemetry.registry import register_resilience

            # per-replica breakers need distinct name label values or
            # the callback gauges of N breakers would collide
            breaker_name = (
                self.name if self.replica is None
                else f"{self.name}:{self.replica}"
            )
            register_resilience(
                self.registry, breaker=batcher.breaker, name=breaker_name
            )
        if self.slo is not None:
            self.slo.register_gauges(self.registry)


def instruments_from_telemetry(telemetry: Optional[Any],
                               name: str = "serve") -> Optional[ServeInstruments]:
    """The one construction path serving callers share: ``None`` in,
    ``None`` out (telemetry off keeps the batcher untouched)."""
    if telemetry is None:
        return None
    return telemetry.serve_instruments(name=name)
