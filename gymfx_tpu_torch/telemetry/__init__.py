"""Unified telemetry: one registry, one sink, one tracer per run.

The port of ``gymfx_tpu/telemetry/`` (ROADMAP.md Queue 1 item 10): the
registry, sink, Prometheus exposition, SLO window, spans, analytic MFU,
run ledger, flight recorder, the one-dispatch-late device metric stream,
the ``/metrics`` + ``/healthz`` endpoint and the serving instruments; and
the performance observatory (item 30): the managed ``torch.profiler``
capture (profiler.py), its trace parser (trace_parse.py), the profile
report (attribution.py) and the compile watch (compile_watch.py).

The :class:`Telemetry` bundle is the object the trainers and the serving
stack thread around; :func:`telemetry_from_config` is the single
construction path off the merged config dict and returns ``None`` when
every ``telemetry_*`` key is unset — callers then take the exact code
path they had without telemetry (tests/test_torch_telemetry.py pins the
final train state ``torch.equal`` to it).

Config keys (config/defaults.py, all default off):

  ``telemetry_enabled``       master switch (registry + instruments)
  ``telemetry_jsonl``         rotating JSONL sink path
  ``telemetry_spans``         host span records (+ torch.profiler
                              record_function regions while profiling)
  ``telemetry_http_port``     /metrics + /healthz endpoint on loopback;
                              0 binds an ephemeral port
  ``telemetry_slo_window_s``  rolling SLO window length (serving)
  ``telemetry_ledger``              append-only JSONL run-ledger path
  ``telemetry_flight_recorder_dir`` postmortem bundle directory
  ``telemetry_flight_recorder_k``   frames the ring buffer retains
  ``telemetry_compile_watch``       graph captures and kernel builds as
                                    metrics, recompiles detected
  ``telemetry_profile_dir``         managed profiler capture bundles
  ``telemetry_profile_supersteps``  which supersteps to capture ("1")
  ``telemetry_profile_every``       and every Nth superstep (0 = off)
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from gymfx_tpu_torch.telemetry.compile_watch import CompileWatch  # noqa: F401
from gymfx_tpu_torch.telemetry.device_stream import (  # noqa: F401
    DelayedLogger,
    DeviceMetricStream,
    HostCopy,
)
from gymfx_tpu_torch.telemetry.flight_recorder import (  # noqa: F401
    FlightRecorder,
    validate_postmortem,
)
from gymfx_tpu_torch.telemetry.profiler import ProfilerSession  # noqa: F401
from gymfx_tpu_torch.telemetry.ledger import (  # noqa: F401
    RunLedger,
    config_digest,
    get_active_ledger,
    set_active_ledger,
    validate_ledger,
)
from gymfx_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    register_resilience,
    resilience_snapshot,
)
from gymfx_tpu_torch.telemetry.sink import JsonlSink  # noqa: F401
from gymfx_tpu_torch.telemetry.slo import SLOWindow  # noqa: F401
from gymfx_tpu_torch.telemetry.spans import Tracer, null_tracer  # noqa: F401

__all__ = [
    "CompileWatch",
    "Counter",
    "DelayedLogger",
    "DeviceMetricStream",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "HostCopy",
    "JsonlSink",
    "MetricsRegistry",
    "ProfilerSession",
    "RunLedger",
    "SLOWindow",
    "Telemetry",
    "Tracer",
    "config_digest",
    "get_active_ledger",
    "null_tracer",
    "register_resilience",
    "resilience_snapshot",
    "set_active_ledger",
    "telemetry_from_config",
    "validate_ledger",
    "validate_postmortem",
]

class Telemetry:
    """Registry + sink + tracer + serving knobs for one run."""

    def __init__(
        self,
        *,
        registry: Optional[MetricsRegistry] = None,
        sink: Optional[JsonlSink] = None,
        tracer: Optional[Tracer] = None,
        slo_window_s: float = 60.0,
        http_port: Optional[int] = None,
        ledger: Optional[RunLedger] = None,
        recorder: Optional[FlightRecorder] = None,
        compile_watch: Optional[CompileWatch] = None,
        profiler: Optional[ProfilerSession] = None,
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.sink = sink
        self.tracer = tracer if tracer is not None else null_tracer()
        self.slo_window_s = float(slo_window_s)
        self.http_port = None if http_port is None else int(http_port)
        self.ledger = ledger
        self.recorder = recorder
        self.compile_watch = compile_watch
        self.profiler = profiler
        self._server = None

    # -- construction helpers the layers share -------------------------
    def span(self, name: str, **attrs: Any):
        return self.tracer.span(name, **attrs)

    def device_stream(self, tag: str, *, iters: int, log_every: int = 0,
                      steps_per_iter: Optional[int] = None) -> DeviceMetricStream:
        return DeviceMetricStream(
            tag, iters=iters, log_every=log_every, registry=self.registry,
            sink=self.sink, steps_per_iter=steps_per_iter,
            recorder=self.recorder,
        )

    def serve_instruments(self, name: str = "serve"):
        from gymfx_tpu_torch.telemetry.instruments import ServeInstruments

        return ServeInstruments(
            self.registry, slo=SLOWindow(self.slo_window_s), name=name
        )

    def start_http(self, health_fn=None):
        """Start the /metrics + /healthz endpoint when
        ``telemetry_http_port`` was configured (idempotent); returns the
        server or None."""
        if self.http_port is None:
            return None
        if self._server is None:
            from gymfx_tpu_torch.telemetry.http import TelemetryServer

            self._server = TelemetryServer(
                self.registry, health_fn=health_fn, port=self.http_port
            )
        return self._server

    @property
    def server(self):
        return self._server

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None
        if self.profiler is not None:
            self.profiler.close()  # a capture an aborted loop left open
        if self.compile_watch is not None:
            self.compile_watch.uninstall()
        if self.ledger is not None:
            if get_active_ledger() is self.ledger:
                set_active_ledger(None)
            self.ledger.close()
        if self.sink is not None:
            self.sink.close()


def telemetry_from_config(config: Dict[str, Any]) -> Optional[Telemetry]:
    """``None`` unless some ``telemetry_*`` key is set — the contract
    callers rely on to keep the off path untouched.  The cadence keys
    alone build nothing: ``telemetry_profile_dir`` is the profiler's
    master switch."""
    enabled = bool(config.get("telemetry_enabled"))
    jsonl = config.get("telemetry_jsonl") or None
    spans = bool(config.get("telemetry_spans"))
    port = config.get("telemetry_http_port")
    port = None if port in (None, "") or int(port) < 0 else int(port)
    ledger_path = config.get("telemetry_ledger") or None
    recorder_dir = config.get("telemetry_flight_recorder_dir") or None
    watch = bool(config.get("telemetry_compile_watch"))
    profile_dir = config.get("telemetry_profile_dir") or None
    if not (enabled or jsonl or spans or port is not None
            or ledger_path or recorder_dir or watch or profile_dir):
        return None
    registry = MetricsRegistry()
    sink = JsonlSink(str(jsonl)) if jsonl else None
    tracer = Tracer(enabled=spans, registry=registry if spans else None,
                    sink=sink if spans else None)
    sha = config_digest(config)
    ledger = None
    if ledger_path:
        ledger = RunLedger(str(ledger_path), config_sha256=sha)
        set_active_ledger(ledger)
    recorder = None
    if recorder_dir:
        recorder = FlightRecorder(
            str(recorder_dir),
            k=int(config.get("telemetry_flight_recorder_k", 8) or 8),
            config_sha256=sha,
            ledger=ledger,
        )
        recorder.set_resilience_source(
            lambda: resilience_snapshot(registry)
        )
    compile_watch = None
    if watch:
        compile_watch = CompileWatch(registry, ledger=ledger, recorder=recorder).install()
    profiler = None
    if profile_dir:
        profiler = ProfilerSession(
            str(profile_dir),
            supersteps=config.get("telemetry_profile_supersteps"),
            every=int(config.get("telemetry_profile_every", 0) or 0),
            config_sha256=sha,
            registry=registry,
            ledger=ledger,
            compile_watch=compile_watch,
        )
    return Telemetry(
        registry=registry,
        sink=sink,
        tracer=tracer,
        slo_window_s=float(config.get("telemetry_slo_window_s", 60.0) or 60.0),
        http_port=port,
        ledger=ledger,
        recorder=recorder,
        compile_watch=compile_watch,
        profiler=profiler,
    )
