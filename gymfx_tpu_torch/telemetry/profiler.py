"""Managed ``torch.profiler`` capture: superstep-windowed, manifested,
never-raises (the port of ``gymfx_tpu/telemetry/profiler.py``).

:class:`ProfilerSession` starts and stops a ``torch.profiler.profile``
(CPU and, on a card, CUDA activities) around whole supersteps on a
configured cadence and writes a capture bundle:

  ``capture_NNN_itM/``
    ``capture.trace.json.gz``  the Chrome trace ``torch.profiler`` exports
    ``manifest.json``   the config's sha256, the superstep range, the
                        platform / device_kind / comparable triple, the
                        compile watch's fingerprints and the workload
                        (the analytic FLOPs, ``telemetry/mfu.
                        analytic_train_step_flops``, and the
                        ``bench_util.measure_phase_split`` baseline); the
                        JAX package's ``xla_flops_*`` keys are null here
                        (no XLA cost model)
    ``scope_map.json``  op name -> phase, for the ops whose every launch
                        came from one phase range (trace_parse.py)

and ledgers a ``profile_capture`` event.  ``python -m
gymfx_tpu_torch.profile_report report <dir>`` turns a bundle into the
schema-pinned report (attribution.py).

Config keys (config/defaults.py, all off; built by
``telemetry_from_config``):

  ``telemetry_profile_dir``        the bundle directory (the master switch)
  ``telemetry_profile_supersteps`` superstep indices to capture ("1" or
                                   "1,8"); default "1", the first
                                   dispatch after the graphs' capture
  ``telemetry_profile_every``      also every Nth superstep (0 = off)

Cost: a due superstep is profiled (the profiler's own overhead on the
host and CUPTI's on the card) and ends in ONE ``torch.cuda.synchronize``
so that the trace holds the window's device work; then, outside the
window, the workload source measures the phase split (a few replays of
each phase on a clone of the state, bench_util.py).  A superstep that is
not due runs exactly the code of the keys-off path.  Every public method
is never-raises: failures count in ``capture_errors``.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Union

import torch

from gymfx_tpu_torch.telemetry.trace_parse import (
    PHASE_SCOPES,
    parse_trace,
    scope_map_from_summary,
)

MANIFEST_NAME = "manifest.json"
SCOPE_MAP_NAME = "scope_map.json"
TRACE_NAME = "capture.trace.json.gz"
CAPTURE_MANIFEST_VERSION = 1


def _parse_supersteps(raw: Union[None, int, str, Iterable[int]]) -> Optional[tuple]:
    """The ``telemetry_profile_supersteps`` key as a sorted tuple of
    superstep indices (an int, a list, or a comma-separated string)."""
    if raw is None or raw == "" or raw is False or isinstance(raw, bool):
        return None
    if isinstance(raw, int):
        return (int(raw),)
    if isinstance(raw, (list, tuple, set)):
        return tuple(sorted(int(v) for v in raw))
    return tuple(sorted(int(tok) for tok in str(raw).split(",") if tok.strip()))


class _Capture:
    """Context manager returned by :meth:`ProfilerSession.capture`."""

    def __init__(self, session: "ProfilerSession", it_start: int, k: int, label: str):
        self.session = session
        self.it_start, self.k, self.label = int(it_start), int(k), label
        self.bundle: Optional[str] = None

    def __enter__(self) -> "_Capture":
        self.session.start_capture(self.it_start, self.k, label=self.label, force=True)
        return self

    def __exit__(self, *exc: Any) -> None:
        self.bundle = self.session.finish_capture()


class ProfilerSession:
    """Cadence-gated ``torch.profiler`` capture windows with manifested
    bundles; every public method is never-raises."""

    def __init__(self, out_dir: str, *, supersteps: Union[None, int, str, Iterable[int]] = None,
                 every: int = 0, config_sha256: Optional[str] = None, registry: Any = None,
                 ledger: Any = None, compile_watch: Any = None,
                 scopes: Sequence[str] = PHASE_SCOPES):
        self.out_dir = Path(out_dir)
        self.supersteps = _parse_supersteps(supersteps)
        self.every = int(every or 0)
        if self.supersteps is None and self.every <= 0:
            # a dir and no cadence: one capture at superstep 1, the first
            # dispatch whose window holds no graph capture
            self.supersteps = (1,)
        self.config_sha256 = config_sha256
        self.ledger = ledger
        self.compile_watch = compile_watch
        self.scopes = tuple(scopes)
        self._workload_source: Optional[Callable[[int, int], Any]] = None
        self._lock = threading.Lock()
        self._capture_seq = 0
        self._active: Optional[Dict[str, Any]] = None
        self._last_capture_ts: Optional[float] = None
        self.captures = 0
        self.capture_errors = 0
        self._counter = None
        if registry is not None:
            try:
                self._counter = registry.counter("gymfx_profile_captures_total",
                                                 "Completed profiler trace captures")
                registry.gauge(
                    "gymfx_profile_last_capture_age_seconds",
                    "Seconds since the last completed profiler capture (-1 before the first)",
                ).set_function(self._last_capture_age)
            except Exception:
                self._counter = None

    # ------------------------------------------------------------------
    def _last_capture_age(self) -> float:
        ts = self._last_capture_ts
        return -1.0 if ts is None else max(0.0, time.time() - ts)

    def set_workload_source(self, fn: Callable[[int, int], Any]) -> None:
        """Bind ``fn(it_start, k) -> dict``, called when a bundle is written
        (after the window closed); the dict is merged into the manifest."""
        self._workload_source = fn

    def due(self, it_start: int, k: int = 1) -> bool:
        """True when the dispatch window ``[it_start, it_start + k)`` holds
        a configured capture superstep (listed, or a multiple of
        ``every``)."""
        try:
            it_start, k = int(it_start), max(1, int(k))
        except Exception:
            return False
        if self.supersteps is not None and any(it_start <= t < it_start + k
                                               for t in self.supersteps):
            return True
        if self.every > 0:
            first = ((it_start + self.every - 1) // self.every) * self.every
            if it_start <= first < it_start + k:
                return True
        return False

    @property
    def capturing(self) -> bool:
        return self._active is not None

    # ------------------------------------------------------------------
    def start_capture(self, it_start: int, k: int = 1, *, label: str = "superstep",
                      force: bool = False) -> bool:
        """Start profiling the window when it is due (or ``force``); returns
        whether a capture is now open."""
        try:
            if self._active is not None:
                return False
            if not force and not self.due(it_start, k):
                return False
            with self._lock:
                self._capture_seq += 1
                seq = self._capture_seq
            bundle = self.out_dir / f"capture_{seq:03d}_it{int(it_start)}"
            bundle.mkdir(parents=True, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            self._active = {"bundle": bundle, "it_start": int(it_start), "k": max(1, int(k)),
                            "label": str(label), "seq": seq, "t0": time.time(), "prof": prof}
            return True
        except Exception:
            self.capture_errors += 1
            self._active = None
            return False

    def finish_capture(self) -> Optional[str]:
        """Wait for the window's device work (one ``synchronize``), stop the
        profiler, export the trace and write the bundle (manifest, scope
        map, ledger event, counter tick); returns the bundle path, or None
        when no capture was open or the write failed."""
        active = self._active
        if active is None:
            return None
        self._active = None
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof = active.pop("prof")
            prof.stop()
            prof.export_chrome_trace(str(active["bundle"] / TRACE_NAME))
        except Exception:
            self.capture_errors += 1
            return None
        try:
            return self._write_bundle(active)
        except Exception:
            self.capture_errors += 1
            return None

    def capture(self, *, it_start: int = 0, k: int = 1, label: str = "manual") -> _Capture:
        """A one-shot context manager that ignores the cadence."""
        return _Capture(self, it_start, k, label)

    def close(self) -> None:
        """Finish a capture an aborted loop left open (idempotent)."""
        self.finish_capture()

    # ------------------------------------------------------------------
    def _write_bundle(self, active: Dict[str, Any]) -> Optional[str]:
        from gymfx_tpu_torch.bench_util import stamp_comparability
        from gymfx_tpu_torch.telemetry.flight_recorder import _jsonable
        from gymfx_tpu_torch.telemetry.mfu import hw_flops_peak

        bundle: Path = active["bundle"]
        it_start, k = active["it_start"], active["k"]
        manifest: Dict[str, Any] = {
            "schema_version": CAPTURE_MANIFEST_VERSION,
            "ts": time.time(),
            "label": active["label"],
            "seq": active["seq"],
            "config_sha256": self.config_sha256,
            "it_start": it_start,
            "k": k,
            "it_end": it_start + k,
            "capture_wall_s": time.time() - active["t0"],
            "trace_file": TRACE_NAME,
            "xla_flops_per_dispatch": None,
            "xla_flops_per_step": None,
        }
        stamp_comparability(manifest)
        manifest["hw_flops_peak"] = hw_flops_peak()
        summary = parse_trace(str(bundle / TRACE_NAME), scopes=self.scopes)
        scope_map = scope_map_from_summary(summary, self.scopes)
        (bundle / SCOPE_MAP_NAME).write_text(json.dumps(scope_map, sort_keys=True),
                                             encoding="utf-8")
        manifest["scope_map_file"] = SCOPE_MAP_NAME
        manifest["scope_map_ops"] = len(scope_map)
        info: Dict[str, Any] = {}
        if self._workload_source is not None:
            t0 = time.perf_counter()
            try:
                info = dict(self._workload_source(it_start, k) or {})
            except Exception:
                manifest["workload_error"] = True
            manifest["workload_s"] = time.perf_counter() - t0
        manifest["fingerprints"] = {}
        if self.compile_watch is not None:
            try:
                manifest["fingerprints"] = self.compile_watch.fingerprints()
            except Exception:
                pass
        for key, value in info.items():
            manifest.setdefault(str(key), _jsonable(value))
        with open(bundle / MANIFEST_NAME, "w", encoding="utf-8") as fh:
            json.dump(_jsonable(manifest), fh, indent=2, sort_keys=True)
            fh.write("\n")
        self._last_capture_ts = time.time()
        with self._lock:
            self.captures += 1
        if self._counter is not None:
            try:
                self._counter.inc()
            except Exception:
                pass
        if self.ledger is not None:
            self.ledger.record("profile_capture", path=str(bundle), it_start=int(it_start),
                               k=int(k))
        return str(bundle)


def find_captures(root: str) -> list:
    """Manifested capture bundles under ``root`` (a bundle, a session dir
    or any ancestor), oldest first."""
    try:
        base = Path(root)
        if (base / MANIFEST_NAME).exists():
            return [str(base)]
        return sorted(str(p.parent) for p in base.rglob(MANIFEST_NAME))
    except Exception:
        return []
