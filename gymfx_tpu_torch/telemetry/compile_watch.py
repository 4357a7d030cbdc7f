"""Compile watch: the port's compiles as metrics, with fingerprints, so
that a silent recompile is counted and not suspected (the port of
``gymfx_tpu/telemetry/compile_watch.py``).

On the card a compile is one of:

  * a CUDA-graph capture: a ``core/graphs.PhaseGraph`` built with a
    ``name`` (the trainers' phase graphs, the episode drivers' chunk
    graphs) reports itself to the active watch with its warm-up and
    capture seconds, and a serving bucket reports through the engine's
    ``on_compile`` hook (:meth:`CompileWatch.watch_engine`);
  * an nvcc build of a kernel library (``ops/_build.py``), whose file
    name carries the sha256 of its source and flags: a build and a cache
    hit are counted apart (``gymfx_compile_events_total{event=
    "nvcc_build"|"nvcc_cache_hit"}``).

Every capture is :meth:`CompileWatch.record_compile` of the identity
``(name, key)``, where the key is the capture's static signature
(``core/graphs.signature`` of its inputs) and its fingerprint the sha256
of that signature with the body's qualified name.  A second capture of a
known identity is a RECOMPILE: counted in
``gymfx_compile_recompiles_total`` and ledgered as ``recompile``; a first
one is ledgered as ``compile_begin`` and ``compile_end``.  The metric
names and ledger kinds are the JAX package's.

The process has one active watch (:meth:`install`; JAX registers its
listeners once per process the same way), which the capture and build
sites read; :meth:`uninstall` clears it, and ``Telemetry.close`` does so
for the watch it built.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, Optional, Tuple

# compile times span a cache hit (~1 ms) to a whole library's nvcc
# build (minutes)
COMPILE_BUCKETS = (0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0)

_install_lock = threading.Lock()
_active: Optional["CompileWatch"] = None


def active() -> Optional["CompileWatch"]:
    """The installed watch, or None."""
    return _active


def fingerprint(text: str) -> str:
    """sha256 of ``text`` (a capture's signature with its body's name)."""
    return hashlib.sha256(str(text).encode("utf-8")).hexdigest()


def capture_identity(name: str, body: Any, signature: tuple) -> Tuple[str, str]:
    """(key, fingerprint) of a capture: the key is the static signature,
    the fingerprint the sha256 of it with the body's qualified name."""
    key = repr(signature)
    qualname = getattr(body, "__qualname__", type(body).__qualname__)
    return key, fingerprint(f"{qualname}|{key}")


class CompileWatch:
    """Registry and ledger view of every compile the process performs."""

    def __init__(self, registry: Any, *, ledger: Any = None, recorder: Any = None,
                 name: str = "default"):
        self.registry = registry
        self.ledger = ledger
        self.recorder = recorder
        self.name = str(name)
        self.events = registry.counter(
            "gymfx_compile_events_total",
            "Compile events by stage (graph captures, nvcc builds and cache hits)",
            labels=("event",),
        )
        self.seconds = registry.histogram(
            "gymfx_compile_seconds", "Compile-stage durations", labels=("event",),
            buckets=COMPILE_BUCKETS,
        )
        self.programs = registry.counter(
            "gymfx_compile_programs_total",
            "Explicitly recorded program compiles by (watch, late)",
            labels=("watch", "late"),
        )
        self.recompiles = registry.counter(
            "gymfx_compile_recompiles_total",
            "Program keys compiled MORE THAN ONCE (silent-recompile detector)",
            labels=("watch",),
        )
        self.bucket_misses = registry.counter(
            "gymfx_serve_bucket_miss_total",
            "Serve requests that landed outside the compiled bucket ladder "
            "(late compile on the decision path)",
            labels=("watch",),
        )
        self._fingerprints: Dict[Tuple[str, str], Optional[str]] = {}
        self._lock = threading.Lock()
        self.captures = 0
        self.recompile_count = 0

    # -- the process's active watch ------------------------------------
    def install(self) -> "CompileWatch":
        """Become the process's active watch: graph captures and kernel
        builds report to it from now on."""
        global _active
        with _install_lock:
            _active = self
        return self

    def uninstall(self) -> None:
        global _active
        with _install_lock:
            if _active is self:
                _active = None

    def _event(self, event: str, duration_s: Optional[float]) -> None:
        try:
            self.events.inc(event=event)
            if duration_s is not None:
                self.seconds.observe(float(duration_s), event=event)
        except Exception:
            pass

    def record_capture(self, name: str, body: Any, signature: tuple,
                       duration_s: Optional[float]) -> None:
        """A CUDA-graph capture of ``body`` (its warm-up included) for the
        static ``signature``: one ``cuda_graph_capture`` event, then
        :meth:`record_compile` of its identity."""
        self._event("cuda_graph_capture", duration_s)
        key, fp = capture_identity(name, body, signature)
        self.record_compile(name, key=key, fingerprint=fp, duration_s=duration_s)

    def record_build(self, library: str, *, cached: bool,
                     duration_s: Optional[float] = None) -> None:
        """A kernel library's nvcc build, or its cache hit (the built file
        for this source and these flags already there)."""
        event = "nvcc_cache_hit" if cached else "nvcc_build"
        self._event(event, duration_s)
        if not cached and self.ledger is not None:
            self.ledger.record("compile_end", name=f"nvcc:{library}",
                               duration_s=None if duration_s is None else float(duration_s))

    # -- explicit program-identity records -----------------------------
    def record_compile(self, name: str, *, key: str = "", fingerprint: Optional[str] = None,
                       duration_s: Optional[float] = None, late: bool = False) -> None:
        """Record one compile under the identity ``(name, key)``; a second
        compile of a known identity is a recompile."""
        ident = (str(name), str(key))
        with self._lock:
            seen = ident in self._fingerprints
            self._fingerprints[ident] = fingerprint
            self.captures += 1
            self.recompile_count += int(seen)
        try:
            self.programs.inc(watch=self.name, late=str(bool(late)).lower())
        except Exception:
            pass
        event = {"name": str(name), "key": str(key), "hlo_sha256": fingerprint,
                 "duration_s": duration_s, "late": bool(late)}
        if seen:
            try:
                self.recompiles.inc(watch=self.name)
            except Exception:
                pass
            if self.ledger is not None:
                self.ledger.record("recompile", **event)
        elif self.ledger is not None:
            self.ledger.record("compile_begin", name=str(name), key=str(key), late=bool(late))
            self.ledger.record("compile_end", name=str(name), key=str(key),
                               duration_s=duration_s, hlo_sha256=fingerprint, late=bool(late))
        if self.recorder is not None:
            self.recorder.record_compile({"kind": "compile", **event})

    @property
    def fingerprint_count(self) -> int:
        with self._lock:
            return len(self._fingerprints)

    def fingerprints(self) -> Dict[str, Optional[str]]:
        """``{"name|key": fingerprint}`` of every identity seen so far (what
        a capture bundle's manifest carries)."""
        with self._lock:
            return {f"{name}|{key}": fp for (name, key), fp in self._fingerprints.items()}

    # -- serving-engine binding ----------------------------------------
    def watch_engine(self, engine: Any, *, name: str = "serve") -> None:
        """Attach to a ``serve/engine.InferenceEngine``: its future bucket
        captures (the boot ladder and late captures on the decision path)
        report through its ``on_compile`` hook, and the buckets captured
        before are recorded now (no duration).  A late capture also counts
        as a serve bucket miss and ledgers ``serve_bucket_miss``."""
        for bucket in sorted(getattr(engine, "_graphs", {})):
            self.record_compile(f"{name}_forward", key=f"bucket={bucket}", late=False)

        def on_compile(bucket: int, duration_s: Optional[float], late: bool) -> None:
            self.record_compile(f"{name}_forward", key=f"bucket={bucket}",
                                duration_s=duration_s, late=late)
            if late:
                try:
                    self.bucket_misses.inc(watch=self.name)
                except Exception:
                    pass
                if self.ledger is not None:
                    self.ledger.record("serve_bucket_miss", bucket=int(bucket))

        engine.on_compile = on_compile

