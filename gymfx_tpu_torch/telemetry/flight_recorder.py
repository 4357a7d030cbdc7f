"""Flight recorder: the last K drained superstep frames, held host-side
and dumped as one postmortem bundle when a run dies (the port of
``gymfx_tpu/telemetry/flight_recorder.py``).

The recorder rides the existing one-dispatch-late drain: each frame is
the host metric stack
:class:`~gymfx_tpu_torch.telemetry.device_stream.DeviceMetricStream`
already fetched (one pinned copy per superstep — the recorder adds no
host sync).  On divergence, watchdog trip, or preemption,
:meth:`dump` writes a bundle directory:

  * ``frames.jsonl`` — the retained frames, oldest first
  * ``manifest.json`` — reason, wall time, config sha256, the rng
    state at dump time (``rng_key``: the trainer's ``torch.Generator``
    state, ``get_state()`` as a list of byte values, where the JAX
    package stores its two-word threefry key), a resilience-counter
    snapshot, and every compile event the run observed

pinned by the port's copy of ``postmortem_schema.json`` next to this
module
(:func:`validate_postmortem` is the shared validator).  Everything on
the record path follows the sink discipline: never raises, failures
are counted (``dropped_frames``, ``dump_errors``), a broken disk costs
you forensics, not the run.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

SCHEMA_PATH = Path(__file__).resolve().parent / "postmortem_schema.json"

POSTMORTEM_SCHEMA_VERSION = 1

# compile events are small dicts; keep enough for any real session but
# bound the host memory a pathological recompile storm could take
MAX_COMPILE_EVENTS = 4096


def _jsonable(obj: Any) -> Any:
    """Coerce numpy/torch leaves to plain JSON types (lossy repr as the
    last resort — a postmortem that drops a weird leaf beats no
    postmortem)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    try:
        arr = np.asarray(obj)
        # an object-dtype array round-trips the unserializable leaf
        # right back out of tolist(); repr it instead
        if arr.dtype != object:
            return arr.tolist()
    except Exception:
        pass
    return repr(obj)


class FlightRecorder:
    """Ring buffer of superstep frames + run provenance, dumpable as a
    schema-pinned postmortem bundle."""

    def __init__(
        self,
        out_dir: str,
        *,
        k: int = 8,
        config: Optional[Dict[str, Any]] = None,
        config_sha256: Optional[str] = None,
        ledger: Any = None,
    ):
        from gymfx_tpu_torch.telemetry.ledger import config_digest

        self.out_dir = Path(out_dir)
        self.k = max(1, int(k))
        self.config_sha256 = (
            config_sha256 if config_sha256 is not None else config_digest(config)
        )
        self.ledger = ledger
        self._frames: deque = deque(maxlen=self.k)
        self._compile_events: List[Dict[str, Any]] = []
        self._rng_source: Optional[Callable[[], Any]] = None
        self._resilience_source: Optional[Callable[[], Dict[str, Any]]] = None
        self._lock = threading.Lock()
        self._frame_seq = 0
        self._dump_seq = 0
        self.dropped_frames = 0
        self.dump_errors = 0
        self.dumps = 0

    # -- sources resolved lazily at dump time --------------------------
    def set_rng_source(self, fn: Callable[[], Any]) -> None:
        """A zero-arg closure returning the CURRENT rng state (a
        generator's ``get_state()``) — called at dump time so the bundle
        carries the state the run died with, not the one it started
        with."""
        self._rng_source = fn

    def set_resilience_source(self, fn: Callable[[], Dict[str, Any]]) -> None:
        """A zero-arg closure returning the resilience-counter snapshot
        (e.g. ``lambda: resilience_snapshot(registry)``)."""
        self._resilience_source = fn

    # -- record paths (hot; never raise) -------------------------------
    def record_frame(self, it_end: int, k: int, metrics: Any) -> None:
        """Retain one drained superstep frame.  ``metrics`` is the
        already-fetched host tree — the recorder only coerces and
        stores, it never touches the device."""
        try:
            frame = {
                "frame_seq": None,  # stamped under the lock below
                "it_end": int(it_end),
                "k": int(k),
                "metrics": _jsonable(metrics),
            }
            with self._lock:
                self._frame_seq += 1
                frame["frame_seq"] = self._frame_seq
                self._frames.append(frame)
        except Exception:
            with self._lock:
                self.dropped_frames += 1

    def record_compile(self, event: Dict[str, Any]) -> None:
        try:
            row = _jsonable(event)
            with self._lock:
                if len(self._compile_events) < MAX_COMPILE_EVENTS:
                    self._compile_events.append(row)
        except Exception:
            pass

    @property
    def frame_count(self) -> int:
        with self._lock:
            return len(self._frames)

    # -- the dump -------------------------------------------------------
    def dump(self, reason: str, extra: Optional[Dict[str, Any]] = None
             ) -> Optional[str]:
        """Write the bundle; returns its directory path, or None when
        the write failed (counted in ``dump_errors``).  Safe to call
        more than once — each dump gets its own directory."""
        try:
            with self._lock:
                self._dump_seq += 1
                dump_seq = self._dump_seq
                frames = list(self._frames)
                compile_events = list(self._compile_events)
            bundle = self.out_dir / f"postmortem_{dump_seq:03d}_{reason}"
            bundle.mkdir(parents=True, exist_ok=True)

            frames_file = "frames.jsonl"
            with open(bundle / frames_file, "w", encoding="utf-8") as fh:
                for frame in frames:
                    fh.write(json.dumps(frame) + "\n")

            rng_key = None
            if self._rng_source is not None:
                try:
                    rng_key = _jsonable(self._rng_source())
                except Exception:
                    rng_key = None
            resilience: Dict[str, Any] = {}
            if self._resilience_source is not None:
                try:
                    resilience = _jsonable(self._resilience_source()) or {}
                except Exception:
                    resilience = {}

            manifest = {
                "schema_version": POSTMORTEM_SCHEMA_VERSION,
                "reason": str(reason),
                "ts": time.time(),
                "config_sha256": self.config_sha256,
                "frames": len(frames),
                "frames_file": frames_file,
                "rng_key": rng_key,
                "resilience": resilience,
                "compile_events": compile_events,
            }
            if extra:
                for key, value in extra.items():
                    manifest.setdefault(str(key), _jsonable(value))
            with open(bundle / "manifest.json", "w", encoding="utf-8") as fh:
                json.dump(manifest, fh, indent=2, sort_keys=True)
                fh.write("\n")

            with self._lock:
                self.dumps += 1
            if self.ledger is not None:
                self.ledger.record("postmortem_dump", reason=str(reason),
                                   path=str(bundle))
            return str(bundle)
        except Exception:
            with self._lock:
                self.dump_errors += 1
            return None


# ---------------------------------------------------------------------------
# validation: the committed schema, shared by the tests and tooling
def load_postmortem_schema() -> Dict[str, Any]:
    with open(SCHEMA_PATH, encoding="utf-8") as fh:
        schema = json.load(fh)
    schema.pop("_comment", None)
    return schema


def validate_postmortem(bundle_dir: str,
                        schema: Optional[Dict[str, Any]] = None) -> List[str]:
    """Return a list of violations (empty = the bundle conforms):
    manifest keys, known reason, frame count matching frames.jsonl,
    per-frame required keys, and monotonic frame_seq."""
    if schema is None:
        schema = load_postmortem_schema()
    problems: List[str] = []
    bundle = Path(bundle_dir)
    manifest_path = bundle / "manifest.json"
    if not manifest_path.exists():
        return [f"{bundle}: missing manifest.json"]
    try:
        manifest = json.loads(manifest_path.read_text(encoding="utf-8"))
    except Exception as exc:
        return [f"{manifest_path}: unparseable manifest ({exc})"]
    for key in schema.get("manifest_required", ()):
        if key not in manifest:
            problems.append(f"manifest: missing required key {key!r}")
    reasons = schema.get("reasons", ())
    if reasons and manifest.get("reason") not in reasons:
        problems.append(
            f"manifest: unknown reason {manifest.get('reason')!r}; "
            f"schema knows {list(reasons)}"
        )
    frames_file = bundle / str(manifest.get("frames_file", "frames.jsonl"))
    if not frames_file.exists():
        problems.append(f"{frames_file}: missing frames file")
        return problems
    frames = []
    for i, line in enumerate(
            frames_file.read_text(encoding="utf-8").splitlines()):
        if not line.strip():
            continue
        try:
            frames.append(json.loads(line))
        except Exception as exc:
            problems.append(f"frames.jsonl row {i}: unparseable ({exc})")
    declared = manifest.get("frames")
    if isinstance(declared, int) and declared != len(frames):
        problems.append(
            f"manifest declares {declared} frames, frames.jsonl has "
            f"{len(frames)}"
        )
    prev_seq = 0
    for i, frame in enumerate(frames):
        for key in schema.get("frame_required", ()):
            if key not in frame:
                problems.append(f"frame {i}: missing required key {key!r}")
        seq = frame.get("frame_seq")
        if isinstance(seq, int):
            if seq <= prev_seq:
                problems.append(
                    f"frame {i}: frame_seq {seq} not monotonic "
                    f"(previous {prev_seq})"
                )
            prev_seq = seq
        else:
            problems.append(f"frame {i}: frame_seq must be an int, got {seq!r}")
    return problems
