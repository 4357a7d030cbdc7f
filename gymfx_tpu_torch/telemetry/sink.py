"""Rotating JSONL sink (the port of ``gymfx_tpu/telemetry/sink.py``):
structured telemetry rows (metric snapshots,
span records, run summaries) appended one JSON object per line.

Rotation keeps unattended runs from filling a disk: when the active
file would exceed ``max_bytes`` the sink renames it to ``<path>.1``
(shifting older backups up to ``backups``) and starts fresh — the same
scheme as stdlib ``RotatingFileHandler``, without dragging the logging
module's global configuration into library code.

Thread-safe; writes are line-atomic under the sink lock.  ``append``
never raises into the caller's hot path — a full disk degrades
telemetry, it must not kill training or serving.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional


class JsonlSink:
    def __init__(self, path: str, *, max_bytes: int = 64 * 1024 * 1024,
                 backups: int = 3):
        if int(max_bytes) <= 0:
            raise ValueError(f"max_bytes must be > 0, got {max_bytes}")
        if int(backups) < 0:
            raise ValueError(f"backups must be >= 0, got {backups}")
        self.path = str(path)
        self.max_bytes = int(max_bytes)
        self.backups = int(backups)
        self._lock = threading.Lock()
        self.rows_written = 0
        self.rotations = 0
        self.write_errors = 0
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)

    # ------------------------------------------------------------------
    def _rotate_locked(self) -> None:
        if self.backups == 0:
            # no backups: truncate in place
            open(self.path, "w").close()
        else:
            oldest = f"{self.path}.{self.backups}"
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(self.backups - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            if os.path.exists(self.path):
                os.replace(self.path, f"{self.path}.1")
        self.rotations += 1

    def append(self, record: Dict[str, Any], *,
               ts: Optional[float] = None) -> bool:
        """Write one row (a ``ts`` epoch-seconds field is added when
        absent).  Returns False when the write failed (disk full,
        permissions) — the error is counted, never raised."""
        row = dict(record)
        row.setdefault("ts", time.time() if ts is None else ts)
        try:
            line = json.dumps(row, default=_json_default) + "\n"
        except (TypeError, ValueError):
            with self._lock:
                self.write_errors += 1
            return False
        with self._lock:
            try:
                try:
                    size = os.path.getsize(self.path)
                except OSError:
                    size = 0
                if size and size + len(line) > self.max_bytes:
                    self._rotate_locked()
                with open(self.path, "a", encoding="utf-8") as fh:
                    fh.write(line)
                self.rows_written += 1
                return True
            except OSError:
                self.write_errors += 1
                return False

    def close(self) -> None:  # symmetry with other telemetry components
        pass


def _json_default(value: Any):
    """Last-resort coercion for numpy scalars / 0-d tensors that leak
    into a telemetry row."""
    try:
        return float(value)
    except (TypeError, ValueError):
        return repr(value)

