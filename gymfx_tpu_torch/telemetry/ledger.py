"""Append-only, schema-pinned run ledger: the lifecycle black box (the
port of ``gymfx_tpu/telemetry/ledger.py``; ``config_digest`` gives the
JAX package's sha256 for the same config).

Every run-shaping event — compiles, superstep dispatches, checkpoint
writes/restores/rollbacks, preemptions, divergences, gate verdicts,
bench rows — lands as one JSONL row with a monotonic ``seq``, a wall
clock ``ts`` (stamped by the sink) and the run's config sha256, so a
post-mortem can replay WHAT happened in WHAT order under WHICH config
without trusting anyone's memory of the session.

Built on the never-raises :class:`~gymfx_tpu_torch.telemetry.sink.JsonlSink`:
a full disk degrades the ledger (``write_errors`` counts it), it never
kills training or serving.  The row shape is pinned by the port's own
copy of ``ledger_schema.json`` next to this module —
:func:`validate_ledger_rows` is the one validator the tests and tooling
share, so the emitter and the schema cannot drift apart silently.
"""
from __future__ import annotations

import hashlib
import json
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

from gymfx_tpu_torch.telemetry.sink import JsonlSink

SCHEMA_PATH = Path(__file__).resolve().parent / "ledger_schema.json"

LEDGER_SCHEMA_VERSION = 1

# the pinned lifecycle vocabulary; record() drops (and counts) anything
# else rather than letting ad-hoc kinds rot the schema
EVENT_KINDS = (
    "run_start",
    "run_end",
    "compile_begin",
    "compile_end",
    "recompile",
    "superstep_dispatch",
    "checkpoint_write",
    "checkpoint_restore",
    "checkpoint_rollback",
    "preemption",
    "divergence",
    "gate_verdict",
    "bench_row",
    "serve_bucket_miss",
    "postmortem_dump",
    "profile_capture",
    "policy_promote",
    "policy_demote",
    "policy_rollback",
    "replica_up",
    "replica_down",
    "replica_failover",
    "curriculum_pick",
    "mesh_degrade",
    "mesh_resume",
)


def config_digest(config: Optional[Dict[str, Any]]) -> Optional[str]:
    """sha256 of the canonical-JSON config dict (sorted keys, non-JSON
    leaves repr-coerced) — the provenance stamp every ledger row and
    postmortem manifest carries.  None in, None out."""
    if config is None:
        return None
    blob = json.dumps(config, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


class RunLedger:
    """Append lifecycle events with a monotonic ``seq``; never raises.

    ``record`` returns True when the row was accepted AND written —
    unknown kinds and sink write failures both return False (the former
    counted in ``dropped_events``, the latter in ``sink.write_errors``).
    """

    def __init__(
        self,
        path: str,
        *,
        config: Optional[Dict[str, Any]] = None,
        config_sha256: Optional[str] = None,
        max_bytes: int = 64 * 1024 * 1024,
        backups: int = 3,
    ):
        self.sink = JsonlSink(path, max_bytes=max_bytes, backups=backups)
        self.path = self.sink.path
        self.config_sha256 = (
            config_sha256 if config_sha256 is not None else config_digest(config)
        )
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped_events = 0
        self._closed = False
        self.record("run_start")

    # ------------------------------------------------------------------
    def record(self, kind: str, **fields: Any) -> bool:
        """Append one event row.  ``fields`` ride alongside the pinned
        base keys (seq, ts, kind, config_sha256, schema_version); a
        field named like a base key is ignored rather than trusted."""
        if kind not in EVENT_KINDS:
            with self._lock:
                self.dropped_events += 1
            return False
        with self._lock:
            if self._closed:
                self.dropped_events += 1
                return False
            self._seq += 1
            seq = self._seq
        row = {k: v for k, v in fields.items()
               if k not in ("seq", "kind", "config_sha256", "schema_version")}
        row.update(
            seq=seq,
            kind=kind,
            config_sha256=self.config_sha256,
            schema_version=LEDGER_SCHEMA_VERSION,
        )
        return self.sink.append(row)

    def close(self) -> None:
        """Append the terminal ``run_end`` row (idempotent)."""
        with self._lock:
            if self._closed:
                return
        self.record("run_end", events=self._seq)
        with self._lock:
            self._closed = True

    def __enter__(self) -> "RunLedger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


# ---------------------------------------------------------------------------
# the process-global active ledger: emitters that cannot thread a
# Telemetry bundle through their call path publish through it when a
# run installed one
_ACTIVE: Optional[RunLedger] = None
_ACTIVE_LOCK = threading.Lock()


def set_active_ledger(ledger: Optional[RunLedger]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = ledger


def get_active_ledger() -> Optional[RunLedger]:
    with _ACTIVE_LOCK:
        return _ACTIVE


# ---------------------------------------------------------------------------
# validation: the committed schema
def load_ledger_schema() -> Dict[str, Any]:
    with open(SCHEMA_PATH, encoding="utf-8") as fh:
        schema = json.load(fh)
    schema.pop("_comment", None)
    return schema


def read_ledger(path: str) -> List[Dict[str, Any]]:
    """Parse every row of a ledger file (skipping blank lines)."""
    rows = []
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        if line.strip():
            rows.append(json.loads(line))
    return rows


def validate_ledger_rows(
    rows: Iterable[Dict[str, Any]],
    schema: Optional[Dict[str, Any]] = None,
) -> List[str]:
    """Return a list of violations (empty = the ledger conforms):
    base keys present, known kinds, per-kind required keys, and a
    strictly monotonic ``seq``."""
    if schema is None:
        schema = load_ledger_schema()
    base = schema.get("base_required", ())
    kinds = schema.get("kinds", {})
    problems: List[str] = []
    prev_seq = 0
    for i, row in enumerate(rows):
        where = f"row {i}"
        if not isinstance(row, dict):
            problems.append(f"{where}: not a JSON object")
            continue
        for key in base:
            if key not in row:
                problems.append(f"{where}: missing base key {key!r}")
        kind = row.get("kind")
        spec = kinds.get(kind)
        if spec is None:
            problems.append(
                f"{where}: unknown kind {kind!r}; schema knows {sorted(kinds)}"
            )
        else:
            for key in spec.get("required", ()):
                if key not in row:
                    problems.append(
                        f"{where} ({kind}): missing required key {key!r}"
                    )
        seq = row.get("seq")
        if isinstance(seq, int):
            if seq <= prev_seq:
                problems.append(
                    f"{where}: seq {seq} not monotonic (previous {prev_seq})"
                )
            prev_seq = seq
        else:
            problems.append(f"{where}: seq must be an int, got {seq!r}")
    return problems


def validate_ledger(path: str,
                    schema: Optional[Dict[str, Any]] = None) -> List[str]:
    return validate_ledger_rows(read_ledger(path), schema)
