"""Serving config surface: the port of ``gymfx_tpu/serve/config.py``
(:16-174).  The ``serve_*`` keys (config/defaults.py) parsed into one
immutable struct shared by the engine constructor and the micro-batcher;
``FleetConfig`` parses the ``serve_fleet_*`` keys for the decision fleet
(ROADMAP.md Queue 1 item 16), which reads them once it is ported."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

from gymfx_tpu_torch.serve.engine import DEFAULT_BUCKETS
from gymfx_tpu_torch.serve.overload import (
    resolve_fallback_policy,
    resolve_shed_policy,
)


class ServeConfig(NamedTuple):
    buckets: Tuple[int, ...]
    max_batch_wait_ms: float
    batch_mode: str   # auto | exact | matmul (engine.resolve_batch_mode)
    warmup: bool
    # ---- overload resilience (docs/serving.md, "Overload behavior") ----
    max_queue: Optional[int]          # admission queue capacity; None = unbounded
    shed_policy: str                  # reject | evict_oldest
    deadline_ms: Optional[float]      # per-request deadline; None = none
    fallback: str                     # hold | flat | reject (live degraded mode)
    breaker_threshold: int            # dispatch failures to trip; 0 = no breaker
    breaker_recovery_s: float         # open -> half-open window
    feed_stale_after_s: Optional[float]  # live stale-feed watchdog; None = off
    # ---- continuous deployment (docs/serving.md, "Hot-swap") ----
    swap_parity_probe: int            # pinned-obs rows per shadow-parity probe; 0 = off
    # ---- device-resident sessions (docs/serving.md) ----
    session_slots: int                # device carry slots per engine; 0 = host-carry path
    slot_mirror: bool                 # one-dispatch-late host mirror (failover handoff)
    staging: bool                     # pipelined batch assembly (double-buffered dispatch)


class FleetConfig(NamedTuple):
    """The ``serve_fleet_*`` keys (docs/serving.md, "Decision fleet").
    ``replicas == 0`` means the fleet is off and serving stays the
    single engine + micro-batcher path."""

    replicas: int                     # active replicas; 0 = fleet off
    standbys: int                     # warm spares promoted on failover
    max_queue: Optional[int]          # fleet-wide queued-request gate; None = off
    probe_interval_s: float           # supervisor probe cadence
    probe_timeout_s: float            # per-probe timeout -> probe failure
    probe_rows: int                   # pinned-obs rows per probe dispatch
    degraded_latency_ms: float        # slow-probe threshold -> degraded
    dead_after: int                   # consecutive probe failures -> dead
    retry_limit: int                  # replica-death re-routes per request
    max_sessions: int                 # SessionStateStore LRU capacity


def _parse_buckets(value: Any) -> Tuple[int, ...]:
    """Bucket ladders arrive as real lists from file configs and as JSON
    strings from the CLI passthrough (same convention as
    feature_columns, core/runtime.py)."""
    if value is None:
        return DEFAULT_BUCKETS
    if isinstance(value, str):
        import json

        try:
            value = json.loads(value)
        except json.JSONDecodeError as e:
            raise ValueError(
                "serve_buckets must be a JSON list of batch sizes "
                f"(e.g. '[1, 8, 64]'), got {value!r}"
            ) from e
    if not isinstance(value, (list, tuple)) or not value:
        raise ValueError(
            f"serve_buckets must be a non-empty list of batch sizes, got {value!r}"
        )
    return tuple(sorted({int(b) for b in value}))


def _opt_positive(config: Dict[str, Any], key: str, kind=float) -> Optional[Any]:
    """None/0/"" -> None (feature off); otherwise a positive number."""
    raw = config.get(key)
    if raw is None or raw == "" or (isinstance(raw, (int, float)) and raw <= 0):
        if isinstance(raw, (int, float)) and raw < 0:
            raise ValueError(f"{key} must be > 0 (or null to disable), got {raw}")
        return None
    return kind(raw)


def serve_config_from(config: Dict[str, Any]) -> ServeConfig:
    wait = float(config.get("serve_max_batch_wait_ms", 2.0) or 0.0)
    if wait < 0:
        raise ValueError(f"serve_max_batch_wait_ms must be >= 0, got {wait}")
    threshold = int(config.get("serve_breaker_threshold", 5) or 0)
    if threshold < 0:
        raise ValueError(
            f"serve_breaker_threshold must be >= 0 (0 disables), got {threshold}"
        )
    recovery = float(config.get("serve_breaker_recovery_s", 5.0) or 0.0)
    if recovery < 0:
        raise ValueError(
            f"serve_breaker_recovery_s must be >= 0, got {recovery}"
        )
    probe = int(config.get("serve_swap_parity_probe", 4) or 0)
    if probe < 0:
        raise ValueError(
            f"serve_swap_parity_probe must be >= 0 (0 disables), got {probe}"
        )
    slots = int(config.get("serve_session_slots", 0) or 0)
    if slots < 0:
        raise ValueError(
            f"serve_session_slots must be >= 0 (0 = host-carry path), got {slots}"
        )
    return ServeConfig(
        buckets=_parse_buckets(config.get("serve_buckets")),
        max_batch_wait_ms=wait,
        batch_mode=str(config.get("serve_batch_mode", "auto") or "auto"),
        warmup=bool(config.get("serve_warmup", True)),
        max_queue=_opt_positive(config, "serve_max_queue", int),
        shed_policy=resolve_shed_policy(
            str(config.get("serve_shed_policy", "reject") or "reject")
        ),
        deadline_ms=_opt_positive(config, "serve_deadline_ms", float),
        fallback=resolve_fallback_policy(
            str(config.get("serve_fallback", "hold") or "hold")
        ),
        breaker_threshold=threshold,
        breaker_recovery_s=recovery,
        feed_stale_after_s=_opt_positive(config, "feed_stale_after_s", float),
        swap_parity_probe=probe,
        session_slots=slots,
        slot_mirror=bool(config.get("serve_slot_mirror", True)),
        staging=bool(config.get("serve_staging", True)),
    )


def fleet_config_from(config: Dict[str, Any]) -> FleetConfig:
    replicas = int(config.get("serve_fleet_replicas", 0) or 0)
    if replicas < 0:
        raise ValueError(
            f"serve_fleet_replicas must be >= 0 (0 disables), got {replicas}"
        )
    standbys = int(config.get("serve_fleet_standbys", 1) or 0)
    if standbys < 0:
        raise ValueError(
            f"serve_fleet_standbys must be >= 0, got {standbys}"
        )
    interval = float(config.get("serve_fleet_probe_interval_s", 0.25) or 0.25)
    timeout = float(config.get("serve_fleet_probe_timeout_s", 2.0) or 2.0)
    if interval <= 0 or timeout <= 0:
        raise ValueError(
            "serve_fleet_probe_interval_s and serve_fleet_probe_timeout_s "
            f"must be > 0, got {interval} / {timeout}"
        )
    rows = int(config.get("serve_fleet_probe_rows", 2) or 1)
    degraded = float(config.get("serve_fleet_degraded_latency_ms", 250.0) or 250.0)
    dead_after = int(config.get("serve_fleet_dead_after", 1) or 1)
    retries = int(config.get("serve_fleet_retry_limit", 2) or 0)
    sessions = int(config.get("serve_fleet_max_sessions", 1_000_000) or 1)
    if rows < 1 or degraded <= 0 or dead_after < 1 or retries < 0 or sessions < 1:
        raise ValueError(
            "fleet knobs out of range: probe_rows >= 1, "
            "degraded_latency_ms > 0, dead_after >= 1, retry_limit >= 0, "
            "max_sessions >= 1"
        )
    return FleetConfig(
        replicas=replicas,
        standbys=standbys,
        max_queue=_opt_positive(config, "serve_fleet_max_queue", int),
        probe_interval_s=interval,
        probe_timeout_s=timeout,
        probe_rows=rows,
        degraded_latency_ms=degraded,
        dead_after=dead_after,
        retry_limit=retries,
        max_sessions=sessions,
    )
