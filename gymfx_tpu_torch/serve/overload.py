"""Typed overload outcomes for the serving path: the port of
``gymfx_tpu/serve/overload.py`` (:37-110; docs/serving.md, "Overload
behavior").

Every request submitted to the :class:`~gymfx_tpu_torch.serve.batcher.
MicroBatcher` resolves — with a Decision row on the fast path, or with
exactly one of these typed errors on the brownout path.  Nothing here
is retried silently and no future is ever left hanging; callers branch
on the type to pick a degraded-mode fallback (``serve_fallback``,
:func:`resolve_fallback_policy`).

  ShedError           admission control refused the request: the
                      bounded queue was full and the shed policy either
                      rejected this (newest) request or evicted the
                      oldest one to admit it;
  DeadlineExceeded    the request's ``deadline_ms`` passed before the
                      engine could serve it (checked when the worker
                      picks it up AND again just before dispatch, so an
                      expired request never occupies a batch slot);
  BatcherClosedError  the batcher was closed/draining — at submit time
                      (admission refused) or with the request still
                      queued (its future fails instead of hanging).

``OVERLOAD_ERRORS`` additionally includes
:class:`~gymfx_tpu_torch.resilience.retry.CircuitOpenError`: a serving
breaker that tripped on repeated dispatch failures fails requests fast
with it, and a fallback policy treats it as one more overload signal.
"""
from __future__ import annotations

from gymfx_tpu_torch.resilience.retry import CircuitOpenError

FALLBACK_POLICIES = ("hold", "flat", "reject")
SHED_POLICIES = ("reject", "evict_oldest")


class ShedError(RuntimeError):
    """Admission control shed this request (queue at capacity).

    ``reason`` is ``"queue_full"`` (reject-newest refused the submit)
    or ``"evicted"`` (an older queued request was dropped to admit a
    newer one)."""

    def __init__(self, message: str, reason: str = "queue_full"):
        super().__init__(message)
        self.reason = reason


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before it could be served.

    ``phase`` records where the miss was detected: ``"pickup"`` (the
    worker popped an already-expired request) or ``"dispatch"`` (it
    expired while the batching window was open)."""

    def __init__(self, message: str, phase: str = "pickup"):
        super().__init__(message)
        self.phase = phase


class BatcherClosedError(RuntimeError):
    """The batcher is closed (or draining): new submissions are refused
    and requests still queued at close resolve with this instead of
    hanging forever."""


class DrainWhilePausedError(RuntimeError):
    """``MicroBatcher.drain()`` was called while the worker is parked by
    ``pause()``: a parked worker can make no progress on queued work, so
    instead of waiting forever the drain waits a bounded grace period
    for a concurrent ``resume()`` and then raises this.  Not a request
    resolution — it signals a caller-side lifecycle bug (drain inside a
    pause bracket)."""


class NoHealthyReplicaError(RuntimeError):
    """The decision fleet has no healthy (or degraded) replica left to
    route to — every replica is dead and no standby remains.  A typed
    request resolution like the other overload errors: the caller's
    degraded-mode fallback decides what a decision-less tick does."""


def resolve_fallback_policy(policy: str) -> str:
    if policy not in FALLBACK_POLICIES:
        raise ValueError(
            f"serve_fallback must be one of {FALLBACK_POLICIES}, "
            f"got {policy!r}"
        )
    return policy


def resolve_shed_policy(policy: str) -> str:
    if policy not in SHED_POLICIES:
        raise ValueError(
            f"serve_shed_policy must be one of {SHED_POLICIES}, "
            f"got {policy!r}"
        )
    return policy


# the full set a serving client must be prepared to catch: every shed /
# expired / closed / breaker-open / no-replica request resolves with one
# of these
OVERLOAD_ERRORS = (
    ShedError,
    DeadlineExceeded,
    BatcherClosedError,
    CircuitOpenError,
    NoHealthyReplicaError,
)
