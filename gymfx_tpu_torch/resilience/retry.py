"""Retry/backoff and the circuit breaker: the port of
``gymfx_tpu/resilience/retry.py`` (:27-234).  Host-only, like the JAX
package's module, and dependency-free:

  RetryPolicy    exponential backoff with deterministic seeded jitter,
                 a per-call timeout and an optional cross-call
                 :class:`RetryBudget`;
  retry_call     drives any callable under a policy, with caller-chosen
                 retryability classification for results and
                 exceptions — the caller decides what is idempotent;
  CircuitBreaker repeated failures trip OPEN (fail fast instead of
                 hammering a dead dependency); after ``recovery_time``
                 one probe call is allowed through (HALF_OPEN) and its
                 outcome closes or re-opens the circuit.

The serving micro-batcher (serve/batcher.py) gates engine dispatch with
the breaker.  ``sleep``, ``rng`` and ``clock`` are injectable, so tests
never sleep.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, NamedTuple, Optional


class RetryPolicy(NamedTuple):
    """Backoff schedule: attempt k (0-based retry index) sleeps
    ``min(max_delay, base_delay * 2**k)`` scaled by a seeded jitter in
    ``[1 - jitter, 1 + jitter]`` (decorrelates a fleet of workers
    retrying the same dead endpoint).  ``timeout`` is the per-call
    transport timeout in seconds."""

    max_attempts: int = 4
    base_delay: float = 0.25
    max_delay: float = 8.0
    jitter: float = 0.25
    timeout: float = 30.0

    def delay(self, retry_index: int, rng: Optional[random.Random] = None) -> float:
        d = min(self.max_delay, self.base_delay * (2.0 ** retry_index))
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, d)


class RetryBudget:
    """Cross-call retry budget: a run-level cap on TOTAL retries so a
    systemically failing dependency degrades to fail-fast instead of
    multiplying every call's latency by the per-call retry count.

    Thread-safe: the budget is shared across concurrent callers (the
    serving path fans requests out from many client threads), so
    ``take`` must grant exactly ``max_retries`` tokens in total no
    matter how many threads race it."""

    def __init__(self, max_retries: int = 64):
        if int(max_retries) < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.max_retries = int(max_retries)
        self.used = 0
        self._lock = threading.Lock()

    @property
    def remaining(self) -> int:
        with self._lock:
            return max(0, self.max_retries - self.used)

    def take(self) -> bool:
        """Consume one retry token; False when the budget is exhausted
        (the caller must fail fast instead of retrying)."""
        with self._lock:
            if self.used >= self.max_retries:
                return False
            self.used += 1
            return True


class RetryError(RuntimeError):
    """Retries exhausted; ``last`` carries the final exception or
    rejected result."""

    def __init__(self, message: str, last: Any = None):
        super().__init__(message)
        self.last = last


def retry_call(
    fn: Callable[[], Any],
    *,
    policy: RetryPolicy,
    retry_on_exc: Callable[[BaseException], bool],
    retry_on_result: Optional[Callable[[Any], bool]] = None,
    budget: Optional[RetryBudget] = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
    on_retry: Optional[Callable[[int, Any], None]] = None,
) -> Any:
    """Call ``fn`` under ``policy``.

    ``retry_on_exc(exc)`` classifies exceptions (False re-raises
    immediately — non-retryable failures must not be masked);
    ``retry_on_result(res)`` optionally rejects returned values (e.g. a
    5xx status tuple).  A rejected final attempt raises
    :class:`RetryError`.  ``sleep``/``rng`` are injectable so tests run
    instantly and deterministically.
    """
    attempts = max(1, int(policy.max_attempts))
    last: Any = None
    for attempt in range(attempts):
        try:
            result = fn()
        except BaseException as exc:  # noqa: BLE001 - classified below
            if not retry_on_exc(exc):
                raise
            last = exc
        else:
            if retry_on_result is None or not retry_on_result(result):
                return result
            last = result
        if attempt == attempts - 1:
            break
        if budget is not None and not budget.take():
            break
        if on_retry is not None:
            on_retry(attempt, last)
        sleep(policy.delay(attempt, rng))
    if isinstance(last, BaseException):
        raise RetryError(
            f"retries exhausted after {attempts} attempts: {last!r}", last
        ) from last
    raise RetryError(
        f"retries exhausted after {attempts} attempts: {last!r}", last
    )


class CircuitOpenError(RuntimeError):
    """The circuit breaker is OPEN: the dependency failed repeatedly and
    calls are refused locally until the recovery window elapses."""


class CircuitBreaker:
    """Classic three-state breaker (closed -> open -> half-open).

    ``allow()`` gates every call: CLOSED passes, OPEN raises
    :class:`CircuitOpenError` until ``recovery_time`` has elapsed, then
    exactly one probe passes (HALF_OPEN).  ``record_success`` closes the
    circuit and clears the failure count; ``record_failure`` increments
    it and trips OPEN at ``failure_threshold`` (a half-open probe
    failure re-trips immediately).  ``on_trip`` fires on the CLOSED ->
    OPEN transition (not on half-open re-trips) — the live router uses
    it to enter its flatten-and-halt degraded mode exactly once.

    Thread-safe: the serving path shares one breaker between the
    batcher worker and any direct-dispatch callers, so transitions are
    serialized under a lock.  ``on_trip`` fires OUTSIDE the lock (the
    router's flatten hook makes venue calls; holding the breaker lock
    across those would invite deadlock)."""

    def __init__(
        self,
        failure_threshold: int = 5,
        recovery_time: float = 30.0,
        *,
        clock: Callable[[], float] = time.monotonic,
        on_trip: Optional[Callable[[], None]] = None,
    ):
        if int(failure_threshold) < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.failure_threshold = int(failure_threshold)
        self.recovery_time = float(recovery_time)
        self._clock = clock
        # public so a consumer built AFTER the breaker (the order
        # router) can attach its degraded-mode entry hook
        self.on_trip = on_trip
        self.failures = 0
        self.trip_count = 0
        self._opened_at: Optional[float] = None
        self._probing = False
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._probing:
            return "half_open"
        if self._clock() - self._opened_at >= self.recovery_time:
            return "half_open"
        return "open"

    def allow(self) -> None:
        with self._lock:
            if self._opened_at is None:
                return
            if self._probing:
                # one probe is already in flight; refuse concurrent calls
                raise CircuitOpenError(
                    "circuit breaker half-open: probe in flight"
                )
            elapsed = self._clock() - self._opened_at
            if elapsed < self.recovery_time:
                raise CircuitOpenError(
                    f"circuit breaker open after {self.failures} consecutive "
                    f"failures; retrying in "
                    f"{self.recovery_time - elapsed:.1f}s"
                )
            self._probing = True  # half-open: let exactly one probe through

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> None:
        fire_trip = False
        with self._lock:
            self.failures += 1
            was_open = self._opened_at is not None
            if self._probing or self.failures >= self.failure_threshold:
                self._opened_at = self._clock()  # (re-)arm the recovery window
                self._probing = False
                if not was_open:
                    self.trip_count += 1
                    fire_trip = self.on_trip is not None
        if fire_trip:
            self.on_trip()
