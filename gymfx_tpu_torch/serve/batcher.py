"""Micro-batching scheduler: coalesce concurrent decide-action requests
into one engine dispatch, under admission control.  The port of
``gymfx_tpu/serve/batcher.py`` (:58-950), host-only: the engine
(serve/engine.py) owns the card.

Concurrent sessions (live instruments, replayed accounts, load
clients) each submit one encoded observation; a single worker thread
coalesces whatever arrives within a bounded window into one
``InferenceEngine.decide_batch`` call.  The latency contract:

  * the window OPENS when the worker picks up the first queued request
    and CLOSES ``max_batch_wait_ms`` later — or immediately, when the
    batch reaches the engine's largest bucket (waiting longer could not
    save a dispatch);
  * therefore no request waits longer than ``max_batch_wait_ms`` plus
    one in-flight dispatch (the worker picks it up as soon as the
    previous batch returns), and with ``max_batch_wait_ms=0`` the
    batcher degrades to dispatch-per-queue-drain;
  * responses are unpadded by the engine and resolved per-request
    through futures — a pad row has no future, so it can never leak.

The overload contract (docs/serving.md, "Overload behavior"): every
submitted request RESOLVES — with its Decision row, or with exactly one
typed error from :mod:`gymfx_tpu_torch.serve.overload`.  Admission
control bounds the queue (``max_queue`` + ``shed_policy``); per-request
deadlines fail a request fast at pickup or at dispatch instead of
letting it occupy a batch slot it can no longer use; an optional
:class:`~gymfx_tpu_torch.resilience.retry.CircuitBreaker` around engine
dispatch fails whole batches fast while the engine is down; and the
worker SURVIVES dispatch exceptions — an engine fault resolves its
batch's futures with the error and the queue keeps moving.  ``health()``
exposes queue depth / oldest-request age / breaker state / counters,
``drain()`` stops admissions and flushes, ``close()`` fails (never
hangs) everything still queued.  What a caller does with a shed,
expired or refused request is its fallback (``serve_fallback``,
overload.resolve_fallback_policy); the batcher only resolves it typed.

Observations and carries are host tensors (numpy rows are converted at
``submit``).  Per-request timing records (enqueue/pickup/dispatch/done)
give the latency percentiles.  ``instruments=`` (telemetry/instruments.
ServeInstruments) mirrors every counter into a metrics registry, with the
rolling SLO window folded into ``health()``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Deque, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from gymfx_tpu_torch.resilience.guards import tree_map
from gymfx_tpu_torch.resilience.retry import CircuitOpenError
from gymfx_tpu_torch.serve.overload import (
    BatcherClosedError,
    DeadlineExceeded,
    DrainWhilePausedError,
    ShedError,
    resolve_shed_policy,
)


class RequestRecord(NamedTuple):
    """Wall-clock trace of one request (time.perf_counter seconds)."""

    t_enqueue: float    # submit() called
    t_pickup: float     # worker opened the batching window
    t_dispatch: float   # engine dispatch started
    t_done: float       # response resolved
    batch_size: int     # real requests coalesced with this one
    bucket: int         # padded bucket the batch ran in

    @property
    def queue_wait_s(self) -> float:
        return self.t_dispatch - self.t_enqueue

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_enqueue


class _Pending(NamedTuple):
    obs: torch.Tensor
    carry: Any
    future: Future
    t_enqueue: float
    deadline: Optional[float]  # absolute perf_counter second, None = no deadline
    session: Optional[str] = None  # slot-cache session id (serve/slots.py)


class _Inflight(NamedTuple):
    """One dispatched-but-unresolved micro-batch (pipelined worker)."""

    handle: Any           # engine.EngineDispatch
    batch: List[_Pending]
    engine: Any
    t_pickup: float
    t_dispatch: float


class MicroBatcher:
    """One worker thread draining a request queue into engine dispatches.

    Use as a context manager or call :meth:`close`; ``submit`` returns a
    ``concurrent.futures.Future`` resolving to the request's
    :class:`~gymfx_tpu_torch.serve.engine.Decision` row — or failing with
    one of the typed overload errors (:mod:`gymfx_tpu_torch.serve.overload`).

    Overload knobs (all default OFF, preserving the unbounded pre-
    admission behavior):

    ``max_queue``            queue capacity; ``None`` = unbounded
    ``shed_policy``          ``"reject"`` — a submit against a full
        queue raises :class:`ShedError` immediately (backpressure lands
        on the newest caller); ``"evict_oldest"`` — the oldest queued
        request's future fails with ``ShedError(reason="evicted")`` and
        the new request is admitted (freshest-data-wins, the right
        policy when stale decisions are worthless anyway)
    ``default_deadline_ms``  deadline applied to submits that do not
        pass their own ``deadline_ms``
    ``breaker``              a :class:`~gymfx_tpu_torch.resilience.retry.
        CircuitBreaker` gating engine dispatch: failures count toward
        the trip threshold and an open breaker fails batches fast with
        :class:`CircuitOpenError` instead of queueing behind a dead
        engine
    """

    def __init__(
        self,
        engine,
        *,
        max_batch_wait_ms: float = 2.0,
        max_batch: Optional[int] = None,
        keep_records: int = 100_000,
        max_queue: Optional[int] = None,
        shed_policy: str = "reject",
        default_deadline_ms: Optional[float] = None,
        breaker: Optional[Any] = None,
        instruments: Optional[Any] = None,
        pipeline: bool = False,
    ):
        if max_batch_wait_ms < 0:
            raise ValueError(
                f"max_batch_wait_ms must be >= 0, got {max_batch_wait_ms}"
            )
        self.engine = engine
        self.max_batch_wait_ms = float(max_batch_wait_ms)
        self.max_batch = int(
            engine.buckets[-1] if max_batch is None else max_batch
        )
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        self.max_queue = None if max_queue is None else int(max_queue)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.shed_policy = resolve_shed_policy(shed_policy)
        if default_deadline_ms is not None and default_deadline_ms <= 0:
            raise ValueError(
                f"default_deadline_ms must be > 0, got {default_deadline_ms}"
            )
        self.default_deadline_ms = default_deadline_ms
        self.breaker = breaker
        self._pending: Deque[_Pending] = deque()
        self._records: List[RequestRecord] = []
        self._records_cap = int(keep_records)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.dispatches = 0
        self.coalesced_total = 0
        self.shed_count = 0
        self.deadline_miss_count = 0
        self.dispatch_failures = 0
        self.breaker_open_count = 0
        self.deferred_count = 0  # slot-mode rows requeued (duplicate
        # session / capacity / mixed-style) — never dropped, never
        # reordered within a session
        # pipelined dispatch (serve_staging): the worker issues batch
        # N+1 via engine.dispatch_async while batch N's replay is
        # still running, resolving N only after N+1 is in flight —
        # depth-1 double buffering
        self.pipeline = bool(pipeline)
        if self.pipeline:
            # the async path never chunks — cap coalescing at the ladder
            self.max_batch = min(self.max_batch, int(engine.buckets[-1]))
        self._inflight = 0
        # optional telemetry (telemetry/instruments.ServeInstruments): the
        # hooks ride the counter sites above; None keeps the plain counters
        self._instr = instruments
        if instruments is not None:
            instruments.bind_batcher(self)
        self._closed = False
        self._draining = False
        self._stop = False
        # pause()/resume() handshake: _paused asks the worker to hold at
        # the next micro-batch boundary; _parked is the worker's ack that
        # it is idle there (owned by the worker, only ever flipped under
        # the cv) — see pause() for the deployer flip protocol
        self._paused = False
        self._parked = False
        self._worker = threading.Thread(
            target=self._run_pipelined if self.pipeline else self._run,
            name="gymfx-serve-batcher",
            daemon=True,
        )
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(
        self,
        obs_row: Any,
        carry: Any = None,
        *,
        deadline_ms: Optional[float] = None,
        session: Optional[str] = None,
    ) -> Future:
        """Enqueue one encoded observation (engine input row); returns a
        Future of its Decision row.  ``carry`` is the session's
        recurrent carry (required by recurrent engines; fresh sessions
        pass ``engine.initial_carry()``).  ``deadline_ms`` bounds how
        long the request may wait end-to-end (defaults to the batcher's
        ``default_deadline_ms``); a request whose deadline passes before
        dispatch fails with :class:`DeadlineExceeded`.

        ``session`` is the slot-cache session id: with the engine's
        device slot cache enabled the row's carry is gathered from /
        scattered to the session's device slot (``carry``, if given, is
        only the SEED for a session not yet resident — the failover
        re-pin path — and the Decision row comes back with
        ``carry=None`` because carry never left the device).  Without a
        slot cache ``session`` is ignored and the host-carry semantics
        above apply bitwise unchanged.

        Raises :class:`BatcherClosedError` after close()/drain(), and
        :class:`ShedError` when the queue is full under the ``reject``
        shed policy (under ``evict_oldest`` the OLDEST queued request's
        future fails instead and this one is admitted)."""
        if (
            self.engine.recurrent
            and carry is None
            and getattr(self.engine, "slot_cache", None) is None
        ):
            # host-carry path: fresh sessions start from the initial
            # carry, pre-filled here so the dispatch can stack blindly.
            # In slot mode a None carry stays None — the device INITIAL
            # row (sessionless) or the session's slot is authoritative.
            carry = self.engine.initial_carry()
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        t_enqueue = time.perf_counter()
        pending = _Pending(
            _row(obs_row, self.engine.obs_dtype),
            carry,
            Future(),
            t_enqueue,
            None if deadline_ms is None else t_enqueue + float(deadline_ms) / 1e3,
            None if session is None else str(session),
        )
        evicted: Optional[_Pending] = None
        with self._cv:
            if self._closed:
                raise BatcherClosedError("MicroBatcher is closed")
            if self._draining:
                raise BatcherClosedError(
                    "MicroBatcher is draining: admissions closed"
                )
            if (
                self.max_queue is not None
                and len(self._pending) >= self.max_queue
            ):
                self.shed_count += 1
                if self.shed_policy == "evict_oldest":
                    evicted = self._pending.popleft()
                else:
                    if self._instr is not None:
                        self._instr.on_shed("queue_full")
                    raise ShedError(
                        f"request queue full ({self.max_queue}); request "
                        "rejected (shed_policy=reject)",
                        reason="queue_full",
                    )
            self._pending.append(pending)
            self._cv.notify_all()
        if evicted is not None:
            if self._instr is not None:
                self._instr.on_shed("evicted")
            _resolve_exc(
                evicted.future,
                ShedError(
                    f"evicted from a full queue ({self.max_queue}) by a "
                    "newer request (shed_policy=evict_oldest)",
                    reason="evicted",
                ),
            )
        return pending.future

    @property
    def records(self) -> List[RequestRecord]:
        with self._cv:
            return list(self._records)

    def health(self) -> Dict[str, Any]:
        """Point-in-time serving health: queue pressure, breaker state
        and the overload counters (a supervisor's poll surface)."""
        now = time.perf_counter()
        with self._cv:
            out = {
                "queue_depth": len(self._pending),
                "inflight_requests": self._inflight,
                "oldest_request_age_s": (
                    now - self._pending[0].t_enqueue if self._pending else 0.0
                ),
                "breaker_state": (
                    None if self.breaker is None else self.breaker.state
                ),
                "shed_count": self.shed_count,
                "deadline_miss_count": self.deadline_miss_count,
                "dispatch_failures": self.dispatch_failures,
                "breaker_open_failures": self.breaker_open_count,
                "deferred_count": self.deferred_count,
                "pipeline": self.pipeline,
                "dispatches": self.dispatches,
                "coalesced_total": self.coalesced_total,
                "max_queue": self.max_queue,
                "draining": self._draining,
                "paused": self._paused,
                "closed": self._closed,
            }
        # with telemetry attached, fold the rolling SLO window in: the
        # numbers /metrics exposes
        if self._instr is not None and self._instr.slo is not None:
            out["slo"] = self._instr.slo.rates()
        return out

    def pause(self, timeout: Optional[float] = None) -> bool:
        """Hold the worker at the next micro-batch boundary.

        Returns True once the worker is provably parked: it has finished
        any in-flight dispatch and is waiting BEFORE picking up the next
        request — queued requests stay queued (no loss, no failure), and
        admissions stay open.  The deployer flips ``self.engine`` inside
        a pause()/resume() bracket so the flip can never race the
        worker's pickup loop.

        Bounded: with ``timeout`` (seconds) a pause that cannot park the
        worker in time is rolled back (the queue keeps moving) and False
        is returned.  ``timeout=None`` waits forever.  Raises
        :class:`BatcherClosedError` on a closed batcher; pausing an
        already-paused batcher returns True immediately."""
        end = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            if self._closed or self._stop:
                raise BatcherClosedError("cannot pause a closed MicroBatcher")
            self._paused = True
            self._cv.notify_all()
            while not self._parked:
                if self._stop:
                    self._paused = False
                    return False
                if end is None:
                    self._cv.wait()
                else:
                    remaining = end - time.perf_counter()
                    if remaining <= 0:
                        # failed pause must not wedge the queue
                        self._paused = False
                        self._cv.notify_all()
                        return False
                    self._cv.wait(remaining)
            return True

    def resume(self) -> None:
        """Release a pause(); the worker re-checks the queue immediately.
        Idempotent — resuming a batcher that is not paused is a no-op."""
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    # how long drain() waits for a concurrent resume() before deciding a
    # paused batcher with queued work is a deadlock, not a flush in
    # progress (tests shrink this on the instance)
    paused_drain_grace_s: float = 5.0

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown, phase 1: stop admissions (submit raises
        :class:`BatcherClosedError`) and wait for the queued + in-flight
        work to flush through the engine.  Returns True when fully
        drained within ``timeout`` seconds (None = wait forever); the
        caller then calls :meth:`close` for phase 2.

        A drain while ``pause()``d cannot make progress — the worker is
        parked at the micro-batch boundary and queued requests stay
        queued forever.  Instead of waiting on that parked worker
        (``timeout=None`` used to hang here), the drain waits a bounded
        grace (``min(timeout, paused_drain_grace_s)``) for a concurrent
        ``resume()`` and then raises :class:`DrainWhilePausedError`."""
        end = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            paused_end: Optional[float] = None
            while self._pending or self._inflight:
                if self._stop:
                    break
                now = time.perf_counter()
                if self._paused and self._pending:
                    if paused_end is None:
                        paused_end = now + self.paused_drain_grace_s
                        if end is not None:
                            paused_end = min(paused_end, end)
                    if now >= paused_end:
                        raise DrainWhilePausedError(
                            "drain() while paused: the worker is parked "
                            "at the micro-batch boundary and "
                            f"{len(self._pending)} queued request(s) "
                            "cannot flush; resume() before draining"
                        )
                    self._cv.wait(paused_end - now)
                    continue
                paused_end = None
                if end is None:
                    self._cv.wait()
                else:
                    remaining = end - now
                    if remaining <= 0:
                        return False
                    self._cv.wait(remaining)
            return not self._pending and not self._inflight

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop the worker and FAIL every request still queued with
        :class:`BatcherClosedError` — a closed batcher never leaves a
        caller blocked on ``future.result()``.  Bounded by at most one
        in-flight dispatch; idempotent.

        ``timeout`` bounds the worker join: a wedged dispatch (stalled
        engine) cannot block the close — queued requests are failed
        immediately and the daemon worker exits whenever its dispatch
        finally returns (the fleet's kill path relies on this)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout)
        with self._cv:
            leftovers = list(self._pending)
            self._pending.clear()
        for p in leftovers:
            _resolve_exc(
                p.future,
                BatcherClosedError(
                    "MicroBatcher closed with the request still queued"
                ),
            )

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def _take(self, timeout: Optional[float]) -> Optional[_Pending]:
        """Pop the oldest LIVE request; requests already past their
        deadline are failed here (the pickup check) and skipped.
        Returns None on stop or timeout."""
        end = None if timeout is None else time.perf_counter() + timeout
        while True:
            expired: Optional[_Pending] = None
            with self._cv:
                while True:
                    if self._stop:
                        return None
                    # park point: only the OUTER pickup (timeout=None,
                    # i.e. between micro-batches) honors pause — the
                    # window-coalescing takes keep the current batch
                    # intact so a pause can never split or drop it
                    if end is None and self._paused:
                        self._parked = True
                        self._cv.notify_all()
                        self._cv.wait()
                        self._parked = False
                        continue
                    if self._pending:
                        break
                    if end is None:
                        self._cv.wait()
                    else:
                        remaining = end - time.perf_counter()
                        if remaining <= 0:
                            return None
                        self._cv.wait(remaining)
                p = self._pending.popleft()
                self._cv.notify_all()
                if (
                    p.deadline is not None
                    and time.perf_counter() > p.deadline
                ):
                    self.deadline_miss_count += 1
                    expired = p
                else:
                    return p
            if self._instr is not None:
                self._instr.on_deadline_miss("pickup")
            _resolve_exc(
                expired.future,
                DeadlineExceeded(
                    "deadline passed while queued (expired at pickup)",
                    phase="pickup",
                ),
            )

    def _run(self) -> None:
        while True:
            first = self._take(None)
            if first is None:  # stop requested; close() fails the rest
                return
            with self._cv:
                self._inflight += 1
            try:
                t_pickup = time.perf_counter()
                batch = [first]
                window_end = t_pickup + self.max_batch_wait_ms / 1000.0
                while len(batch) < self.max_batch:
                    remaining = window_end - time.perf_counter()
                    if remaining <= 0:
                        break
                    nxt = self._take(remaining)
                    if nxt is None:  # window closed (or stop: seen above)
                        break
                    batch.append(nxt)
                # dispatch-time deadline check: a request that expired
                # while the window was open must not occupy a batch slot
                now = time.perf_counter()
                live: List[_Pending] = []
                n_expired = 0
                for p in batch:
                    if p.deadline is not None and now > p.deadline:
                        n_expired += 1
                        _resolve_exc(
                            p.future,
                            DeadlineExceeded(
                                "deadline passed inside the batching "
                                "window (expired at dispatch)",
                                phase="dispatch",
                            ),
                        )
                    else:
                        live.append(p)
                if n_expired:
                    with self._cv:
                        self.deadline_miss_count += n_expired
                    if self._instr is not None:
                        self._instr.on_deadline_miss("dispatch", n_expired)
                live = self._defer_conflicts(live)
                if live:
                    self._dispatch(live, t_pickup)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    @staticmethod
    def _slot_row(p: _Pending) -> bool:
        # slot-eligible: has a session (slot/seed semantics) or carries
        # nothing (computes from the device INITIAL row — bitwise the
        # initial carry in exact mode).  A sessionless row with an
        # explicit carry must ride the host path: slots cannot honor it.
        return p.session is not None or p.carry is None

    def _defer_conflicts(self, batch: List[_Pending]) -> List[_Pending]:
        """Slot-mode batch admission: requeue (at the FRONT, order
        preserved) rows that cannot share this dispatch — a duplicate
        session (its decisions are serial by contract), sessions beyond
        the slot capacity, rows past the ladder's largest bucket (the
        slot path never chunks), or rows of the other carry style when
        the batch mixes slot and host rows.  A no-op without the slot
        cache — the host path dispatches every batch exactly as before.
        """
        engine = self.engine
        cache = getattr(engine, "slot_cache", None)
        if cache is None or not engine.recurrent or not batch:
            return batch
        largest = int(engine.buckets[-1])
        style_slot = self._slot_row(batch[0])
        keep: List[_Pending] = []
        defer: List[_Pending] = []
        seen: set = set()
        for p in batch:
            if self._slot_row(p) != style_slot or len(keep) >= largest:
                defer.append(p)
                continue
            if style_slot and p.session is not None:
                if p.session in seen or len(seen) >= cache.slots:
                    defer.append(p)
                    continue
                seen.add(p.session)
            keep.append(p)
        if defer:
            with self._cv:
                self._pending.extendleft(reversed(defer))
                self.deferred_count += len(defer)
                self._cv.notify_all()
        return keep

    def _dispatch(self, batch: List[_Pending], t_pickup: float) -> None:
        # one engine read per dispatch: the deployer may retarget
        # self.engine between micro-batches (under pause()), and a batch
        # must see exactly one engine end-to-end
        engine = self.engine
        n = len(batch)
        if self.breaker is not None:
            try:
                self.breaker.allow()
            except CircuitOpenError as exc:
                # fail fast while the engine is (presumed) down — the
                # queue must not build behind a dead dependency
                with self._cv:
                    self.breaker_open_count += n
                if self._instr is not None:
                    self._instr.on_breaker_open(n)
                for p in batch:
                    _resolve_exc(p.future, exc)
                return
        obs = torch.stack([p.obs for p in batch])
        use_slots = (
            getattr(engine, "slot_cache", None) is not None
            and engine.recurrent
            and all(self._slot_row(p) for p in batch)
        )
        carries = (
            _stack_carries([p.carry for p in batch])
            if engine.recurrent and not use_slots
            else None
        )
        t_dispatch = time.perf_counter()
        try:
            if use_slots:
                out = engine.decide_batch_slots(
                    obs,
                    [p.session for p in batch],
                    seed_carries=[p.carry for p in batch],
                )
            else:
                out = engine.decide_batch(obs, carries)
        except BaseException as exc:
            # resolve every waiter with the fault and KEEP SERVING: one
            # poisoned dispatch must not stall the whole queue (the
            # breaker is what escalates repeated failures)
            if self.breaker is not None:
                self.breaker.record_failure()
            with self._cv:
                self.dispatch_failures += 1
            if self._instr is not None:
                self._instr.on_dispatch_failure(n)
            for p in batch:
                _resolve_exc(p.future, exc)
            return
        if self.breaker is not None:
            self.breaker.record_success()
        t_done = time.perf_counter()
        bucket = engine.bucket_for(n)
        for i, p in enumerate(batch):
            _resolve_result(
                p.future,
                type(out)(
                    out.action[i],
                    out.value[i],
                    out.actor_out[i],
                    tree_map(lambda x: x[i], out.carry)
                    if engine.recurrent and out.carry is not None
                    else out.carry,
                ),
            )
        rows = [
            RequestRecord(p.t_enqueue, t_pickup, t_dispatch, t_done, n, bucket)
            for p in batch
        ]
        with self._cv:
            self.dispatches += 1
            self.coalesced_total += n
            if len(self._records) + n <= self._records_cap:
                self._records.extend(rows)
        if self._instr is not None:
            self._instr.on_batch_complete(rows)

    # ------------------------------------------------------------------
    # pipelined dispatch (pipeline=True): overlap host batch assembly
    # with the replay of the PREVIOUS batch on the card.  The worker
    # issues batch N+1 through engine.dispatch_async (which returns as
    # soon as the replay is enqueued on the engine's stream) and
    # only then resolves batch N's outputs.  Depth is exactly one: at
    # most one unresolved dispatch exists, which is what makes the
    # engine's double-buffered pinned staging safe, and the worker only parks for pause() with nothing in
    # flight — the deployer's flip/adopt contract is unchanged.
    def _run_pipelined(self) -> None:
        pending: Optional[_Inflight] = None
        while True:
            # a requested pause drains the pipeline first: the worker
            # must reach the park point with nothing unresolved, and
            # under sustained load the poll below would never block
            if pending is not None and self._paused:
                self._resolve_async(pending)
                pending = None
            # with a dispatch in flight, poll instead of block so the
            # idle path resolves it promptly; _take(None) is the only
            # park point, reached with nothing unresolved
            first = self._take(None if pending is None else 0.0)
            if first is None:
                if pending is not None:
                    self._resolve_async(pending)
                    pending = None
                    continue  # re-check: stop vs merely-empty queue
                return  # stop requested; close() fails the rest
            with self._cv:
                self._inflight += 1
            dispatched = False
            try:
                t_pickup = time.perf_counter()
                batch = [first]
                window_end = t_pickup + self.max_batch_wait_ms / 1000.0
                while len(batch) < self.max_batch:
                    remaining = window_end - time.perf_counter()
                    if remaining <= 0:
                        break
                    nxt = self._take(remaining)
                    if nxt is None:
                        break
                    batch.append(nxt)
                now = time.perf_counter()
                live: List[_Pending] = []
                n_expired = 0
                for p in batch:
                    if p.deadline is not None and now > p.deadline:
                        n_expired += 1
                        _resolve_exc(
                            p.future,
                            DeadlineExceeded(
                                "deadline passed inside the batching "
                                "window (expired at dispatch)",
                                phase="dispatch",
                            ),
                        )
                    else:
                        live.append(p)
                if n_expired:
                    with self._cv:
                        self.deadline_miss_count += n_expired
                    if self._instr is not None:
                        self._instr.on_deadline_miss("dispatch", n_expired)
                live = self._defer_conflicts(live)
                if live:
                    handle = self._dispatch_async(live, t_pickup)
                    if handle is not None:
                        dispatched = True
                        # previous batch resolves AFTER the next one is
                        # already running on device — the overlap
                        if pending is not None:
                            self._resolve_async(pending)
                        pending = handle
            finally:
                if not dispatched:
                    # the batch resolved synchronously (expired, fully
                    # deferred, breaker-open, or dispatch fault) — this
                    # iteration holds nothing in flight
                    with self._cv:
                        self._inflight -= 1
                        self._cv.notify_all()

    def _dispatch_async(
        self, batch: List[_Pending], t_pickup: float
    ) -> Optional[_Inflight]:
        """Issue one micro-batch via ``engine.dispatch_async``; returns
        the in-flight record, or None when the batch was fully resolved
        here (breaker open / dispatch fault).  The caller's _inflight
        slot transfers to the returned record — _resolve_async releases
        it."""

        engine = self.engine
        n = len(batch)
        if self.breaker is not None:
            try:
                self.breaker.allow()
            except CircuitOpenError as exc:
                with self._cv:
                    self.breaker_open_count += n
                if self._instr is not None:
                    self._instr.on_breaker_open(n)
                for p in batch:
                    _resolve_exc(p.future, exc)
                return None
        obs = self._staged_obs(batch)
        use_slots = (
            getattr(engine, "slot_cache", None) is not None
            and engine.recurrent
            and all(self._slot_row(p) for p in batch)
        )
        t_dispatch = time.perf_counter()
        try:
            if use_slots:
                handle = engine.dispatch_async(
                    obs,
                    sessions=[p.session for p in batch],
                    seed_carries=[p.carry for p in batch],
                )
            else:
                carries = (
                    _stack_carries([p.carry for p in batch])
                    if engine.recurrent
                    else None
                )
                handle = engine.dispatch_async(obs, carries)
        except BaseException as exc:
            if self.breaker is not None:
                self.breaker.record_failure()
            with self._cv:
                self.dispatch_failures += 1
            if self._instr is not None:
                self._instr.on_dispatch_failure(n)
            for p in batch:
                _resolve_exc(p.future, exc)
            return None
        return _Inflight(handle, batch, engine, t_pickup, t_dispatch)

    def _staged_obs(self, batch: List[_Pending]) -> torch.Tensor:
        """Assemble the batch's obs rows into a reusable double-buffered
        staging tensor instead of a fresh torch.stack per dispatch.  Two
        buffers alternate per dispatch; with pipeline depth one a buffer
        is never rewritten before the dispatch that read it resolved."""
        engine = self.engine
        shape = (self.max_batch, *engine.obs_shape)
        bufs = getattr(self, "_obs_bufs", None)
        if bufs is None or bufs[0].shape != shape:
            bufs = [torch.empty(shape, dtype=engine.obs_dtype) for _ in range(2)]
            self._obs_bufs = bufs
            self._obs_flip = 0
        self._obs_flip ^= 1
        buf = bufs[self._obs_flip]
        for i, p in enumerate(batch):
            buf[i] = p.obs
        return buf[: len(batch)]

    def _resolve_async(self, inf: _Inflight) -> None:
        """Materialize one in-flight micro-batch: resolve the engine
        handle (one wait on its event; slot mode also folds the carry
        mirror update in), fan the rows out to their futures, and release
        the _inflight slot."""
        engine = inf.engine
        batch = inf.batch
        n = len(batch)
        try:
            out = inf.handle.resolve()
        except BaseException as exc:
            if self.breaker is not None:
                self.breaker.record_failure()
            with self._cv:
                self.dispatch_failures += 1
                self._inflight -= 1
                self._cv.notify_all()
            if self._instr is not None:
                self._instr.on_dispatch_failure(n)
            for p in batch:
                _resolve_exc(p.future, exc)
            return
        if self.breaker is not None:
            self.breaker.record_success()
        t_done = time.perf_counter()
        bucket = engine.bucket_for(n)
        for i, p in enumerate(batch):
            _resolve_result(
                p.future,
                type(out)(
                    out.action[i],
                    out.value[i],
                    out.actor_out[i],
                    tree_map(lambda x: x[i], out.carry)
                    if engine.recurrent and out.carry is not None
                    else out.carry,
                ),
            )
        rows = [
            RequestRecord(
                p.t_enqueue, inf.t_pickup, inf.t_dispatch, t_done, n, bucket
            )
            for p in batch
        ]
        with self._cv:
            self.dispatches += 1
            self.coalesced_total += n
            if len(self._records) + n <= self._records_cap:
                self._records.extend(rows)
            self._inflight -= 1
            self._cv.notify_all()
        if self._instr is not None:
            self._instr.on_batch_complete(rows)


def _resolve_exc(future: Future, exc: BaseException) -> None:
    try:
        future.set_exception(exc)
    except InvalidStateError:  # caller cancelled the future; nothing owed
        pass


def _resolve_result(future: Future, result: Any) -> None:
    try:
        future.set_result(result)
    except InvalidStateError:
        pass


def batcher_from_config(engine, config, *, instruments=None) -> MicroBatcher:
    """Build an admission-controlled batcher from the merged config dict
    (or an already-parsed :class:`~gymfx_tpu_torch.serve.config.ServeConfig`),
    including the serving circuit breaker when
    ``serve_breaker_threshold`` > 0, and ``instruments`` (telemetry/
    instruments.ServeInstruments, or None).  The fleet
    (``serve_fleet_replicas`` > 0, ROADMAP.md Queue 1 item 16) and the
    performance observatory's keys (item 30) raise."""
    from gymfx_tpu_torch.resilience.retry import CircuitBreaker
    from gymfx_tpu_torch.serve.config import ServeConfig, serve_config_from
    from gymfx_tpu_torch.serve.engine import check_serving_config

    if isinstance(config, ServeConfig):
        scfg = config
    else:
        check_serving_config(config)
        scfg = serve_config_from(config)
    breaker = None
    if scfg.breaker_threshold:
        breaker = CircuitBreaker(scfg.breaker_threshold, scfg.breaker_recovery_s)
    return MicroBatcher(
        engine,
        max_batch_wait_ms=scfg.max_batch_wait_ms,
        max_queue=scfg.max_queue,
        shed_policy=scfg.shed_policy,
        default_deadline_ms=scfg.deadline_ms,
        breaker=breaker,
        instruments=instruments,
        # pipelined assembly rides the slot knob: without device slots
        # the worker loop is the synchronous one
        pipeline=bool(scfg.session_slots > 0 and scfg.staging),
    )


def _row(obs_row: Any, dtype) -> torch.Tensor:
    """One observation row as a host tensor of the engine's dtype."""
    if not isinstance(obs_row, torch.Tensor):
        obs_row = torch.as_tensor(np.asarray(obs_row))
    return obs_row.detach().to("cpu", dtype)


def _stack_carries(carries: List[Any]) -> Any:
    """Per-request carries (trees of host tensors or arrays) stacked
    leaf by leaf on a new leading axis."""
    return tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]), *carries)
