"""The port's micro-batcher (gymfx_tpu_torch/serve/batcher.py) and
retry/breaker (gymfx_tpu_torch/resilience/retry.py) on the CPU.

* Micro-batching on the port's engine: a burst coalesces into one
  dispatch whose answers equal ``decide_batch`` on the same rows
  (``torch.equal``), a full bucket closes the window early, the window
  bound holds per request, recurrent carries stream through the
  futures, concurrent clients all resolve, and the synchronous and
  pipelined loops give the same answers; slot sessions through the
  pipelined loop keep their serial order.
* Admission and overload, through a stub engine, with the semantics of
  tests/test_serve_overload.py and tests/test_serve_batcher.py: shed
  (reject, evict_oldest), deadlines (at pickup, in the window), close,
  drain, the breaker (its recovery window on an injected clock), a
  dispatch fault, health, pause / resume / drain-while-paused, and
  ``batcher_from_config``.
* retry.py: ``RetryPolicy.delay``, ``retry_call`` (with an injected
  sleep) and ``CircuitBreaker`` (on an injected clock) take the same
  transitions as the JAX package's on the same scripted calls.
"""
import random
import threading
import time

import numpy as np
import pytest
import torch

from gymfx_tpu.resilience import retry as jax_retry

from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.resilience import retry
from gymfx_tpu_torch.resilience.retry import CircuitBreaker, CircuitOpenError
from gymfx_tpu_torch.serve import (
    OVERLOAD_ERRORS,
    BatcherClosedError,
    DeadlineExceeded,
    Decision,
    DrainWhilePausedError,
    MicroBatcher,
    ShedError,
    batcher_from_config,
)
from gymfx_tpu_torch.serve.overload import resolve_fallback_policy, resolve_shed_policy

from test_torch_serve_engine import _build, _rows

OBS_DIM = 6
TIMEOUT = 30


class FakeEngine:
    """Batcher test double: action = row index, value = row sum; ``gate``
    holds dispatch until released and ``fail_next`` raises, so queue
    states are reproducible without timing races."""

    recurrent = False
    obs_dtype = torch.float32
    obs_shape = (OBS_DIM,)
    buckets = (1, 8)

    def __init__(self):
        self.gate = threading.Event()
        self.gate.set()
        self.fail_next = 0
        self.dispatch_count = 0

    def bucket_for(self, n):
        return next((b for b in self.buckets if b >= n), self.buckets[-1])

    def initial_carry(self):
        return None

    def decide_batch(self, obs, carries=None):
        self.dispatch_count += 1
        self.gate.wait(timeout=TIMEOUT)
        if self.fail_next > 0:
            self.fail_next -= 1
            raise RuntimeError("injected engine fault")
        n = len(obs)
        return Decision(torch.arange(n, dtype=torch.int32), obs.sum(dim=1),
                        torch.zeros(n), ())


def _obs(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, OBS_DIM)).astype(np.float32)


def _blocked_batcher(**kw):
    """A batcher whose first dispatch is held at the engine's gate."""
    eng = FakeEngine()
    eng.gate.clear()
    mb = MicroBatcher(eng, max_batch_wait_ms=0.0, **kw)
    f0 = mb.submit(_obs(1)[0])
    end = time.perf_counter() + 5.0
    while eng.dispatch_count == 0:
        assert time.perf_counter() < end, "worker never reached dispatch"
        time.sleep(0.001)
    return eng, mb, f0


# ---- micro-batching on the engine --------------------------------------------
def test_burst_coalesces_into_one_dispatch_with_exact_results():
    _j, eng, _jp, _ref, rng = _build("mlp", jax_engine=False)
    obs = _rows(rng, eng, 6)
    want = eng.decide_batch(obs)
    with MicroBatcher(eng, max_batch_wait_ms=250.0) as mb:
        futs = [mb.submit(obs[i]) for i in range(6)]
        got = [f.result(timeout=TIMEOUT) for f in futs]
    assert mb.dispatches == 1 and mb.coalesced_total == 6
    for i, d in enumerate(got):
        assert torch.equal(d.actor_out, want.actor_out[i]), i
        assert torch.equal(d.value, want.value[i]) and int(d.action) == int(want.action[i])
    assert all(r.batch_size == 6 and r.bucket == 8 for r in mb.records)


def test_full_bucket_closes_the_window_early():
    _j, eng, _jp, _ref, rng = _build("mlp", buckets=(1, 4), jax_engine=False)
    obs = _rows(rng, eng, 4)
    with MicroBatcher(eng, max_batch_wait_ms=60_000.0, max_batch=4) as mb:
        t0 = time.perf_counter()
        for f in [mb.submit(obs[i]) for i in range(4)]:
            f.result(timeout=TIMEOUT)
        assert time.perf_counter() - t0 < TIMEOUT
    assert mb.dispatches == 1


def test_queue_wait_bound_holds_per_request():
    _j, eng, _jp, _ref, rng = _build("mlp", jax_engine=False)
    obs = _rows(rng, eng, 12)
    with MicroBatcher(eng, max_batch_wait_ms=20.0) as mb:
        for f in [mb.submit(obs[i]) for i in range(12)]:
            f.result(timeout=TIMEOUT)
        records = mb.records
    assert len(records) == 12
    for r in records:
        assert r.t_dispatch - r.t_pickup <= 0.020 + 0.25, r
        assert 0.0 <= r.queue_wait_s <= r.latency_s


def test_recurrent_sessions_stream_carry_through_futures():
    _j, eng, _jp, ref, rng = _build("lstm", buckets=(1, 4), jax_engine=False)
    obs = _rows(rng, eng, 3)
    carry, host = None, eng.initial_carry_batch(1)
    with MicroBatcher(eng, max_batch_wait_ms=1.0) as mb:
        for t in range(3):
            d = mb.submit(obs[t], carry).result(timeout=TIMEOUT)
            want = eng.decide_batch(obs[t:t + 1], host)
            assert torch.equal(d.actor_out, want.actor_out[0]), t
            assert all(torch.equal(a, b[0]) for a, b in zip(d.carry, want.carry)), t
            carry, host = d.carry, want.carry
    assert eng.late_compiles == 0


@pytest.mark.parametrize("pipeline", [False, True])
def test_concurrent_clients_resolve_to_decide_batch(pipeline):
    _j, eng, _jp, _ref, rng = _build("mlp", jax_engine=False)
    obs = _rows(rng, eng, 16)
    want = eng.decide_batch(obs)
    results = {}
    with MicroBatcher(eng, max_batch_wait_ms=5.0, pipeline=pipeline) as mb:
        def client(i):
            for j in range(3):
                results[(i, j)] = mb.submit(obs[(i + j) % 16]).result(timeout=TIMEOUT)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert mb.health()["pipeline"] is pipeline
    assert len(results) == 48 and mb.coalesced_total == 48
    for (i, j), d in results.items():
        assert torch.equal(d.actor_out, want.actor_out[(i + j) % 16]), (i, j)


def test_pipelined_batcher_defers_duplicate_sessions_and_keeps_their_order():
    _j, eng, _jp, _ref, rng = _build("lstm", jax_engine=False)
    eng.enable_slots(4)
    mb = MicroBatcher(eng, max_batch_wait_ms=20.0, pipeline=True)
    try:
        assert mb.pause(timeout=TIMEOUT)
        row = _rows(rng, eng, 1)[0]
        f1, f2 = mb.submit(row, session="dup"), mb.submit(row, session="dup")
        f3 = mb.submit(row)  # sessionless: the initial carry, no state kept
        mb.resume()
        d1, d2, d3 = (f.result(timeout=TIMEOUT) for f in (f1, f2, f3))
        assert mb.deferred_count >= 1 and d1.carry is None
        h1 = eng.decide_batch(row[None], eng.initial_carry_batch(1))
        h2 = eng.decide_batch(row[None], h1.carry)
        assert torch.equal(d1.actor_out, h1.actor_out[0])
        assert torch.equal(d2.actor_out, h2.actor_out[0])
        assert torch.equal(d3.actor_out, h1.actor_out[0])
    finally:
        mb.close(timeout=TIMEOUT)


def test_close_rejects_new_submits_and_validates_args():
    eng = FakeEngine()
    mb = MicroBatcher(eng, max_batch_wait_ms=1.0)
    mb.close()
    mb.close()  # idempotent
    with pytest.raises(BatcherClosedError, match="closed"):
        mb.submit(np.zeros(OBS_DIM, np.float32))
    with pytest.raises(ValueError, match="max_batch_wait_ms"):
        MicroBatcher(eng, max_batch_wait_ms=-1.0)
    with pytest.raises(ValueError, match="max_batch"):
        MicroBatcher(eng, max_batch=0)
    with pytest.raises(ValueError, match="max_queue"):
        MicroBatcher(eng, max_queue=0)
    with pytest.raises(ValueError, match="default_deadline_ms"):
        MicroBatcher(eng, default_deadline_ms=0.0)
    # instruments bind to the batcher (telemetry/instruments.ServeInstruments;
    # tests/test_torch_telemetry.py drives them)
    with pytest.raises(AttributeError, match="bind_batcher"):
        MicroBatcher(eng, instruments=object())


# ---- admission and overload -----------------------------------------------
def test_reject_policy_sheds_newest_with_typed_error():
    eng, mb, f0 = _blocked_batcher(max_queue=2)
    rows = _obs(3, seed=1)
    f1, f2 = mb.submit(rows[0]), mb.submit(rows[1])
    with pytest.raises(ShedError) as exc:
        mb.submit(rows[2])
    assert exc.value.reason == "queue_full"
    eng.gate.set()
    for f in (f0, f1, f2):
        assert isinstance(f.result(timeout=TIMEOUT), Decision)
    assert mb.health()["shed_count"] == 1
    mb.close()


def test_evict_oldest_fails_the_victims_future():
    eng, mb, f0 = _blocked_batcher(max_queue=2, shed_policy="evict_oldest")
    rows = _obs(3, seed=2)
    f1, f2, f3 = (mb.submit(r) for r in rows)
    with pytest.raises(ShedError) as exc:
        f1.result(timeout=TIMEOUT)
    assert exc.value.reason == "evicted"
    eng.gate.set()
    d2, d3 = f2.result(timeout=TIMEOUT), f3.result(timeout=TIMEOUT)
    assert float(d2.value) == pytest.approx(float(rows[1].sum()), rel=1e-6)
    assert float(d3.value) == pytest.approx(float(rows[2].sum()), rel=1e-6)
    assert mb.shed_count == 1
    mb.close()


def test_deadline_expires_at_pickup_while_queued():
    eng, mb, f0 = _blocked_batcher()
    f1 = mb.submit(_obs(1, seed=3)[0], deadline_ms=1.0)
    time.sleep(0.03)
    eng.gate.set()
    with pytest.raises(DeadlineExceeded) as exc:
        f1.result(timeout=TIMEOUT)
    assert exc.value.phase == "pickup"
    assert isinstance(f0.result(timeout=TIMEOUT), Decision)
    assert mb.deadline_miss_count == 1
    mb.close()


def test_deadline_expires_inside_the_batching_window():
    eng = FakeEngine()
    with MicroBatcher(eng, max_batch_wait_ms=60.0, max_batch=8) as mb:
        fut = mb.submit(_obs(1, seed=4)[0], deadline_ms=10.0)
        with pytest.raises(DeadlineExceeded) as exc:
            fut.result(timeout=TIMEOUT)
        assert exc.value.phase == "dispatch"
        assert mb.deadline_miss_count == 1 and eng.dispatch_count == 0


def test_close_fails_queued_futures_instead_of_hanging():
    eng, mb, f0 = _blocked_batcher()
    rows = _obs(2, seed=5)
    f1, f2 = mb.submit(rows[0]), mb.submit(rows[1])
    closer = threading.Thread(target=mb.close)
    closer.start()
    eng.gate.set()
    closer.join(timeout=TIMEOUT)
    assert not closer.is_alive()
    assert isinstance(f0.result(timeout=TIMEOUT), Decision)
    for f in (f1, f2):
        with pytest.raises(BatcherClosedError):
            f.result(timeout=TIMEOUT)
    with pytest.raises(BatcherClosedError):
        mb.submit(rows[0])


def test_drain_flushes_then_blocks_admissions():
    eng = FakeEngine()
    mb = MicroBatcher(eng, max_batch_wait_ms=1.0)
    futs = [mb.submit(r) for r in _obs(5, seed=6)]
    assert mb.drain(timeout=TIMEOUT) is True
    for f in futs:
        assert isinstance(f.result(timeout=1), Decision)
    with pytest.raises(BatcherClosedError, match="draining"):
        mb.submit(_obs(1)[0])
    assert mb.health()["draining"] is True
    mb.close()


def test_breaker_trips_then_fails_fast_and_recovers_on_its_clock():
    now = [0.0]
    eng = FakeEngine()
    eng.fail_next = 2
    breaker = CircuitBreaker(2, recovery_time=5.0, clock=lambda: now[0])
    with MicroBatcher(eng, max_batch_wait_ms=0.0, breaker=breaker) as mb:
        rows = _obs(4, seed=7)
        for i in range(2):
            with pytest.raises(RuntimeError, match="injected"):
                mb.submit(rows[i]).result(timeout=TIMEOUT)
        assert breaker.state == "open"
        with pytest.raises(CircuitOpenError):
            mb.submit(rows[2]).result(timeout=TIMEOUT)
        assert mb.health()["breaker_state"] == "open"
        assert mb.dispatch_failures == 2 and mb.breaker_open_count == 1
        now[0] = 5.0  # the recovery window passed: the next dispatch is the probe
        assert breaker.state == "half_open"
        assert isinstance(mb.submit(rows[3]).result(timeout=TIMEOUT), Decision)
        assert breaker.state == "closed"


def test_worker_survives_dispatch_exception_and_keeps_serving():
    eng = FakeEngine()
    eng.fail_next = 1
    with MicroBatcher(eng, max_batch_wait_ms=0.0) as mb:
        rows = _obs(2, seed=8)
        with pytest.raises(RuntimeError, match="injected"):
            mb.submit(rows[0]).result(timeout=TIMEOUT)
        assert isinstance(mb.submit(rows[1]).result(timeout=TIMEOUT), Decision)
        assert mb.dispatch_failures == 1


def test_health_surface_keys_and_oldest_age():
    eng, mb, f0 = _blocked_batcher(max_queue=4)
    mb.submit(_obs(1, seed=9)[0])
    h = mb.health()
    for key in ("queue_depth", "inflight_requests", "oldest_request_age_s", "breaker_state",
                "shed_count", "deadline_miss_count", "dispatch_failures",
                "breaker_open_failures", "deferred_count", "pipeline", "dispatches",
                "coalesced_total", "max_queue", "draining", "paused", "closed"):
        assert key in h, key
    assert h["queue_depth"] == 1 and h["inflight_requests"] == 1
    assert h["oldest_request_age_s"] >= 0.0 and h["max_queue"] == 4
    eng.gate.set()
    mb.close()
    assert mb.health()["closed"] is True


def test_batcher_from_config_wires_admission_and_breaker():
    eng = FakeEngine()
    cfg = dict(DEFAULT_VALUES)
    cfg.update(serve_max_queue=7, serve_shed_policy="evict_oldest", serve_deadline_ms=250.0,
               serve_breaker_threshold=3, serve_breaker_recovery_s=1.5)
    mb = batcher_from_config(eng, cfg)
    try:
        assert (mb.max_queue, mb.shed_policy, mb.default_deadline_ms) == (7, "evict_oldest", 250.0)
        assert mb.breaker.failure_threshold == 3 and mb.breaker.recovery_time == 1.5
        assert mb.pipeline is False
    finally:
        mb.close()
    mb = batcher_from_config(eng, dict(DEFAULT_VALUES))
    try:
        assert mb.max_queue is None and mb.default_deadline_ms is None
        assert mb.breaker.failure_threshold == 5
    finally:
        mb.close()
    with pytest.raises(NotImplementedError, match="item 16"):
        batcher_from_config(eng, {**DEFAULT_VALUES, "serve_fleet_replicas": 1})
    # the serving telemetry runs (tests/test_torch_telemetry.py), and so do
    # the performance observatory's keys (tests/test_torch_observatory.py)
    mb = batcher_from_config(eng, {**DEFAULT_VALUES, "telemetry_profile_dir": "prof",
                                   "telemetry_compile_watch": True})
    mb.close()


def test_policy_validators_and_the_overload_set():
    assert resolve_shed_policy("reject") == "reject"
    assert resolve_fallback_policy("flat") == "flat"
    with pytest.raises(ValueError, match="shed_policy"):
        resolve_shed_policy("drop_everything")
    with pytest.raises(ValueError, match="fallback"):
        resolve_fallback_policy("panic")
    assert CircuitOpenError in OVERLOAD_ERRORS and ShedError in OVERLOAD_ERRORS


def test_pause_parks_the_worker_without_queue_loss_then_resume_flips_engine():
    eng, mb, f0 = _blocked_batcher()
    rows = _obs(2, seed=11)
    f1, f2 = mb.submit(rows[0]), mb.submit(rows[1])
    parked = {"ok": None}
    pauser = threading.Thread(target=lambda: parked.update(ok=mb.pause(timeout=TIMEOUT)))
    pauser.start()
    time.sleep(0.02)
    assert parked["ok"] is None
    eng.gate.set()
    pauser.join(timeout=TIMEOUT)
    assert parked["ok"] is True and isinstance(f0.result(timeout=TIMEOUT), Decision)
    h = mb.health()
    assert h["paused"] is True and h["queue_depth"] == 2
    assert not f1.done() and not f2.done()
    f3 = mb.submit(_obs(1, seed=12)[0])
    eng2 = FakeEngine()
    mb.engine = eng2
    mb.resume()
    for f in (f1, f2, f3):
        assert isinstance(f.result(timeout=TIMEOUT), Decision)
    assert eng2.dispatch_count > 0 and eng.dispatch_count == 1
    mb.close()


def test_pause_timeout_rolls_back_and_the_queue_keeps_moving():
    eng, mb, f0 = _blocked_batcher()
    assert mb.pause(timeout=0.05) is False
    assert mb.health()["paused"] is False
    eng.gate.set()
    assert isinstance(f0.result(timeout=TIMEOUT), Decision)
    assert isinstance(mb.submit(_obs(1, seed=13)[0]).result(timeout=TIMEOUT), Decision)
    mb.close()


def test_drain_while_paused_raises_typed_instead_of_hanging():
    mb = MicroBatcher(FakeEngine(), max_batch_wait_ms=0.0)
    assert mb.pause(timeout=TIMEOUT) is True
    mb.paused_drain_grace_s = 0.05
    fut = mb.submit(_obs(1, seed=15)[0])
    t0 = time.perf_counter()
    with pytest.raises(DrainWhilePausedError):
        mb.drain(timeout=TIMEOUT)
    assert time.perf_counter() - t0 < 5.0 and not fut.done()
    mb.resume()
    assert mb.drain(timeout=TIMEOUT) is True
    assert isinstance(fut.result(timeout=1), Decision)
    mb.close()


def test_pause_is_idempotent_drain_while_paused_and_empty_succeeds():
    mb = MicroBatcher(FakeEngine(), max_batch_wait_ms=0.0)
    assert mb.pause(timeout=TIMEOUT) is True and mb.pause(timeout=TIMEOUT) is True
    mb.paused_drain_grace_s = 0.05
    assert mb.drain(timeout=TIMEOUT) is True
    mb.resume()
    mb.resume()
    mb.close()
    with pytest.raises(BatcherClosedError):
        mb.pause(timeout=1)


# ---- retry.py against the JAX package's ---------------------------------------
def test_retry_policy_delays_match():
    for pol_args in ({}, {"base_delay": 0.1, "max_delay": 1.0, "jitter": 0.5}, {"jitter": 0.0}):
        ours, theirs = retry.RetryPolicy(**pol_args), jax_retry.RetryPolicy(**pol_args)
        r1, r2 = random.Random(5), random.Random(5)
        assert [ours.delay(k, r1) for k in range(8)] == [theirs.delay(k, r2) for k in range(8)]
        assert [ours.delay(k) for k in range(8)] == [theirs.delay(k) for k in range(8)]


def _scripted(module, script, budget=None, attempts=4):
    """retry_call over ``script`` (each entry an exception class to raise,
    or a result): (outcome, sleeps, retries seen, calls made)."""
    calls, sleeps, seen = [], [], []
    items = iter(script)

    def fn():
        item = next(items)
        calls.append(item)
        if isinstance(item, type) and issubclass(item, BaseException):
            raise item("scripted")
        return item

    try:
        out = module.retry_call(
            fn, policy=module.RetryPolicy(max_attempts=attempts),
            retry_on_exc=lambda e: isinstance(e, ConnectionError),
            retry_on_result=lambda r: r == 503, budget=budget, sleep=sleeps.append,
            rng=random.Random(1), on_retry=lambda k, last: seen.append((k, repr(last))))
    except BaseException as exc:  # noqa: BLE001 - the outcome is compared
        out = (type(exc).__name__, repr(getattr(exc, "last", None)))
    return out, sleeps, seen, len(calls)


RETRY_SCRIPTS = [
    [200],
    [ConnectionError, 503, 200],
    [ConnectionError, ConnectionError, ConnectionError, ConnectionError],
    [503, 503, 503, 503],
    [ConnectionError, ValueError],
]


@pytest.mark.parametrize("script", RETRY_SCRIPTS, ids=lambda s: "-".join(map(str, s)))
def test_retry_call_takes_the_jax_transitions(script):
    assert _scripted(retry, script) == _scripted(jax_retry, script)
    ours = _scripted(retry, script, budget=retry.RetryBudget(1))
    theirs = _scripted(jax_retry, script, budget=jax_retry.RetryBudget(1))
    assert ours == theirs


def _breaker_trace(module):
    now = [0.0]
    trips = []
    b = module.CircuitBreaker(3, recovery_time=10.0, clock=lambda: now[0],
                              on_trip=lambda: trips.append(now[0]))
    trace = []
    for t, op in [(0, "f"), (1, "f"), (2, "s"), (3, "f"), (4, "f"), (5, "f"), (6, "a"),
                  (15, "a"), (16, "a"), (16, "f"), (17, "a"), (30, "a"), (30, "s"),
                  (31, "a"), (32, "f")]:
        now[0] = float(t)
        if op == "a":
            try:
                b.allow()
                trace.append((t, "allowed", b.state))
            except module.CircuitOpenError:
                trace.append((t, "refused", b.state))
        elif op == "f":
            b.record_failure()
            trace.append((t, "fail", b.state, b.failures))
        else:
            b.record_success()
            trace.append((t, "ok", b.state, b.failures))
    return trace, trips, b.trip_count


def test_circuit_breaker_takes_the_jax_transitions():
    assert _breaker_trace(retry) == _breaker_trace(jax_retry)
    with pytest.raises(ValueError):
        CircuitBreaker(0)


def test_retry_budget_grants_exactly_its_tokens_across_threads():
    budget = retry.RetryBudget(50)
    granted = []

    def take():
        granted.extend(t for t in (budget.take() for _ in range(20)) if t)

    threads = [threading.Thread(target=take) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert len(granted) == 50 and budget.remaining == 0
    with pytest.raises(ValueError):
        retry.RetryBudget(-1)
