"""Deterministic fault injection: the port of
``gymfx_tpu/resilience/faults.py``.

Everything here is seeded and replayable: the same profile string
produces the same fault sequence on every run, so a chaos failure is a
plain red test, not a flake.

  FlakyTransport           wraps a live-path transport with a scripted
                           fault plan (timeouts, connection drops, 5xx,
                           accept-then-fail, truncated bodies);
  FlakyEngine              wraps a serving InferenceEngine with scripted
                           DISPATCH faults (slow dispatch, stalled
                           worker, engine exceptions) — the serving
                           chaos harness;
  contaminate_market_data  injects NaN/inf into feed windows (the bars
                           AND the padded obs window, so both the
                           reward path and the policy input see them);
  SimulatedPreemptionError mid-run kill for checkpoint/resume drills;
  parse_fault_profile      the ``fault_profile`` config-knob grammar.

The grammar is parsed as the JAX package parses it, the same dict and
the same errors.  What acts on it here: the feed contamination, the
scengen stress overlay (scengen/stress.py), the preemption drill, the
serving plans (``FlakyEngine`` around serve/engine.InferenceEngine) and
``FlakyTransport`` (host-only; the live broker comes with ROADMAP.md
Queue 1 item 25).  A training run whose profile would fire a ``mesh=``
event raises ``not_ported(..., 17)`` (:func:`refuse_mesh_and_fleet`);
``fleet=`` events raise ``not_ported(..., 16)`` where they would act
(the decision fleet).

Profile grammar — semicolon-separated ``key=value`` clauses::

    nan_bars=30-31;transport=http:503,http:503,ok;seed=7
    serve=slow:40+slow:40+exc+ok;burst=32x4;seed=0

  nan_bars / inf_bars   bar indices to poison: ``N``, ``N-M`` (inclusive)
                        or ``N,M,K`` (comma list within the clause is
                        not supported — use multiple clauses or a range)
  fields                comma-free ``+``-joined MarketData fields to
                        poison (default ``close``)
  transport             ``+``- or ``,``-joined fault tokens consumed one
                        per HTTP call (see FAULT_TOKENS)
  serve                 ``+``- or ``,``-joined serving fault tokens
                        consumed one per engine dispatch (see
                        SERVE_FAULT_TOKENS), or ``pR`` for a seeded
                        probabilistic plan at rate R
  burst                 ``NxK`` — the burst-arrival shape for overload
                        scenarios: K rounds of N simultaneous requests
                        (read by the caller that drives the burst)
  fleet                 ``+``-joined fleet fault events of the form
                        ``<action>:<replica>@<decision>[:<ms>]`` —
                        ``kill:1@8`` kills replica 1 at global decision
                        index 8, ``stall:0@4:250`` wedges replica 0's
                        next dispatch for 250 ms at decision 4,
                        ``flap:2@6`` makes replica 2 throw transient
                        dispatch errors at decision 6 then recover
                        (the decision fleet, ROADMAP.md Queue 1 item 16)
  mesh                  ``+``-joined TRAINING-mesh fault events of the
                        form ``kill:<device>@<superstep>`` —
                        ``kill:3@2`` marks mesh device 3 lost at the
                        first superstep boundary reaching iteration 2
                        (the mesh and the elastic runtime, ROADMAP.md
                        Queue 1 item 17)
  preempt_at            iteration index after which the trainer raises
                        SimulatedPreemptionError (checkpoint drill)
  scengen               a scengen preset name (``scengen=flash_crash``):
                        overlays the preset's STRUCTURED market stress —
                        crash drops with recovery tails, drought spread
                        blowouts, gap level shifts — onto the training
                        feed (scengen/stress.py), so chaos
                        runs fuzz with market moves, not only NaNs
  seed                  seed for probabilistic plans (``transport=p0.3``)
                        and the scengen stress layout
"""
from __future__ import annotations

import random
import socket
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from gymfx_tpu_torch.resilience.guards import tree_map

FAULT_TOKENS = (
    "ok",               # pass through untouched
    "timeout",          # socket.timeout before the venue sees anything
    "conn",             # ConnectionError before the venue sees anything
    "http:<code>",      # synthesize an HTTP error; venue sees nothing
    "accept-then-503",  # venue PROCESSES the call, response is lost as a
                        # 503 — the case that distinguishes safe retry
                        # (lookup-first) from double-fill (blind resubmit)
    "partial",          # venue processes, body truncated mid-JSON
)


SERVE_FAULT_TOKENS = (
    "ok",           # dispatch passes through untouched
    "slow:<ms>",    # dispatch completes after an injected delay —
                    # queued requests age past their deadlines
    "stall:<ms>",   # a long injected delay standing in for a wedged
                    # worker/runtime (same mechanics as slow, separate
                    # token so plans read as what they simulate)
    "exc",          # the dispatch raises InjectedDispatchError — feeds
                    # the serving circuit breaker
)


FLEET_FAULT_ACTIONS = (
    "kill",     # hard-fail the replica: batcher killed, standby promoted
    "stall",    # one wedged dispatch of <ms> (supervisor sees a slow/dead
                # probe; requests re-route)
    "flap",     # a short burst of dispatch exceptions, then recovery —
                # the transient-fault case retries must absorb
)


MESH_FAULT_ACTIONS = (
    "kill",     # mark a mesh device lost at a superstep boundary
)


class InjectedDispatchError(RuntimeError):
    """Injected engine-dispatch failure (the serving chaos harness's
    stand-in for a runtime error / device loss mid-dispatch)."""


class FlakyEngine:
    """Deterministic chaos wrapper around a serving InferenceEngine.

    Intercepts ``decide_batch`` (the batcher's dispatch path) with a
    scripted fault plan consumed one token per dispatch — dispatches
    beyond the plan pass through — or a seeded probabilistic plan
    (``failure_rate`` + ``rate_tokens``).  Every other attribute
    (buckets, recurrent, obs_dtype, initial_carry, bucket_for, ...)
    delegates to the wrapped engine, so the wrapper drops into
    ``MicroBatcher(engine=...)`` unchanged.  ``sleep`` is injectable so
    tests can run stall plans instantly.
    """

    def __init__(
        self,
        inner: Any,
        *,
        plan: Sequence[str] = (),
        failure_rate: float = 0.0,
        rate_tokens: Sequence[str] = ("slow:50", "exc"),
        seed: int = 0,
        sleep: Callable[[float], None] = None,
    ):
        import time as _time

        self._inner = inner
        self._plan: List[str] = [str(t) for t in plan]
        self._rate = float(failure_rate)
        self._rate_tokens = tuple(rate_tokens)
        self._rng = random.Random(seed)
        self._sleep = _time.sleep if sleep is None else sleep
        self.dispatch_calls = 0
        self.faults_injected = 0
        self.history: List[str] = []

    # attributes that belong to the WRAPPER; everything else reads from
    # and writes through to the wrapped engine, so deployer/fleet wiring
    # (``engine.on_compile = cb``, ``engine.params = ...``) lands on the
    # real engine even when chaos is interposed
    _OWN_ATTRS = frozenset(
        {
            "_inner",
            "_plan",
            "_rate",
            "_rate_tokens",
            "_rng",
            "_sleep",
            "dispatch_calls",
            "faults_injected",
            "history",
        }
    )

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    def __setattr__(self, name: str, value: Any) -> None:
        if name in self._OWN_ATTRS or "_inner" not in self.__dict__:
            object.__setattr__(self, name, value)
        elif hasattr(self._inner, name):
            setattr(self._inner, name, value)
        else:
            object.__setattr__(self, name, value)

    def push_faults(self, *tokens: str) -> None:
        """Append fault tokens to the scripted plan mid-run — how the
        fleet-chaos harness turns a parsed ``fleet=`` stall/flap event
        into this replica's next dispatches."""
        self._plan.extend(str(t) for t in tokens)

    def _next_token(self) -> str:
        if self._plan:
            return self._plan.pop(0)
        if self._rate > 0.0 and self._rng.random() < self._rate:
            return self._rng.choice(self._rate_tokens)
        return "ok"

    def _consume_token(self) -> None:
        """One fault decision per dispatch, shared by every intercepted
        dispatch surface (sync, slot, async)."""
        self.dispatch_calls += 1
        token = self._next_token()
        self.history.append(token)
        if token == "ok":
            return
        self.faults_injected += 1
        if token.startswith(("slow:", "stall:")):
            self._sleep(float(token.split(":", 1)[1]) / 1e3)
            return
        if token == "exc":
            raise InjectedDispatchError(
                "injected engine dispatch failure"
            )
        raise ValueError(
            f"unknown serve fault token {token!r}; known: {SERVE_FAULT_TOKENS}"
        )

    def decide_batch(self, obs_batch: Any, carries: Any = None):
        self._consume_token()
        return self._inner.decide_batch(obs_batch, carries)

    # the slot-cache / pipelined dispatch surfaces (serve/slots.py,
    # docs/serving.md "Device-resident sessions") are class-defined on
    # InferenceEngine, so __getattr__ delegation alone would bypass
    # fault injection — intercept them explicitly.  Faults inject at
    # DISPATCH time (matching the sync path); a resolve() of an already
    # issued handle is never failed by the wrapper.
    def dispatch_async(self, obs_batch: Any, carries: Any = None, **kwargs):
        self._consume_token()
        return self._inner.dispatch_async(obs_batch, carries, **kwargs)

    def decide_batch_slots(
        self, obs_batch: Any, sessions: Any, seed_carries: Any = None
    ):
        return self.dispatch_async(
            obs_batch, sessions=sessions, seed_carries=seed_carries
        ).resolve()

    def decide(self, obs_vec: Any, carry: Any = None):
        """Single-request convenience routed through the FAULTED
        ``decide_batch`` (the inner engine's own ``decide`` would bypass
        the plan), so the live direct-dispatch path is chaos-testable
        too."""
        carries = None
        if self._inner.recurrent:
            if carry is None:
                carry = self._inner.initial_carry()
            carries = tree_map(lambda x: torch.as_tensor(x)[None], carry)
        out = self.decide_batch(torch.as_tensor(np.asarray(obs_vec))[None], carries)
        return type(out)(
            out.action[0],
            out.value[0],
            out.actor_out[0],
            tree_map(lambda x: x[0], out.carry)
            if self._inner.recurrent
            else out.carry,
        )


def flaky_engine_from_profile(
    engine: Any,
    profile: Dict[str, Any],
    *,
    sleep: Callable[[float], None] = None,
) -> Any:
    """Wrap ``engine`` per the parsed profile's serving clauses; an
    inert profile returns the engine untouched, so the fast path stays
    byte-for-byte the pre-chaos code path."""
    plan = profile.get("serve_plan") or []
    rate = float(profile.get("serve_rate") or 0.0)
    if not plan and rate <= 0.0:
        return engine
    return FlakyEngine(
        engine,
        plan=plan,
        failure_rate=rate,
        seed=int(profile.get("seed", 0)),
        sleep=sleep,
    )


class SimulatedPreemptionError(RuntimeError):
    """Injected mid-run kill: the trainer stops as if the machine was
    preempted.  Carries the iteration index for the resume drill."""

    def __init__(self, iteration: int):
        super().__init__(
            f"simulated preemption after iteration {iteration}; resume "
            "from the latest auto-checkpoint"
        )
        self.iteration = int(iteration)


class FlakyTransport:
    """Deterministic flaky wrapper around a live-path transport.

    ``plan`` is a sequence of fault tokens consumed one per call (calls
    beyond the plan pass through); alternatively ``failure_rate`` draws
    tokens from ``rate_tokens`` with a seeded RNG.  Matches the
    ``Transport`` callable shape of ``live/oanda.py`` exactly, so it
    drops into ``OandaLiveBroker(transport=...)`` (ROADMAP.md Queue 1
    item 25) and composes under the retry layer.

    The injected HTTP errors return OANDA-shaped ``errorMessage`` bodies
    so the production error path (not a test-only one) handles them.
    """

    def __init__(
        self,
        inner: Callable[..., Any],
        *,
        plan: Sequence[str] = (),
        failure_rate: float = 0.0,
        rate_tokens: Sequence[str] = ("timeout", "http:503"),
        seed: int = 0,
        match: Optional[Callable[[str, str], bool]] = None,
    ):
        self._inner = inner
        self._plan: List[str] = [str(t) for t in plan]
        self._rate = float(failure_rate)
        self._rate_tokens = tuple(rate_tokens)
        self._rng = random.Random(seed)
        self._match = match
        self.calls = 0
        self.faults_injected = 0
        self.history: List[str] = []

    def _next_token(self) -> str:
        if self._plan:
            return self._plan.pop(0)
        if self._rate > 0.0 and self._rng.random() < self._rate:
            return self._rng.choice(self._rate_tokens)
        return "ok"

    def __call__(self, method: str, url: str, headers: Dict[str, str],
                 body: Optional[bytes]):
        self.calls += 1
        if self._match is not None and not self._match(method, url):
            self.history.append("ok")
            return self._inner(method, url, headers, body)
        token = self._next_token()
        self.history.append(token)
        if token == "ok":
            return self._inner(method, url, headers, body)
        self.faults_injected += 1
        if token == "timeout":
            raise socket.timeout("injected transport timeout")
        if token == "conn":
            raise ConnectionError("injected connection failure")
        if token.startswith("http:"):
            code = int(token.split(":", 1)[1])
            return code, (
                b'{"errorMessage":"injected fault: HTTP %d"}' % code
            )
        if token == "accept-then-503":
            # the venue processed the request; only the response is lost
            self._inner(method, url, headers, body)
            return 503, b'{"errorMessage":"injected fault: response lost"}'
        if token == "partial":
            status, raw = self._inner(method, url, headers, body)
            text = raw if isinstance(raw, (bytes, bytearray)) else str(raw).encode()
            return status, bytes(text)[: max(1, len(text) // 2)]
        raise ValueError(f"unknown fault token {token!r}; known: {FAULT_TOKENS}")


def contaminate_market_data(
    data: Any,
    *,
    bars: Iterable[int],
    fields: Sequence[str] = ("close",),
    value: float = float("nan"),
) -> Any:
    """Poison ``bars`` of the named MarketData fields with ``value``
    (NaN by default) and return the rebuilt MarketData (each poisoned
    field a new tensor of its dtype on its device).

    Price fields are mirrored into ``padded_close`` at the shifted
    offsets so BOTH consumption paths see the contamination: the reward
    path reads ``close[t]`` and the obs window dynamic-slices
    ``padded_close`` — poisoning only one would understate the blast
    radius a real bad feed row has.
    """
    bar_idx = np.asarray(sorted(set(int(b) for b in bars)), dtype=np.int64)
    if bar_idx.size == 0:
        return data
    n = int(data.close.shape[0])
    if bar_idx.min() < 0 or bar_idx.max() >= n:
        raise ValueError(
            f"fault bars {bar_idx.min()}..{bar_idx.max()} out of range "
            f"for a {n}-bar dataset"
        )
    replace: Dict[str, Any] = {}
    idx = torch.from_numpy(bar_idx)
    for field in fields:
        arr = getattr(data, field).clone()
        arr[idx.to(arr.device)] = value
        replace[field] = arr
        if field == "close":
            padded = data.padded_close.clone()
            pad = padded.shape[0] - n
            padded[(idx + pad).to(padded.device)] = value
            replace["padded_close"] = padded
    return data._replace(**replace)


def nonfinite_report(data: Any) -> Dict[str, int]:
    """Host-side diagnostic: count of non-finite values per floating
    MarketData field (all zeros on a clean feed).  Cheap enough to run
    once at load time; the guard metrics point here when they fire."""
    out: Dict[str, int] = {}
    for field, arr in zip(type(data)._fields, data):
        if not isinstance(arr, torch.Tensor) or not arr.is_floating_point():
            continue
        bad = int((~torch.isfinite(arr)).sum())
        if bad:
            out[field] = bad
    return out


def _parse_fleet_token(tok: str) -> Dict[str, Any]:
    """Parse one fleet fault event ``<action>:<replica>@<decision>[:<ms>]``
    (``ms`` only for ``stall``, default 250)."""
    action, sep, rest = tok.partition(":")
    if action not in FLEET_FAULT_ACTIONS or not sep:
        raise ValueError(
            f"fleet fault token {tok!r} must start with one of "
            f"{FLEET_FAULT_ACTIONS} followed by ':<replica>@<decision>'"
        )
    replica_s, at_sep, at_s = rest.partition("@")
    if not at_sep:
        raise ValueError(
            f"fleet fault token {tok!r} is missing '@<decision>'"
        )
    ms: Optional[float] = None
    if action == "stall":
        at_s, _, ms_s = at_s.partition(":")
        ms = float(ms_s) if ms_s else 250.0
        if ms <= 0:
            raise ValueError(f"fleet stall ms must be > 0, got {ms!r}")
    elif ":" in at_s:
        raise ValueError(
            f"fleet fault token {tok!r}: only 'stall' takes a ':<ms>' tail"
        )
    replica, at = int(replica_s), int(at_s)
    if replica < 0 or at < 0:
        raise ValueError(
            f"fleet fault token {tok!r}: replica and decision index "
            "must be >= 0"
        )
    return {"action": action, "replica": replica, "at": at, "ms": ms}


def _parse_mesh_token(tok: str) -> Dict[str, Any]:
    """Parse one mesh fault event ``kill:<device>@<superstep>``."""
    action, sep, rest = tok.partition(":")
    if action not in MESH_FAULT_ACTIONS or not sep:
        raise ValueError(
            f"mesh fault token {tok!r} must start with one of "
            f"{MESH_FAULT_ACTIONS} followed by ':<device>@<superstep>'"
        )
    device_s, at_sep, at_s = rest.partition("@")
    if not at_sep:
        raise ValueError(f"mesh fault token {tok!r} is missing '@<superstep>'")
    try:
        device, at = int(device_s), int(at_s)
    except ValueError:
        raise ValueError(
            f"mesh fault token {tok!r}: device and superstep must be ints"
        ) from None
    if device < 0 or at < 0:
        raise ValueError(
            f"mesh fault token {tok!r}: device and superstep index "
            "must be >= 0"
        )
    return {"action": action, "device": device, "at": at}


def refuse_mesh_and_fleet(profile: Dict[str, Any], *, mesh: bool = True,
                          fleet: bool = False) -> None:
    """``not_ported`` for the clauses the port cannot act on where they
    would act: a mesh event in training (``mesh``, item 17), a fleet event
    in serving (``fleet``, the decision fleet, item 16)."""
    from gymfx_tpu_torch.core.types import not_ported

    if mesh and profile.get("mesh"):
        raise not_ported("fault_profile mesh= events (simulated device loss on a mesh)", 17)
    if fleet and profile.get("fleet"):
        raise not_ported("fault_profile fleet= events (the decision fleet)", 16)


def _parse_bars(spec: str) -> List[int]:
    spec = spec.strip()
    if "-" in spec:
        lo, hi = spec.split("-", 1)
        return list(range(int(lo), int(hi) + 1))
    return [int(spec)]


def parse_fault_profile(spec: Optional[str]) -> Dict[str, Any]:
    """Parse the ``fault_profile`` config string (grammar in the module
    docstring) into a plain dict::

        {"nan_bars": [...], "inf_bars": [...], "fields": [...],
         "transport_plan": [...], "transport_rate": float,
         "serve_plan": [...], "serve_rate": float,
         "burst": {"size": int, "rounds": int}|None,
         "fleet": [{"action": str, "replica": int, "at": int,
                    "ms": float|None}, ...]  (sorted by "at"),
         "mesh": [{"action": str, "device": int, "at": int}, ...]
                  (sorted by "at"),
         "preempt_at": int|None, "seed": int}

    Empty/None spec parses to an all-inert profile; unknown clause keys
    raise (a typo'd chaos knob must not silently run a clean baseline).
    """
    profile: Dict[str, Any] = {
        "nan_bars": [],
        "inf_bars": [],
        "fields": ["close"],
        "transport_plan": [],
        "transport_rate": 0.0,
        "serve_plan": [],
        "serve_rate": 0.0,
        "burst": None,
        "fleet": [],
        "mesh": [],
        "preempt_at": None,
        "scengen": None,
        "seed": 0,
    }
    if not spec:
        return profile
    for clause in str(spec).split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if "=" not in clause:
            raise ValueError(
                f"fault_profile clause {clause!r} is not key=value"
            )
        key, val = (part.strip() for part in clause.split("=", 1))
        if key == "nan_bars":
            profile["nan_bars"].extend(_parse_bars(val))
        elif key == "inf_bars":
            profile["inf_bars"].extend(_parse_bars(val))
        elif key == "fields":
            profile["fields"] = [
                f for f in val.replace("+", ",").split(",") if f
            ]
        elif key == "transport":
            if val.startswith("p") and _is_float(val[1:]):
                profile["transport_rate"] = float(val[1:])
            else:
                profile["transport_plan"] = [
                    t for t in val.replace("+", ",").split(",") if t
                ]
        elif key == "serve":
            if val.startswith("p") and _is_float(val[1:]):
                profile["serve_rate"] = float(val[1:])
            else:
                profile["serve_plan"] = [
                    t for t in val.replace("+", ",").split(",") if t
                ]
        elif key == "burst":
            size, _, rounds = val.partition("x")
            profile["burst"] = {
                "size": int(size),
                "rounds": int(rounds) if rounds else 1,
            }
            if profile["burst"]["size"] < 1 or profile["burst"]["rounds"] < 1:
                raise ValueError(
                    f"burst clause must be NxK with N,K >= 1, got {val!r}"
                )
        elif key == "fleet":
            for tok in [t for t in val.replace(",", "+").split("+") if t]:
                profile["fleet"].append(_parse_fleet_token(tok))
            profile["fleet"].sort(key=lambda ev: ev["at"])
        elif key == "mesh":
            for tok in [t for t in val.replace(",", "+").split("+") if t]:
                profile["mesh"].append(_parse_mesh_token(tok))
            profile["mesh"].sort(key=lambda ev: ev["at"])
        elif key == "preempt_at":
            profile["preempt_at"] = int(val)
        elif key == "scengen":
            # honor-or-reject at parse time
            from gymfx_tpu_torch.scengen.params import scenario_params

            scenario_params(val)
            profile["scengen"] = val
        elif key == "seed":
            profile["seed"] = int(val)
        else:
            raise ValueError(
                f"unknown fault_profile key {key!r}; known: nan_bars, "
                "inf_bars, fields, transport, serve, burst, fleet, "
                "mesh, preempt_at, scengen, seed"
            )
    return profile


def apply_fault_profile_to_market_data(data: Any, profile: Dict[str, Any]) -> Any:
    """Apply the feed-contamination part of a parsed profile (transport
    and preemption faults are wired where those subsystems live).
    Scengen stress goes first so NaN/inf clauses can poison the
    stressed bars too."""
    if profile.get("scengen"):
        from gymfx_tpu_torch.scengen.stress import apply_scengen_stress

        data = apply_scengen_stress(
            data, profile["scengen"], seed=int(profile.get("seed", 0))
        )
    if profile.get("nan_bars"):
        data = contaminate_market_data(
            data, bars=profile["nan_bars"],
            fields=tuple(profile.get("fields", ("close",))),
            value=float("nan"),
        )
    if profile.get("inf_bars"):
        data = contaminate_market_data(
            data, bars=profile["inf_bars"],
            fields=tuple(profile.get("fields", ("close",))),
            value=float("inf"),
        )
    return data


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False
