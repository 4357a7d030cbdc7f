"""Batched low-latency policy inference: a bucket ladder of CUDA graphs.

The port of ``gymfx_tpu/serve/engine.py`` (:46-901).  Where the JAX
package AOT-compiles the actor forward pass once for each padded batch
bucket, ``InferenceEngine`` captures it once for each bucket as a CUDA
graph (``core/graphs.PhaseGraph``) over static tensors: the padded
observations and carry in, the action, value, actor output and carry
out.  It

  * captures every bucket of the LADDER (default 1/8/64/512/4096) at
    construction (``warmup``): boot pays every capture, the serving path
    only replays.  A dispatch to a bucket without a graph captures one
    and counts it in ``late_compiles`` (the JAX package's name for its
    late compiles, so "a warm engine has 0" reads the same);
  * serves any request batch by padding it with neutral observations up
    to the smallest covering bucket and unpadding the responses, so N
    concurrent sessions share ONE replay instead of N;
  * supports every policy of train/policies.py, discrete and continuous
    (a Gaussian twin's action is its mean thresholded as the env coerces
    it, core/env.py: 1 at ``mu >= thr``, 2 at ``mu <= -thr``, else 0; its
    ``actor_out`` is the mean); recurrent policies stream their ``(c, h)``
    carry through the engine per session (or keep it on the card,
    serve/slots.py).

Two in-graph batching modes (``batch_mode``):

  ``exact``   each row runs the SINGLE-row program (the policy on a
      (1, ...) batch, the row copied out first so that its storage is
      aligned as a fresh tensor's) — the counterpart of the JAX
      package's ``lax.map`` of the single-example program.  Every
      response is bit-identical to ``policy(obs[None])`` at every bucket
      size: the same kernels at the same shapes (cuBLAS picks its
      algorithm by shape, so one batched GEMM is not row-invariant).
      The graph holds one forward a row: its capture and replay grow
      with the bucket, so the exact ladder is meant for small buckets.
  ``matmul``  the bucket's rows run as one batched forward (full-width
      GEMMs, K4 at B = bucket) — the throughput mode.  Responses may
      differ from the single-row program, and across buckets, by float
      reassociation where the GEMM algorithm changes with the shape.
  ``auto``    ``matmul`` on CUDA, ``exact`` on the CPU.

Threads and streams.  The engine owns one CUDA stream: every host-to-
device copy, replay and device-to-host copy is issued on it, under the
engine's lock.  Every capture also happens under that lock, with
``capture_error_mode="thread_local"``, so that a capture after boot
(``enable_slots``, a late bucket) cannot be broken by a batcher thread
that synchronizes on an event meanwhile.  :meth:`dispatch_async` copies
the outputs into pinned host tensors with ``non_blocking=True`` and
records an event; :meth:`EngineDispatch.resolve` waits on it.

On the CPU nothing is captured (PhaseGraph's CPU mode) and every
dispatch runs the body eagerly: the same static-buffer semantics, so
the CPU tests see the card's code path.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gymfx_tpu_torch import resolve_device
from gymfx_tpu_torch.core.graphs import PhaseGraph
from gymfx_tpu_torch.core.types import not_ported
from gymfx_tpu_torch.resilience.guards import tree_leaves, tree_map

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 8, 64, 512, 4096)
# PhaseGraph's capture mode for every engine graph (module docstring)
CAPTURE_MODE = "thread_local"


class WeightSwapError(RuntimeError):
    """A hot-swap was rejected (name/shape/dtype mismatch against the
    captured ladder, a failed probe, or a late capture during the swap
    probe).  The engine keeps serving the previous weights — a rejected
    swap is never destructive."""


class Decision(NamedTuple):
    """One response row (or a batch of them, leading dim n).
    ``actor_out`` is the raw actor head output — logits ``(n_actions,)``,
    or a continuous policy's mean ``()`` — so callers can audit the
    decision; ``action`` is the greedy env-action int (0 hold / 1 long / 2
    short).  Every field is a host
    tensor; ``carry`` is the ``(c, h)`` tuple of a recurrent policy, ()
    for a stateless one, None in slot mode (the carry stays on the card)."""

    action: Any
    value: Any
    actor_out: Any
    carry: Any


class EngineDispatch:
    """An issued, not-yet-materialized engine dispatch.

    ``dispatch_async`` returns one of these right after it has queued
    the replay and the copies of its outputs to pinned host memory on
    the engine's stream, so the caller (the pipelined micro-batcher) can
    assemble and dispatch the NEXT batch while this one runs.
    :meth:`resolve` waits on the dispatch's event, copies the rows out
    of the pinned buffers, and — in slot mode with the mirror enabled —
    records the fetched carry rows into the slot cache's host mirror.
    Idempotent: resolving twice returns the same Decision.
    """

    __slots__ = ("_engine", "_n", "_outputs", "_carry", "_sessions",
                 "_mode", "_event", "_resolved")

    def __init__(self, engine, n, outputs, carry, sessions, mode, event):
        self._engine = engine
        self._n = int(n)
        self._outputs = outputs    # (action, value, actor_out) host rows
        self._carry = carry        # host carry rows (or None / ())
        self._sessions = sessions  # per-row session ids (slot mode)
        self._mode = mode          # "slots" | "host"
        self._event = event        # CUDA event after the copies (None on the CPU)
        self._resolved = None

    @property
    def n(self) -> int:
        return self._n

    def resolve(self) -> Decision:
        if self._resolved is not None:
            return self._resolved
        if self._event is not None:
            self._event.synchronize()
        # out of the pinned buffers (the caching host allocator reuses
        # them once the copies' events have passed)
        action, value, actor_out = (x.clone() for x in self._outputs)
        engine = self._engine
        if self._mode == "slots":
            if self._carry is not None:
                carry2 = tree_map(lambda x: x.clone(), self._carry)
                cache = engine.slot_cache
                if cache is not None:
                    cache.update_mirror(self._sessions, carry2)
                engine.mirror_fetch_bytes += sum(_nbytes(x) for x in tree_leaves(carry2))
            # carry stays device-resident: None here is the slot-mode
            # contract (the mirror is the host view of session carry)
            decision = Decision(action, value, actor_out, None)
        else:
            carry = tree_map(lambda x: x.clone(), self._carry) if engine.recurrent else ()
            decision = Decision(action, value, actor_out, carry)
        self._resolved = decision
        return decision


def resolve_batch_mode(mode: str, device=None) -> str:
    """'auto' -> 'matmul' on CUDA, 'exact' on the CPU (``device`` as the
    entry points resolve it)."""
    if mode not in ("auto", "exact", "matmul"):
        raise ValueError(f"serve batch_mode must be auto|exact|matmul, got {mode!r}")
    if mode != "auto":
        return mode
    return "matmul" if resolve_device(device).type == "cuda" else "exact"


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _leaf_signature(leaf: Any) -> Tuple[Tuple[int, ...], str]:
    """(shape, dtype-name) of a params leaf (a tensor or an array)."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.as_tensor(np.asarray(leaf))
    return tuple(int(s) for s in leaf.shape), str(leaf.dtype)


class InferenceEngine:
    """The bucket ladder of CUDA graphs over a policy's forward pass.

    Parameters
    ----------
    policy : a train/policies.py module (any family, discrete or Gaussian)
    params : its parameters by name (``named_parameters`` keys; e.g. from
        train/checkpoint.py ``load_params`` or convert.py); the engine
        keeps its own copies on its device, which every graph reads
    example_obs_vec : one encoded observation — the flat ``(obs_dim,)``
        vector or the ``(window, token_dim)`` token block — fixing the
        request shape and dtype
    buckets : the padded batch ladder; captured at construction when
        ``warmup=True`` (the default — serving must never capture)
    batch_mode : 'auto' | 'exact' | 'matmul' (see module docstring)
    continuous : the policy is a Gaussian twin: the action is its mean
        thresholded at ``continuous_threshold`` as the env coerces it
    continuous_threshold : the env's ``continuous_action_threshold``
    neutral_obs : the pad row (defaults to zeros); never visible in
        responses
    device : CUDA unless the caller names another
    """

    def __init__(
        self,
        policy: torch.nn.Module,
        params: Dict[str, Any],
        example_obs_vec: Any,
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        batch_mode: str = "auto",
        continuous: bool = False,
        continuous_threshold: float = 0.33,
        neutral_obs: Optional[Any] = None,
        warmup: bool = True,
        device=None,
    ):
        if not buckets:
            raise ValueError("bucket ladder must not be empty")
        self.device = resolve_device(device)
        self.policy = policy.to(self.device)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if self.buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {self.buckets}")
        self.batch_mode = resolve_batch_mode(batch_mode, self.device)
        self.continuous = bool(continuous)
        # the threshold rounded to float32, as the env's parameter is
        self.continuous_threshold = float(np.float32(continuous_threshold))
        names = [k for k, _ in policy.named_parameters()]
        if sorted(params) != sorted(names):
            raise ValueError(f"params {sorted(params)} are not the policy's {sorted(names)}")
        # the graphs' static parameters, contiguous like the module's own
        # (a GEMM's algorithm, and so its sums, follow the weight's layout):
        # swap_weights copies into them
        self.params = {k: torch.as_tensor(params[k]).detach().to(self.device)
                       .clone(memory_format=torch.contiguous_format) for k in names}

        obs = (example_obs_vec if isinstance(example_obs_vec, torch.Tensor)
               else torch.as_tensor(np.asarray(example_obs_vec)))
        self.obs_shape = tuple(int(s) for s in obs.shape)
        self.obs_dtype = obs.dtype
        if neutral_obs is None:
            neutral_obs = torch.zeros(self.obs_shape, dtype=self.obs_dtype)
        self.neutral_obs = self._as_rows(neutral_obs, single=True)
        if tuple(self.neutral_obs.shape) != self.obs_shape:
            raise ValueError(f"neutral_obs shape {tuple(self.neutral_obs.shape)} != "
                             f"observation shape {self.obs_shape}")

        self.recurrent = bool(getattr(policy, "recurrent", False))
        self._carry0 = (tuple(x[0].cpu() for x in policy.initial_carry(1))
                        if self.recurrent else ())
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._graphs: Dict[int, PhaseGraph] = {}
        self.capture_s: Dict[int, float] = {}
        # ---- device-resident session slots (serve/slots.py) ----
        # all None/empty until enable_slots(); the host-carry serving
        # path never consults them
        self.slot_cache = None
        self._slot_graphs: Dict[int, PhaseGraph] = {}
        self.slot_capture_s: Dict[int, float] = {}
        self._obs_staging: Dict[int, list] = {}
        self._staging_flip = 0
        self.slot_dispatches = 0
        self.slot_decisions = 0
        self.mirror_fetch_bytes = 0   # carry bytes fetched for the mirror
        self.seed_upload_bytes = 0    # carry bytes uploaded to seed slots
        # serializes every dispatch, capture and weight copy: the engine's
        # stream, its static tensors and its staging buffers are shared
        self._lock = threading.Lock()
        self.late_compiles = 0  # captures after boot — a warm engine has 0
        self.generation = 0     # bumped on every accepted swap_weights
        self.swap_count = 0
        # capture hook: on_compile(bucket, seconds, late) after every
        # bucket capture (None costs nothing)
        self.on_compile: Optional[Callable[[int, float, bool], None]] = None
        if warmup:
            self.warmup()

    # ------------------------------------------------------------------
    def _as_rows(self, x: Any, single: bool = False) -> torch.Tensor:
        """Observations as a host tensor of the engine's dtype."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        x = x.detach().to("cpu", self.obs_dtype)
        if not single and x.dim() == len(self.obs_shape):  # single row convenience
            x = x[None]
        return x

    def _check_rows(self, obs: torch.Tensor) -> int:
        if tuple(obs.shape[1:]) != self.obs_shape:
            raise ValueError(f"obs batch shape {tuple(obs.shape)} does not match "
                             f"(n, {', '.join(map(str, self.obs_shape))})")
        return int(obs.shape[0])

    def initial_carry_batch(self, n: int):
        """Fresh (zero) recurrent carry for ``n`` sessions, host tensors."""
        return tree_map(lambda x: x.expand(n, *x.shape).clone(), self._carry0)

    def initial_carry(self):
        """Fresh per-session carry (host tensors)."""
        return tree_map(lambda x: x.clone(), self._carry0)

    # ---- the programs ------------------------------------------------
    def _forward(self, x, carry):
        """(action, value, actor_out, carry2) of the policy on rows ``x``."""
        if self.recurrent:
            out, value, carry2 = torch.func.functional_call(self.policy, self.params, (x, carry))
        else:
            out, value = torch.func.functional_call(self.policy, self.params, (x,))
            carry2 = ()
        if self.continuous:
            mu, thr = out[0], self.continuous_threshold
            action = torch.where(mu >= thr, 1, torch.where(mu <= -thr, 2, 0)).to(torch.int32)
            return action, value, mu, carry2
        return torch.argmax(out, dim=-1).to(torch.int32), value, out, carry2

    def _batched(self, obs, carry):
        """The bucket's rows through the batch mode's program."""
        if self.batch_mode == "matmul":
            return self._forward(obs, carry)
        rows = [self._forward(obs[i:i + 1].clone(), tree_map(lambda c: c[i:i + 1].clone(), carry))
                for i in range(obs.shape[0])]
        action, value, actor_out = (torch.cat([r[j] for r in rows]) for j in range(3))
        carry2 = tuple(torch.cat([r[3][j] for r in rows]) for j in range(len(carry)))
        return action, value, actor_out, carry2

    def _body(self, inputs):
        with torch.no_grad():
            return self._batched(inputs["obs"], inputs["carry"])

    def _slot_body(self, inputs):
        state = self.slot_cache.state
        with torch.no_grad():
            carry = tuple(s.index_select(0, inputs["gather"]) for s in state)
            action, value, actor_out, carry2 = self._batched(inputs["obs"], carry)
            for s, c in zip(state, carry2):
                s.index_copy_(0, inputs["scatter"], c)
        return action, value, actor_out, carry2

    def _zero_inputs(self, bucket: int) -> Dict[str, Any]:
        return {
            "obs": self.neutral_obs.expand(bucket, *self.obs_shape).to(self.device).clone(),
            "carry": tree_map(lambda x: x.to(self.device), self.initial_carry_batch(bucket)),
        }

    def _on_stream(self):
        """The engine's stream as the current one (nothing on the CPU),
        after the work already queued on the caller's stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self.stream)

    def _capture(self, kind: str, bucket: int, late: bool) -> PhaseGraph:
        """Capture ``bucket``'s graph of the host-carry (``"host"``) or the
        slot (``"slots"``) ladder on the engine's stream and replay it
        once (the serving path never pays a first call); the lock held."""
        body, inputs, graphs, seconds_by = (
            (self._body, self._zero_inputs(bucket), self._graphs, self.capture_s)
            if kind == "host" else
            (self._slot_body, self._slot_inputs(bucket), self._slot_graphs, self.slot_capture_s))
        t0 = time.perf_counter()
        with self._on_stream():
            graph = (PhaseGraph(body, inputs) if self.stream is None
                     else PhaseGraph(body, inputs, capture_error_mode=CAPTURE_MODE))
            graph()
        self._sync()
        seconds = time.perf_counter() - t0
        graphs[bucket] = graph
        seconds_by[bucket] = seconds
        if late:
            self.late_compiles += 1
        if self.on_compile is not None:
            self.on_compile(bucket, seconds, late)
        return graph

    def _sync(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()

    def warmup(self) -> None:
        """Capture every ladder bucket and replay each once.  Idempotent."""
        with self._lock:
            for bucket in self.buckets:
                if bucket not in self._graphs:
                    self._capture("host", bucket, late=False)

    @property
    def executable_count(self) -> int:
        """The number of captured bucket graphs (the host-carry ladder)."""
        return len(self._graphs)

    # ------------------------------------------------------------------
    def swap_weights(self, params: Dict[str, Any], *, probe: bool = True) -> int:
        """Hot-swap the served weights without recapturing the ladder.

        Honor-or-reject: the candidate must have exactly the served
        parameter names, each with the same shape and dtype, or
        :class:`WeightSwapError` is raised before anything is copied.
        The copy into the graphs' static parameters runs on the engine's
        stream under the dispatch lock, so it is ordered after every
        replay already in flight and before every later one.

        With ``probe=True`` (default) the smallest captured bucket is
        replayed once against the new weights while the lock is held;
        an exception or a late capture during the probe restores the old
        weights (from a copy on the card) and raises.

        Returns the new generation number (monotonic, starts at 0).
        """
        if sorted(params) != sorted(self.params):
            raise WeightSwapError(
                f"params names mismatch: engine serves {sorted(self.params)}, "
                f"candidate is {sorted(params)}")
        for name in self.params:
            ns, nd = _leaf_signature(params[name])
            cs, cd = _leaf_signature(self.params[name])
            if ns != cs or nd != cd:
                raise WeightSwapError(
                    f"params leaf {name!r} mismatch: engine serves shape={cs} dtype={cd}, "
                    f"candidate has shape={ns} dtype={nd} — same-shape swaps only (the "
                    "ladder's graphs are captured for one signature)")
        # transfer outside the lock
        new = {k: torch.as_tensor(v).detach().to(self.device) for k, v in params.items()}
        with self._lock:
            with self._on_stream():
                old = {k: p.clone() for k, p in self.params.items()}
                for k, p in self.params.items():
                    p.copy_(new[k])
            before = self.late_compiles
            if probe and self._graphs:
                bucket = min(self._graphs)
                try:
                    self._dispatch(self._zero_inputs_host(bucket), bucket).resolve()
                except Exception as exc:
                    self._restore(old)
                    raise WeightSwapError(
                        f"swap probe dispatch failed on bucket {bucket}: {exc}") from exc
                if self.late_compiles != before:
                    self._restore(old)
                    raise WeightSwapError(
                        "late capture during weight swap — the candidate does not fit the "
                        "captured ladder (hard failure by contract; previous weights restored)")
            self._sync()
            self.generation += 1
            self.swap_count += 1
            return self.generation

    def _restore(self, old: Dict[str, torch.Tensor]) -> None:
        with self._on_stream():
            for k, p in self.params.items():
                p.copy_(old[k])
        self._sync()

    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket covering ``n`` requests (the largest
        bucket when ``n`` exceeds the ladder — decide_batch then splits
        the batch into max-bucket chunks)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for bucket in self.buckets:
            if bucket >= n:
                return bucket
        return self.buckets[-1]

    # ------------------------------------------------------------------
    def _staged_pad(self, obs: torch.Tensor, n: int, bucket: int):
        """Pad ``obs`` into a double-buffered host staging buffer (pinned
        on CUDA), alternating per dispatch; returns the buffer and its
        ``[buffer, event]`` entry, whose event the caller sets after the
        copy that reads it.  Safe with pipeline depth
        one: a buffer is rewritten two dispatches later, after the
        dispatch that referenced it has been resolved.  The buffer also
        keeps the event of the copy that last read it and waits on it
        before a rewrite, so a caller outside that discipline (a second
        thread's dispatch) cannot race the card's read either.  Callers
        must hold the dispatch lock."""
        bufs = self._obs_staging.get(bucket)
        if bufs is None:
            pin = self.stream is not None
            bufs = [[torch.empty((bucket, *self.obs_shape), dtype=self.obs_dtype,
                                 pin_memory=pin), None] for _ in range(2)]
            self._obs_staging[bucket] = bufs
        self._staging_flip ^= 1
        slot = bufs[self._staging_flip]
        if slot[1] is not None:
            slot[1].synchronize()
        buf = slot[0]
        buf[:n] = obs
        buf[n:] = self.neutral_obs
        return buf, slot

    def _upload(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """``dst`` (a static input) from host ``src``, on the engine's
        stream: pinned and non-blocking on CUDA."""
        if self.stream is not None and not src.is_pinned():
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    def _zero_inputs_host(self, bucket: int) -> Dict[str, Any]:
        return {"obs": self.neutral_obs.expand(bucket, *self.obs_shape),
                "carry": self.initial_carry_batch(bucket), "n": bucket}

    def _dispatch(self, host: Dict[str, Any], bucket: int) -> EngineDispatch:
        """One replay of ``bucket``'s graph on host rows (``host["obs"]``
        (n, ...), ``host["carry"]`` padded to the bucket); the lock held."""
        graph = self._graphs.get(bucket)
        if graph is None:
            # never hit after warmup() with a covering ladder; counted so
            # the zero-captures-after-boot contract is testable
            graph = self._capture("host", bucket, late=True)
        n = host["n"]
        with self._on_stream():
            buf, slot = self._staged_pad(host["obs"], n, bucket)
            self._upload(graph.inputs["obs"], buf)
            for dst, src in zip(graph.inputs["carry"], host["carry"]):
                self._upload(dst, src)
            slot[1] = self._record()
            action, value, actor_out, carry2 = graph()
            outputs, event = self._fetch((action, value, actor_out, *carry2), n)
        return EngineDispatch(self, n, outputs[:3], tuple(outputs[3:]), None, "host", event)

    def _record(self):
        if self.stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self.stream)
        return event

    def _fetch(self, tensors, n: int):
        """The first ``n`` rows of each static output to the host: pinned
        buffers filled on the engine's stream and an event after them
        (on CUDA), plain copies on the CPU."""
        if self.stream is None:
            return tuple(t[:n].clone() for t in tensors), None
        out = []
        for t in tensors:
            host = torch.empty((n, *t.shape[1:]), dtype=t.dtype, pin_memory=True)
            host.copy_(t[:n], non_blocking=True)
            out.append(host)
        return tuple(out), self._record()

    def _host_carry(self, carries, n: int, bucket: int):
        """The recurrent carry rows padded to ``bucket`` with the initial
        carry (host tensors of the carry's dtypes)."""
        if not self.recurrent:
            return ()
        pad = self.initial_carry_batch(bucket)
        for full, got in zip(pad, tree_leaves(carries)):
            full[:n] = torch.as_tensor(got if isinstance(got, torch.Tensor)
                                       else np.asarray(got)).to(full.dtype)
        return pad

    def decide_batch(self, obs_batch: Any, carries: Any = None) -> Decision:
        """Decide for ``n`` concurrent requests in one replay.

        ``obs_batch``: (n, *obs_shape) stacked encoded observations.
        ``carries``: the stacked recurrent carry with leading dim n
        (required for recurrent policies; ignored otherwise).  Returns a
        :class:`Decision` of stacked host tensors with leading dim
        exactly n — pad rows are computed and discarded here, they can
        never leak to a caller.
        """
        obs = self._as_rows(obs_batch)
        n = self._check_rows(obs)
        if self.recurrent and carries is None:
            raise ValueError(
                "recurrent policy: decide_batch needs the stacked session carries "
                "(engine.initial_carry_batch(n) for fresh sessions)")
        bucket = self.bucket_for(n)
        if n > bucket:  # ladder exceeded: chunk by the largest bucket
            outs = [
                self.decide_batch(obs[i:i + bucket],
                                  tree_map(lambda x: x[i:i + bucket], tuple(carries))
                                  if self.recurrent else None)
                for i in range(0, n, bucket)
            ]
            carry = (tuple(torch.cat([o.carry[j] for o in outs]) for j in range(len(self._carry0)))
                     if self.recurrent else ())
            return Decision(torch.cat([o.action for o in outs]),
                            torch.cat([o.value for o in outs]),
                            torch.cat([o.actor_out for o in outs]), carry)
        return self._issue(obs, carries, n, bucket).resolve()

    def _issue(self, obs: torch.Tensor, carries, n: int, bucket: int) -> EngineDispatch:
        host = {"obs": obs, "carry": self._host_carry(carries, n, bucket), "n": n}
        with self._lock:
            return self._dispatch(host, bucket)

    def decide(self, obs_vec: Any, carry: Any = None) -> Decision:
        """Single-request convenience: one row through the smallest
        bucket."""
        carries = None
        if self.recurrent:
            if carry is None:
                carry = self.initial_carry()
            carries = tuple(torch.as_tensor(x)[None] for x in carry)
        out = self.decide_batch(self._as_rows(obs_vec, single=True)[None], carries)
        return Decision(out.action[0], out.value[0], out.actor_out[0],
                        tuple(x[0] for x in out.carry) if self.recurrent else out.carry)

    # ------------------------------------------------------------------
    # device-resident session slots (serve/slots.py) — a parallel ladder
    # of graphs whose fused gather→policy→scatter keeps recurrent carry
    # on the card.  The host-carry path above is untouched: with
    # serve_session_slots unset none of this is captured or consulted.
    def enable_slots(self, n_slots: int, *, mirror: bool = True):
        """Allocate the device slot state and capture the fused slot
        ladder (one graph per bucket, like :meth:`warmup`), under the
        dispatch lock, so a call after boot is safe beside a running
        batcher.  Idempotent for the same capacity; a no-op (returns
        None) on stateless policies, which have no carry to cache.
        Returns the :class:`~gymfx_tpu_torch.serve.slots.SlotCache`."""
        if not self.recurrent:
            return None
        if self.slot_cache is not None:
            if self.slot_cache.slots != int(n_slots):
                raise ValueError(f"slot cache already enabled with {self.slot_cache.slots} "
                                 f"slots (asked for {n_slots})")
            return self.slot_cache
        from gymfx_tpu_torch.serve.slots import SlotCache

        with self._lock:
            self.slot_cache = SlotCache(int(n_slots), self._carry0, mirror=mirror,
                                        device=self.device)
            self._warmup_slots()
        return self.slot_cache

    def warmup_slots(self) -> None:
        """Capture the fused slot graph of every bucket and replay each
        once (gathering INITIAL, scattering SCRATCH — session rows are
        untouched).  Idempotent."""
        if self.slot_cache is None:
            return
        with self._lock:
            self._warmup_slots()

    def _warmup_slots(self) -> None:
        for bucket in self.buckets:
            if bucket not in self._slot_graphs:
                self._capture("slots", bucket, late=False)

    def _slot_inputs(self, bucket: int) -> Dict[str, Any]:
        cache = self.slot_cache
        return {
            "obs": self.neutral_obs.expand(bucket, *self.obs_shape).to(self.device).clone(),
            "gather": torch.full((bucket,), cache.initial_row, dtype=torch.int64,
                                 device=self.device),
            "scatter": torch.full((bucket,), cache.scratch_row, dtype=torch.int64,
                                  device=self.device),
        }

    def dispatch_async(
        self,
        obs_batch: Any,
        carries: Any = None,
        *,
        sessions: Optional[Sequence[Optional[str]]] = None,
        seed_carries: Optional[Sequence[Any]] = None,
    ) -> EngineDispatch:
        """Issue one dispatch WITHOUT materializing the outputs; returns
        an :class:`EngineDispatch` whose ``resolve()`` waits on them.

        With the slot cache enabled and per-row ``sessions`` given, the
        fused slot ladder runs: carry is gathered from and scattered to
        the device slots (no per-decision carry transfer; a new
        session's slot is seeded from ``seed_carries[i]`` when provided
        — the failover re-pin — else from the initial carry).  Rows with
        ``sessions[i] is None`` compute from the initial carry and leave
        no state behind.  Otherwise the host-carry semantics of
        :meth:`decide_batch` apply (``carries`` defaults to the initial
        batch for recurrent policies).  The batch must fit the ladder:
        the async path never chunks.
        """
        obs = self._as_rows(obs_batch)
        n = self._check_rows(obs)
        bucket = self.bucket_for(n)
        if n > bucket:
            raise ValueError(f"async dispatch of {n} rows exceeds the largest bucket {bucket} "
                             "(the async path never chunks)")
        cache = self.slot_cache
        if cache is not None and self.recurrent and sessions is not None:
            sessions = [None if s is None else str(s) for s in sessions]
            if len(sessions) != n:
                raise ValueError(f"{len(sessions)} sessions for {n} obs rows")
            with self._lock:
                gather, scatter, seeds = cache.assign(bucket, sessions, seed_carries)
                return self._dispatch_slots(obs, n, bucket, gather, scatter, seeds, sessions)
        # host-carry async path (stateless engines, or explicit carries)
        if self.recurrent and carries is None:
            carries = self.initial_carry_batch(n)
        return self._issue(obs, carries, n, bucket)

    def _dispatch_slots(self, obs, n, bucket, gather, scatter, seeds, sessions) -> EngineDispatch:
        """One replay of ``bucket``'s fused slot graph; the lock held."""
        cache = self.slot_cache
        graph = self._slot_graphs.get(bucket)
        if graph is None:
            graph = self._capture("slots", bucket, late=True)
        with self._on_stream():
            for slot, carry in seeds:
                for s, c in zip(cache.state, tree_leaves(carry)):
                    row = torch.as_tensor(c if isinstance(c, torch.Tensor) else np.asarray(c))
                    row = row.to(s.dtype)
                    self._upload(s[slot], row)
                    self.seed_upload_bytes += _nbytes(row)
            buf, slot_entry = self._staged_pad(obs, n, bucket)
            self._upload(graph.inputs["obs"], buf)
            self._upload(graph.inputs["gather"], gather)
            self._upload(graph.inputs["scatter"], scatter)
            slot_entry[1] = self._record()
            action, value, actor_out, carry2 = graph()
            fetched = (action, value, actor_out, *(carry2 if cache.mirror_enabled else ()))
            outputs, event = self._fetch(fetched, n)
        self.slot_dispatches += 1
        self.slot_decisions += n
        carry_out = tuple(outputs[3:]) if cache.mirror_enabled else None
        return EngineDispatch(self, n, outputs[:3], carry_out, sessions, "slots", event)

    def decide_batch_slots(
        self,
        obs_batch: Any,
        sessions: Sequence[Optional[str]],
        seed_carries: Optional[Sequence[Any]] = None,
    ) -> Decision:
        """Synchronous slot-mode decide: one fused replay, resolved
        immediately.  Decision.carry is None — carry stays on the card
        (the mirror holds the host view)."""
        return self.dispatch_async(obs_batch, sessions=sessions,
                                   seed_carries=seed_carries).resolve()

    def slot_stats(self) -> Dict[str, Any]:
        """Slot-cache counters."""
        out = {
            "enabled": self.slot_cache is not None,
            "slot_dispatches": self.slot_dispatches,
            "slot_decisions": self.slot_decisions,
            "mirror_fetch_bytes": self.mirror_fetch_bytes,
            "seed_upload_bytes": self.seed_upload_bytes,
        }
        if self.slot_cache is not None:
            out.update(self.slot_cache.stats())
        return out


# ---------------------------------------------------------------------------
# construction from the training stack
# ---------------------------------------------------------------------------
class EngineBundle(NamedTuple):
    """A warm engine plus everything needed to feed it requests."""

    engine: InferenceEngine
    env: Any              # the bound core.runtime.Environment
    policy_name: str
    obs_spec: Any         # train/policies.py ObsSpec
    encode: Any           # batched obs dict -> policy inputs (the trainers' encoder)
    reset_obs: Any        # the env's reset observation, one env (shape template)
    # the config's telemetry bundle (None with every telemetry_* key unset):
    # its registry feeds batcher_from_config's instruments
    # (telemetry.instruments_from_telemetry), its /metrics + /healthz
    # endpoint is up when telemetry_http_port is set
    telemetry: Any = None


def check_serving_config(config: Dict[str, Any]) -> None:
    """Raise for the serving features the port has not reached: the
    decision fleet (ROADMAP.md Queue 1 item 16; with it a fault profile's
    fleet events)."""
    from gymfx_tpu_torch.resilience.faults import parse_fault_profile, refuse_mesh_and_fleet

    if int(config.get("serve_fleet_replicas", 0) or 0) > 0:
        raise not_ported("the decision fleet (serve_fleet_replicas > 0)", 16)
    refuse_mesh_and_fleet(parse_fault_profile(config.get("fault_profile")), mesh=False,
                          fleet=True)


def engine_health(engine: "InferenceEngine") -> Dict[str, Any]:
    """The ``/healthz`` payload of a serving engine: its ladder, the
    captures after boot (0 on a warm path), the weights' generation and
    the slot-cache counters."""
    return {
        "status": "ok",
        "buckets": list(engine.buckets),
        "late_compiles": int(engine.late_compiles),
        "generation": int(engine.generation),
        "slots": engine.slot_stats(),
    }


def engine_from_config(
    config: Dict[str, Any],
    *,
    params: Optional[Dict[str, Any]] = None,
    env: Optional[Any] = None,
    warmup: bool = True,
    device=None,
) -> EngineBundle:
    """Build a warm engine (plus its featurizer inputs) from the merged
    config dict.

    Resolves the policy exactly like the trainers (make_trainer_policy,
    the same encoded obs layout), loads params from ``checkpoint_dir``
    when present (honoring the checkpoint's recorded architecture, and
    checked against the policy's parameters), else initializes fresh ones
    from ``seed`` with an explicit ``torch.Generator`` (a serving stack
    must be bootable without a trained model for load tests; the draws
    are the port's own, not flax's).  ``params`` (by name, e.g. from
    convert.policy_params_from_flax) overrides both.  Runs on CUDA
    unless ``device`` (or ``env``'s device) says otherwise.  With a
    ``telemetry_*`` key set the bundle carries the telemetry
    (``bundle.telemetry``), its ``/healthz`` reading the engine
    (:func:`engine_health`).
    """
    from gymfx_tpu_torch.core import env as env_core
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.serve.config import serve_config_from
    from gymfx_tpu_torch.train.policies import (
        is_token_policy,
        make_obs_encoder,
        make_obs_spec,
        make_trainer_policy,
    )

    from gymfx_tpu_torch.telemetry import telemetry_from_config

    check_serving_config(config)
    scfg = serve_config_from(config)
    if env is None:
        env = Environment(config, device=device)
    device = env.device
    policy_name = str(config.get("policy") or "mlp")
    policy_kwargs = dict(config.get("policy_kwargs") or {})
    ckpt_dir = config.get("checkpoint_dir")
    if ckpt_dir:
        from gymfx_tpu_torch.train.checkpoint import read_metadata

        meta = read_metadata(str(ckpt_dir))
        if not config.get("policy") and meta.get("policy"):
            policy_name = str(meta["policy"])
            policy_kwargs = dict(meta.get("policy_kwargs") or policy_kwargs)

    dtype_name = str(config.get("policy_dtype", "float32"))
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    continuous = str(config.get("action_space_mode", "discrete")) == "continuous"

    data = env.require_resident_data("serving boot (reset obs template)")
    _state, reset_obs = env_core.reset(env.cfg, env.params, data)
    spec = make_obs_spec(reset_obs)
    encode = make_obs_encoder(policy_name, env.cfg.window_size, spec)
    example_vec = encode(reset_obs)[0]
    in_dim = example_vec.shape[-1] if is_token_policy(policy_name) else spec.total_size
    policy = make_trainer_policy(
        policy_name, int(in_dim), continuous=continuous, dtype=dtype, kwargs=policy_kwargs,
        window=env.cfg.window_size,
    ).to(device)

    if params is None:
        template = {k: v.detach() for k, v in policy.named_parameters()}
        if ckpt_dir:
            from gymfx_tpu_torch.train.checkpoint import load_params

            params, _step = load_params(str(ckpt_dir), template=template)
        else:
            from gymfx_tpu_torch.train.ppo import init_policy_weights

            gen = torch.Generator(device=device).manual_seed(int(config.get("seed", 0) or 0))
            init_policy_weights(policy, gen)
            params = {k: v.detach().clone() for k, v in policy.named_parameters()}

    engine = InferenceEngine(
        policy,
        params,
        example_vec.detach().cpu(),
        buckets=scfg.buckets,
        batch_mode=scfg.batch_mode,
        continuous=continuous,
        continuous_threshold=float(config.get("continuous_action_threshold", 0.33) or 0.33),
        warmup=bool(warmup and scfg.warmup),
        device=device,
    )
    if scfg.session_slots > 0 and warmup and scfg.warmup:
        # device-resident session carry (serve/slots.py) — a no-op for
        # stateless policies; skipped on warmup=False boots (the slot
        # ladder, like the host ladder, must never capture lazily in
        # serving, so a cold boot stays cold)
        engine.enable_slots(scfg.session_slots, mirror=scfg.slot_mirror)
    telemetry = telemetry_from_config(config)
    if telemetry is not None:
        if telemetry.compile_watch is not None:
            # the boot ladder's buckets now, later captures as they come
            telemetry.compile_watch.watch_engine(engine)
        telemetry.start_http(health_fn=lambda: engine_health(engine))
    return EngineBundle(
        engine=engine,
        env=env,
        policy_name=policy_name,
        obs_spec=spec,
        encode=encode,
        reset_obs=reset_obs,
        telemetry=telemetry,
    )
