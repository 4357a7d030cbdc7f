"""Episode rollout: the driver loop over batched steps, in chunks that
replay from CUDA graphs on the card.

The port of ``gymfx_tpu/core/rollout.py`` (lines 31-330).  The JAX
package scans one env's episode; here one step steps every env of the
batch.  Drivers are (init, act) pairs like the JAX package's, with a
``torch.Generator`` in place of a PRNG key, and the step index a 0-d
int32 tensor on the episode's device, as the JAX package's is a traced
int:

  buy_hold  long on the first step, hold after
  flat      always hold
  random    uniform over {0, 1, 2} per step (torch's stream, not JAX's)
  replay    actions from a device table, 0 past its end
  policy    any callable (params, obs, generator) -> action

Every driver is an episode chunk's body: ``rollout_chunked`` runs an
episode as chunks of ``chunk_size`` steps (the JAX package's compiled
``_rollout_chunk``, :207-221), and on a CUDA device each chunk length is
one ``core/graphs.PhaseGraph``, captured at its first use and replayed
after, so an episode takes one graph for ``chunk_size`` and one for the
last remainder.  The graphs are cached in an :class:`EpisodeGraphs` by
static signature (the config, the env params, the driver, the tape,
the collect flag, the input shapes); runtime data a driver reads (a
policy's weights) travels in its carry, so new weights replay the same
graph.  A chunk's collected outputs are copied into a preallocated
``(steps, n_envs)`` buffer on the device before the next replay
overwrites them.  On the CPU, and with ``eager=True`` on any device,
each chunk's body runs op by op: the same ops on the same values.
``Environment.step`` and ``reset`` stay op by op.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gymfx_tpu_torch import resolve_device
from gymfx_tpu_torch.core import env as env_core
from gymfx_tpu_torch.core import graphs
from gymfx_tpu_torch.core.broker import sign
from gymfx_tpu_torch.core.obs import build_obs
from gymfx_tpu_torch.core.types import EXEC_DIAG_INDEX, EnvConfig, EnvParams, EnvState
from gymfx_tpu_torch.data.feed import MarketData
from gymfx_tpu_torch.resilience.guards import tree_map


class Driver(NamedTuple):
    """An action source: act(carry, obs, i, generator) -> ((N,) int32
    action, carry), ``i`` the step index as a 0-d int32 tensor."""

    init: Callable[[], Any]
    act: Callable[[Any, Dict[str, Any], torch.Tensor, torch.Generator], Tuple[Any, Any]]


def _n_and_device(obs):
    x = next(iter(obs.values()))
    return x.shape[0], x.device


def _per_env(a, n: int):
    """A one-element action as an (n,) int32 tensor."""
    return a.to(torch.int32).reshape(1).repeat(n)


def _buy_hold_act(carry, obs, i, gen):
    n, _ = _n_and_device(obs)
    return _per_env(i == 0, n), carry


def _flat_act(carry, obs, i, gen):
    n, device = _n_and_device(obs)
    return torch.zeros((n,), dtype=torch.int32, device=device), carry


def _random_act(carry, obs, i, gen):
    n, device = _n_and_device(obs)
    return torch.randint(0, 3, (n,), generator=gen, dtype=torch.int32, device=device), carry


_BUY_HOLD = Driver(init=lambda: (), act=_buy_hold_act)
_FLAT = Driver(init=lambda: (), act=_flat_act)
_RANDOM = Driver(init=lambda: (), act=_random_act)


def buy_hold_driver() -> Driver:
    return _BUY_HOLD


def flat_driver() -> Driver:
    return _FLAT


def random_driver() -> Driver:
    """Uniform actions drawn from the episode's generator, which must be
    on the episode's device."""
    return _RANDOM


def replay_driver(actions, device=None) -> Driver:
    """Replay an action sequence, 0 past its end, from a table on
    ``device`` (CUDA unless named)."""
    seq = torch.from_numpy(np.asarray(actions, dtype=np.int32).reshape(-1)).to(
        resolve_device(device))
    m = int(seq.shape[0])

    def act(carry, obs, i, gen):
        n, _ = _n_and_device(obs)
        a = torch.where(i < m, seq[torch.clamp_max(i, m - 1).reshape(1).long()], 0)
        return _per_env(a, n), carry

    return Driver(init=lambda: (), act=act)


def policy_driver(apply_fn: Callable[..., Any], policy_params) -> Driver:
    """Wrap a policy: apply_fn(policy_params, obs, generator) -> action."""

    def act(carry, obs, i, gen):
        return apply_fn(policy_params, obs, gen), carry

    return Driver(init=lambda: (), act=act)


DRIVERS = {
    "buy_hold": buy_hold_driver,
    "flat": flat_driver,
    "random": random_driver,
}


def episode_step_count(outputs) -> torch.Tensor:
    """Steps executed before (and including) termination, per env: the
    first done step + 1, or every step when none is done (the JAX
    package's, :198-204, over the leading step axis)."""
    done = outputs["done"]
    return torch.where(done.any(dim=0), done.to(torch.int8).argmax(dim=0) + 1, done.shape[0])


def _collect(params: EnvParams, state: EnvState, reward, done, action) -> Dict[str, Any]:
    return {
        "equity_delta": state.equity_delta,
        "equity": params.initial_cash + state.equity_delta,
        "reward": reward,
        "done": done,
        "action": action.to(torch.int32),
        "position": sign(state.pos).to(torch.int32),
        "trade_count": state.trade_count,
        "bar_index": state.t + 1,
        "pending_active": state.pending_active,
        "pending_target": state.pending_target,
        "pending_sl": state.pending_sl,
        "pending_tp": state.pending_tp,
        "pos_units": state.pos,
        "bracket_sl": state.bracket_sl,
        "bracket_tp": state.bracket_tp,
        "order_denied": state.exec_diag[:, EXEC_DIAG_INDEX["order_denied_min_quantity"]],
    }


def _chunk_body(cfg: EnvConfig, params: EnvParams, tape: MarketData, driver: Driver,
                length: int, collect: bool, gen: torch.Generator):
    """One chunk of ``length`` steps as a function of its inputs (state,
    obs, driver carry, first step index ``i``): it syncs nothing with the
    host, so it is what a chunk's graph captures.  The step is the JAX
    scan body's (``env.step``); the info dict it would build is read only
    for the event-context streams, so the body builds those alone."""

    def body(x):
        state, obs, dcarry, i0 = x["state"], x["obs"], x["carry"], x["i"]
        pieces = []
        for j in range(length):
            action, dcarry = driver.act(dcarry, obs, i0 + j, gen)
            state, reward, done, parts = env_core.transition(cfg, params, tape, state, action)
            obs = build_obs(state, tape, cfg, params)
            if collect:
                out = _collect(params, state, reward, done, action)
                if cfg.event_context_execution_overlay:
                    out["event_context"] = {k: v for k, v in parts["event_info"].items()
                                            if k.startswith("event_context_")}
                pieces.append(out)
        return dict(state=state, obs=obs, carry=dcarry, i=i0 + length,
                    out=_stack(pieces) if collect else {})

    return body


def _stack(pieces):
    first = pieces[0]
    if isinstance(first, dict):
        return {k: _stack([p[k] for p in pieces]) for k in first}
    return torch.stack(pieces)


class EpisodeGraphs:
    """The episode chunks' graphs by static signature, the generator
    registered with them (set from the episode's generator before each
    replay, which it then advances as the eager chunk would), and the
    staging shard every streamed shard is copied into.  An Environment
    keeps one; ``rollout_chunked`` without one makes one for the call."""

    def __init__(self):
        self.graphs: Dict[tuple, graphs.PhaseGraph] = {}
        self.generator: Optional[torch.Generator] = None
        self.staging: Optional[MarketData] = None

    def run(self, cfg, params, tape, driver, length: int, collect: bool, inputs,
            generator: torch.Generator):
        """One chunk from its graph (built on a miss) on ``inputs`` drawing
        from ``generator``'s state: the graph's static outputs."""
        key = (length, collect, cfg, id(params), id(tape), id(driver), graphs.signature(inputs))
        graph = self.graphs.get(key)
        if self.generator is None:
            self.generator = torch.Generator(device=generator.device)
        gen = self.generator
        if graph is None:
            graph = self.graphs[key] = graphs.PhaseGraph(
                _chunk_body(cfg, params, tape, driver, length, collect, gen),
                graphs.clone_tree(inputs), gen, name=f"episode_chunk_{length}")
        gen.set_state(generator.get_state())
        out = graph(inputs)
        generator.set_state(gen.get_state())
        return out

    def stage(self, shard: MarketData) -> MarketData:
        """The staging shard with ``shard``'s tensors copied in and its
        ``row0`` as a 0-d device tensor (every shard of a stream has one
        shape, so one staging shard, and the graphs keyed on it, serve
        them all)."""
        fields = {k: v for k, v in shard._asdict().items() if isinstance(v, torch.Tensor)}
        staging = self.staging
        if staging is None or graphs.signature(fields) != graphs.signature(
                {k: getattr(staging, k) for k in fields}):
            self.staging = shard._replace(
                row0=torch.tensor(int(shard.row0), dtype=torch.int64, device=shard.close.device),
                **{k: v.clone() for k, v in fields.items()})
            return self.staging
        graphs.copy_tree({k: getattr(staging, k) for k in fields}, fields)
        staging.row0.fill_(int(shard.row0))
        return staging


def _graphed(eager: Optional[bool], device: torch.device) -> bool:
    return device.type == "cuda" if eager is None else not eager


def _run_chunks(cfg, params, tape, driver, cur, lo: int, hi: int, total: int, generator,
                collect: bool, buf, chunk_size: int, cache: EpisodeGraphs, graphed: bool):
    """Steps ``[lo, hi)`` of a ``total``-step episode on ``tape`` from
    ``cur`` (state, obs, carry, i) in chunks, each from its graph when
    ``graphed``; each chunk's outputs go to ``buf`` (a dict of (total,
    n_envs) buffers, made at the first chunk).  Returns (cur, buf)."""
    done = lo
    while done < hi:
        this = min(chunk_size, hi - done)
        if graphed:
            out = cache.run(cfg, params, tape, driver, this, collect, cur, generator)
        else:
            out = _chunk_body(cfg, params, tape, driver, this, collect, generator)(cur)
        if collect:
            if buf is None:
                buf = tree_map(lambda x: torch.empty((total, *x.shape[1:]), dtype=x.dtype,
                                                     device=x.device), out["out"])
            tree_map(lambda b, x: b[done:done + this].copy_(x), buf, out["out"])
        cur = {k: out[k] for k in ("state", "obs", "carry", "i")}
        done += this
    return cur, buf


def _start(state, obs, driver, driver_carry, device):
    dcarry = driver.init() if driver_carry is None else driver_carry
    return dict(state=state, obs=obs, carry=dcarry,
                i=torch.zeros((), dtype=torch.int32, device=device))


def _finish(cur, buf, graphed: bool):
    """(final state, outputs), the state copied out of the graphs' static
    buffers."""
    state = cur["state"]
    if graphed:
        state = graphs.clone_tree(state)
    return state, ({} if buf is None else buf)


def rollout_chunked(cfg: EnvConfig, params: EnvParams, data: MarketData,
                    driver: Driver, steps: int, generator: torch.Generator,
                    collect: bool = True, driver_carry: Any = None,
                    chunk_size: int = 64, n_envs: int = 1,
                    cache: Optional[EpisodeGraphs] = None, eager: Optional[bool] = None):
    """Run ``n_envs`` episodes for ``steps`` env steps (frozen after
    termination) in chunks of ``chunk_size``.  Returns (final_state,
    outputs): outputs maps each collected stream to a (steps, n_envs)
    tensor when ``collect``, else is empty.  Event-context info streams
    are collected too when the overlay is on.  On a CUDA device each
    chunk replays from its graph in ``cache`` (one for this call when None),
    on the CPU it runs op by op; ``eager=True`` runs every chunk op by op
    on any device, ``eager=False`` through its PhaseGraph on any device
    (on the CPU, PhaseGraph's static-buffer mode)."""
    if chunk_size < 1:
        raise ValueError("chunk_size must be >= 1")
    state, obs = env_core.reset(cfg, params, data, n_envs)
    steps = int(steps)
    if steps <= 0:
        return state, {}
    graphed = _graphed(eager, data.close.device)
    cur = _start(state, obs, driver, driver_carry, data.close.device)
    cur, buf = _run_chunks(cfg, params, data, driver, cur, 0, steps, steps, generator, collect,
                           None, chunk_size, cache or EpisodeGraphs(), graphed)
    return _finish(cur, buf, graphed)


def rollout(cfg: EnvConfig, params: EnvParams, data: MarketData, driver: Driver,
            steps: int, generator: torch.Generator, collect: bool = True,
            driver_carry: Any = None, n_envs: int = 1,
            cache: Optional[EpisodeGraphs] = None, eager: Optional[bool] = None):
    """:func:`rollout_chunked` in chunks of 64 steps: the JAX package
    scans the whole episode as one program, which on the card is a graph
    per chunk length all the same."""
    return rollout_chunked(cfg, params, data, driver, steps, generator, collect, driver_carry,
                           n_envs=n_envs, cache=cache, eager=eager)


def rollout_streamed(cfg: EnvConfig, params: EnvParams, streamer, driver: Driver,
                     steps: int, generator: torch.Generator, collect: bool = True,
                     driver_carry: Any = None, chunk_size: int = 64,
                     cache: Optional[EpisodeGraphs] = None, eager: Optional[bool] = None):
    """One env's episode over a :class:`~gymfx_tpu_torch.data.feed.BarStreamer`
    (the JAX package's ``rollout_streamed``, core/rollout.py:266-330).

    The same steps as :func:`rollout_chunked` on the resident tape, with
    the same global cursors; each shard's ``row0`` rebases them into its
    arrays, and the streamer issues shard ``k + 1``'s copy before shard
    ``k``'s steps run.  Step ``i`` moves the cursor to bar ``i``, so the
    shard serving cursors ``[lo, hi)`` runs steps ``[lo, hi)``, cut into
    chunks (``eager`` as in :func:`rollout_chunked`).  Through the graphs
    each shard is copied into the cache's one staging shard (its ``row0``
    a 0-d device tensor there), so the graphs of one chunk length serve
    every shard.

    As in the JAX package, an episode that ends mid-stream freezes its
    cursor; once a later shard no longer covers it, the inert post-done
    reads clamp to that shard's edge and may differ from the resident
    episode.  Every step up to the end is the resident episode's.
    """
    if chunk_size < 1:
        raise ValueError("chunk_size must be >= 1")
    cache = cache or EpisodeGraphs()
    cur = buf = None
    graphed = False
    done_steps = 0
    steps = int(steps)
    for lo, hi, shard in streamer.iter_shards():
        if cur is None:
            # the cursor starts at bar 0, which shard 0 always covers
            state, obs = env_core.reset(cfg, params, shard, 1)
            if steps <= 0:
                return state, {}
            graphed = _graphed(eager, shard.close.device)
            cur = _start(state, obs, driver, driver_carry, shard.close.device)
        end = steps if hi is None else min(int(hi), steps)
        if end > done_steps:
            tape = cache.stage(shard) if graphed else shard
            cur, buf = _run_chunks(cfg, params, tape, driver, cur, done_steps, end, steps,
                                   generator, collect, buf, chunk_size, cache, graphed)
        done_steps = max(done_steps, end)
        if done_steps >= steps:
            break
    return _finish(cur, buf, graphed)
