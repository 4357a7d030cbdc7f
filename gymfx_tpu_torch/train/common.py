"""Shared trainer helpers: the port of ``gymfx_tpu/train/common.py``'s
``make_train_many_with_data`` (:43-57), ``make_train_many_overlapped``
(:60-128), ``profiler_workload`` (:448-520), ``build_train_eval_envs``
(:126-187), ``build_portfolio_train_eval_envs`` (:201-246),
``labeled_eval_summary`` and ``eval_checkpointed_policy``
(:249-311), ``validate_minibatch_scheme`` and
``resolve_minibatch_scheme`` (:315-371), ``minibatch_plan`` (:374-409)
and ``masked_reset``; ``member_minibatch_plan`` is ``minibatch_plan``
over a population's member axis (the JAX package's ``vmap`` of it).

Trees of fields are dicts of tensors.  ``make_train_many_with_data`` and
``make_train_many_overlapped`` are the eager loops (the CPU's): on a CUDA
device the trainers chain their phases' graph replays instead
(train/ppo.py, and :func:`run_overlapped_graphed` for the overlapped
schedule on two streams); either way the metrics come back stacked on a
leading ``(k,)`` axis, on the device.
"""
from __future__ import annotations

import contextlib
import hashlib
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from gymfx_tpu_torch import resolve_device
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.data.feed import Frame, MarketDataset, load_dataframe
from gymfx_tpu_torch.resilience.guards import tree_leaves, tree_map
from gymfx_tpu_torch.resilience.loop import ResilientLoop
from gymfx_tpu_torch.scengen.feed import ScenGenDataset
from gymfx_tpu_torch.telemetry import DelayedLogger, null_tracer, register_resilience


def masked_reset(done, fresh, cur):
    """Where ``done`` ((N,) bool), replace each env's entry of ``cur``
    with ``fresh``'s (a tensor, or a NamedTuple or tuple of tensors, such
    as a recurrent carry; ``fresh`` broadcasts over the env axis, so a
    single-env (1, ...) reset state serves every env)."""

    def one(f, c):
        return torch.where(done.view(-1, *([1] * (c.dim() - 1))), f, c)

    if isinstance(cur, tuple):
        leaves = (one(f, c) for f, c in zip(fresh, cur))
        return type(cur)(*leaves) if hasattr(cur, "_fields") else tuple(leaves)
    return one(fresh, cur)


class TrainLoop:
    """The host side of a trainer's ``train`` loop around its
    dispatches, which PPOTrainer, ImpalaTrainer and PortfolioPPOTrainer
    share (the JAX package's per-loop wiring, gymfx_tpu/train/ppo.py
    :687-753): a ``resilience/loop.ResilientLoop`` built from
    ``loop_kwargs`` with the run's ledger and flight recorder, and, with
    ``metrics_stream``, the one-dispatch-late metric drain (the
    telemetry's ``DeviceMetricStream``, else a ``DelayedLogger`` for
    ``log_every``) and a ``train/superstep`` span around each dispatch.
    With ``telemetry=None`` and ``log_every=0`` it adds nothing to the
    loop but the ResilientLoop it always had."""

    def __init__(self, algo: str, *, iters: int, steps_per_iter: int, log_every: int = 0,
                 telemetry=None, metrics_stream: bool = True, workload=None, **loop_kwargs):
        self.algo, self.telemetry = algo, telemetry
        self.logger = None
        if metrics_stream:
            self.logger = (DelayedLogger(algo, log_every, iters) if telemetry is None else
                           telemetry.device_stream(algo, iters=iters, log_every=log_every,
                                                   steps_per_iter=steps_per_iter))
        self.tracer = telemetry.tracer if telemetry is not None and metrics_stream \
            else null_tracer()
        self.hooks = ResilientLoop(
            steps_per_iter=steps_per_iter,
            loggers=() if self.logger is None else (self.logger,),
            ledger=None if telemetry is None else telemetry.ledger,
            recorder=None if telemetry is None else telemetry.recorder,
            profiler=None if telemetry is None else telemetry.profiler, **loop_kwargs)
        # the profiler's workload payload, ``workload(it_start, k)``,
        # resolved when a capture bundle is written
        if self.hooks.profiler is not None and workload is not None:
            self.hooks.profiler.set_workload_source(workload)

    def start(self, rng_state: Callable[[], Any]) -> None:
        """Bind the telemetry to the run: the flight recorder's generator
        source (``rng_state``, read at dump time) and the watchdog's live
        counters as registry gauges."""
        telemetry = self.telemetry
        if telemetry is None:
            return
        if telemetry.recorder is not None:
            telemetry.recorder.set_rng_source(rng_state)
        if self.hooks.monitor is not None:
            register_resilience(telemetry.registry, monitor=self.hooks.monitor, name=self.algo)

    def span(self, it: int, k: int):
        return self.tracer.span("train/superstep", algo=self.algo, it=it, k=k)

    def begin_superstep(self, it: int, k: int) -> bool:
        """Before dispatching iterations ``[it, it + k)``: open the
        profiler's capture window when this superstep is due."""
        return self.hooks.begin_superstep(it, k)

    def after_superstep(self, it: int, k: int, metrics: Dict[str, Any], state_fn) -> None:
        """Right after dispatching iterations ``[it, it + k)``: the drain
        first (an aborting hook flushes it, so it must already hold this
        superstep's metrics), then the resilience hooks."""
        if self.logger is not None:
            self.logger.after_dispatch(it, k, metrics)
        self.hooks.after_superstep(it, k, metrics, state_fn)

    def finish(self, state_fn) -> None:
        if self.logger is not None:
            self.logger.finish()
        self.hooks.finish(state_fn)


def make_train_many_with_data(step: Callable):
    """The curriculum's ``train_many(state, data, k)``: ``k`` train steps
    of ``step(state, data) -> (state, metrics)`` on one tape, the metrics
    stacked on a leading ``(k,)`` axis (the JAX package's
    ``make_train_many_with_data``, :43-57)."""

    def train_many(state, data, k: int):
        k = int(k)
        if k < 1:
            raise ValueError(f"train_many needs k >= 1, got {k}")
        history = []
        for _ in range(k):
            state, metrics = step(state, data)
            history.append(metrics)
        return state, {key: torch.stack([m[key] for m in history]) for key in history[0]}

    return train_many


def split_generator(generator: torch.Generator) -> Tuple[torch.Generator, torch.Generator]:
    """Two generators for one overlapped body, the rollout's and the
    update's (the JAX package's ``jax.random.split(inter.rng)``): seeded
    from a sha256 of ``generator``'s state, on its device.  A host
    computation that draws nothing, so the two phases' draws are a function
    of the schedule and never of which stream runs first."""
    digest = hashlib.sha256(generator.get_state().numpy().tobytes()).digest()
    return tuple(torch.Generator(device=generator.device).manual_seed(
        int.from_bytes(digest[8 * i: 8 * i + 8], "little") >> 1) for i in (0, 1))


def make_train_many_overlapped(rollout_phase: Callable, update_phase: Callable,
                               learner_fields: Tuple[str, ...] = ("params", "opt_state")):
    """The pipelined superstep, op by op (the JAX package's
    ``make_train_many_overlapped``, :60-128): ``train_many(state, k)`` runs
    a prologue rollout, then ``k - 1`` bodies of {rollout i+1 on the params
    before the update, update i}, then the epilogue update: as many
    rollouts and updates as the sequential driver.

    ``rollout_phase(state) -> (inter, rollout_out)`` and
    ``update_phase(state, rollout_out) -> (state, metrics)`` draw from
    ``state.generator``.  Each body splits the carried generator
    (:func:`split_generator`): the rollout draws from the first, which the
    carry keeps, the update from the second; the update's
    ``learner_fields`` are merged into the rollout's carry, so the
    rollouts act on params one update stale and the update's quarantine
    resets are dropped inside a dispatch (the JAX semantics).  ``k = 1``
    is the sequential train step.  Returns (state, metrics stacked on a
    leading ``(k,)`` axis); the caller's generator ends where the carried
    one did."""

    def merge(rolled, updated):
        return rolled._replace(**{f: getattr(updated, f) for f in learner_fields})

    def train_many(state, k: int):
        k = int(k)
        if k < 1:
            raise ValueError(f"train_many needs k >= 1, got {k}")
        caller = state.generator
        inter, rollout_out = rollout_phase(state)
        history = []
        for _ in range(k - 1):
            g_roll, g_upd = split_generator(inter.generator)
            inter2, rollout_out2 = rollout_phase(inter._replace(generator=g_roll))
            updated, metrics = update_phase(inter._replace(generator=g_upd), rollout_out)
            history.append(metrics)
            inter, rollout_out = merge(inter2, updated), rollout_out2
        final, last = update_phase(inter, rollout_out)
        history.append(last)
        if final.generator is not caller:
            caller.set_state(final.generator.get_state())
            final = final._replace(generator=caller)
        return final, {key: torch.stack([m[key] for m in history]) for key in last}

    return train_many


def run_overlapped_graphed(state, k: int, rollout, update, learner_fields: Tuple[str, ...],
                           side: Optional["torch.cuda.Stream"]):
    """:func:`make_train_many_overlapped`'s schedule from two sets of phase
    graphs on two streams: rollout j and update j replay the graphs of set
    ``j % 2``, each set with its own static buffers and memory pools, so
    that rollout i+1 (set B, the current stream) never writes what update
    i (set A, ``side``) reads, and update i writes its params into its own
    static outputs while rollout i+1 reads the ones before it.

    ``rollout(state, s, generator) -> (inter, rollout_out, graph)`` replays
    set ``s``'s rollout graph on the current stream; ``update(inter,
    rollout_out, graph, s, generator) -> (state, metrics)`` replays set
    ``s``'s update graph, which reads ``graph``'s buffers; both return the
    static outputs.  Events join the streams: update i waits for rollout
    i, rollout i+1 for update i-1 (its params, and its reads of set B's
    buffers), the epilogue update (on the current stream) for update k-2,
    so everything the caller enqueues after this returns (the metrics'
    pinned copy, the late read's event) follows both phases of every
    body.  Each body's metrics are stacked on ``side`` right after its
    update, before the set's next replay overwrites them.  With ``side``
    None (the CPU's static-buffer graphs) the same schedule runs in order
    on the one device queue."""
    streams = side is not None
    main = torch.cuda.current_stream() if streams else None
    caller = gen = state.generator
    inter, rollout_out, graph = rollout(state, 0, gen)
    rolled = main.record_event() if streams else None
    updated_ev = None
    history = []
    for i in range(k - 1):
        g_roll, g_upd = split_generator(gen)
        if streams:
            side.wait_event(rolled)
        with torch.cuda.stream(side) if streams else contextlib.nullcontext():
            updated, metrics = update(inter._replace(generator=g_upd), rollout_out, graph, i % 2,
                                      g_upd)
            stacked = torch.stack(list(metrics.values()))
            done = side.record_event() if streams else None
        if streams:
            stacked.record_stream(main)
            if updated_ev is not None:
                main.wait_event(updated_ev)
        history.append(stacked)
        inter2, rollout_out, graph = rollout(inter._replace(generator=g_roll), (i + 1) % 2, g_roll)
        rolled = main.record_event() if streams else None
        inter = inter2._replace(**{f: getattr(updated, f) for f in learner_fields})
        updated_ev, gen = done, g_roll
    if updated_ev is not None:
        main.wait_event(updated_ev)
    final, last = update(inter, rollout_out, graph, (k - 1) % 2, gen)
    history.append(torch.stack(list(last.values())))
    if gen is not caller:
        caller.set_state(gen.get_state())
    return final._replace(generator=caller), dict(zip(last, torch.stack(history).unbind(1)))


def profiler_workload(trainer, state, k: int, *, algo: str, params, n_envs: int, horizon: int,
                      update_epochs: int = 1, split_iters: int = 2, data=None) -> Dict[str, Any]:
    """The workload payload of a capture bundle's manifest
    (``ProfilerSession.set_workload_source``; the JAX package's :448-520):
    the analytic FLOPs of a train step (``telemetry/mfu``) and the
    ``bench_util.measure_phase_split`` baseline the report reconciles
    against, measured from a clone of the live ``state`` that is copied
    back (its tensors are the graphs' static outputs), after the capture
    window.  No XLA cost model exists here: ``xla_flops_*`` are None.
    Never raises (a failed part is None)."""
    from gymfx_tpu_torch.bench_util import measure_phase_split
    from gymfx_tpu_torch.telemetry.mfu import analytic_train_step_flops

    info: Dict[str, Any] = {"algo": str(algo), "n_envs": int(n_envs), "horizon": int(horizon),
                            "steps_per_iter": int(n_envs) * int(horizon),
                            "xla_flops_per_dispatch": None, "xla_flops_per_step": None}
    try:
        info["analytic_flops_per_step"] = analytic_train_step_flops(
            params, num_envs=int(n_envs), horizon=int(horizon), update_epochs=int(update_epochs))
    except Exception:
        info["analytic_flops_per_step"] = None
    try:
        split = measure_phase_split(trainer, state, int(split_iters), data)
    except Exception:
        split = None
    info["phase_split"] = None if split is None else {
        "rollout_ms": split[0] / int(split_iters) * 1e3,
        "update_ms": split[1] / int(split_iters) * 1e3,
        "iters": int(split_iters),
        "source": "measure_phase_split",
    }
    return info


def build_train_eval_envs(config: Dict[str, Any], *, device=None) -> Tuple[Any, Optional[Any]]:
    """(train_env, eval_env-or-None) honouring the out-of-sample keys:

    ``eval_data_file``   evaluate on a separate dataset file;
    ``eval_split``       hold out the LAST fraction of bars (a chronological
                         cut: a random one would leak future bars into
                         training).
    Without either, eval_env is None and evaluation is in-sample.  Both
    envs are on ``device`` (CUDA unless named)."""
    eval_file = config.get("eval_data_file")
    split = config.get("eval_split")
    feed = str(config.get("feed") or "replay").lower()
    if eval_file and split:
        raise ValueError("set either eval_data_file or eval_split, not both")
    if feed == "curriculum" and split:
        raise ValueError(
            "feed=curriculum cannot hold out via eval_split (which tape "
            "would be cut?); name a held-out tape with eval_data_file"
        )
    if eval_file:
        eval_config = dict(config)
        eval_config["input_data_file"] = str(eval_file)
        if feed in ("scengen", "curriculum"):
            # train on generated tapes or a library, evaluate on the named
            # replayed tape
            eval_config["feed"] = "replay"
            eval_config.pop("tapes", None)
        return Environment(config, device=device), Environment(eval_config, device=device)
    if split:
        frac = float(split)
        if not 0.0 < frac < 1.0:
            raise ValueError(f"eval_split must be in (0, 1), got {split!r}")
        min_bars = int(config.get("window_size", 32)) + 2

        def check(cut: int, n_all: int) -> None:
            if cut < min_bars or n_all - cut < min_bars:
                raise ValueError(
                    f"eval_split={frac} leaves too few bars (train {cut}, "
                    f"eval {n_all - cut}; both need >= {min_bars})"
                )

        if feed == "scengen":
            # generate once, then cut chronologically: both halves come from
            # one seeded tape (a generation per half would desync the
            # overlay processes at the cut)
            full = ScenGenDataset(config, device=resolve_device(device))
            n_all = len(full)
            cut = n_all - int(n_all * frac)
            check(cut, n_all)
            return (Environment(config, dataset=full.sliced(slice(0, cut)), device=device),
                    Environment(config, dataset=full.sliced(slice(cut, None)), device=device))
        frame = load_dataframe(config)
        n_all = len(frame)
        cut = n_all - int(n_all * frac)
        check(cut, n_all)

        def part(rows: slice) -> MarketDataset:
            return MarketDataset(Frame({k: v[rows] for k, v in frame.columns.items()},
                                       frame.timestamps[rows]), config)

        return (Environment(config, dataset=part(slice(0, cut)), device=device),
                Environment(config, dataset=part(slice(cut, None)), device=device))
    return Environment(config, device=device), None


def build_portfolio_train_eval_envs(config: Dict[str, Any], *,
                                    device=None) -> Tuple[Any, Optional[Any]]:
    """(train_env, eval_env-or-None) for the multi-pair portfolio env (the
    JAX package's :201-246): ``eval_portfolio_files`` evaluates on a
    separate per-pair file map (the same pairs in the same order: the
    policy's heads are positional); ``eval_split`` holds out the LAST
    fraction of the aligned bars, cut after the cross-pair join.
    ``eval_data_file`` is refused: one file cannot describe a book."""
    from gymfx_tpu_torch.core.portfolio import PortfolioEnvironment

    if config.get("eval_data_file"):
        raise ValueError(
            "portfolio trainers hold out via eval_split or "
            "eval_portfolio_files (a per-pair file map); eval_data_file "
            "is single-pair only"
        )
    eval_files = config.get("eval_portfolio_files")
    split = config.get("eval_split")
    if eval_files and split:
        raise ValueError("set either eval_portfolio_files or eval_split, not both")
    if eval_files:
        eval_config = dict(config)
        eval_config["portfolio_files"] = dict(eval_files)
        eval_config.pop("eval_portfolio_files", None)
        train_env = PortfolioEnvironment(config, device=device)
        eval_env = PortfolioEnvironment(eval_config, device=device)
        if list(eval_env.pairs) != list(train_env.pairs):
            raise ValueError(
                "eval_portfolio_files must list the same pairs in the "
                f"same order as portfolio_files (train {train_env.pairs}, "
                f"eval {eval_env.pairs})"
            )
        return train_env, eval_env
    if split:
        frac = float(split)
        return (PortfolioEnvironment(config, split=("train", frac), device=device),
                PortfolioEnvironment(config, split=("eval", frac), device=device))
    return PortfolioEnvironment(config, device=device), None


def labeled_eval_summary(make_summary, train_env, eval_env) -> Dict[str, Any]:
    """The out-of-sample summary shape: ``make_summary(env_or_None)`` runs
    a greedy evaluation on the given env (None = the training env)."""
    if eval_env is None:
        summary = make_summary(None)
        summary["eval_scope"] = "in_sample"
        return summary
    summary = make_summary(eval_env)
    summary["eval_scope"] = "held_out"
    summary["eval_bars"] = eval_env.n_bars
    summary["train_bars"] = train_env.n_bars
    summary["in_sample"] = make_summary(None)
    return summary


def eval_checkpointed_policy(
    config: Dict[str, Any],
    *,
    build_envs,
    make_trainer,
    evaluate_fn,
    resolve_policy=None,
    validate=None,
) -> Dict[str, Any]:
    """The ``driver_mode=policy`` skeleton: checkpoint-dir guard,
    metadata honour (``resolve_policy(meta, config)`` edits the config
    copy), train/eval env build, ``validate(meta, env)``, template-checked
    params restore, greedy evaluation, and the labeled summary keys."""
    from gymfx_tpu_torch.train.checkpoint import load_params, read_metadata

    ckpt_dir = config.get("checkpoint_dir")
    if not ckpt_dir:
        raise ValueError("driver_mode=policy requires checkpoint_dir")
    meta = read_metadata(str(ckpt_dir))
    config = dict(config)
    # the minibatch scheme shapes only the update, which never runs in
    # inference: pin the scheme valid for any env count so the
    # env_permute default cannot refuse a one-env evaluation trainer
    config["ppo_minibatch_scheme"] = "sample_permute"
    if resolve_policy is not None:
        resolve_policy(meta, config)
    train_env, eval_env = build_envs(config)
    env = eval_env if eval_env is not None else train_env
    if validate is not None:
        validate(meta, env)
    trainer = make_trainer(env, config)
    # template-checked restore: an architecture mismatch fails at load
    # time, not as a shape error inside the episode
    params, step = load_params(str(ckpt_dir), template=trainer.params_template())
    summary = evaluate_fn(trainer, params, config.get("steps"))
    summary["checkpoint_step"] = step
    summary["eval_scope"] = "held_out" if eval_env is not None else "in_sample"
    summary["mode"] = "inference"
    return summary


def validate_minibatch_scheme(scheme: str, n_envs: int, minibatches: int,
                              *, horizon: Optional[int] = None) -> None:
    """Construction-time validation shared by the PPO trainers."""
    if scheme not in ("sample_permute", "env_permute"):
        raise ValueError(
            "ppo_minibatch_scheme must be 'sample_permute' or "
            f"'env_permute', got {scheme!r}"
        )
    if scheme == "env_permute" and n_envs % minibatches:
        raise ValueError(
            f"env_permute needs num_envs ({n_envs}) divisible by "
            f"ppo_minibatches ({minibatches})"
        )
    if scheme == "sample_permute" and horizon is not None:
        # the plan slices floor(T*N / minibatches) samples per minibatch,
        # so a remainder is never trained on in that epoch
        total = int(horizon) * int(n_envs)
        dropped = total % int(minibatches)
        if dropped:
            warnings.warn(
                f"sample_permute drops {dropped} of {total} samples per "
                f"epoch (horizon*num_envs={total} not divisible by "
                f"ppo_minibatches={minibatches}); pick sizes where "
                "horizon*num_envs % minibatches == 0 to train on every "
                "sample",
                stacklevel=2,
            )


def resolve_minibatch_scheme(config, n_envs: int, minibatches: int) -> None:
    """From-config resolution of the env_permute default: with fewer envs
    than minibatches no whole-trajectory minibatch exists, so degrade to
    sample_permute with a warning.  Mutates ``config`` in place."""
    scheme = str(config.get("ppo_minibatch_scheme", "env_permute"))
    if scheme == "env_permute" and int(n_envs) < int(minibatches):
        warnings.warn(
            f"ppo_minibatch_scheme=env_permute needs num_envs "
            f"({n_envs}) >= ppo_minibatches ({minibatches}); falling "
            "back to sample_permute for this run — raise num_envs to a "
            "multiple of ppo_minibatches to use trajectory minibatches",
            stacklevel=2,
        )
        config["ppo_minibatch_scheme"] = "sample_permute"


def minibatch_plan(fields: Dict[str, Any], *, scheme: str, n_envs: int,
                   horizon: int, minibatches: int):
    """``(n_perm, mb, take)``: a per-epoch permutation of ``n_perm``
    indices is cut into ``minibatches`` chunks of ``mb``, and ``take(idx)``
    gathers one flat minibatch from the (T, N, ...) ``fields`` (a field
    may be a tuple of such tensors, as a recurrent carry is).

      sample_permute  an iid shuffle of all T*N samples;
      env_permute     permute envs; a minibatch holds whole (T, ...)
                      trajectories, flattened env-major.
    """
    if scheme == "env_permute":
        source = tree_map(lambda x: x.swapaxes(0, 1), fields)
        mb = n_envs // minibatches

        def take(idx):
            return tree_map(lambda x: x[idx].reshape(mb * horizon, *x.shape[2:]), source)

        return n_envs, mb, take

    n_total = horizon * n_envs
    source = tree_map(lambda x: x.reshape(n_total, *x.shape[2:]), fields)

    def take(idx):
        return tree_map(lambda x: x[idx], source)

    return n_total, n_total // minibatches, take


def member_minibatch_plan(fields: Dict[str, Any], *, scheme: str, members: int, n_envs: int,
                          horizon: int, minibatches: int):
    """:func:`minibatch_plan` for each member of a population at once:
    ``fields`` are (T, P, N, ...), each member permutes its own ``n_perm``
    indices, and ``take(idx)`` gathers (P, mb) indices into a (P, M, ...)
    minibatch whose member ``p`` is what :func:`minibatch_plan`'s ``take``
    gives on member ``p``'s (T, N, ...) fields."""
    some = tree_leaves(fields)[0]
    rows = torch.arange(members, device=some.device)[:, None]
    if scheme == "env_permute":
        source = tree_map(lambda x: x.permute(1, 2, 0, *range(3, x.dim())), fields)
        mb = n_envs // minibatches

        def take(idx):
            return tree_map(lambda x: x[rows, idx].reshape(members, mb * horizon, *x.shape[3:]),
                            source)

        return n_envs, mb, take
    n_total = horizon * n_envs
    source = tree_map(lambda x: x.transpose(0, 1).reshape(members, n_total, *x.shape[3:]),
                      fields)

    def take(idx):
        return tree_map(lambda x: x[rows, idx], source)

    return n_total, n_total // minibatches, take
