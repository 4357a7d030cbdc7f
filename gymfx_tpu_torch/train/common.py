"""Shared trainer helpers: the port of ``gymfx_tpu/train/common.py``'s
``make_train_many_with_data`` (:43-57), ``build_train_eval_envs``
(:126-187), ``build_portfolio_train_eval_envs`` (:201-246),
``labeled_eval_summary`` and ``eval_checkpointed_policy``
(:249-311), ``validate_minibatch_scheme`` and
``resolve_minibatch_scheme`` (:315-371), ``minibatch_plan`` (:374-409)
and ``masked_reset``.

Trees of fields are dicts of tensors.  ``make_train_many_with_data`` is
the eager loop (the CPU's): on a CUDA device ``PPOTrainer`` chains its
phases' graph replays instead (train/ppo.py); either way the metrics
come back stacked on a leading ``(k,)`` axis, on the device.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from gymfx_tpu_torch import resolve_device
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.data.feed import Frame, MarketDataset, load_dataframe
from gymfx_tpu_torch.resilience.guards import tree_map
from gymfx_tpu_torch.scengen.feed import ScenGenDataset


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
