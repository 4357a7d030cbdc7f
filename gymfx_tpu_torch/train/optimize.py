"""Population hyperparameter search (mode=optimization): the GA.

The port of ``gymfx_tpu/train/optimize.py``.  The reference exposes a
GA-tunable schema on its ATR bracket strategy ((name, lo, hi, type)
tuples, reference strategy_plugins/direct_atr_sltp.py:345-350); here the
optimizer is in the framework: strategy hyperparameters are ``EnvParams``
fields, so a POPULATION of P candidates is one batched episode of P env
rows, each schema field a ``(P,)`` params column (the binding the
portfolio's ``core/portfolio.bind_rows`` makes for pairs).  Every
candidate sees the same action stream: the JAX package's draws, ``split``
then ``randint(k, (), 0, 3)`` from ``PRNGKey(seed)`` each step, drawn once
with the port's threefry (``lob/prng.py``) and replayed through
``core/rollout.replay_driver``.

On the card the episode replays from ``rollout_chunked``'s graphs of
64-step chunks (``Environment.episode_graphs``): the columns are static
buffers that each generation overwrites in place, so one ring size
(``atr_period``) captures its chunk graphs once and every generation
replays them.  The host reads the fitness (rap, total return, drawdown,
trades) once per generation; the elitist refill stays in numpy with the
JAX package's ``default_rng(seed)`` draws.

Algorithm: elitist evolution — evaluate population fitness (risk-
adjusted performance: total_return - lambda * drawdown_fraction, the
reference's ``rap``), keep the top half, refill with Gaussian mutations
of elites clipped to the schema bounds.  ``atr_period`` sizes a ring
buffer (a static shape), so an OUTER sweep covers it: one GA per period
over a small grid (``optimize_atr_periods``, by default points spanning
the reference's 7..30) and the best (k_sl, k_tp, atr_period) triple by
fitness.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gymfx_tpu_torch.core.rollout import replay_driver, rollout_chunked
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.lob import prng

DEFAULT_SCHEMA: Tuple[Tuple[str, float, float], ...] = (
    ("k_sl", 1.0, 4.0),
    ("k_tp", 1.5, 6.0),
)

# the port's copy of the built-in ATR strategy's GA schema
# (gymfx_tpu/plugins/builtin/strategies.py hparam_schema, reference
# direct_atr_sltp.py:345-350)
STRATEGY_HPARAM_SCHEMA: Tuple[Tuple[str, float, float, str], ...] = (
    ("atr_period", 7, 30, "int"),
    ("k_sl", 1.0, 4.0, "float"),
    ("k_tp", 1.5, 6.0, "float"),
)


def episode_actions(seed: int, steps: int) -> np.ndarray:
    """The fitness episode's (steps,) int32 action stream: the JAX
    package's ``rng, k = split(rng); randint(k, (), 0, 3)`` per step from
    ``PRNGKey(seed)``."""
    key = prng.PRNGKey(seed)
    subkeys = []
    for _ in range(int(steps)):
        pair = prng.split(key, 2)
        key = pair[0]
        subkeys.append(pair[1])
    if not subkeys:
        return np.zeros((0,), np.int32)
    return prng.randint(torch.stack(subkeys), 1, 0, 3)[:, 0].numpy()


class CandidateEpisode:
    """One seeded random-entry episode of ``population`` candidates, each
    an env row whose schema fields are its own values.  A call takes a
    (population, len(schema)) array and returns the device tensors
    ``(rap, total_return, dd_fraction, trades)``, each (population,).

    Shared by the GA's fitness and the winner's held-out re-evaluation,
    so both numbers measure the same thing on different bars.  The
    columns, the params built on them and the driver are made once, so
    on the card every call replays the same chunk graphs (``eager=True``
    runs every chunk op by op, for comparisons)."""

    def __init__(self, env: Environment, schema: Sequence[Tuple[str, float, float]],
                 risk_lambda: float, steps: int, population: int, seed: int,
                 eager: Optional[bool] = None):
        self.env = env
        self.schema = list(schema)
        self.risk_lambda = float(risk_lambda)
        self.steps = int(steps)
        self.population = int(population)
        self.eager = eager
        cfg, device = env.cfg, env.device
        self.columns = {
            name: torch.zeros((self.population,), dtype=cfg.dtype, device=device)
            for name, _, _ in self.schema
        }
        self.params = env.params._replace(**self.columns)
        self.driver = replay_driver(episode_actions(seed, self.steps), device)
        self.percent = torch.tensor(100.0, dtype=cfg.dtype, device=device)
        self.generator = torch.Generator(device=device)

    def __call__(self, vals):
        # the JAX package's jnp.asarray(pop, float32), then astype(dtype)
        host = torch.from_numpy(np.asarray(vals, dtype=np.float32).reshape(self.population, -1))
        for i, (name, _, _) in enumerate(self.schema):
            self.columns[name].copy_(host[:, i].to(self.env.cfg.dtype))
        data = self.env.require_resident_data("the optimizer's episode")
        state, _ = rollout_chunked(
            self.env.cfg, self.params, data, self.driver, self.steps, self.generator,
            collect=False, n_envs=self.population, cache=self.env.episode_graphs,
            eager=self.eager,
        )
        total_return = state.equity_delta / self.params.initial_cash
        dd_fraction = state.max_drawdown_pct / self.percent
        rap = total_return - self.risk_lambda * dd_fraction
        return rap, total_return, dd_fraction, state.trade_count


def candidate_episode_metrics(env: Environment, schema: Sequence[Tuple[str, float, float]],
                              risk_lambda: float, steps: int, *, population: int = 1,
                              seed: int = 0, eager: Optional[bool] = None) -> CandidateEpisode:
    """``vals -> (rap, total_return, dd_fraction, trades)`` for
    ``population`` candidates on ``env``'s bars (:class:`CandidateEpisode`);
    the JAX function's ``(vals, rng)`` takes its key's seed here."""
    return CandidateEpisode(env, schema, risk_lambda, steps, population, seed, eager)


def hparam_schema(config: Dict[str, Any]) -> List[Tuple[str, float, float]]:
    raw = config.get("optimize_params")
    if isinstance(raw, str):  # a command line delivers a JSON string
        raw = json.loads(raw)
    if raw:
        return [(str(k), float(lo), float(hi)) for k, (lo, hi) in raw.items()]
    return list(DEFAULT_SCHEMA)


class Optimizer:
    def __init__(
        self,
        env: Environment,
        schema: Sequence[Tuple[str, float, float]],
        *,
        population: int = 32,
        risk_lambda: float = 1.0,
        mutation_scale: float = 0.15,
        episode_steps: Optional[int] = None,
        eager: Optional[bool] = None,
    ):
        self.env = env
        self.schema = list(schema)
        self.population = int(population)
        if self.population < 2:
            raise ValueError("optimize_population must be >= 2")
        self.risk_lambda = float(risk_lambda)
        self.mutation_scale = float(mutation_scale)
        self.episode_steps = int(episode_steps or env.cfg.n_bars - 1)
        self.eager = eager
        for name, _, _ in self.schema:
            if not hasattr(env.params, name):
                raise ValueError(f"unknown hyperparameter {name!r} (not in EnvParams)")
        self._episodes: Dict[int, CandidateEpisode] = {}

    def _fitness(self, population_vals, seed: int):
        """The population's (rap, total_return, dd_fraction, trades) on the
        device: one batched episode, every candidate on one action stream
        (fitness differences come from the hyperparameters, not from
        action-sampling luck)."""
        episode = self._episodes.get(seed)
        if episode is None:
            episode = self._episodes[seed] = candidate_episode_metrics(
                self.env, self.schema, self.risk_lambda, self.episode_steps,
                population=self.population, seed=seed, eager=self.eager)
        return episode(population_vals)

    def run(self, generations: int = 8, seed: int = 0) -> Dict[str, Any]:
        rng = np.random.default_rng(seed)
        lo = np.array([s[1] for s in self.schema])
        hi = np.array([s[2] for s in self.schema])
        pop = rng.uniform(lo, hi, size=(self.population, len(self.schema)))

        history = []
        graphs_before = set(self.env.episode_graphs.graphs)
        t0 = time.perf_counter()
        best_vals, best_fit = None, -np.inf
        for gen in range(generations):
            rap_t, _total_return, _dd, _trades = self._fitness(pop, seed)
            rap = rap_t.cpu().numpy().astype(np.float64)  # the generation's one read
            order = np.argsort(-rap)
            if rap[order[0]] > best_fit:
                best_fit = float(rap[order[0]])
                best_vals = pop[order[0]].copy()
            history.append(
                {
                    "generation": gen,
                    "best_rap": float(rap[order[0]]),
                    "mean_rap": float(rap.mean()),
                    # population spread: zero means NOTHING discriminated
                    # the candidates this generation
                    "rap_std": float(rap.std()),
                    "best_candidate": {
                        name: float(pop[order[0]][i])
                        for i, (name, _, _) in enumerate(self.schema)
                    },
                }
            )
            # elitist refill that preserves the population size exactly
            elites = pop[order[: max(1, self.population // 2)]]
            n_fill = self.population - len(elites)
            parents = elites[rng.integers(0, len(elites), size=n_fill)]
            mutations = parents + rng.normal(
                0.0, self.mutation_scale * (hi - lo), size=parents.shape
            )
            pop = np.clip(np.concatenate([elites, mutations], axis=0), lo, hi)
        wall = time.perf_counter() - t0
        captured = [g for k, g in self.env.episode_graphs.graphs.items() if k not in graphs_before]

        # a winner pinned to a schema bound says the optimum may lie
        # OUTSIDE the searched box: the bound is the binding constraint
        boundary: Dict[str, str] = {}
        for i, (name, l, h) in enumerate(self.schema):
            v = float(best_vals[i])
            tol = 1e-3 * max(h - l, 1e-12)
            if v <= l + tol:
                boundary[name] = "low"
            elif v >= h - tol:
                boundary[name] = "high"

        return {
            "mode": "optimization",
            "schema": [
                {"name": n, "low": float(l), "high": float(h)}
                for n, l, h in self.schema
            ],
            "population": self.population,
            "generations": generations,
            "risk_penalty_lambda": self.risk_lambda,
            "best_params": {
                name: float(best_vals[i])
                for i, (name, _, _) in enumerate(self.schema)
            },
            "best_rap": best_fit,
            "boundary_clipped": boundary,
            "history": history,
            "selection_signal": bool(any(h["rap_std"] > 0.0 for h in history)),
            "wall_seconds": wall,
            # the part of wall_seconds spent capturing episode graphs (0
            # on the CPU and when this ring size's graphs already existed)
            "capture_seconds": float(sum(g.capture_s for g in captured)),
        }


def atr_period_bounds(config: Dict[str, Any]) -> Tuple[int, int]:
    """The sweepable ``atr_period`` range: a user ``optimize_params``
    override wins; otherwise the builtin strategy schema's 7..30
    (reference strategy_plugins/direct_atr_sltp.py:346)."""
    override = next(
        ((l, h) for n, l, h in hparam_schema(config) if n == "atr_period"),
        None,
    )
    if override is None:
        override = next((l, h) for n, l, h, _t in STRATEGY_HPARAM_SCHEMA if n == "atr_period")
    lo, hi = int(override[0]), int(override[1])
    if lo < 1 or hi < lo:
        raise ValueError(
            f"atr_period bounds [{lo}, {hi}] must be positive ints with "
            "low <= high (ring-buffer length)"
        )
    return lo, hi


def atr_period_grid(config: Dict[str, Any]) -> List[int]:
    """The outer-sweep grid for ``atr_period``.  Explicit
    ``optimize_atr_periods`` wins (validated against the schema bounds);
    otherwise the ATR strategy gets a default 4-point grid spanning
    :func:`atr_period_bounds` UNLESS the user pinned ``atr_period`` in
    the config; non-ATR strategies never sweep."""
    raw = config.get("optimize_atr_periods")
    if isinstance(raw, str):  # a command line delivers a JSON string
        try:
            raw = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ValueError(
                "optimize_atr_periods must be a JSON list (e.g. "
                f"'[7, 14, 21]') or a single integer, got {raw!r}"
            ) from e
    if isinstance(raw, (int, float)):  # scalar: a one-point grid
        raw = [raw]
    if raw:
        lo, hi = atr_period_bounds(config)
        grid = sorted({int(p) for p in raw})
        bad = [p for p in grid if not lo <= p <= hi]
        if bad:
            raise ValueError(
                f"optimize_atr_periods entries {bad} outside the strategy "
                f"schema's [{lo}, {hi}] range (plugins/builtin/"
                "strategies.py:hparam_schema, or the optimize_params "
                "override) — the summary reports grid points as schema "
                "low/high, so out-of-range periods would misdescribe the "
                "search space"
            )
        return grid
    if (
        str(config.get("strategy_plugin", "")) == "direct_atr_sltp"
        and config.get("atr_period") is None
    ):
        lo, hi = atr_period_bounds(config)
        if (lo, hi) == (7, 30):
            return [7, 14, 21, 30]  # the documented reference-range grid
        span = hi - lo
        return sorted({lo + span * i // 3 for i in range(4)})
    return []


def _risk_lambda(config: Dict[str, Any]) -> float:
    return float(config.get("risk_lambda", config.get("risk_penalty_lambda", 1.0)))


def optimize_from_config(config: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """The GA from a merged config on ``device`` (CUDA unless named); the
    JAX package's result, key for key, plus ``capture_seconds``."""
    from gymfx_tpu_torch.train.common import build_train_eval_envs

    # GA fitness is DEFINED on the training bars; the out-of-sample keys
    # hold bars out of the candidate episodes, and the WINNER is
    # re-evaluated on them after the search (label)
    holds_out = bool(config.get("eval_split") or config.get("eval_data_file"))

    # one dataset load and chronological split for the whole sweep: the
    # training slice does not depend on the period
    base_train_env, _ = build_train_eval_envs(dict(config), device=device)
    train_dataset = base_train_env.dataset

    def run_at(period: Optional[int]) -> Dict[str, Any]:
        cfg = dict(config)
        if period is not None:
            cfg["atr_period"] = int(period)
        env = Environment(cfg, dataset=train_dataset, device=device)
        # atr_period is swept OUTSIDE the GA (a static ring-buffer shape);
        # an optimize_params override listing it feeds the grid's bounds
        inner_schema = [s for s in hparam_schema(cfg) if s[0] != "atr_period"]
        population = int(cfg.get("optimize_population", 32))
        generations = int(cfg.get("optimize_generations", 8))
        if not inner_schema:
            # nothing continuous to tune: every candidate is identical,
            # so one minimal evaluation per grid point scores the period
            population, generations = 2, 1
        optimizer = Optimizer(
            env,
            inner_schema,
            population=population,
            risk_lambda=_risk_lambda(cfg),
            mutation_scale=float(cfg.get("optimize_mutation_scale", 0.15)),
            episode_steps=cfg.get("steps"),
        )
        return optimizer.run(generations=generations, seed=int(cfg.get("seed", 0) or 0))

    def label(result: Dict[str, Any]) -> Dict[str, Any]:
        if not holds_out:
            result["eval_scope"] = "in_sample_by_design"
            result["eval_note"] = (
                "GA fitness is defined on the training bars; pass "
                "eval_split or eval_data_file to automatically "
                "re-evaluate the winning candidate held-out"
            )
            return result
        # the winner on the held-out bars: the fitness episode's
        # definition, over the FULL holdout
        cfg = dict(config)
        bp = result["best_params"]
        if "atr_period" in bp:
            cfg["atr_period"] = int(bp["atr_period"])
        train_env, eval_env = build_train_eval_envs(cfg, device=device)
        schema = [s for s in hparam_schema(cfg) if s[0] != "atr_period"]
        vals = np.asarray([[bp[n] for n, _, _ in schema]], np.float32)
        episode = candidate_episode_metrics(
            eval_env, schema, _risk_lambda(cfg), eval_env.cfg.n_bars - 1,
            seed=int(cfg.get("seed", 0) or 0))
        rap, total_return, dd, trades = (x.cpu() for x in episode(vals))
        result["held_out"] = {
            "rap": float(rap[0]),
            "total_return": float(total_return[0]),
            "drawdown_fraction": float(dd[0]),
            "trades": int(trades[0]),
            "eval_bars": int(eval_env.cfg.n_bars),
            "train_bars": int(train_env.cfg.n_bars),
            "driver": "seeded random-entry stream (the fitness episode "
                      "definition, on held-out bars)",
        }
        result["eval_scope"] = "fitness_in_sample_winner_held_out"
        result["eval_note"] = (
            "GA fitness is defined on the training bars (in-sample by "
            "design); the winning candidate was automatically "
            "re-evaluated on the held-out bars — see held_out"
        )
        return result

    grid = atr_period_grid(config)
    if not grid and any(n == "atr_period" for n, _, _ in hparam_schema(config)):
        raise ValueError(
            "optimize_params declares atr_period but nothing sweeps it: "
            "unpin atr_period from the config or pass "
            "optimize_atr_periods (non-ATR strategies cannot sweep it)"
        )
    if not grid:
        return label(run_at(None))

    # outer sweep: one GA per ring-buffer size, the best triple by
    # fitness (the same action stream for every period)
    sweep, best_period, best = [], None, None
    for period in grid:
        res = run_at(period)
        sweep.append(
            {
                "atr_period": period,
                "best_rap": res["best_rap"],
                "best_params": dict(res["best_params"]),
            }
        )
        if best is None or res["best_rap"] > best["best_rap"]:
            best_period, best = period, res

    best["best_params"] = {**best["best_params"], "atr_period": best_period}
    # a winner at a grid endpoint is as boundary-clipped as an inner-GA
    # winner at a schema bound
    if len(grid) > 1:
        bc = dict(best.get("boundary_clipped") or {})
        if best_period == grid[0]:
            bc["atr_period"] = "low"
        elif best_period == grid[-1]:
            bc["atr_period"] = "high"
        best["boundary_clipped"] = bc
    best["schema"].append(
        {
            "name": "atr_period",
            "low": float(grid[0]),
            "high": float(grid[-1]),
            "grid": grid,
        }
    )
    best["atr_period_sweep"] = sweep
    return label(best)
