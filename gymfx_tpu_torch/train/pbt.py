"""Population-based training (BASELINE.json config 5: "pod-scale
population-based training"), over the bar-venue PPO trainer or the
portfolio trainer.

The port of ``gymfx_tpu/train/pbt.py``: :class:`PBTConfig`,
:class:`PBTTrainer` (:93-250; ``_PBTTrainerCore``, :57-95, is
``train/ppo.PPOTrainer`` with ``members = P``), ``make_portfolio_pbt``,
``_pbt_config_from`` and ``train_pbt_from_config`` with both branches
(:323-407).  The whole population trains as one program, as the JAX
package's ``jax.vmap`` over stacked member states: one core trainer with
``members = P`` whose phases run every member at once.  Over the bar
venue that is ``PPOTrainer``: P * n_envs env rows in one EnvState (one
K1, K2 and K3 launch a step for the whole population), member-stacked
params (one batched GEMM a layer), an LSTM carry per row; over the
portfolio ``train/portfolio_ppo.PortfolioPPOTrainer`` (one K2 and one K3
launch a step for all P * N * I pair rows).  Each member's learning
rate, clip epsilon and entropy coefficient are (P,) tensors in its
optimizer state (train/optim.py ``HyperAdamState``, the port of
``optax.inject_hyperparams``), which the update and the loss read, so on
the card one pair of phase graphs serves the whole run.  Under
``feed=curriculum`` every member trains on the population step's one
tape (the JAX package's ``in_axes=(0, None)``).

Exploit/explore (Jaderberg et al. 2017) every ``interval`` steps: the
members in the bottom quantile of fitness copy the params and optimizer
state of a random top-quantile member and perturb each explored
hyperparameter by x1.25 or /1.25, clipped to its bounds.  The draws are
numpy's, the same calls in the same order as the JAX package's, so both
replace the same members with the same donors and the same values.  The
copy writes in place into the train state's tensors (on the card the
phase graphs' static buffers).  Fitness is an EMA of each member's
``mean_reward``, on the host.

``train_pbt_from_config`` over the bar venue saves the best member's
params (``state_format: "params"``) to ``checkpoint_dir``, which the
policy mode loads (train/ppo.eval_policy_from_config).
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from gymfx_tpu_torch.resilience.guards import tree_leaves
from gymfx_tpu_torch.train import ppo
from gymfx_tpu_torch.train.checkpoint import save_checkpoint
from gymfx_tpu_torch.train.common import (
    build_portfolio_train_eval_envs,
    build_train_eval_envs,
    labeled_eval_summary,
    resolve_minibatch_scheme,
)
from gymfx_tpu_torch.train.portfolio_ppo import (
    PortfolioPPOConfig,
    PortfolioPPOTrainer,
    evaluate,
)
from gymfx_tpu_torch.train.ppo import PPOTrainer, _refuse_unported_training_keys


class PBTConfig(NamedTuple):
    population: int = 8
    interval: int = 5            # train steps between exploit/explore
    quantile: float = 0.25
    lr_min: float = 1e-5
    lr_max: float = 1e-2
    clip_eps_min: float = 0.05
    clip_eps_max: float = 0.5
    ent_coef_min: float = 1e-4
    ent_coef_max: float = 0.1
    perturb: float = 1.25
    fitness_decay: float = 0.7   # EMA over per-step mean reward

    def explore_bounds(self) -> Dict[str, Any]:
        """Per-hyperparameter (min, max) clip bounds for explore."""
        return {
            "learning_rate": (self.lr_min, self.lr_max),
            "clip_eps": (self.clip_eps_min, self.clip_eps_max),
            "ent_coef": (self.ent_coef_min, self.ent_coef_max),
        }


class PBTTrainer:
    """PBT over a core trainer of ``pbt.population`` members: ``core``
    (a PortfolioPPOTrainer with ``members = P``, see
    :func:`make_portfolio_pbt`), or by default the bar-venue
    ``PPOTrainer(env, pcfg, members=P)``."""

    def __init__(self, env, pcfg=None, pbt: PBTConfig = PBTConfig(), core=None):
        self.trainer = core if core is not None else PPOTrainer(env, pcfg, members=pbt.population)
        self.pbt = pbt

    # ------------------------------------------------------------------
    def init_population(self, seed: int = 0):
        """(state, fitness): the members' weights from ``seed``, their
        learning rates log-uniform in [lr_min, lr_max] (numpy, as the JAX
        package draws them), zero fitness."""
        state = self.trainer.init_state(seed)
        rng = np.random.default_rng(seed)
        lrs = np.exp(rng.uniform(np.log(self.pbt.lr_min), np.log(self.pbt.lr_max),
                                 self.pbt.population))
        self.set_hyper(state, "learning_rate", lrs)
        return state, np.zeros(self.pbt.population)

    @staticmethod
    def set_hyper(state, key: str, values) -> None:
        """Write every member's ``key`` into the state's (P,) tensor in
        place."""
        h = state.opt_state.hyper[key]
        h.copy_(torch.as_tensor(np.asarray(values, np.float32)))

    @staticmethod
    def get_hyper(state, key: str) -> np.ndarray:
        return state.opt_state.hyper[key].cpu().numpy()

    def get_lrs(self, state) -> np.ndarray:
        return self.get_hyper(state, "learning_rate")

    # ------------------------------------------------------------------
    def _exploit_explore(self, state, fitness, rng):
        """Replace the bottom quantile by donors from the top (params and
        optimizer state copied in place), perturb each replaced member's
        explored hyperparameters; returns (state, fitness, replaced)."""
        p = self.pbt.population
        k = max(1, int(p * self.pbt.quantile))
        order = np.argsort(fitness)          # ascending
        bottom, top = order[:k], order[-k:]
        src_for = {int(b): int(top[rng.integers(0, len(top))]) for b in bottom}

        device = self.trainer.device
        dst = torch.tensor(list(src_for), dtype=torch.int64, device=device)
        src = torch.tensor([src_for[b] for b in src_for], dtype=torch.int64, device=device)
        for leaf in tree_leaves((state.params, state.opt_state)):
            leaf.index_copy_(0, dst, leaf.index_select(0, src))

        for key, (lo, hi) in self.pbt.explore_bounds().items():
            vals = self.get_hyper(state, key).copy()
            for b in src_for:
                factor = self.pbt.perturb if rng.random() < 0.5 else 1.0 / self.pbt.perturb
                vals[b] = float(np.clip(vals[b] * factor, lo, hi))
            self.set_hyper(state, key, vals)
        fitness[list(src_for)] = fitness[[src_for[b] for b in src_for]]
        return state, fitness, sorted(src_for)

    # ------------------------------------------------------------------
    def _step(self, state, it: int):
        """One population step (state, (P,) metrics); under
        ``feed=curriculum`` on the tape picked for ``it``, shared by every
        member (each trains the same market with its own
        hyperparameters)."""
        curriculum = self.trainer.curriculum
        if curriculum is None:
            return self.trainer.train_step(state)
        tape = curriculum.pick(it)[2]
        if isinstance(self.trainer, PPOTrainer):
            return self.trainer.train_step(state, tape)
        self.trainer.use_tape(tape)
        return self.trainer.train_step(state)

    def train(self, total_env_steps: int, seed: int = 0) -> Dict[str, Any]:
        """``total_env_steps // (n_envs * horizon * population)`` population
        steps (at least one) with exploit/explore every ``interval``: the
        JAX package's result dict (``best_params`` the best member's: over
        the bar venue as one plain trainer's params, over the portfolio
        member-stacked as P = 1)."""
        pcfg = self.trainer.pcfg
        per_iter = pcfg.n_envs * pcfg.horizon * self.pbt.population
        iters = max(1, int(total_env_steps) // per_iter)
        state, fitness = self.init_population(seed)
        rng = np.random.default_rng(seed + 1)
        decay = self.pbt.fitness_decay
        replacements = []
        t0 = time.perf_counter()
        metrics = {}
        for it in range(iters):
            state, metrics = self._step(state, it)
            step_fit = metrics["mean_reward"].cpu().numpy().astype(np.float64)
            fitness = decay * fitness + (1 - decay) * step_fit
            if (it + 1) % self.pbt.interval == 0 and it + 1 < iters:
                state, fitness, replaced = self._exploit_explore(state, fitness, rng)
                replacements.append({"iter": it + 1, "replaced": replaced})
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)
        dt = time.perf_counter() - t0
        best = int(np.argmax(fitness))
        if isinstance(self.trainer, PPOTrainer):
            # the bar venue's best member as the plain trainer's params
            best_params = {k: v[best].clone() for k, v in state.params.items()}
        else:
            best_params = {k: v[best:best + 1].clone() for k, v in state.params.items()}
        return {
            "population": self.pbt.population,
            "iterations": iters,
            "total_env_steps": per_iter * iters,
            "env_steps_per_sec": per_iter * iters / dt,
            "fitness": fitness.tolist(),
            "learning_rates": self.get_lrs(state).tolist(),
            "clip_eps": self.get_hyper(state, "clip_eps").tolist(),
            "ent_coef": self.get_hyper(state, "ent_coef").tolist(),
            "best_member": best,
            "best_params": best_params,
            "replacements": replacements,
            "final_metrics": {k: v.cpu().numpy().tolist() for k, v in metrics.items()},
        }


def make_portfolio_pbt(config: Dict[str, Any], pbt: PBTConfig, env) -> PBTTrainer:
    """The portfolio PBT trainer, its PPO config read as the JAX package's
    ``make_portfolio_pbt`` reads it."""
    resolve_minibatch_scheme(config, int(config.get("num_envs", 64) or 64),
                             int(config.get("ppo_minibatches", 4)))
    pcfg = PortfolioPPOConfig(
        n_envs=int(config.get("num_envs", 64) or 64),
        horizon=int(config.get("ppo_horizon", 64)),
        epochs=int(config.get("ppo_epochs", 2)),
        minibatches=int(config.get("ppo_minibatches", 4)),
        lr=float(config.get("learning_rate", 3e-4)),
        policy=str(config.get("policy") or "mlp"),
        minibatch_scheme=str(config.get("ppo_minibatch_scheme", "env_permute")),
    )
    return PBTTrainer(env, pbt=pbt, core=PortfolioPPOTrainer(env, pcfg, members=pbt.population))


def _pbt_config_from(config: Dict[str, Any]) -> PBTConfig:
    return PBTConfig(
        population=int(config.get("pbt_population", 8)),
        interval=int(config.get("pbt_interval", 5)),
        quantile=float(config.get("pbt_quantile", 0.25)),
        lr_min=float(config.get("pbt_lr_min", 1e-5)),
        lr_max=float(config.get("pbt_lr_max", 1e-2)),
        clip_eps_min=float(config.get("pbt_clip_eps_min", 0.05)),
        clip_eps_max=float(config.get("pbt_clip_eps_max", 0.5)),
        ent_coef_min=float(config.get("pbt_ent_coef_min", 1e-4)),
        ent_coef_max=float(config.get("pbt_ent_coef_max", 0.1)),
        perturb=float(config.get("pbt_perturb", 1.25)),
        fitness_decay=float(config.get("pbt_fitness_decay", 0.7)),
    )


def train_pbt_from_config(config: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """``mode=training`` with ``trainer=pbt``: the population sweep, then
    the best member's greedy evaluation, held out where the config holds
    bars out.  With ``portfolio_files`` over the portfolio trainer, else
    over the bar-venue PPO trainer, whose best member's params are saved
    to ``checkpoint_dir`` (``state_format: "params"``)."""
    _refuse_unported_training_keys(config)
    if config.get("portfolio_files"):
        env, eval_env = build_portfolio_train_eval_envs(config, device=device)
        trainer = make_portfolio_pbt(config, _pbt_config_from(config), env)
        result = trainer.train(int(config.get("train_total_steps", 1_000_000)),
                               seed=int(config.get("seed", 0) or 0))
        best_params = result.pop("best_params")
        pcfg = trainer.trainer.pcfg
        out = labeled_eval_summary(
            lambda e: evaluate(PortfolioPPOTrainer(env if e is None else e, pcfg), best_params),
            env, eval_env,
        )
        out.update({"mode": "training", "trainer": "pbt_portfolio", "pbt": result})
        return out

    env, eval_env = build_train_eval_envs(config, device=device)
    resolve_minibatch_scheme(config, int(config.get("num_envs", 256) or 256),
                             int(config.get("ppo_minibatches", 4)))
    pcfg = ppo.ppo_config_from(config)
    trainer = PBTTrainer(env, pcfg, _pbt_config_from(config))
    result = trainer.train(int(config.get("train_total_steps", 1_000_000)),
                           seed=int(config.get("seed", 0) or 0))
    best_params = result.pop("best_params")
    summary = labeled_eval_summary(
        lambda e: ppo.evaluate(PPOTrainer(env if e is None else e, pcfg), best_params),
        env, eval_env,
    )
    summary["pbt"] = result
    ckpt_dir = config.get("checkpoint_dir")
    if ckpt_dir:
        save_checkpoint(
            ckpt_dir, best_params, step=result["total_env_steps"],
            metadata={"policy": pcfg.policy, "policy_kwargs": dict(pcfg.policy_kwargs),
                      "state_format": "params"},
            keep=int(config.get("checkpoint_keep", 0) or 0),
        )
        summary["checkpoint_dir"] = str(ckpt_dir)
    return summary
