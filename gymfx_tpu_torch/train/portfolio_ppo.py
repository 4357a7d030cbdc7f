"""PPO over the multi-pair portfolio environment (BASELINE config 5).

The port of ``gymfx_tpu/train/portfolio_ppo.py``: the per-pair heads and
the three portfolio policies (:29-108), :class:`PortfolioPPOConfig`,
:class:`PortfolioTrainState`, the token encoding (:153-165; the flat
one is ``policies.flatten_obs``),
:class:`PortfolioPPOTrainer` (rollout :257-303, GAE, the loss, update
:365-419, ``train`` :428-508), :func:`evaluate` (:511-573),
:func:`eval_portfolio_policy_from_config` and
:func:`train_portfolio_from_config` (:576-739).

Actions are per-pair vectors (I,) in {0, 1, 2}: the policy emits one
categorical head per pair and the joint log-prob is the sum of the
pairs' log-probs (in pair order).

One trainer serves PPO and population-based training: every phase runs
over a leading member axis P (``members``), the JAX package's
``jax.vmap`` over stacked member train states (train/pbt.py); the
portfolio trainer is P = 1.  Params are member-stacked (each leaf with a
leading (P,) axis) and the policy runs all members in one forward
(train/policies.py ``_dense``; K4 takes the members folded into its
batch).  The env steps the P * N books' I pairs as one batch of rows
(core/portfolio.py): one K2 and one K3 launch a step for the whole
population.  The optimizer state holds each member's learning rate,
clip epsilon and entropy coefficient as (P,) tensors (train/optim.py
``HyperAdamState``), read by the update and the loss.

On a CUDA device each phase replays a CUDA graph (core/graphs.py),
captured at its first call, as PPOTrainer's do; the evaluation's chunks
replay chunk graphs.  Test hooks: ``rollout_phase(state, actions=...)``
((horizon, P, N, I) actions) and ``update_phase(state, out,
permutations=...)`` ((P, epochs, n_perm)) replace the phases' draws.
"""
from __future__ import annotations

import math
import time
import types
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from gymfx_tpu_torch.core import graphs
from gymfx_tpu_torch.core import portfolio as P
from gymfx_tpu_torch.core.types import EnvState, not_ported
from gymfx_tpu_torch.metrics import compute_analyzers, summarize_trading
from gymfx_tpu_torch.resilience.faults import parse_fault_profile
from gymfx_tpu_torch.telemetry.spans import profiler_range
from gymfx_tpu_torch.train.checkpoint import resume_from_config, save_checkpoint
from gymfx_tpu_torch.train.common import (
    TrainLoop,
    build_portfolio_train_eval_envs,
    eval_checkpointed_policy,
    labeled_eval_summary,
    masked_reset,
    member_minibatch_plan,
    resolve_minibatch_scheme,
    validate_minibatch_scheme,
)
from gymfx_tpu_torch.train.optim import ClipAdam, HyperAdamState, apply_updates
from gymfx_tpu_torch.train.policies import (
    RingTransformerEncoder,
    _dense,
    flatten_obs,
    flax_attention,
    is_token_policy,
    tokens_from_obs,
)
from gymfx_tpu_torch.train.ppo import (
    _DTYPES,
    PolicyTrainer,
    _refuse_unported_training_keys,
    _step_sharpe,
    train_with_telemetry,
    init_policy_weights,
    resolve_collect_dtype,
    resolve_optimizer_state_dtype,
    sample_categorical,
)

class _PerPairHeads(nn.Module):
    """The shared actor-critic head: per-pair categorical logits (..., I, 3)
    and a scalar value, float32, on the pooled embedding."""

    def _heads(self, pooled):
        pooled = pooled.to(torch.float32)
        logits = _dense(pooled, self.logits, torch.float32)
        value = _dense(pooled, self.value, torch.float32)
        return logits.unflatten(-1, (self.n_pairs, 3)), value.squeeze(-1)


class PortfolioMLPPolicy(_PerPairHeads):
    """The tanh MLP over the flat portfolio obs, per-pair heads."""

    def __init__(self, in_dim: int, n_pairs: int, hidden=(256, 256, 256), dtype=torch.float32):
        super().__init__()
        widths = [int(in_dim), *[int(h) for h in hidden]]
        self.n_pairs, self.dtype = n_pairs, dtype
        self.hidden = nn.ModuleList(nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:]))
        self.logits = nn.Linear(widths[-1], n_pairs * 3)
        self.value = nn.Linear(widths[-1], 1)

    def forward(self, x):
        x = x.to(self.dtype)
        for layer in self.hidden:
            x = torch.tanh(_dense(x, layer, self.dtype))
        return self._heads(x)


class PortfolioTransformerPolicy(_PerPairHeads):
    """Attention over bars (flax's multi-head attention); each token
    carries every pair's features."""

    def __init__(self, token_dim: int, n_pairs: int, window: int, d_model: int = 128,
                 n_heads: int = 4, n_layers: int = 2, dtype=torch.float32):
        super().__init__()
        self.n_pairs = n_pairs
        self.encoder = RingTransformerEncoder(token_dim, window, d_model, n_heads, n_layers,
                                              dtype, attention=flax_attention)
        self.logits = nn.Linear(d_model, n_pairs * 3)
        self.value = nn.Linear(d_model, 1)

    def forward(self, tokens):
        return self._heads(self.encoder(tokens))


class PortfolioRingTransformerPolicy(_PerPairHeads):
    """The portfolio actor-critic over RingTransformerEncoder: its
    attention is K4 (single-device mode)."""

    def __init__(self, token_dim: int, n_pairs: int, window: int, d_model: int = 128,
                 n_heads: int = 4, n_layers: int = 2, dtype=torch.float32,
                 sp_backend: str = "ring"):
        super().__init__()
        self.n_pairs = n_pairs
        self.encoder = RingTransformerEncoder(token_dim, window=window, d_model=d_model,
                                              n_heads=n_heads, n_layers=n_layers, dtype=dtype,
                                              sp_backend=sp_backend)
        self.logits = nn.Linear(d_model, n_pairs * 3)
        self.value = nn.Linear(d_model, 1)

    def forward(self, tokens):
        return self._heads(self.encoder(tokens))


def make_portfolio_policy(name: str, in_dim: int, n_pairs: int, window: int,
                          dtype=torch.float32) -> nn.Module:
    if name == "transformer":
        return PortfolioTransformerPolicy(in_dim, n_pairs, window, dtype=dtype)
    if name in ("transformer_ring", "transformer_ulysses"):
        return PortfolioRingTransformerPolicy(
            in_dim, n_pairs, window, dtype=dtype,
            sp_backend="ulysses" if name == "transformer_ulysses" else "ring")
    if name == "mlp":
        return PortfolioMLPPolicy(in_dim, n_pairs, dtype=dtype)
    raise ValueError(
        f"portfolio trainer supports policy "
        f"mlp|transformer|transformer_ring|transformer_ulysses, "
        f"got {name!r}"
    )


class PortfolioPPOConfig(NamedTuple):
    n_envs: int = 64
    horizon: int = 64
    epochs: int = 2
    minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-4
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    policy: str = "mlp"
    minibatch_scheme: str = "sample_permute"
    policy_dtype: Any = torch.float32
    collect_dtype: Any = torch.float32
    opt_state_dtype: Any = torch.float32


class PortfolioTrainState(NamedTuple):
    params: Dict[str, torch.Tensor]  # member-stacked (P, ...) float32
    opt_state: HyperAdamState
    env_states: P.PortfolioState     # P * N books, member-major
    obs_vec: Any                     # (P, N, ...) policy inputs
    generator: torch.Generator


class PortfolioPPOTrainer(PolicyTrainer):
    """PPO for a PortfolioEnvironment, over ``members`` policies at once
    (P = 1 for the portfolio trainer, the population under PBT).
    ``hyper`` sets every member's starting learning rate, clip epsilon
    and entropy coefficient (``pcfg``'s by default)."""

    def __init__(self, env: P.PortfolioEnvironment, pcfg: PortfolioPPOConfig,
                 members: int = 1):
        validate_minibatch_scheme(pcfg.minibatch_scheme, pcfg.n_envs, pcfg.minibatches,
                                  horizon=pcfg.horizon)
        self.env, self.pcfg, self.members = env, pcfg, int(members)
        self.device = env.device
        self._recurrent = False
        cfg = env.cfg
        self.n_pairs = cfg.n_pairs
        self._window = cfg.window_size
        self._is_transformer = is_token_policy(pcfg.policy)
        self.books = self.members * pcfg.n_envs
        # (params, data) bound to the population's rows, and to one book
        self._rows = env.rows(self.books)
        reset_state, reset_obs = P.reset(cfg, *env.rows(1))
        self._reset_vec = self._encode(reset_obs)  # (1, ...)
        # the fresh reset of every book (an auto-reset's source)
        books = self.books
        self._reset_state = P.PortfolioState(
            pairs=EnvState(*(x.repeat(books, *([1] * (x.dim() - 1))) for x in reset_state.pairs)),
            acct=EnvState(*(x.expand(books, *x.shape[1:]).contiguous() for x in reset_state.acct)),
            swept_realized=reset_state.swept_realized.expand(books).contiguous(),
            prev_realized_q=reset_state.prev_realized_q.expand(books, -1).contiguous(),
        )
        self.obs_shape = tuple(self._reset_vec.shape[1:])
        self.policy = make_portfolio_policy(pcfg.policy, self.obs_shape[-1], cfg.n_pairs,
                                            cfg.window_size, pcfg.policy_dtype).to(self.device)
        self.optimizer = ClipAdam(pcfg.lr, pcfg.max_grad_norm, pcfg.opt_state_dtype)
        # feed=curriculum: the sampler picks a book a train step; the phases
        # read one staging copy of the bound rows, which each pick is copied
        # into (use_tape), so one graph a phase serves every tape
        self.curriculum = getattr(env, "curriculum", None)
        if self.curriculum is not None:
            self._rows = (self._rows[0], graphs.clone_tree(self._rows[1]))
        self._graphs_on = self.device.type == "cuda"
        self._graphs: Dict[tuple, graphs.PhaseGraph] = {}
        self._gens = (torch.Generator(device=self.device),)

    def use_tape(self, tape: P.PortfolioData) -> None:
        """Make the curriculum's book ``tape`` the active one: its rows are
        copied into the staging rows and episode restarts come from its
        fresh reset (the JAX trainer's explicit-data step)."""
        eparams = self.env.params
        graphs.copy_tree(self._rows[1], P.bind_rows(eparams, tape, self.books)[1])
        reset_state, reset_obs = P.reset(self.env.cfg, *P.bind_rows(eparams, tape, 1))
        books = self.books
        graphs.copy_tree(self._reset_state, P.PortfolioState(
            pairs=EnvState(*(x.repeat(books, *([1] * (x.dim() - 1))) for x in reset_state.pairs)),
            acct=EnvState(*(x.expand(books, *x.shape[1:]) for x in reset_state.acct)),
            swept_realized=reset_state.swept_realized.expand(books),
            prev_realized_q=reset_state.prev_realized_q.expand(books, -1),
        ))
        self._reset_vec.copy_(self._encode(reset_obs))

    def _encode(self, obs):
        if self._is_transformer:
            # a portfolio's window blocks are (window, I) a book: the
            # unbatched reference's ``v.ndim >= 2 and v.shape[0] == window``
            return tokens_from_obs(obs, self._window, min_dims=3)
        return flatten_obs(obs)

    def params_template(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().expand(self.members, *v.shape)
                for k, v in self.policy.named_parameters()}

    def initial_hyper(self) -> Dict[str, float]:
        return {"learning_rate": self.pcfg.lr, "clip_eps": self.pcfg.clip_eps,
                "ent_coef": self.pcfg.ent_coef}

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> PortfolioTrainState:
        """Each member's policy weights drawn in turn from one generator
        seeded ``seed`` (which the phases then draw from), a fresh
        optimizer state with ``pcfg``'s hyperparameters, every book at the
        fresh reset state."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        members = []
        for _ in range(self.members):
            init_policy_weights(self.policy, gen)
            members.append({k: v.detach().clone() for k, v in self.policy.named_parameters()})
        params = {k: torch.stack([m[k] for m in members]) for k in members[0]}
        env_states = graphs.clone_tree(self._reset_state)
        obs_vec = self._reset_vec.expand(self.books, *self.obs_shape).reshape(
            self.members, self.pcfg.n_envs, *self.obs_shape).clone()
        return PortfolioTrainState(params, self.optimizer.init_members(params, self.initial_hyper()),
                                   env_states, obs_vec, gen)

    def forward(self, params, x):
        """(logits (P, B, I, 3), value (P, B)) of every member's policy on
        its inputs ``x`` (P, B, ...)."""
        return torch.func.functional_call(self.policy, params, (x,))

    # ---- rollout ------------------------------------------------------
    def rollout_phase(self, state: PortfolioTrainState, *, actions=None, eager: bool = False):
        """One horizon of every member's N books: (post-rollout state,
        (trajectory of (horizon, P, N, ...) tensors, bootstrap value (P,
        N))), new tensors; ``state.generator`` advances.  ``actions``
        ((horizon, P, N, I) ints) replaces the draws (test hook);
        ``eager`` runs the phase op by op on the card too (comparisons)."""
        if self._graphs_on and not eager:
            graph = self._rollout_graphed(state, self._hooks(actions=actions))
            out = graphs.clone_tree(graph.outputs)
        else:
            with profiler_range("rollout"):
                out = self._rollout_body(state.params, state.env_states, state.obs_vec,
                                         state.generator, actions)
        return (state._replace(env_states=out["env_states"], obs_vec=out["obs_vec"]),
                (out["traj"], out["last_value"]))

    @torch.no_grad()
    def _rollout_body(self, params, env_states, obs_vec, gen, actions=None):
        cfg, pcfg, dev = self.env.cfg, self.pcfg, self.device
        eparams, data = self._rows
        T, M, N, I = pcfg.horizon, self.members, pcfg.n_envs, self.n_pairs
        traj = {
            "obs": torch.empty((T, M, N, *self.obs_shape), dtype=pcfg.collect_dtype, device=dev),
            "action": torch.empty((T, M, N, I), dtype=torch.int32, device=dev),
            "logp": torch.empty((T, M, N), dtype=torch.float32, device=dev),
            "value": torch.empty((T, M, N), dtype=torch.float32, device=dev),
            "reward": torch.empty((T, M, N), dtype=torch.float32, device=dev),
            "done": torch.empty((T, M, N), dtype=torch.bool, device=dev),
        }
        for t in range(T):
            logits, value = self.forward(params, obs_vec)
            if actions is None:
                action = sample_categorical(logits, gen)
            else:
                action = actions[t].to(device=dev, dtype=torch.int64)
            logp = P.pair_sum(F.log_softmax(logits, dim=-1).gather(-1, action[..., None])[..., 0])
            env_states2, obs2, reward, done, _ = P.step(
                cfg, eparams, data, env_states, action.reshape(M * N, I), with_info=False)
            obs_vec2 = self._encode(obs2).view(M, N, *self.obs_shape)
            traj["obs"][t] = obs_vec
            traj["action"][t] = action
            traj["logp"][t] = logp
            traj["value"][t] = value
            traj["reward"][t] = reward.view(M, N)
            traj["done"][t] = done.view(M, N)
            env_states = P.masked_reset(done, self._reset_state, env_states2)
            obs_vec = masked_reset(done, self._reset_vec, obs_vec2.view(M * N, *self.obs_shape)
                                   ).view(M, N, *self.obs_shape)
        _, last_value = self.forward(params, obs_vec)
        return dict(env_states=env_states, obs_vec=obs_vec, traj=traj, last_value=last_value)

    # ---- update -------------------------------------------------------
    def _gae(self, traj, last_value):
        g, lam = self.pcfg.gamma, self.pcfg.gae_lambda
        reward, value, done = traj["reward"], traj["value"], traj["done"]
        advs = torch.empty_like(reward)
        adv_next, v_next = torch.zeros_like(last_value), last_value
        for t in range(reward.shape[0] - 1, -1, -1):
            nonterm = 1.0 - done[t].to(torch.float32)
            delta = reward[t] + g * v_next * nonterm - value[t]
            adv_next = delta + g * lam * nonterm * adv_next
            advs[t] = adv_next
            v_next = value[t]
        return advs, advs + value

    def _loss(self, params, batch, hyper):
        """(Σ over members of each member's loss, dict of the (P,) loss
        terms) of one minibatch (P, M, ...)."""
        logits, value = self.forward(params, batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        logp = P.pair_sum(logp_all.gather(-1, batch["action"].to(torch.int64)[..., None])[..., 0])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        adv = (adv - adv.mean(dim=1, keepdim=True)) / (
            adv.std(dim=1, correction=0, keepdim=True) + 1e-8)
        clip_eps, ent_coef = hyper["clip_eps"][:, None], hyper["ent_coef"]
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
        policy_loss = -torch.mean(torch.minimum(unclipped, clipped), dim=1)
        value_loss = 0.5 * torch.mean((value - batch["ret"]) ** 2, dim=1)
        entropy = -torch.mean(P.pair_sum(torch.sum(torch.exp(logp_all) * logp_all, dim=-1)), dim=1)
        total = policy_loss + self.pcfg.vf_coef * value_loss - ent_coef * entropy
        return total, dict(policy_loss=policy_loss, value_loss=value_loss, entropy=entropy)

    def loss_and_grads(self, params, batch, hyper):
        """((P,) losses, (P,) loss terms, member-stacked gradients)."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            loss, aux = self._loss(leaves, batch, hyper)
            grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
        return (loss.detach(), {k: a.detach() for k, a in aux.items()},
                dict(zip(leaves.keys(), grads)))

    def update_phase(self, state: PortfolioTrainState, rollout_out, *, permutations=None,
                     eager: bool = False):
        """GAE and the minibatched epochs of every member on one collected
        trajectory: (new state, metrics dict of (P,) tensors), new
        tensors; ``state.generator`` advances.  ``permutations`` ((P,
        epochs, n_perm) ints) replaces the draws (test hook); ``eager`` as
        in :meth:`rollout_phase`."""
        traj, last_value = rollout_out
        if self._graphs_on and not eager:
            inputs = dict(params=state.params, opt_state=state.opt_state, traj=traj,
                          last_value=last_value, **self._hooks(permutations=permutations))
            out = graphs.clone_tree(self._update_graphed(inputs, state.generator).outputs)
        else:
            with profiler_range("update"):
                out = self._update_body(state.params, state.opt_state, traj, last_value,
                                        state.generator, permutations)
        return (state._replace(params=out["params"], opt_state=out["opt_state"]),
                out["metrics"])

    def _update_body(self, params, opt_state, traj, last_value, gen, permutations=None):
        pcfg = self.pcfg
        advs, returns = self._gae(traj, last_value)
        fields = {"obs": traj["obs"], "action": traj["action"], "logp": traj["logp"],
                  "adv": advs, "ret": returns}
        n_perm, mb, take = member_minibatch_plan(
            fields, scheme=pcfg.minibatch_scheme, members=self.members, n_envs=pcfg.n_envs,
            horizon=pcfg.horizon, minibatches=pcfg.minibatches)
        losses, terms = [], []
        for epoch in range(pcfg.epochs):
            if permutations is None:
                perm = torch.argsort(torch.rand((self.members, n_perm), generator=gen,
                                                device=self.device), dim=1)
            else:
                perm = permutations[:, epoch].to(self.device)
            for i in range(pcfg.minibatches):
                batch = take(perm[:, i * mb:(i + 1) * mb])
                loss, aux, grads = self.loss_and_grads(params, batch, opt_state.hyper)
                updates, opt_state, _ = self.optimizer.update_members(grads, opt_state)
                params = apply_updates(params, updates)
                losses.append(loss)
                terms.append(aux)
        metrics = dict(
            loss=torch.stack(losses).mean(dim=0),
            policy_loss=torch.stack([t["policy_loss"] for t in terms]).mean(dim=0),
            value_loss=torch.stack([t["value_loss"] for t in terms]).mean(dim=0),
            entropy=torch.stack([t["entropy"] for t in terms]).mean(dim=0),
            mean_reward=traj["reward"].transpose(0, 1).reshape(self.members, -1).mean(dim=1),
        )
        return dict(params=params, opt_state=opt_state, metrics=metrics)

    # ---- the train step ----------------------------------------------
    def train_step(self, state: PortfolioTrainState, eager: bool = False):
        """One rollout phase then one update phase: (state, metrics of
        (P,) tensors).  On a CUDA device the two graphs replay back to
        back, the update graph reading the rollout graph's static outputs
        in place, and the returned state's tensors are static buffers of
        the graphs that the next train step overwrites (clone what must
        outlive it); the metrics are new tensors.  ``eager`` runs both
        phases op by op."""
        if eager or not self._graphs_on:
            inter, rollout_out = self.rollout_phase(state, eager=eager)
            return self.update_phase(inter, rollout_out, eager=eager)
        rollout = self._rollout_graphed(state, {})
        inputs = dict(params=rollout.inputs["params"], opt_state=state.opt_state,
                      traj=rollout.outputs["traj"], last_value=rollout.outputs["last_value"])
        update = self._update_graphed(inputs, state.generator, shared=(
            "params", "traj", "last_value"))
        out = update.outputs
        return (PortfolioTrainState(out["params"], out["opt_state"],
                                    rollout.outputs["env_states"], rollout.outputs["obs_vec"],
                                    state.generator),
                {k: v.clone() for k, v in out["metrics"].items()})

    def _graph(self, kind: str, inputs, build):
        key = (kind, self.pcfg, self.members, tuple(sorted(inputs)), graphs.signature(inputs))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = build()
        return graph

    def _rollout_graphed(self, state: PortfolioTrainState, hooks):
        inputs = dict(params=state.params, env_states=state.env_states, obs_vec=state.obs_vec,
                      **hooks)

        gen = self._gens[0]

        def body(x):
            return self._rollout_body(x["params"], x["env_states"], x["obs_vec"], gen,
                                      x.get("actions"))

        graph = self._graph("rollout", inputs, lambda: graphs.PhaseGraph(
            body, graphs.clone_tree(inputs), gen, name=f"{type(self).__name__}.rollout"))
        return self._replay("rollout", graph, inputs, state.generator)

    def _update_graphed(self, inputs, generator, shared=()):
        gen = self._gens[0]

        def body(x):
            return self._update_body(x["params"], x["opt_state"], x["traj"], x["last_value"],
                                     gen, x.get("permutations"))

        graph = self._graph("update", inputs, lambda: graphs.PhaseGraph(body, {
            k: v if k in shared else graphs.clone_tree(v) for k, v in inputs.items()}, gen,
            name=f"{type(self).__name__}.update"))
        return self._replay("update", graph, inputs, generator)

    def train(self, total_env_steps: int, seed: int = 0, initial_params=None,
              initial_state: Optional[PortfolioTrainState] = None, *,
              checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
              step_offset: int = 0, checkpoint_metadata=None, preempt_at: Optional[int] = None,
              telemetry=None, mesh_faults=(), checkpoint_keep: int = 0):
        """``total_env_steps // (n_envs * horizon)`` train steps (at least
        one) of the portfolio trainer (P = 1), with periodic full-state
        checkpoints through ``resilience/loop.ResilientLoop``, the
        simulated preemption at ``preempt_at`` and, under ``telemetry``,
        the run ledger's rows and the flight recorder's dumps (the JAX
        package's portfolio loop, :433-486: no metric drain).  Mesh
        faults (ROADMAP Queue 1 item 17) raise.  Returns (state, metrics
        as floats plus ``env_steps_per_sec``, ``iterations``,
        ``total_env_steps``, ``last_checkpoint_step``)."""
        if mesh_faults:
            raise not_ported("PortfolioPPOTrainer.train(mesh_faults=...)", 17)
        if self.members != 1:
            raise ValueError("train() runs one policy; a population trains through train/pbt.py")
        state = self.init_state(seed) if initial_state is None else initial_state
        if initial_params is not None:
            state = state._replace(params=initial_params)
        per_iter = self.pcfg.n_envs * self.pcfg.horizon
        iters = max(1, int(total_env_steps) // per_iter)
        loop = TrainLoop(
            "portfolio_ppo", iters=iters, steps_per_iter=per_iter, telemetry=telemetry,
            metrics_stream=False, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, step_offset=step_offset,
            checkpoint_metadata=checkpoint_metadata, max_consecutive_skips=0,
            preempt_at=preempt_at, checkpoint_keep=int(checkpoint_keep or 0),
        )
        t0 = time.perf_counter()
        metrics: Dict[str, Any] = {}
        for it in range(iters):
            loop.begin_superstep(it, 1)
            if self.curriculum is not None:
                self.use_tape(self.curriculum.pick(it)[2])
            state, metrics = self.train_step(state)
            loop.after_superstep(it, 1, metrics, lambda: (state, state.params))
        loop.finish(lambda: (state, state.params))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = {k: float(v[0]) for k, v in metrics.items()}
        out["env_steps_per_sec"] = per_iter * iters / (time.perf_counter() - t0)
        out["iterations"] = iters
        out["total_env_steps"] = per_iter * iters
        if loop.hooks.last_checkpoint_step is not None:
            out["last_checkpoint_step"] = loop.hooks.last_checkpoint_step
        return state, out


# ---------------------------------------------------------------------------
def _eval_chunk_body(trainer: PortfolioPPOTrainer, params_rows, chunk: int):
    cfg = trainer.env.cfg

    @torch.no_grad()
    def body(x):
        st, vec = x["state"], x["vec"]
        equity = torch.empty((chunk,), dtype=st.acct.equity_delta.dtype, device=vec.device)
        done = torch.empty((chunk,), dtype=torch.bool, device=vec.device)
        for i in range(chunk):
            logits, _ = trainer.forward(x["params"], vec)
            action = torch.argmax(logits, dim=-1).to(torch.int32)
            st, obs, _, dn, info = P.step(cfg, *params_rows, st, action.reshape(1, -1))
            vec = trainer._encode(obs)[None]
            equity[i] = info["equity"][0]
            done[i] = dn[0]
        return dict(state=st, vec=vec, equity=equity, done=done)

    return body


def evaluate(trainer: PortfolioPPOTrainer, params, steps: Optional[int] = None,
             chunk: int = 128) -> Dict[str, Any]:
    """Greedy (per-pair argmax) episode of one book -> the reference-style
    trading metrics on the account ledger, trade statistics pooled over
    pairs.  ``params`` is one member's, member-stacked (P = 1).  The
    episode runs in chunks of ``chunk`` steps, each a replay of one chunk
    graph on the card (the JAX package's jitted ``lax.scan`` chunk)."""
    env = trainer.env
    cfg = env.cfg
    steps = int(steps or cfg.n_bars - 1)
    rows = env.rows(1)
    state0, obs0 = P.reset(cfg, *rows)
    inputs = dict(params=params, state=state0, vec=trainer._encode(obs0)[None])
    body = _eval_chunk_body(trainer, rows, chunk)
    graph = None
    if trainer._graphs_on:
        key = ("eval", chunk, graphs.signature(inputs))
        graph = trainer._graphs.get(key)
        if graph is None:
            graph = trainer._graphs[key] = graphs.PhaseGraph(body, graphs.clone_tree(inputs))
    eqs, dones = [], []
    cur = inputs
    for _ in range(max(1, math.ceil(steps / chunk))):
        out = graph(cur) if graph is not None else body(cur)
        eqs.append(out["equity"].cpu().numpy().astype(np.float64))
        dones.append(out["done"].cpu().numpy())
        cur = dict(params=params, state=out["state"], vec=out["vec"])
    equity = np.concatenate(eqs)[:steps]
    done = np.concatenate(dones)[:steps]
    st = cur["state"]
    pairs = EnvState(*(x.cpu() for x in st.pairs))
    acct = EnvState(*(x.cpu() for x in st.acct))
    agg = types.SimpleNamespace(
        trade_count=int(pairs.trade_count.sum()),
        trades_won=int(pairs.trades_won.sum()),
        trades_lost=int(pairs.trades_lost.sum()),
        trade_pnl_sum=float(pairs.trade_pnl_sum.double().sum()),
        trade_pnl_sumsq=float(pairs.trade_pnl_sumsq.double().sum()),
        max_drawdown_pct=float(acct.max_drawdown_pct[0]),
        max_drawdown_money=float(acct.max_drawdown_money[0]),
    )
    ts = env.timestamps[1: steps + 1]
    analyzers = compute_analyzers(equity=equity, done=done, state=agg, timestamps=ts)
    final_eq = float(equity[int(np.argmax(done))] if done.any() else equity[-1])
    summary = summarize_trading(initial_cash=float(env.params.acct.initial_cash),
                                final_equity=final_eq, analyzers=analyzers, config=env.config)
    summary["sharpe_ratio_steps"] = _step_sharpe(equity, env.timeframe_hours or (1.0 / 60.0))
    summary["pairs"] = list(env.pairs)
    return summary


def eval_portfolio_policy_from_config(config: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """``driver_mode=policy`` with ``portfolio_files``: greedy evaluation of
    a checkpointed portfolio policy (train/common.eval_checkpointed_policy),
    the pair set checked against the checkpoint's (the heads are
    positional)."""

    def resolve(meta, cfg):
        stored = str(meta.get("policy") or "")
        if not cfg.get("policy") and stored.startswith("portfolio_"):
            cfg["policy"] = stored[len("portfolio_"):]

    def validate(meta, env):
        if meta.get("pairs") and list(meta["pairs"]) != list(env.pairs):
            raise ValueError(
                f"checkpoint was trained on pairs {meta['pairs']}, config "
                f"loads {env.pairs} — the per-pair heads are positional"
            )

    return eval_checkpointed_policy(
        config,
        build_envs=lambda cfg: build_portfolio_train_eval_envs(cfg, device=device),
        make_trainer=lambda env, cfg: PortfolioPPOTrainer(
            env, PortfolioPPOConfig(policy=str(cfg.get("policy") or "mlp"))),
        evaluate_fn=lambda tr, params, steps: evaluate(tr, params, steps=steps),
        resolve_policy=resolve,
        validate=validate,
    )


def portfolio_config_from(config: Dict[str, Any]) -> PortfolioPPOConfig:
    """The portfolio trainer's config, as the JAX package's
    ``_train_portfolio_from_config`` reads it."""
    pdt = _DTYPES[str(config.get("policy_dtype", "float32"))]
    return PortfolioPPOConfig(
        n_envs=int(config.get("num_envs", 64) or 64),
        horizon=int(config.get("ppo_horizon", 64)),
        epochs=int(config.get("ppo_epochs", 2)),
        minibatches=int(config.get("ppo_minibatches", 4)),
        lr=float(config.get("learning_rate", 3e-4)),
        policy=str(config.get("policy") or "mlp"),
        minibatch_scheme=str(config.get("ppo_minibatch_scheme", "env_permute")),
        policy_dtype=pdt,
        collect_dtype=resolve_collect_dtype(config, pdt),
        opt_state_dtype=resolve_optimizer_state_dtype(config),
    )


def train_portfolio_from_config(config: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """``mode=training`` with ``trainer=portfolio``: train, checkpoint, and
    the held-out (or in-sample) greedy evaluation's summary."""
    _refuse_unported_training_keys(config)
    env, eval_env = build_portfolio_train_eval_envs(config, device=device)
    n_envs = int(config.get("num_envs", 64) or 64)
    resolve_minibatch_scheme(config, n_envs, int(config.get("ppo_minibatches", 4)))
    pcfg = portfolio_config_from(config)
    trainer = PortfolioPPOTrainer(env, pcfg)
    # full-state checkpoints continue the exact trajectory; params-only
    # ones warm-start
    resume_state, resume_params, resume_step = resume_from_config(config, trainer)
    meta = {"policy": f"portfolio_{pcfg.policy}", "pairs": env.pairs}
    # the JAX package's :672-706: the profile's preemption drill and the
    # telemetry's ledger and recorder (a portfolio's feed is not poisoned)
    profile = parse_fault_profile(config.get("fault_profile"))

    def run(telemetry):
        if telemetry is not None and telemetry.ledger is not None and (
                resume_state is not None or resume_params is not None):
            telemetry.ledger.record("checkpoint_restore", step=int(resume_step))
        return trainer.train(
            int(config.get("train_total_steps", 1_000_000)),
            seed=int(config.get("seed", 0) or 0),
            initial_params=resume_params, initial_state=resume_state,
            checkpoint_dir=config.get("checkpoint_dir"),
            checkpoint_every=int(config.get("checkpoint_every", 0) or 0),
            step_offset=resume_step, checkpoint_metadata=meta,
            preempt_at=profile.get("preempt_at"), telemetry=telemetry,
            checkpoint_keep=int(config.get("checkpoint_keep", 0) or 0),
        )

    state, metrics = train_with_telemetry(config, None, run)
    summary = labeled_eval_summary(
        lambda e: evaluate(trainer if e is None else PortfolioPPOTrainer(e, pcfg), state.params),
        env, eval_env,
    )
    summary.update({"mode": "training", "trainer": "portfolio_ppo", "pairs": env.pairs,
                    "train_metrics": metrics})
    ckpt_dir = config.get("checkpoint_dir")
    if ckpt_dir:
        final_step = resume_step + metrics["total_env_steps"]
        if metrics.get("last_checkpoint_step") != final_step:
            save_checkpoint(
                ckpt_dir, state, step=final_step, metadata=meta, params=state.params,
                keep=int(config.get("checkpoint_keep", 0) or 0), protect=(int(resume_step),),
            )
        summary["checkpoint_dir"] = str(ckpt_dir)
    return summary
