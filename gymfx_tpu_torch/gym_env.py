"""The Gymnasium shell over the port's env step.

The port of ``gymfx_tpu/gym_env.py``: :func:`build_base_observation_space`
(the reference's Dict observation blocks), :class:`GymFxEnv` (the
stage-B and calendar blocks too, ``Discrete(3)`` or ``Box(-1, 1, (1,))``
actions, ``reset`` / ``step`` / ``close`` / ``summary``, the info layout
of ``_py_info`` and the ``GYMFX_BRACKET_AUDIT`` JSONL audit) and
:func:`build_environment` (the engine dispatcher).  ``reset()`` /
``step()`` are the reference system's external contract: an agent
attaches through them.

A step is one env of ``core/env.step``.  On the card it replays one CUDA
graph of one step (:class:`StepProgram`, the counterpart of the JAX
shell's compiled ``jit_step``): the env state is the graph's static
input, which the graph updates in place; the action is copied in; the
step's outputs (obs, reward, done and the info dict) are packed inside
the graph into one byte buffer, copied to pinned host memory with one
non-blocking copy behind one event (the JAX shell's one ``device_get``).
On the CPU the step runs op by op (on the card too where the program's
``graphed`` is set False before its first step: the comparison of the
graph with the same steps op by op).

``gymnasium`` is used where it is installed (``gym_compat.py``); the
spaces and the ``Env`` base are otherwise the port's minimal stand-ins.
A ``metrics_plugin`` other than the two built-in ones is a third-party
plugin (ROADMAP Queue 1 item 9) and raises.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from gymfx_tpu_torch.core import env as env_core
from gymfx_tpu_torch.core import graphs
from gymfx_tpu_torch.core.obs import CALENDAR_OBS_KEYS, build_info
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.core.types import EnvState, not_ported
from gymfx_tpu_torch.gym_compat import Env, spaces
from gymfx_tpu_torch.resilience.guards import tree_leaves, tree_map


def build_base_observation_space(config: Dict[str, Any], *, window_size: int):
    """The reference's observation space declaration (reference
    app/env.py:31-90)."""
    feature_columns = list(config.get("feature_columns") or [])
    include_prices = bool(config.get("include_price_window", not feature_columns))
    include_agent_state = bool(config.get("include_agent_state", True))
    blocks: Dict[str, Any] = {}
    if feature_columns:
        blocks["features"] = spaces.Box(-np.inf, np.inf, (window_size, len(feature_columns)),
                                        np.float32)
    if include_prices:
        blocks["prices"] = spaces.Box(-np.inf, np.inf, (window_size,), np.float32)
        blocks["returns"] = spaces.Box(-np.inf, np.inf, (window_size,), np.float32)
    if include_agent_state:
        blocks["position"] = spaces.Box(-1.0, 1.0, (1,), np.float32)
        blocks["equity_norm"] = spaces.Box(-np.inf, np.inf, (1,), np.float32)
        blocks["unrealized_pnl_norm"] = spaces.Box(-np.inf, np.inf, (1,), np.float32)
        blocks["steps_remaining_norm"] = spaces.Box(0.0, 1.0, (1,), np.float32)
    if not blocks:
        raise ValueError("preprocessor observation contract emits no observation blocks")
    return spaces.Dict(blocks)


def action_space_for(cfg):
    """``Box(-1, 1, (1,))`` in continuous mode, else ``Discrete(3)``."""
    if cfg.action_space_mode == "continuous":
        return spaces.Box(-1.0, 1.0, (1,), np.float32)
    return spaces.Discrete(3)


def actions_tensor(actions, n: int) -> torch.Tensor:
    """``n`` actions as an (n,) float32 host tensor: the first entry of each
    row (a Box action's one value, a Discrete action itself).  The env
    step casts a discrete action to int32 and keeps a continuous one, so
    the float32 carrier serves both."""
    a = np.asarray(actions).reshape(n, -1)[:, 0]
    return torch.from_numpy(a.astype(np.float32))


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in ``tree_leaves``'s order (a
    dict's keys sorted), by the next items of the iterator ``leaves``."""
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(x, leaves) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(x, leaves) for x in tree)
    return next(leaves)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a 1-D tensor of unit stride (a copy only where its one
    axis is strided: a column of a wider block)."""
    flat = x.reshape(-1)
    return flat if flat.stride(0) == 1 else flat.clone(memory_format=torch.contiguous_format)


class StepProgram:
    """A step function ``fn(state, action) -> (new state, outputs)`` over a
    state held by the program.  On a CUDA device (unless ``eager``) it is
    one CUDA graph, captured at the first :meth:`step`: its static inputs
    are the state, which the graph overwrites with the new state, and the
    (n,) float32 action; its outputs (a tree of tensors) are packed into
    one byte buffer inside the graph, copied to pinned host memory with one
    non-blocking copy and read behind one event.  Elsewhere it runs op by
    op.  :meth:`step` returns the outputs as numpy arrays."""

    def __init__(self, fn: Callable, state, device: torch.device, eager: bool = False):
        self.fn = fn
        self.device = device
        self.graphed = device.type == "cuda" and not eager
        self.state = state
        self.graph: Optional[graphs.PhaseGraph] = None
        self._layout = None
        self._host = None
        self._action = None
        self._event = None

    def load(self, state) -> None:
        """Make ``state`` the program's state (copied into the graph's
        static inputs once it is captured)."""
        if self.graph is None:
            self.state = state
        else:
            graphs.copy_tree(self.graph.inputs["state"], state)

    def _pack(self, x):
        new_state, out = self.fn(x["state"], x["action"])
        leaves = tree_leaves(out)
        # widest elements first: every leaf's byte offset stays aligned to
        # its element size, so the host views need no copy
        order = sorted(range(len(leaves)), key=lambda i: -leaves[i].element_size())
        # each leaf's byte range and numpy dtype, worked out once: a step
        # unpacks by numpy views alone
        fields, offset = [], 0
        for i in order:
            nbytes = leaves[i].numel() * leaves[i].element_size()
            dtype = torch.empty((), dtype=leaves[i].dtype).numpy().dtype
            fields.append((i, offset, offset + nbytes, dtype, tuple(leaves[i].shape)))
            offset += nbytes
        self._layout = (out, fields)
        packed = torch.cat([_flat(leaves[i]).view(torch.uint8) for i in order])
        graphs.copy_tree(x["state"], new_state)
        return packed

    def _unpack(self, packed: np.ndarray):
        """The step's outputs as views of ``packed`` (the uint8 host
        buffer)."""
        out, fields = self._layout
        views = [None] * len(fields)
        for i, start, stop, dtype, shape in fields:
            views[i] = packed[start:stop].view(dtype).reshape(shape)
        return _unflatten(out, iter(views))

    def step(self, action: torch.Tensor):
        """One step on ``action`` ((n,) float32 host tensor): the outputs as
        numpy arrays; the program's state advances."""
        if not self.graphed:
            self.state, out = self.fn(self.state, action.to(self.device))
            return tree_map(lambda x: x.cpu().numpy(), out)
        if self.graph is None:
            inputs = {"state": graphs.clone_tree(self.state),
                      "action": action.to(self.device)}
            # the capture's warm-up runs advance the static state: the
            # program's state is copied in after it
            self.graph = graphs.PhaseGraph(self._pack, inputs, name="StepProgram.step")
            graphs.copy_tree(self.graph.inputs["state"], self.state)
            self.state = self.graph.inputs["state"]
            self._host = torch.empty(self.graph.outputs.shape, dtype=torch.uint8, pin_memory=True)
            self._action = torch.empty(action.shape, dtype=torch.float32, pin_memory=True)
            self._event = torch.cuda.Event()
        self._action.copy_(action)
        self.graph.inputs["action"].copy_(self._action, non_blocking=True)
        packed = self.graph()
        self._host.copy_(packed, non_blocking=True)
        self._event.record()
        self._event.synchronize()
        # a copy: the pinned buffer is the next step's
        return self._unpack(self._host.numpy().copy())


class GymFxEnv(Env):
    """The single-env Gymnasium adapter over the port's env step (on the
    card one CUDA graph a step, see the module docstring).  ``device``:
    CUDA unless the caller names another."""

    metadata = {"render_modes": []}

    def __init__(self, config: Dict[str, Any], dataset=None, *, device=None):
        super().__init__()
        self._env = Environment(config, dataset=dataset, device=device)
        self.config = dict(self._env.config)
        cfg = self._env.cfg
        self.window_size = cfg.window_size
        self.initial_cash = float(self.config.get("initial_cash", 10000.0))
        self.total_bars = cfg.n_bars
        self.action_space = action_space_for(cfg)
        self.continuous_action_threshold = (
            float(self.config.get("continuous_action_threshold", 0.33) or 0.33)
            if cfg.action_space_mode == "continuous" else None)

        blocks = dict(build_base_observation_space(self.config,
                                                   window_size=cfg.window_size).spaces)
        if cfg.stage_b_force_close_obs:
            blocks.update(
                bars_to_force_close=spaces.Box(0.0, np.inf, (1,), np.float32),
                hours_to_force_close=spaces.Box(0.0, np.inf, (1,), np.float32),
                is_force_close_zone=spaces.Box(0.0, 1.0, (1,), np.float32),
                is_monday_entry_window=spaces.Box(0.0, 1.0, (1,), np.float32),
            )
        if cfg.oanda_fx_calendar_obs:
            for key in CALENDAR_OBS_KEYS:
                high = 1.0 if key.startswith("is_") or key == "broker_market_open" else np.inf
                blocks[key] = spaces.Box(0.0, high, (1,), np.float32)
            blocks["margin_closeout_percent"] = spaces.Box(0.0, np.inf, (1,), np.float32)
            blocks["margin_available_norm"] = spaces.Box(0.0, np.inf, (1,), np.float32)
        self.observation_space = spaces.Dict(blocks)

        self._data = self._env.require_resident_data("GymFxEnv")
        env = self._env

        def step_fn(state, action):
            st, obs, reward, done, info = env_core.step(env.cfg, env.params, self._data, state,
                                                        action)
            return st, (obs, reward, done, info)

        self._program = StepProgram(step_fn, None, env.device)
        self._state: Optional[EnvState] = None
        self._last_info: Dict[str, Any] = {}
        self._equity_trace: list = []
        self._done_trace: list = []
        # the append-only JSONL audit of bracket decisions, gated by the
        # reference's variable (direct_atr_sltp.py:40-50); only bracket
        # strategies audit (direct_fixed_sltp with the same record schema,
        # its atr fields null)
        self._audit_path = (os.environ.get("GYMFX_BRACKET_AUDIT")
                            if cfg.strategy in ("direct_fixed_sltp", "direct_atr_sltp") else None)

    @property
    def device(self) -> torch.device:
        return self._env.device

    # ------------------------------------------------------------------
    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        env = self._env
        state, obs = env_core.reset(env.cfg, env.params, self._data, 1)
        self._program.load(state)
        self._state = state
        self._equity_trace, self._done_trace = [], []
        self._last_info = {}
        info = build_info(state, self._data, env.cfg, env.params)
        host_obs, host_info = tree_map(lambda x: x.cpu().numpy(), (obs, info))
        return self._np_obs(host_obs), self._py_info(host_info)

    def step(self, action):
        if self._state is None:
            raise RuntimeError("Call reset() before step().")
        obs, reward, done, info = self._program.step(actions_tensor(action, 1))
        self._state = self._program.state
        py_info = self._py_info(info)
        self._last_info = py_info
        self._equity_trace.append(float(info["equity_delta"][0]))
        done = bool(done[0])
        self._done_trace.append(done)
        if self._audit_path:
            self._audit_emit(py_info)
        return self._np_obs(obs), float(reward[0]), done, False, py_info

    def _audit_emit(self, info: Dict[str, Any]) -> None:
        """The reference-schema audit records (direct_atr_sltp.py:164-168,
        242-247, 256-261): long_bracket / short_bracket entries with their
        ATR and k-multiple fields, session_force_close on a session
        flatten."""
        if not info.get("pending_active"):
            return
        target = float(info.get("pending_target", 0.0))
        if target == 0.0:
            # the event overlay's force-flats are not audited in the
            # reference (action 3 is handled before the plugin)
            if info.get("event_context_forced_flat"):
                return
            rec = {"kind": "session_force_close", "entry": info.get("price"),
                   "size": float(info.get("position_units", 0.0))}
        else:
            cfg = self._env.cfg
            if cfg.strategy == "direct_atr_sltp":
                from gymfx_tpu_torch.core.strategy import _effective_sltp_multiples

                k_sl_eff, k_tp_eff = _effective_sltp_multiples(cfg, self._env.params)
                atr_fields = {"atr": float(info.get("atr", 0.0)), "k_sl_eff": float(k_sl_eff),
                              "k_tp_eff": float(k_tp_eff), "sltp_risk_mode": cfg.sltp_risk_mode}
            else:
                atr_fields = {"atr": None, "k_sl_eff": None, "k_tp_eff": None,
                              "sltp_risk_mode": None}
            rec = {
                "kind": "long_bracket" if target > 0 else "short_bracket",
                "entry": info.get("price"),
                "stop": float(info.get("pending_sl", 0.0)) or None,
                "limit": float(info.get("pending_tp", 0.0)) or None,
                "size": abs(target),
                "bar_index": info.get("bar_index"),
                **atr_fields,
            }
        try:
            with open(self._audit_path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(rec) + "\n")
        except OSError:
            pass

    def render(self):
        return None

    def close(self):
        self._state = None

    # ------------------------------------------------------------------
    @staticmethod
    def _np_obs(obs) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v[0], dtype=np.float32) for k, v in obs.items()}

    def _py_info(self, info) -> Dict[str, Any]:
        """The step's host info (each leaf (1,)) -> the reference-shaped
        info dict of python scalars."""
        out: Dict[str, Any] = {}
        action_diag: Dict[str, Any] = {}
        exec_diag: Dict[str, Any] = {}
        for k, v in info.items():
            val = np.asarray(v)[0].item()
            if k.startswith("action_diagnostics/"):
                action_diag[k.split("/", 1)[1]] = val
            elif k.startswith("execution_diagnostics/"):
                exec_diag[k.split("/", 1)[1]] = val
            else:
                out[k] = val
        if int(action_diag.get("steps", 0)) == 0:
            action_diag["raw_min"] = None
            action_diag["raw_max"] = None
        action_diag["continuous_action_threshold"] = self.continuous_action_threshold
        out["action_diagnostics"] = action_diag
        out["execution_diagnostics"] = exec_diag
        for key in ("broker_profile", "market_type", "trade_rate_band_id", "calendar_policy_id"):
            if self._env.cfg.oanda_fx_calendar_obs and self.config.get(key) is not None:
                out[key] = self.config[key]
        return out

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """The episode summary through the configured metrics plugin
        (reference app/env.py:697-716)."""
        from gymfx_tpu_torch.metrics import compute_analyzers, summarize_default, summarize_trading
        from gymfx_tpu_torch.train.ppo import env_state_row

        name = str(self.config.get("metrics_plugin", "default_metrics"))
        summarize = {"default_metrics": summarize_default,
                     "trading_metrics": summarize_trading}.get(name)
        if summarize is None:
            raise not_ported(f"the metrics_plugin {name!r} (a third-party plugin, "
                             "plugins/registry.py)", 9)
        if self._state is not None and self._equity_trace:
            equity = self.initial_cash + np.asarray(self._equity_trace, np.float64)
            done = np.asarray(self._done_trace, bool)
            timestamps = self._env.dataset.timestamps
            ts = timestamps[1: len(equity) + 1] if len(timestamps) else None
            analyzers = compute_analyzers(equity=equity, done=done,
                                          state=env_state_row(self._state, 0), timestamps=ts)
            final_equity = float(equity[-1] if not done.any() else equity[int(np.argmax(done))])
        else:
            analyzers = {}
            final_equity = self.initial_cash
        summary = summarize(initial_cash=self.initial_cash, final_equity=final_equity,
                            analyzers=analyzers, config=self.config)
        summary["action_diagnostics"] = dict(self._last_info.get("action_diagnostics", {}))
        summary["execution_diagnostics"] = dict(self._last_info.get("execution_diagnostics", {}))
        summary["event_context_diagnostics"] = {
            k: v for k, v in self._last_info.items() if k.startswith("event_context_")}
        return summary


def build_environment(*, config: Dict[str, Any], dataset=None, device=None,
                      **_ignored) -> GymFxEnv:
    """The engine dispatcher (reference gym_fx/__init__.py:4-12): every
    engine name resolves to the port's step; unknown names are refused."""
    engine = str(config.get("simulation_engine", "scan")).lower()
    if engine not in ("scan", "backtrader", "nautilus"):
        raise ValueError(f"unsupported simulation_engine '{engine}'")
    return GymFxEnv(config, dataset=dataset, device=device)
