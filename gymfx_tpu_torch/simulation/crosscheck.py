"""Scan-vs-replay execution cross-check.

The port of ``gymfx_tpu/simulation/crosscheck.py``.  The role the
Nautilus-backed env plays in the reference (an independent engine
verifying the training env's execution): re-execute one scan episode's
DECISION STREAM (the pending orders the strategy recorded, including
bracket SL/TP prices) through the float64 replay engine and reconcile
realized balances.  The scan side is the port's batched episode (K2 and
K3 on the card); its state and trace are read on the host, env 0's row.

  * the SCAN engine (core/broker.py, K2) is the throughput path: pending
    market orders fill at the next bar's open, brackets resolve
    intrabar against H/L under the profile's collision policy;
  * the REPLAY engine (simulation/replay.py) is the verification twin.
    Its latency model makes order timing line up exactly: a target
    submitted with ``latency_ms == one bar interval`` fills at the
    FIRST path tick of the next frame — the next bar's open, the scan
    engine's fill rule.  Same-bar bracket arming matches too (fills
    flush before the path walk).

Working from the decision stream (``pending_active/target/sl/tp`` in
the rollout trace) rather than raw actions means EVERY strategy kernel
is verifiable — default flow, fixed/ATR brackets, third-party
registered kernels, continuous action mode, event overlays — because
the stream records what the strategy decided, not how it decided it.

Intrabar path construction: the scan models continuous intrabar
movement (a stop at S inside the bar's range fills at S), so each
frame's execution path walks the bar's legs in the collision-policy
order (worst_case: adverse extreme first for the held position; ohlc:
O->H->L->C) with the armed bracket levels inserted as explicit ticks —
the replay then triggers at the same price the scan did.  A bar that
gaps open through a bracket fills at the open in both engines.

The instrument is resolved from the layered config through
``contracts.instrument_spec_from_config`` (the reference's env-side
resolver, simulation_engines/nautilus_gym.py:34-51).  Venue
quantization (DIVERGENCES.md #9d) means fractional sizes under
``size_precision=0`` show up here as bounded divergence — set
``size_precision``/``min_quantity`` in the config when cross-checking
fractional-unit strategies.

Out of scope: financing (the per-bar scan accrual vs per-event replay
accrual is cross-checked to the cent by the JAX package's
tests/test_execution_profile.py)
and bankrupt episodes (the scan freezes at termination mid-stream).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gymfx_tpu_torch.contracts import (
    ExecutionCostProfile,
    MarketFrame,
    SCHEMA_VERSION,
    TargetAction,
    instrument_spec_from_config,
)


def _profile_for_replay(config: Dict[str, Any], bar_ms: float) -> ExecutionCostProfile:
    """The episode's cost assumptions as a replay profile whose latency
    is exactly one bar — the scan engine's next-open fill timing."""
    from gymfx_tpu_torch.core.types import _parse_profile

    profile = _parse_profile(config)
    if profile is None:
        # key resolution mirrors the scan engine's (core/types.py
        # make_env_params): slippage_perc (default_broker's param) wins
        # over the bare slippage key; the scan's no-profile default
        # limit policy is "cross" (make_env_config)
        slippage = float(
            config.get("slippage_perc", config.get("slippage", 0.0)) or 0.0
        )
        profile = ExecutionCostProfile(
            schema_version=SCHEMA_VERSION,
            profile_id="crosscheck-from-config",
            commission_rate_per_side=float(config.get("commission", 0.0) or 0.0),
            full_spread_rate=0.0,
            slippage_bps_per_side=slippage * 1e4,
            latency_ms=0,
            financing_enabled=False,
            intrabar_collision_policy=str(
                config.get("intrabar_collision_policy", "worst_case")
            ),
            limit_fill_policy=str(config.get("limit_fill_policy", "cross")),
            margin_model="leveraged",
            enforce_margin_preflight=False,
            random_seed=0,
        )
    return dataclasses.replace(profile, latency_ms=int(round(bar_ms)))


def _build_path(
    o: float, h: float, l: float, c: float,
    walk_pos: float, levels: Sequence[float], ohlc_order: bool,
) -> Tuple[float, ...]:
    """One bar's execution path: its legs in collision order, with the
    armed bracket levels inserted as explicit ticks (clamped to the
    leg) so triggers happen at the same prices the scan engine uses.

    worst_case for a LONG walks the adverse (low) leg first: O->L->H->C;
    for a short (or under the ohlc policy) the bar walks O->H->L->C.
    """
    if ohlc_order or walk_pos <= 0:
        legs = [(o, h), (h, l), (l, c)]
    else:
        legs = [(o, l), (l, h), (h, c)]
    path: List[float] = [o]
    lvls = [x for x in levels if x > 0.0]
    for a, b in legs:
        inner = [x for x in lvls if min(a, b) < x < max(a, b)]
        inner.sort(reverse=a > b)
        for x in inner:
            path.append(x)
        path.append(b)
    deduped: List[float] = [path[0]]
    for x in path[1:]:
        if x != deduped[-1]:
            deduped.append(x)
    return tuple(deduped)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _first_env(state, trace):
    """Env 0 of a batched episode (state fields (N,), trace (steps, N))
    on the host."""
    state = type(state)(*(x[0].cpu() for x in state))
    trace = {k: v[:, 0].cpu() for k, v in trace.items() if isinstance(v, torch.Tensor)}
    return state, trace


def _scan_episode(env, config, actions, steps, seed):
    """Run the scan side: the config's driver, or ``actions`` replayed;
    returns env 0's (state, trace) on the host."""
    from gymfx_tpu_torch.core.rollout import replay_driver

    n_bars = env.n_bars
    if actions is None:
        driver = env.make_driver()
        n_steps = min(int(steps or config.get("steps", 500)), n_bars - 2)
        state, trace = env.rollout(driver, n_steps, seed=seed)
    else:
        acts = [int(a) for a in actions][: n_bars - 2]
        state, trace = env.rollout(replay_driver(np.asarray(acts), env.device), len(acts),
                                   seed=seed)
    state, trace = _first_env(state, trace)
    if bool(_host(trace["done"]).astype(bool).any()):
        raise ValueError(
            "episode terminated early (bankruptcy); crosscheck needs the "
            "full decision stream to execute in both engines"
        )
    return state, trace


def crosscheck_episode(
    config: Dict[str, Any],
    actions: Optional[Sequence[int]] = None,
    *,
    steps: Optional[int] = None,
    seed: int = 0,
    env: Optional[Any] = None,
    scan_state: Optional[Any] = None,
    trace: Optional[Dict[str, Any]] = None,
    terminated: bool = False,
    device=None,
) -> Dict[str, Any]:
    """Run one episode through both engines; return both balances.

    Three entry modes:
      * default — the config's driver (driver_mode) runs one scan
        episode and its decision stream is re-executed;
      * ``actions`` — an explicit action stream is run through the scan
        engine first, then its decision stream re-executed;
      * ``scan_state`` + ``trace`` (+ ``terminated``) — the caller (the
        command line's ``verify_execution`` path) already ran the
        episode: one env's state and its (steps,) trace; nothing is
        re-run on the scan side.
    A new Environment is on ``device`` (CUDA unless named).  Returns
    scan/replay realized balances, divergence with its quantization
    bound, replay hashes, and fill counts.
    """
    from gymfx_tpu_torch.core import broker
    from gymfx_tpu_torch.core.runtime import Environment

    config = dict(config)
    if env is None:
        env = Environment(config, device=device)
    if env.cfg.venue == "lob":
        raise ValueError(
            "venue=lob episodes execute through the book engine; "
            "reconcile them with crosscheck_lob_episode (the LOB's "
            "pure-Python oracle replay), not the bar-vs-replay crosscheck"
        )
    if env.cfg.financing_enabled:
        raise ValueError(
            "crosscheck does not model financing; disable financing_enabled "
            "(both engines' financing is cross-checked by "
            "tests/test_execution_profile.py)"
        )
    slip_rate = float(env.params.slippage)
    bar_ms = env.dataset.bar_interval_ms()
    if not bar_ms:
        raise ValueError("crosscheck requires timestamped bars")

    n_bars = env.n_bars
    if scan_state is not None:
        if trace is None:
            raise ValueError("scan_state requires the collected rollout trace")
        if terminated:
            raise ValueError(
                "episode terminated early (bankruptcy); crosscheck needs the "
                "full decision stream to execute in both engines"
            )
        state = scan_state
    else:
        state, trace = _scan_episode(env, config, actions, steps, seed)

    pend_active = _host(trace["pending_active"]).astype(bool)
    pend_target = _host(trace["pending_target"]).astype(np.float64)
    pend_sl = _host(trace["pending_sl"]).astype(np.float64)
    pend_tp = _host(trace["pending_tp"]).astype(np.float64)
    pos_units = _host(trace["pos_units"]).astype(np.float64)
    bracket_sl = _host(trace["bracket_sl"]).astype(np.float64)
    bracket_tp = _host(trace["bracket_tp"]).astype(np.float64)
    order_denied = _host(trace["order_denied"]).astype(np.int64)
    # cap at n_bars: a longer trace ran past exhaustion, where steps are
    # no-ops (the strategy never acts on bars that do not exist)
    n_steps = min(len(pend_active), n_bars)

    params = type(env.params)(*(x.cpu() for x in env.params))
    state = type(state)(*(x.cpu() for x in state))
    scan_balance = float(broker.realized_balance(state, params))

    # replay side: scan step i processes bar i (step 0 is the warmup on
    # bar 0), so the pending order recorded at step i is submitted on
    # frame i and the one-bar latency fills it at bar i+1's first path
    # tick — the bar's open, the scan engine's rule
    spec = instrument_spec_from_config(config)
    profile = _profile_for_replay(config, bar_ms)
    ts = np.asarray(env.dataset.timestamps).astype("datetime64[ns]").astype(np.int64)
    # the same (compute-dtype) price arrays the scan engine executed on,
    # so the comparison isolates engine semantics, not float width
    data = env.require_resident_data("crosscheck_episode")
    o, h, l, c = (_host(x).astype(np.float64) for x in (data.open, data.high, data.low,
                                                          data.close))

    ohlc_order = env.cfg.intrabar_collision_policy == "ohlc"
    frames: List[MarketFrame] = []
    # frames stop at bar n_steps-1, the last bar the scan episode
    # processed: its final pending order never fills (the episode ends
    # first), so the replay twin leaves it in flight too.
    #
    # Bar j's intrabar path is built from the scan's RECORDED state:
    #   walk_pos  the position held through bar j's intrabar phase —
    #             the pending target when it actually FILLED at bar j's
    #             open (the order_denied counter not incrementing proves
    #             it cleared the venue size rules), else the carry-over
    #             position;
    #   levels    the bracket prices live DURING bar j: the entry's
    #             brackets when it armed at bar j's open (same-bar
    #             arming), else the levels still armed after step j-1
    #             (state.bracket_sl/tp — zero when flat, so exited or
    #             cancelled brackets never poison later paths).
    for j in range(min(n_steps, n_bars)):
        if j == 0:
            walk_pos, levels = 0.0, (0.0, 0.0)
        else:
            filled = bool(pend_active[j - 1]) and not (
                order_denied[j] > order_denied[j - 1]
            )
            if filled:
                walk_pos = float(pend_target[j - 1])
            else:
                walk_pos = float(pos_units[j - 1])
            if filled and (pend_sl[j - 1] > 0.0 or pend_tp[j - 1] > 0.0):
                levels = (float(pend_sl[j - 1]), float(pend_tp[j - 1]))
            else:
                levels = (float(bracket_sl[j - 1]), float(bracket_tp[j - 1]))
        frames.append(
            MarketFrame(
                instrument_id=spec.instrument_id,
                timeframe_minutes=max(1, int(round(bar_ms / 60_000.0))),
                ts_event_ns=int(ts[j]),
                open=float(o[j]),
                high=float(h[j]),
                low=float(l[j]),
                close=float(c[j]),
                volume=0.0,
                execution_path=_build_path(
                    float(o[j]), float(h[j]), float(l[j]), float(c[j]),
                    walk_pos, levels, ohlc_order,
                ),
            )
        )

    target_actions = [
        TargetAction(
            instrument_id=spec.instrument_id,
            ts_event_ns=int(ts[i]),
            target_units=float(pend_target[i]),
            action_id=f"step-{i}",
            stop_loss_price=float(pend_sl[i]) if pend_sl[i] > 0.0 else None,
            take_profit_price=float(pend_tp[i]) if pend_tp[i] > 0.0 else None,
        )
        for i in range(n_steps)
        if pend_active[i]
    ]

    from gymfx_tpu_torch.simulation.replay import ReplayAdapter

    initial_cash = float(config.get("initial_cash", 10000.0) or 10000.0)
    result = ReplayAdapter(profile).run(
        instrument_specs=[spec],
        frames=frames,
        actions=target_actions,
        initial_cash=initial_cash,
        base_currency=spec.quote_currency,
        default_leverage=float(config.get("leverage", 1.0) or 1.0),
        # the scan's per-fill-type slippage switches, mirrored as venue
        # behavior (simulation/replay.py run docstring)
        slip_open=bool(env.cfg.slip_open),
        slip_limit=bool(env.cfg.slip_limit),
        slip_match=bool(env.cfg.slip_match),
    )
    replay_balance = float(result["summary"]["final_balance"])
    fills = [e for e in result["events"] if e["event_type"] == "order_filled"]

    # the replay venue quotes at price_precision (like the reference's
    # Nautilus book) while the scan engine fills at unquantized floats:
    # each fill can differ by up to half a tick per unit, plus the scan
    # compute dtype's rounding (f32 ~1e-7 relative); under
    # limit_fill_policy=cross with a nonzero adverse rate the two
    # engines price TP touches differently (limit price vs touching
    # tick's book) by up to the adverse displacement per unit
    eps = float(torch.finfo(env.cfg.dtype).eps)
    tick = 10.0 ** (-spec.price_precision)
    max_price = float(np.max(c))
    dtype_eps = 3.0 * eps * max_price
    # with scan-side venue quantization (venue_quantization) both engines
    # land fills on the same tick grid, so the half-tick term disappears
    # and only compute-dtype rounding remains — plus a midpoint-flip
    # allowance: the scan computes prices (and the quantize ratio x/tick,
    # ~1e5) at the env compute dtype, so a fill whose true value lies
    # within that dtype's error band of a tick midpoint can round to the
    # ADJACENT tick vs the replay's float64 rounding — a full-tick
    # divergence on that fill's units.  The allowance covers the worst
    # single fill flipping in full plus the band-width fraction of the
    # remaining units.  In float64 envs the quantize is exact unless
    # slippage scales the price.
    scan_quantized = float(env.params.price_tick) > 0
    filled_units = sum(float(f["quantity"]) for f in fills)
    max_fill_qty = max((float(f["quantity"]) for f in fills), default=0.0)
    flip_allowance = 0.0
    if scan_quantized:
        per_unit = dtype_eps
        exact = env.cfg.dtype == torch.float64 and slip_rate == 0.0 and (
            profile.quote_adverse_rate_per_side == 0.0
        )
        if not exact:
            band = min(1.0, 2.0 * eps * max_price / tick)
            flip_allowance = tick * (band * filled_units + max_fill_qty)
    else:
        per_unit = tick / 2.0 + dtype_eps
    if (
        profile.limit_fill_policy == "cross"
        and profile.quote_adverse_rate_per_side > 0
    ):
        per_unit += profile.quote_adverse_rate_per_side * max_price
    quantization_bound = filled_units * per_unit + flip_allowance + 0.01

    return {
        "schema": "scan_replay_crosscheck.v2",
        "instrument": spec.instrument_id,
        "steps": int(n_steps),
        "actions_submitted": len(target_actions),
        "scan_realized_balance": scan_balance,
        "replay_final_balance": replay_balance,
        "divergence": abs(scan_balance - replay_balance),
        "quantization_bound": quantization_bound,
        "within_bound": abs(scan_balance - replay_balance) <= quantization_bound,
        "scan_trades": int(state.trade_count),
        "replay_fills": len(fills),
        "replay_pending_unexecuted": result["native"]["orders_pending_unexecuted"],
        "replay_result_hash": result["result_hash"],
        "profile_id": profile.profile_id,
        "latency_ms": profile.latency_ms,
    }


def crosscheck_lob_episode(
    config: Dict[str, Any],
    actions: Optional[Sequence[int]] = None,
    *,
    steps: Optional[int] = None,
    seed: int = 0,
    env: Optional[Any] = None,
    device=None,
) -> Dict[str, Any]:
    """Third-engine crosscheck: one ``venue=lob`` scan episode vs the
    pure-Python reference book (``lob/oracle.OracleVenue``).

    The scan side runs the batched book under the rollout (K5, K8 and
    K9 on the card); the oracle side REGENERATES every bar's message
    stream from the same seeded flow process (``lob/flow.py``, its plain
    version), replays it through the plain-Python book, and re-executes
    the episode's DECISION STREAM (the recorded pending orders) through a
    float64 ledger mirror.  Matching is integer-exact on both sides, so
    the reconciliation bound carries only compute-dtype ledger rounding;
    the venue's min-quantity denial counters must agree EXACTLY.
    """
    from gymfx_tpu_torch.core import broker
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.lob.flow import bar_key, bar_messages, price_to_ticks, seed_messages
    from gymfx_tpu_torch.lob.oracle import OracleVenue
    from gymfx_tpu_torch.lob.scenarios import scenario_flow_params

    config = dict(config)
    if env is None:
        env = Environment(config, device=device)
    cfg = env.cfg
    if cfg.venue != "lob":
        raise ValueError("crosscheck_lob_episode requires venue=lob")
    if cfg.lob_flow_from_scengen:
        raise ValueError(
            "crosscheck_lob_episode regenerates flow from the STATIC "
            "scenario preset; feed=scengen derives per-bar FlowParams "
            "from the tape's scen_flags, which the oracle replay does "
            "not model — run the crosscheck on a replay feed"
        )
    if cfg.enforce_margin_closeout:
        raise ValueError(
            "crosscheck_lob_episode does not model venue-forced "
            "liquidations (pending_forced is not in the rollout trace); "
            "disable enforce_margin_closeout"
        )
    if cfg.financing_enabled:
        raise ValueError(
            "crosscheck does not model financing; disable financing_enabled"
        )

    n_bars = env.n_bars
    state, trace = _scan_episode(env, config, actions, steps, seed)
    pend_active = _host(trace["pending_active"]).astype(bool).ravel()
    pend_target = _host(trace["pending_target"]).astype(np.float64).ravel()
    pend_sl = _host(trace["pending_sl"]).astype(np.float64).ravel()
    pend_tp = _host(trace["pending_tp"]).astype(np.float64).ravel()
    order_denied = _host(trace["order_denied"]).astype(np.int64).ravel()
    n_steps = min(len(pend_active), n_bars)

    params = type(env.params)(*(x.cpu() for x in env.params))
    scan_balance = float(broker.realized_balance(state, params))

    # regenerate the venue's message streams bar for bar (the flow's
    # plain version, batched over the executed bars, read once)
    data = env.require_resident_data("crosscheck_lob_episode")
    dev = data.close.device
    tick = torch.tensor(cfg.lob_tick_size, dtype=data.close.dtype, device=dev)
    fp = scenario_flow_params(cfg.lob_scenario)
    bars = torch.arange(1, n_steps, dtype=torch.int32, device=dev)
    rows = bars.long()
    o_t = price_to_ticks(data.open[rows], tick)
    c_t = price_to_ticks(data.close[rows], tick)
    h_t = torch.maximum(price_to_ticks(data.high[rows], tick), torch.maximum(o_t, c_t))
    l_t = torch.minimum(price_to_ticks(data.low[rows], tick), torch.minimum(o_t, c_t))
    flow = bar_messages(bar_key(cfg.lob_flow_seed, bars), o_t, h_t, l_t, c_t,
                        cfg.lob_messages_per_bar, fp)
    seeds = seed_messages(o_t, cfg.lob_seed_levels, fp)
    o_ticks = _host(o_t)
    flow_np = tuple(_host(a) for a in flow)
    seeds_np = tuple(_host(a) for a in seeds)
    o_price = _host(data.open[rows])

    lot_units = (
        cfg.lob_lot_units if cfg.lob_lot_units > 0 else float(params.position_size)
    )
    oracle = OracleVenue(
        depth_levels=cfg.lob_depth_levels,
        queue_slots=cfg.lob_queue_slots,
        seed_levels=cfg.lob_seed_levels,
        tick=cfg.lob_tick_size,
        lot_units=lot_units,
        commission=float(params.commission),
        initial_cash=float(config.get("initial_cash", 10000.0) or 10000.0),
    )
    for i, j in enumerate(range(1, n_steps)):
        oracle.execute_bar(
            int(o_ticks[i]),
            float(o_price[i]),
            tuple(np.asarray(a[i]) for a in seeds_np),
            tuple(np.asarray(a[i]) for a in flow_np),
            (
                bool(pend_active[j - 1]),
                float(pend_target[j - 1]),
                float(pend_sl[j - 1]),
                float(pend_tp[j - 1]),
            ),
        )

    oracle_balance = oracle.balance()
    scan_denied = int(order_denied[n_steps - 1])
    # matching is integer-exact on both sides; the bound carries only
    # the scan ledger's compute-dtype rounding across its fills
    max_price = float(np.max(_host(data.close)))
    dtype_eps = 3.0 * float(torch.finfo(cfg.dtype).eps) * max_price
    bound = oracle.fills_units * dtype_eps + 0.01
    divergence = abs(scan_balance - oracle_balance)
    return {
        "schema": "lob_crosscheck.v1",
        "steps": int(n_steps),
        "bars_executed": int(n_steps - 1),
        "scan_realized_balance": scan_balance,
        "oracle_realized_balance": oracle_balance,
        "divergence": divergence,
        "quantization_bound": bound,
        "within_bound": divergence <= bound,
        "scan_trades": int(state.trade_count),
        "scan_denied": scan_denied,
        "oracle_denied": int(oracle.denied),
        "denied_match": scan_denied == int(oracle.denied),
        "oracle_fill_units": float(oracle.fills_units),
        "scenario": cfg.lob_scenario,
        "depth_levels": cfg.lob_depth_levels,
        "queue_slots": cfg.lob_queue_slots,
        "messages_per_bar": cfg.lob_messages_per_bar,
    }
