"""The port's LOB venue and LOB training against the JAX package.

* ``execute_bar`` (lob/venue.py) against ``gymfx_tpu/lob/venue.py::
  execute_bar`` under ``jax.vmap``, on one batch of envs built to hit
  every path of the venue at several bars of a 16-level, 4-slot book
  with ``lob_volatile`` flow and 1-unit lots: the depth walk of a 40-lot
  entry, the sub-lot denial, the forced liquidation, the gap through the
  stop, resting take-profits with partial maker fills and stops fired on
  prints (the scenarios of the JAX package's tests/test_lob.py:296-352);
  and, on a batch of its own, take-profits one tick off the open filled
  in part and then pulled by a stop that fires on a later print, long
  and short.
  Against the JAX function run op by op (``jax.disable_jit``, 4 flow
  messages per bar: eager JAX costs ~1 s a message): BITWISE, every
  field.  Against the jitted function (8 messages per bar): every
  integer field, the position and the brackets BITWISE; the float ledger
  at rtol 1e-6 / atol 1e-5, because XLA:CPU contracts ``cash - delta *
  fill`` into a fused multiply-add inside jit while the port rounds the
  product (ROADMAP.md Queue 3).  Each path must occur in both.  (With
  more messages the volatile flow drains the 16-level book and exits
  nearly every position in full; the training test below runs 16.)
* The seeded books (``seed_book``, through K5's plain version) equal the
  JAX package's ``process_stream`` of the same seed stream.
* Training: one rollout phase of ``PPOTrainer`` on the LOB venue (8
  envs, window 8, hidden (16, 16), horizon 16, 16 messages per bar,
  random restarts on a 12-bar tape, so every episode ends and resets) against the
  jitted JAX ``PPOTrainer._rollout_phase`` (EnvParams as traced
  arguments, tests/test_torch_rollout.py), with its start offsets and
  actions injected.  The tape's prices lie on the 1e-5 tick grid, as
  quotes do, so ``price / tick`` lands near an integer and XLA's
  reciprocal multiply rounds to the same tick (ROADMAP.md Queue 3).
  Every integer field, the position, the brackets, the actions and the
  dones BITWISE; the float ledger, obs and rewards at rtol 1e-6 / atol
  1e-5 (the fused multiply-adds above); logp and value at rtol/atol 1e-5
  (the CPU GEMMs sum in different orders).  Then one update phase from
  each side's trajectory with the JAX permutation: loss terms at rtol
  1e-4 / atol 1e-5, as tests/test_torch_train.py holds f32 updates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.core.types import EXEC_DIAG_INDEX
from gymfx_tpu.lob import venue as jvenue
from gymfx_tpu.lob.book import empty_book as jax_empty_book
from gymfx_tpu.lob.book import process_stream as jax_process_stream
from gymfx_tpu.lob.flow import seed_messages as jax_seed_messages
from gymfx_tpu.lob.scenarios import scenario_flow_params as jax_scenario
from gymfx_tpu.train.ppo import PPOTrainer as JaxTrainer
from gymfx_tpu.train.ppo import ppo_config_from as jax_ppo_config_from

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.core.types import EnvState, make_env_config
from gymfx_tpu_torch.lob import venue
from gymfx_tpu_torch.lob.flow import price_to_ticks
from gymfx_tpu_torch.ops import lob_bar
from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

from test_torch_parity import assert_bitwise, paired_envs, random_walk_columns, to_np, x64_off
from test_torch_rollout import _jax_phase

LOB = dict(
    venue="lob", lob_scenario="lob_volatile", lob_depth_levels=16, lob_queue_slots=4,
    lob_messages_per_bar=32, strategy_plugin="direct_fixed_sltp", position_size=40.0,
    lob_lot_units=1.0, lob_match_kernel="on",
)
TICK = np.float32(1e-5)
INT_FIELDS = ("t", "trade_count", "trades_won", "trades_lost", "exec_diag", "pending_active",
              "pending_forced", "started", "terminated")
BARS = (3, 5, 8, 13, 21, 27)
# per scenario: pos, entry, pending (active, target, forced), sl/tp offsets
# from the open in ticks (pending brackets for entries, armed otherwise)
SCENARIOS = {
    "depth_walk": (0.0, 0.0, (True, 40.0, False), (-2000, 4000)),
    "sub_lot": (0.0, 0.0, (True, 0.3, False), (-2000, 4000)),
    "forced": (0.3, 1.1, (True, 0.0, True), (0, 0)),
    "gap_stop": (40.0, 1.1, (False, 0.0, False), (5, 4000)),
    "tp_short": (-40.0, 1.1, (False, 0.0, False), (10000, -1)),
    "tp_long": (40.0, 1.1, (False, 0.0, False), (-10000, 1)),
    "stop_long": (40.0, 1.1, (False, 0.0, False), (-1, 10000)),
    "stop_short": (-40.0, 1.1, (False, 0.0, False), (1, -10000)),
}


def _grid_columns(n, seed):
    """``random_walk_columns`` with prices on the 1e-5 tick grid."""
    cols = random_walk_columns(n=n, seed=seed)
    return {k: (v if k == "VOLUME" else np.round(v, 5)) for k, v in cols.items()}


def _venue_case(n_msgs, scenarios=SCENARIOS):
    """(JAX env, port env, JAX state, port state, bar rows): one env per
    (scenario, bar)."""
    jax_env, torch_env = paired_envs(_grid_columns(40, 7), window_size=8,
                                     **dict(LOB, lob_messages_per_bar=n_msgs))
    rows = np.array([t for _ in scenarios for t in BARS], np.int64)
    n = len(rows)
    data = torch_env.data
    o = to_np(data.open)[rows]
    base, _ = torch_env.reset(n)
    fields = {k: to_np(v).copy() for k, v in base._asdict().items()}
    for i, (pos, entry, (active, target, forced), (sl, tp)) in enumerate(
            s for s in scenarios.values() for _ in BARS):
        o_tick = np.float32(np.round(o[i] / TICK))
        sl_px = np.float32((o_tick + sl) * TICK) if sl else np.float32(0)
        tp_px = np.float32((o_tick + tp) * TICK) if tp else np.float32(0)
        fields["pos"][i], fields["entry_price"][i] = pos, entry
        fields["cash_delta"][i] = -pos * entry
        fields["pending_active"][i], fields["pending_target"][i] = active, target
        fields["pending_forced"][i] = forced
        if active:
            fields["pending_sl"][i], fields["pending_tp"][i] = sl_px, tp_px
        else:
            fields["bracket_sl"][i], fields["bracket_tp"][i] = sl_px, tp_px
        fields["t"][i] = rows[i]
        fields["started"][i] = True
    state = EnvState(**{k: torch.from_numpy(v) for k, v in fields.items()})
    jstate = type(jax_env.reset()[0])(**{k: jnp.asarray(v) for k, v in fields.items()})
    return jax_env, torch_env, jstate, state, rows


def _jax_execute(jax_env, jstate, rows, jit):
    data = jax_env.data
    t = jnp.asarray(rows, jnp.int32)

    def run(st, t):
        return jvenue.execute_bar(st, data.open[t], data.high[t], data.low[t], data.close[t],
                                  t, jax_env.cfg, jax_env.params)

    fn = jax.vmap(run)
    if jit:
        return jax.jit(fn)(jstate, t)
    with jax.disable_jit():
        return fn(jstate, t)


@pytest.mark.parametrize("jit,n_msgs", [(False, 4), (True, 8)], ids=["op_by_op", "jit"])
def test_execute_bar_matches_jax(jit, n_msgs):
    jax_env, torch_env, jstate, state, rows = _venue_case(n_msgs)
    with x64_off():
        ref = _jax_execute(jax_env, jstate, rows, jit)
    tr = torch.from_numpy(rows)
    d = torch_env.data
    ours = venue.execute_bar(state, d.open[tr], d.high[tr], d.low[tr], d.close[tr],
                             tr.to(torch.int32), torch_env.cfg, torch_env.params)
    for name in ours._fields:
        if not jit or name in INT_FIELDS or name.startswith(("bracket", "pending", "pos")):
            assert_bitwise(getattr(ref, name), getattr(ours, name), name)
        else:
            np.testing.assert_allclose(to_np(getattr(ours, name)), to_np(getattr(ref, name)),
                                       rtol=1e-6, atol=1e-5, err_msg=name)
    # every path of the venue ran
    k = len(BARS)
    pos = to_np(ours.pos).reshape(len(SCENARIOS), k)
    by = dict(zip(SCENARIOS, range(len(SCENARIOS))))
    entry = to_np(ours.entry_price).reshape(len(SCENARIOS), k)
    o = to_np(d.open)[rows].reshape(len(SCENARIOS), k)
    # the 40-lot entry walked past the touch (where the flow left it open)
    held = pos[by["depth_walk"]] == 40.0
    assert held.any()
    assert (entry[by["depth_walk"]][held] > o[by["depth_walk"]][held] + 1.5 * TICK).all()
    denied = to_np(ours.exec_diag)[:, EXEC_DIAG_INDEX["order_denied_min_quantity"]]
    assert (denied.reshape(len(SCENARIOS), k)[by["sub_lot"]] == 1).all()
    assert (pos[by["sub_lot"]] == 0.0).all() and (pos[by["forced"]] == 0.0).all()
    assert (pos[by["gap_stop"]] == 0.0).all()
    assert (to_np(ours.bracket_sl).reshape(len(SCENARIOS), k)[by["gap_stop"]] == 0.0).all()
    for name in ("tp_short", "tp_long"):
        partial = (np.abs(pos[by[name]]) > 0) & (np.abs(pos[by[name]]) < 40)
        assert partial.any(), f"{name}: no partial maker fill at any bar"
    for name in ("stop_long", "stop_short"):
        assert (pos[by[name]] == 0.0).any(), f"{name}: no stop fired on prints"


# a take-profit one tick off the open rests behind the seed's lots, a
# stop three ticks off on the other side: the flow fills the take-profit
# in part, then prints through the stop, which pulls what rests of it
TP_THEN_STOP = {
    "long": (40.0, 1.1, (False, 0.0, False), (-3, 1)),
    "short": (-40.0, 1.1, (False, 0.0, False), (3, -1)),
}


@pytest.mark.parametrize("jit,n_msgs", [(False, 4), (True, 8)], ids=["op_by_op", "jit"])
def test_execute_bar_matches_jax_when_a_stop_pulls_a_partly_filled_take_profit(jit, n_msgs):
    jax_env, torch_env, jstate, state, rows = _venue_case(n_msgs, TP_THEN_STOP)
    with x64_off():
        ref = _jax_execute(jax_env, jstate, rows, jit)
    tr = torch.from_numpy(rows)
    d, cfg = torch_env.data, torch_env.cfg
    ours = venue.execute_bar(state, d.open[tr], d.high[tr], d.low[tr], d.close[tr],
                             tr.to(torch.int32), cfg, torch_env.params)
    for name in ours._fields:
        if not jit or name in INT_FIELDS or name.startswith(("bracket", "pending", "pos")):
            assert_bitwise(getattr(ref, name), getattr(ours, name), name)
        else:
            np.testing.assert_allclose(to_np(getattr(ours, name)), to_np(getattr(ref, name)),
                                       rtol=1e-6, atol=1e-5, err_msg=name)
    # the path occurred: the bar's book work, through the venue's stages
    tick = torch.tensor(cfg.lob_tick_size, dtype=torch.float32)
    o_t, c_t = price_to_ticks(d.open[tr], tick), price_to_ticks(d.close[tr], tick)
    h_t = torch.maximum(price_to_ticks(d.high[tr], tick), torch.maximum(o_t, c_t))
    l_t = torch.minimum(price_to_ticks(d.low[tr], tick), torch.minimum(o_t, c_t))
    orders, _ = venue.bar_orders(state, o_t, tick, cfg, torch_env.params)
    _, fills = lob_bar.run_bar_plain(venue.seed_book(o_t, cfg),
                                     venue.bar_flow(o_t, h_t, l_t, c_t, tr.to(torch.int32), cfg),
                                     orders)
    pulled = (fills.tp_lots > 0) & (fills.tp_lots < 40) & (fills.fired == 1) & (fills.gap_lots == 0)
    by_side = pulled.reshape(len(TP_THEN_STOP), len(BARS)).any(dim=1)
    assert bool(by_side.all() if jit else by_side.any()), pulled
    assert (to_np(ours.pos)[pulled.numpy()] == 0.0).all()
    assert (to_np(ours.bracket_sl)[pulled.numpy()] == 0.0).all()


def test_seed_book_matches_jax_process_stream():
    jax_env, torch_env, _, _, rows = _venue_case(8)
    cfg = torch_env.cfg
    o = torch_env.data.open[torch.from_numpy(rows)]
    o_t = price_to_ticks(o, torch.tensor(1e-5, dtype=torch.float32))
    ours = venue.seed_book(o_t, cfg)
    with x64_off():
        fp = jax_scenario(cfg.lob_scenario)
        seed = jax.vmap(lambda ot: jax_seed_messages(ot, cfg.lob_seed_levels, fp))(
            jnp.asarray(o_t.numpy()))
        ref, _ = jax.vmap(lambda m: jax_process_stream(
            jax_empty_book(cfg.lob_depth_levels, cfg.lob_queue_slots), m))(seed)
    for name, a, b in zip(ref._fields, ref, ours):
        assert_bitwise(a, b, name)
    assert int(ours.bid_qty.sum()) == len(rows) * cfg.lob_seed_levels * 16


def test_scengen_driven_lob_flow_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        make_env_config({"venue": "lob", "feed": "scengen"}, n_bars=64)


def test_lob_venue_refuses_bar_engine_knobs():
    with pytest.raises(ValueError, match="rollout_env_kernel requires venue='bar'"):
        make_env_config({"venue": "lob", "rollout_env_kernel": "on"}, n_bars=64)
    with pytest.raises(ValueError, match="lob_match_kernel"):
        make_env_config({"venue": "lob", "lob_match_kernel": "sometimes"}, n_bars=64)
    with pytest.raises(ValueError, match="scenario"):
        make_env_config({"venue": "lob", "lob_scenario": "lob_nope"}, n_bars=64)
    for bad, match in (({"slippage": 0.001}, "slippage"),
                       ({"intrabar_collision_policy": "ohlc"}, "collision"),
                       ({"limit_fill_policy": "touch"}, "limit_fill_policy")):
        with pytest.raises(ValueError, match=match):
            paired_envs(random_walk_columns(n=40), window_size=8, **LOB, **bad)


def _trainers():
    over = dict(LOB, lob_messages_per_bar=16, num_envs=8, window_size=8, ppo_horizon=16,
                ppo_epochs=1, ppo_minibatches=2, policy="mlp", policy_kwargs={"hidden": [16, 16]},
                random_episode_start=True, feature_columns=["CLOSE", "VOLUME"])
    jax_env, torch_env = paired_envs(_grid_columns(12, 3), **over)
    return (JaxTrainer(jax_env, jax_ppo_config_from(jax_env.config)),
            PPOTrainer(torch_env, ppo_config_from(torch_env.config)))


def test_lob_rollout_and_update_phase_match_ppo_trainer():
    jt, tt = _trainers()
    n = jt.pcfg.n_envs
    with x64_off():
        js = jt.init_state(0)
        _, k0 = jax.random.split(js.rng)
        offsets = np.array(jax.random.randint(k0, (n,), 0, max(1, jt.env.cfg.n_bars - 2)))
        js2, (jtraj, jlast) = _jax_phase(jt)(js)
        _, *keys = jax.random.split(js2.rng, 2)
        perm = np.array(jax.random.permutation(keys[0], n))[None]
        jnew, jm = jax.jit(jt._update_phase)(js2, (jtraj, jlast))
    params = convert.mlp_params_from_flax(jax.tree.map(np.asarray, js.params), device="cpu")
    ts = tt.init_state(0)
    ts = ts._replace(params=params, opt_state=tt.optimizer.init(params))
    ts2, (traj, last) = tt.rollout_phase(ts, actions=torch.from_numpy(np.array(jtraj["action"])),
                                         start_offsets=torch.from_numpy(offsets))
    for key in ("done", "action"):
        assert_bitwise(jtraj[key], traj[key], f"traj {key}")
    for key in ("obs", "reward"):
        np.testing.assert_allclose(to_np(traj[key]), np.asarray(jtraj[key]), rtol=1e-6, atol=1e-5)
    for key in ("logp", "value"):
        np.testing.assert_allclose(to_np(traj[key]), np.asarray(jtraj[key]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(last), np.asarray(jlast), rtol=1e-5, atol=1e-5)
    for name in ts2.env_states._fields:
        ref, ours = getattr(js2.env_states, name), getattr(ts2.env_states, name)
        if ours.dtype in (torch.int32, torch.bool) or name.startswith(("bracket", "pending", "pos")):
            assert_bitwise(ref, ours, name)
        else:
            np.testing.assert_allclose(to_np(ours), to_np(ref), rtol=1e-6, atol=1e-5, err_msg=name)
    # positions were held (nonzero pnl rewards) and episodes ended and reset
    assert (to_np(traj["reward"]) != 0).mean() > 0.25 and bool(np.asarray(jtraj["done"]).any())

    _, tm = tt.update_phase(ts2, (traj, last), permutations=torch.from_numpy(perm))
    for key in ("loss", "policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4, atol=1e-5, err_msg=key)
    assert float(tm["nonfinite_skips"]) == 0.0
