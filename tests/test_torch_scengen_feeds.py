"""The scenario generator's feeds in the port against the JAX package:
the grid and frames (scengen/feed.py), the stress overlay, the LOB flow
from the tape's flags (K9's flag route's plain version), the envs on
``feed=scengen``, the scengen and portfolio curriculum tapes, the
portfolio's LOB venue and ``main --feed scengen``.

Small sizes: tapes of 200-600 bars, window 8, at most 16 envs, books of
depth 8 with 8 messages a bar.  Generated tapes are snapped to the tick
grid (``scengen_snap_to_tick``) where the comparison is bitwise: the
float64 rounding onto 1e-5 ticks takes both packages' float32 prices,
which differ by an ulp or two (tests/test_torch_scengen.py), to the same
grid values.  Unsnapped prices are compared within rtol 2e-6, as there.

* ``fx_timestamp_grid`` equals the JAX package's pandas grid (timestamps
  and Monday mask) at M1, H1, H4 and M15, from starts on and off the
  weekend; ``synthesize_frame`` (snapped: every column BITWISE) and
  ``synthesize_portfolio_frames`` equal the JAX package's, flags exact;
  ``ScenGenDataset.sliced`` builds the JAX package's MarketData bitwise,
  its flags sliced with its frame.
* ``apply_scengen_stress`` on a port MarketData (tensors) equals the JAX
  package's on its MarketData for every family (crash, drought, gap):
  the same numpy draws, every field BITWISE.
* ``flow_params_from_regime`` equals the JAX blend field by field for
  every flag kind; K9's plain version with flags equals JAX
  ``bar_messages`` under the blended params BITWISE for every scenario
  on envs of all four kinds (neither, drought, crash, both), whose kind
  thresholds are the blend's float32 sums (which differ from the replay
  path's rounded float64 sums for some scenario: asserted).
* ``execute_bar`` with ``scen_flags`` against the JAX venue's (jitted),
  on bars of every kind; the env on ``feed=scengen`` (bar and LOB venue)
  against the JAX env: its MarketData BITWISE; on the LOB venue each step
  of an episode over drought and crash bars is ``execute_bar`` under that
  bar's flags, bitwise (the env's wiring of ``data.scen_flags``).
* ``eval_split`` on a generated tape cuts one generation, as JAX's.
* ``CurriculumSampler`` over ``scengen:`` tapes, compressed and not: the
  JAX package's picks, every tape BITWISE; ``PortfolioCurriculumSampler``:
  the JAX picks, its books' snapped prices within rtol 2e-6 or one tick
  (three pairs mix their shocks through the Cholesky factor, so prices an
  ulp apart can round a tick apart), its refusals of a ``file:`` tape,
  of unequal bar counts and of ``eval_split``.
* The portfolio env on a generated book binds the JAX env's tapes
  BITWISE (the JAX env given the port's frames, its own being an ulp
  apart): every pair leaf, the conversion factors; its steps are the
  replayed book's (tests/test_torch_portfolio.py).  With ``venue="lob"``
  the JAX portfolio runs every pair through the LOB venue (its vmapped
  ``core.env.step`` reads the pair config's venue) and so does the port:
  8 steps against the jitted JAX step (ROADMAP Queue 3).
* ``main --feed scengen``: the diagnostic episode's results equal the
  JAX ``main``'s (training through ``main``: tests/test_torch_cli.py).
"""
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gymfx_tpu.app.main import main as jax_main
from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.core import portfolio as JP
from gymfx_tpu.core.runtime import Environment as JaxEnvironment
from gymfx_tpu.lob import flow as jax_flow
from gymfx_tpu.lob import scenarios as jax_scenarios
from gymfx_tpu.lob import venue as jax_venue
from gymfx_tpu.scengen import feed as JF
from gymfx_tpu.scengen import stress as JS
from gymfx_tpu.train.common import build_train_eval_envs as jax_build_envs

from gymfx_tpu_torch.app.main import main
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core import portfolio as TP
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.lob import flow, scenarios, venue
from gymfx_tpu_torch.ops import cases, lob_flow
from gymfx_tpu_torch.scengen import feed as TF
from gymfx_tpu_torch.scengen import stress as TS
from gymfx_tpu_torch.train.common import build_train_eval_envs

from test_torch_cli import _argv, _json, assert_results_match
from test_torch_lob_venue import INT_FIELDS, _venue_case
from test_torch_parity import assert_bitwise, paired_envs, random_walk_columns, to_np, x64_off

REPO = pathlib.Path(__file__).resolve().parent.parent
PRICE_RTOL = 2e-6
GEN = dict(feed="scengen", scengen_bars=400, scengen_seed=3, scengen_snap_to_tick=True,
           window_size=8)
LOB = dict(venue="lob", lob_scenario="lob_volatile", lob_depth_levels=8, lob_queue_slots=4,
           lob_messages_per_bar=8, strategy_plugin="direct_fixed_sltp", position_size=40.0,
           lob_lot_units=1.0)
PAIRS = '["EUR_USD", "GBP_USD", "AUD_USD"]'
TICK = 1.0001e-5  # one tick of lob_tick_size, in float32
KINDS = (0, 2, 4, 6)


def _configs(**over):
    return {**JAX_DEFAULTS, **over}, {**DEFAULT_VALUES, **over}


def _assert_close(ref, ours, label):
    a, b = to_np(ref), to_np(ours)
    assert a.shape == b.shape and a.dtype == b.dtype, label
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5, err_msg=label)
    else:
        np.testing.assert_array_equal(b, a, err_msg=label)


@pytest.mark.parametrize("n,tf,start", [
    (3000, 1 / 60, "2024-01-01"), (700, 1.0, "2024-01-05"), (50, 4.0, "2024-01-06 23:00"),
    (2, 0.25, "2024-01-07 21:45"),
])
def test_fx_timestamp_grid_matches_jax(n, tf, start):
    ours, monday = TF.fx_timestamp_grid(n, tf, start=start)
    ref, ref_monday = JF.fx_timestamp_grid(n, tf, start=start)
    assert ours.dtype == np.dtype("datetime64[us]")
    np.testing.assert_array_equal(ours, ref.values.astype("datetime64[us]"))
    np.testing.assert_array_equal(monday, ref_monday)


@pytest.mark.parametrize("snap", [False, True], ids=["raw", "snapped"])
def test_synthesize_frame_matches_jax(snap):
    jcfg, tcfg = _configs(**dict(GEN, scengen_preset="flash_crash", scengen_snap_to_tick=snap))
    ref, ref_flags = JF.synthesize_frame(jcfg)
    ours, flags = TF.synthesize_frame(tcfg, device="cpu")
    np.testing.assert_array_equal(flags, ref_flags)
    assert (flags & 4).any(), "no crash bar in the tape"
    np.testing.assert_array_equal(ours.timestamps, ref.index.values.astype("datetime64[us]"))
    assert sorted(ours.columns) == sorted(ref.columns)
    for col in ref.columns:
        a, b = ref[col].to_numpy(np.float64), ours.columns[col]
        if snap or col not in ("OPEN", "HIGH", "LOW", "CLOSE"):
            assert_bitwise(a, b, col)
        else:
            np.testing.assert_allclose(b, a, rtol=PRICE_RTOL, err_msg=col)


def test_synthesize_portfolio_frames_matches_jax():
    jcfg, tcfg = _configs(**dict(GEN, scengen_preset="multi_asset_stress"))
    pairs, frames, flags = TF.synthesize_portfolio_frames(tcfg, device="cpu")
    ref_pairs, ref_frames, ref_flags = JF.synthesize_portfolio_frames(jcfg)
    assert pairs == ref_pairs == list(TF.DEFAULT_PORTFOLIO_PAIRS)
    np.testing.assert_array_equal(flags, ref_flags)
    for p in pairs:
        np.testing.assert_allclose(frames[p].columns["CLOSE"], ref_frames[p]["CLOSE"].to_numpy(),
                                   rtol=PRICE_RTOL, atol=TICK, err_msg=p)
    for bad in ("not json", "[]"):
        for fn, cfg in ((TF.synthesize_portfolio_frames, tcfg), (JF.synthesize_portfolio_frames, jcfg)):
            with pytest.raises(ValueError, match="scengen_pairs must be"):
                fn(dict(cfg, scengen_pairs=bad))


def test_scengen_dataset_sliced_builds_the_jax_market_data():
    jcfg, tcfg = _configs(**dict(GEN, scengen_preset="multi_asset_stress"))
    kwargs = dict(window_size=8, feature_columns=("OPEN", "CLOSE", "VOLUME"))
    sl = slice(100, 300)
    ours = TF.ScenGenDataset(tcfg, device="cpu").sliced(sl)
    ref = JF.ScenGenDataset(jcfg).sliced(sl)
    with x64_off():
        md_ref = ref.build_market_data(device=False, **kwargs)
    md = ours.build_market_data(device=None, **kwargs)
    for name in md._fields:
        if name != "row0":
            assert_bitwise(getattr(md_ref, name), getattr(md, name), name)
    assert len(ours) == 200 and np.array_equal(ours.scen_flags, TF.ScenGenDataset(
        tcfg, device="cpu").scen_flags[sl])
    on_device = ours.build_market_data(device="cpu", **kwargs)
    assert isinstance(on_device.scen_flags, torch.Tensor)
    assert on_device.scen_flags.dtype == torch.int32
    with pytest.raises(ValueError, match="aligned with its frame"):
        TF.ScenGenDataset(tcfg, ours.frame, ours.scen_flags[:-1])


@pytest.mark.parametrize("preset,seed", [("flash_crash", 0), ("liquidity_drought", 7),
                                         ("gap_open", 1), ("multi_asset_stress", 3)])
def test_apply_scengen_stress_matches_jax(preset, seed):
    jax_env, torch_env = paired_envs(random_walk_columns(n=200, seed=5), window_size=8)
    with x64_off():
        ref = JS.apply_scengen_stress(jax_env.data, preset, seed)
    ours = TS.apply_scengen_stress(torch_env.data, preset, seed)
    for name in ours._fields:
        if name != "row0":
            assert_bitwise(getattr(ref, name), getattr(ours, name), name)
            if isinstance(getattr(torch_env.data, name), torch.Tensor):
                assert getattr(ours, name).device == getattr(torch_env.data, name).device
    assert int(to_np(ours.scen_flags).astype(bool).sum()) > 0
    # host MarketData stays numpy
    host = torch_env.dataset.build_market_data(device=None, **torch_env.md_kwargs)
    assert isinstance(TS.apply_scengen_stress(host, preset, seed).close, np.ndarray)


def _flags(n):
    """Bar flags of every kind, the other bits set too."""
    return torch.tensor([KINDS[i % 4] | (i * 9 % 32 & ~6) for i in range(n)], dtype=torch.int32)


@pytest.mark.parametrize("scenario", scenarios.scenario_names())
def test_flow_params_from_regime_matches_the_jax_blend(scenario):
    flags = _flags(12)
    ours = scenarios.flow_params_from_regime(scenarios.scenario_flow_params(scenario), flags, 64)
    with x64_off():
        ref = jax.vmap(lambda f: jax_scenarios.flow_params_from_regime(
            jax_scenarios.scenario_flow_params(scenario), f, 64))(jnp.asarray(flags.numpy()))
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), to_np(getattr(ours, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


FLAG_MSGS, FLAG_SEED = 24, 5


@jax.jit
@functools.partial(jax.vmap, in_axes=(None, 0, 0, 0, 0, 0, 0))
def _jax_flag_messages(base, t1, o1, h1, l1, c1, f1):
    """JAX ``bar_messages`` under ``flow_params_from_regime``, the base
    scenario's fields passed as arrays (one compile for every scenario;
    the blend's fields are float32 and int32 arrays either way)."""
    fp = jax_scenarios.flow_params_from_regime(base, f1, FLAG_MSGS)
    return jax_flow.bar_messages(jax_flow.bar_key(FLAG_SEED, t1), o1, h1, l1, c1, FLAG_MSGS, fp)


@pytest.mark.parametrize("scenario", scenarios.scenario_names())
def test_flag_route_plain_matches_jax_bar_messages(scenario):
    n, n_msgs, seed = 16, FLAG_MSGS, FLAG_SEED
    t, o, h, l, c = cases.lob_flow_bars(n, "int32", seed=3)
    flags = _flags(n)
    ours = lob_flow.bar_flow_plain(seed, t, o, h, l, c, n_msgs,
                                   scenarios.scenario_flow_params(scenario), flags)
    base = jax_scenarios.scenario_flow_params(scenario)
    with x64_off():
        base = type(base)(*(jnp.asarray(v, jnp.float32 if isinstance(v, float) else jnp.int32)
                            for v in base))
        ref = _jax_flag_messages(base, *(jnp.asarray(x.numpy()) for x in (t, o, h, l, c, flags)))
    for name, a, b in zip(ref._fields, ref, ours):
        assert_bitwise(a, b, name)
    # the crash kinds fire the burst, the drought kinds thin the flow
    burst = slice(n_msgs // 3, n_msgs // 3 + max(1, n_msgs // 8))
    crash_rows = (scenarios.regime_kind(flags) & 2) != 0
    assert (ours.kind[crash_rows][:, burst] == 3).all() and (ours.side[crash_rows][:, burst] == -1).all()
    # the K9 wrapper on CPU tensors is this plain version and launches nothing
    before = (lob_flow.bar_flow.launches, lob_flow.bar_flow.flag_launches)
    again = lob_flow.bar_flow(seed, t, o, h, l, c, n_msgs, scenarios.scenario_flow_params(scenario),
                              flags)
    assert (lob_flow.bar_flow.launches, lob_flow.bar_flow.flag_launches) == before
    assert all(torch.equal(x, y) for x, y in zip(again, ours))


def test_the_blend_thresholds_are_float32_sums():
    differ = [(name, k) for name in scenarios.scenario_names()
              for k, s in enumerate(scenarios.regime_flow_sets(scenarios.scenario_flow_params(name), 64))
              if flow.kind_thresholds(s, True) != flow.kind_thresholds(s, False)]
    assert differ, "no scenario's blend rounds its thresholds apart from the replay path's"
    thin = scenarios.scenario_flow_params("lob_thin")
    f32 = np.float32
    two = f32(f32(thin.p_noop) + f32(thin.p_add))
    assert flow.kind_thresholds(thin, True) == (f32(thin.p_noop), two, f32(two + f32(thin.p_cancel)))


def test_execute_bar_with_scen_flags_matches_jax():
    jax_env, torch_env, jstate, state, rows = _venue_case(8)
    flags = _flags(len(rows))
    assert set(scenarios.regime_kind(flags).tolist()) == {0, 1, 2, 3}
    d, jd = torch_env.data, jax_env.data
    t = jnp.asarray(rows, jnp.int32)

    def run(st, t1, f1):
        return jax_venue.execute_bar(st, jd.open[t1], jd.high[t1], jd.low[t1], jd.close[t1], t1,
                                     jax_env.cfg, jax_env.params, scen_flags=f1)

    with x64_off():
        ref = jax.jit(jax.vmap(run))(jstate, t, jnp.asarray(flags.numpy()))
    tr = torch.from_numpy(rows)
    ours = venue.execute_bar(state, d.open[tr], d.high[tr], d.low[tr], d.close[tr],
                             tr.to(torch.int32), torch_env.cfg, torch_env.params, flags)
    plain = venue.execute_bar(state, d.open[tr], d.high[tr], d.low[tr], d.close[tr],
                              tr.to(torch.int32), torch_env.cfg, torch_env.params)
    for name in ours._fields:
        if name in INT_FIELDS or name.startswith(("bracket", "pending", "pos")):
            assert_bitwise(getattr(ref, name), getattr(ours, name), name)
        else:
            np.testing.assert_allclose(to_np(getattr(ours, name)), to_np(getattr(ref, name)),
                                       rtol=1e-6, atol=1e-5, err_msg=name)
    # the flags changed the flow of some env
    assert not torch.equal(ours.pos, plain.pos) or not torch.equal(ours.cash_delta, plain.cash_delta)


@pytest.mark.parametrize("venue_name", ["bar", "lob"])
def test_env_on_the_scengen_feed_matches_jax(venue_name):
    # seed 190: the episode's first 30 bars cross a drought and a crash
    over = dict(GEN, scengen_preset="multi_asset_stress", scengen_bars=200, scengen_seed=190,
                **(dict(LOB, rollout_env_kernel="off") if venue_name == "lob" else {}))
    jcfg, tcfg = _configs(**over)
    with x64_off():
        jenv = JaxEnvironment(jcfg)
    tenv = Environment(tcfg, device="cpu")
    assert tenv.cfg.lob_flow_from_scengen == (venue_name == "lob") == jenv.cfg.lob_flow_from_scengen
    for name in tenv.data._fields:
        if name != "row0":
            assert_bitwise(getattr(jenv.data, name), getattr(tenv.data, name), name)
    if venue_name == "bar":
        return  # the bar venue reads the tape as a replayed one's
    # the LOB env blends each bar's flow by that bar's flags: its step is
    # execute_bar under data.scen_flags[t] (whose flag route equals the
    # JAX venue's: test_execute_bar_with_scen_flags_matches_jax)
    flags = to_np(tenv.data.scen_flags)
    steps = 30
    assert {0, 1, 2} <= set(((flags[:steps] >> 1) & 3).tolist()), "the episode misses a flag kind"
    state, _ = tenv.reset(1)
    seen = set()
    for t in range(steps):
        d, row = tenv.data, state.t + 1
        kind = int((d.scen_flags[row] >> 1) & 3)
        expected = venue.execute_bar(state._replace(t=row, last_trade_cost=torch.zeros_like(
            state.last_trade_cost)), d.open[row], d.high[row], d.low[row], d.close[row], row,
            tenv.cfg, tenv.params, d.scen_flags[row])
        state, *_ = tenv.step(state, torch.ones(1, dtype=torch.int32))
        for name in ("pos", "cash_delta", "bracket_sl", "bracket_tp", "trade_count"):
            assert_bitwise(getattr(expected, name), getattr(state, name), f"bar {t} {name}")
        seen.add(kind)
    assert {0, 1, 2} <= seen


def test_eval_split_cuts_one_generation_as_jax():
    jcfg, tcfg = _configs(**dict(GEN, eval_split=0.25, scengen_preset="liquidity_drought"))
    with x64_off():
        jtrain, jeval = jax_build_envs(jcfg)
    train, held = build_train_eval_envs(tcfg, device="cpu")
    assert (train.n_bars, held.n_bars) == (jtrain.n_bars, jeval.n_bars) == (300, 100)
    for ours, ref in ((train, jtrain), (held, jeval)):
        for name in ("close", "scen_flags", "calendar", "ev_spread_mult"):
            assert_bitwise(getattr(ref.data, name), getattr(ours.data, name), name)
    full = TF.ScenGenDataset(tcfg, device="cpu")
    assert np.array_equal(to_np(held.data.scen_flags), full.scen_flags[300:])
    with pytest.raises(ValueError, match="leaves too few bars"):
        build_train_eval_envs(dict(tcfg, eval_split=0.99), device="cpu")


@pytest.mark.parametrize("mode", ["off", "on"])
def test_curriculum_over_scengen_tapes_matches_jax(mode):
    over = dict(GEN, feed="curriculum", tapes="scengen:flash_crash@2,scengen:range_chop@1",
                data_compress=mode, curriculum_seed=4)
    jcfg, tcfg = _configs(**over)
    with x64_off():
        jenv = JaxEnvironment(jcfg)
    tenv = Environment(tcfg, device="cpu")
    picks = [tenv.curriculum.pick(i)[0] for i in range(10)]
    assert picks == [jenv.curriculum.pick(i)[0] for i in range(10)] and set(picks) == {0, 1}
    for i in range(2):
        ours, ref = tenv.curriculum._tape_data(i), jenv.curriculum._tape_data(i)
        for name in ours._fields:
            if name != "row0":
                assert_bitwise(getattr(ref, name), getattr(ours, name), f"tape {i} {name}")
    assert (tenv.curriculum.tape(1) is None) == (mode == "off")


def _portfolio_curriculum(tapes_value, **over):
    return _configs(**dict(GEN, feed="curriculum", tapes=tapes_value, scengen_bars=200,
                           scengen_pairs=PAIRS, curriculum_seed=3, **over))


def test_portfolio_curriculum_matches_jax():
    jcfg, tcfg = _portfolio_curriculum("scengen:multi_asset_stress,scengen:multi_asset_calm@2")
    with x64_off():
        jenv = JP.PortfolioEnvironment(jcfg)
    tenv = TP.PortfolioEnvironment(tcfg, device="cpu")
    assert tenv.pairs == jenv.pairs == json.loads(PAIRS) and tenv.n_bars == 200
    picks = [tenv.curriculum.pick(i)[0] for i in range(10)]
    assert picks == [jenv.curriculum.pick(i)[0] for i in range(10)] and set(picks) == {0, 1}
    for i in range(2):
        ours, ref = tenv.curriculum._tape_data(i), jenv.curriculum._tape_data(i)
        # snapped prices: an ulp apart before the snap can round a tick apart
        np.testing.assert_allclose(to_np(ours.close), np.asarray(ref.pair.close).T,
                                   rtol=PRICE_RTOL, atol=TICK, err_msg=f"tape {i}")
    assert tenv.curriculum._tape_data(0) is tenv.data


@pytest.mark.parametrize("tapes_value,match", [
    ("scengen:multi_asset_calm,file:x.csv", "a 'file:' tape is a single CSV"),
    ('["scengen:multi_asset_calm", {"scengen": "multi_asset_stress", "scengen_bars": 150}]',
     "same bar count"),
])
def test_portfolio_curriculum_refuses_as_jax(tapes_value, match):
    jcfg, tcfg = _portfolio_curriculum(tapes_value)
    with pytest.raises(ValueError, match=match):
        TP.PortfolioEnvironment(tcfg, device="cpu")
    with x64_off(), pytest.raises(ValueError, match=match):
        JP.PortfolioEnvironment(jcfg)
    with pytest.raises(ValueError, match="cannot be combined with eval_split"):
        TP.PortfolioEnvironment(tcfg, split=("train", 0.3), device="cpu")


def _step_books(jenv, tenv, books, steps, seed):
    """Both envs reset and stepped ``steps`` times with the same random
    actions on ``books`` books (JAX jitted and vmapped over the books);
    every output and state leaf compared."""
    rng = np.random.default_rng(seed)
    n_pairs = tenv.cfg.n_pairs
    with x64_off():
        js, jo = jax.vmap(lambda _: JP.reset(jenv.cfg, jenv.params, jenv.data))(jnp.arange(books))
        jstep = jax.jit(jax.vmap(lambda s, a: JP.step(jenv.cfg, jenv.params, jenv.data, s, a)))
        ts, to = tenv.reset(books)
        for k in jo:
            _assert_close(jo[k], to[k], f"reset obs {k}")
        for t in range(steps):
            a = rng.integers(0, 4, (books, n_pairs)).astype(np.int32)
            js, jo, jr, jd, _ = jstep(js, jnp.asarray(a))
            ts, to, tr, td, _ = tenv.step(ts, torch.from_numpy(a))
            _assert_close(jr, tr, f"step {t} reward")
            _assert_close(jd, td, f"step {t} done")
            for k in jo:
                _assert_close(jo[k], to[k], f"step {t} obs {k}")
            for f in js.pairs._fields:
                x = np.asarray(getattr(js.pairs, f))
                _assert_close(x.reshape(books * n_pairs, *x.shape[2:]), getattr(ts.pairs, f),
                              f"step {t} pairs {f}")
            for f in js.acct._fields:
                _assert_close(getattr(js.acct, f), getattr(ts.acct, f), f"step {t} acct {f}")
    return ts


def test_portfolio_on_a_generated_book_steps_as_jax(monkeypatch):
    jcfg, tcfg = _configs(**dict(GEN, scengen_preset="multi_asset_stress", scengen_bars=120,
                                 scengen_pairs=PAIRS, margin_rate=0.02, leverage=20.0))
    pairs, frames, flags = TF.synthesize_portfolio_frames(tcfg, device="cpu")

    def the_ports_frames(config):
        # the JAX env on the port's generated book (its own differs by ulps)
        return pairs, {p: pd.DataFrame(f.columns, index=pd.DatetimeIndex(
            f.timestamps, name="DATE_TIME")) for p, f in frames.items()}, flags

    monkeypatch.setattr(JF, "synthesize_portfolio_frames", the_ports_frames)
    with x64_off():
        jenv = JP.PortfolioEnvironment(jcfg)
    tenv = TP.PortfolioEnvironment(tcfg, device="cpu")
    assert tenv.pairs == jenv.pairs == pairs and tenv.n_bars == jenv.n_bars == 120
    assert_bitwise(jenv.data.conv, tenv.data.conv, "conv")
    n = tenv.n_bars
    for name in tenv.data.pair._fields:
        if name == "row0":
            continue
        ref = np.asarray(getattr(jenv.data.pair, name))  # (I, rows, ...)
        ours = to_np(getattr(tenv.data.pair, name)).reshape(len(pairs), tenv.data.stride,
                                                            *ref.shape[2:])
        assert_bitwise(ref, np.ascontiguousarray(ours[:, :ref.shape[1]]), name)
    assert_bitwise(np.asarray(jenv.data.pair.close).T, tenv.data.close[:n], "close")


def test_portfolio_lob_venue_steps_as_jax():
    """The JAX portfolio env reads no venue key of its own: its pairs step
    through ``core.env.step`` with the pair config's venue, the LOB venue
    here; the port's rows do the same."""
    files = {"EUR_USD": str(REPO / "examples/data/eurusd_sample.csv"),
             "GBP_USD": str(REPO / "examples/data/gbpusd_sample.csv")}
    jcfg, tcfg = _configs(**dict(LOB, portfolio_files=files, window_size=8, max_rows=40,
                                 rollout_env_kernel="off", position_size=4.0, lob_depth_levels=4,
                                 lob_seed_levels=4, lob_messages_per_bar=4))
    with x64_off():
        jenv = JP.PortfolioEnvironment(jcfg)
    tenv = TP.PortfolioEnvironment(tcfg, device="cpu")
    assert tenv.cfg.pair_cfg.venue == jenv.cfg.pair_cfg.venue == "lob"
    ts = _step_books(jenv, tenv, 1, 8, seed=4)
    assert bool((ts.pairs.trade_count > 0).any() or (ts.pairs.pos != 0).any())


def test_main_diagnostic_episode_on_the_scengen_feed_matches_jax(tmp_path):
    extra = ("--feed", "scengen", "--scengen_preset", "flash_crash", "--scengen_bars", "300",
             "--scengen_snap_to_tick", "--driver_mode", "buy_hold", "--steps", "120")
    with x64_off():
        ref = _json(jax_main(_argv(tmp_path, *extra)))
    ours = _json(main(_argv(tmp_path, *extra), device="cpu"))
    assert_results_match(ref, ours)
    assert ours["action_diagnostics"]["steps"] > 0
