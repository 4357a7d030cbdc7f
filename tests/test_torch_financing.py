"""FX rollover financing (gymfx_tpu_torch/data/financing.py and its
wiring in data/feed.py, core/runtime.py, core/portfolio.py) against the
JAX package's (gymfx_tpu/data/financing.py, which reads pandas).

* The rate table, ``rate_at`` and ``rollover_mask`` on the JAX package's
  own cases; the port's CSV reader against ``pd.read_csv``.
* ``precompute_rollover_accrual`` on generated tapes that cross several
  22:00 UTC rollovers and a month boundary, start before the table's
  first month and hold invalid timestamps: bitwise float64.
* The tape's ``rollover_accrual`` column from a financed config: bitwise
  in the compute dtype (float32), and the bar interval ``validate_profile_
  latency`` reads.
* The shipped financed example through ``main``, and a financed episode
  over a tape that crosses two rollovers and a month boundary: the
  summary against the JAX ``main``'s, floats within rtol 1e-6 / atol 1e-5
  (XLA:CPU contracts ``cash + pos * close * rate`` into an FMA in the
  jitted episode, ROADMAP Queue 3).
* The LOB venue with financing: a 16-level book's episode over hourly
  bars that cross three rollovers and a month boundary, the JAX
  package's jitted rollout against the port's (the venue's plain path
  adds the accrual after ``execute_bar``): every integer field, the
  position and the brackets BITWISE; the float ledger and the trace at
  rtol 1e-6 / atol 1e-5 (the same FMA contraction), and the held
  position's cash moves by the accrual on exactly the rollover bars.
* The portfolio with a profile per pair and financing: per-pair accrual
  columns and param columns, stepped against the JAX package's jitted
  step (the same tolerance).
"""
import dataclasses

import jax
import numpy as np
import pandas as pd
import pytest

from gymfx_tpu.app.main import main as jax_main
from gymfx_tpu.core import runtime as JR
from gymfx_tpu.data import financing as JF
from gymfx_tpu.data.feed import load_market_dataset as jax_load
from gymfx_tpu_torch.app.main import main
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core import runtime as TR
from gymfx_tpu_torch.data import financing as TF
from gymfx_tpu_torch.data.feed import load_market_dataset
from gymfx_tpu_torch.ops import cases

from test_torch_parity import x64_off

RATES = "examples/data/fx_rollover_rates_smoke.csv"
PESSIMISTIC = "examples/configs/execution_cost_profiles/pessimistic_v1.json"
RTOL, ATOL = 1e-6, 1e-5


def _timestamps(n, start, minutes=1, nat=()):
    ts = np.datetime64(start, "us") + np.arange(n) * np.timedelta64(minutes, "m")
    ts = ts.astype("datetime64[us]")
    for i in nat:
        ts[i] = np.datetime64("NaT")
    return ts


def _jax_series(ts):
    return pd.Series(pd.to_datetime(ts))


def test_rate_table_reader_matches_pandas():
    rows = TF.read_rate_table(RATES)
    assert TF.parse_rate_table(rows) == JF.parse_rate_table(pd.read_csv(RATES))


def test_rate_table_is_month_aware():
    rows = [{"LOCATION": "USA", "TIME": "2024-01", "Value": 4.0},
            {"LOCATION": "USA", "TIME": "2024-03", "Value": 5.0},
            {"LOCATION": "XXX", "TIME": "2024-03", "Value": 9.0},
            {"LOCATION": "USA", "TIME": "not a month", "Value": 9.0}]
    table = TF.parse_rate_table(rows)
    assert table == JF.parse_rate_table(pd.DataFrame(rows))
    for day, want in (("2024-01-15", 4.0), ("2024-02-15", 4.0), ("2024-03-15", 5.0),
                      ("2023-06-01", 4.0)):
        ns = int(np.datetime64(day, "ns").astype(np.int64))
        assert TF.rate_at(table, "USD", ns) == JF.rate_at(table, "USD", ns) == want
    assert TF.rate_at(table, "CHF", 0) == 0.0


def test_rollover_mask_fires_once_per_day():
    ts = np.array(["2024-03-05T21:59", "2024-03-05T22:00", "2024-03-05T22:01",
                   "2024-03-06T10:00", "2024-03-06T22:30", "2024-03-06T23:00"],
                  dtype="datetime64[us]")
    mask = TF.rollover_mask(ts)
    assert mask.tolist() == [False, True, False, False, True, False]
    assert mask.tolist() == JF.rollover_mask(_jax_series(ts)).tolist()


@pytest.mark.parametrize("start,minutes,n", [
    ("2023-12-28T00:00", 5, 12_000),   # before the table, over the month boundaries
    ("2024-01-30T20:03", 1, 4_000),    # Jan -> Feb, three rollovers
    ("2024-02-27T21:00", 7, 2_000),    # past the table's last month
])
@pytest.mark.parametrize("pair", ["EUR_USD", "USD_JPY", "GBP_USD", "EUR_CHF"])
def test_accrual_column_is_bitwise_the_jax_package_s(start, minutes, n, pair):
    ts = _timestamps(n, start, minutes, nat=(3, n // 2))
    base, quote = TF.split_pair(pair)
    ours = TF.precompute_rollover_accrual(ts, TF.read_rate_table(RATES), base, quote)
    want = JF.precompute_rollover_accrual(_jax_series(ts), pd.read_csv(RATES), base, quote)
    assert ours.dtype == want.dtype == np.float64
    assert ours.tobytes() == want.tobytes()
    if pair != "EUR_CHF":
        assert np.count_nonzero(ours) >= 2
    assert TF.split_pair(pair) == JF.split_pair(pair)


def test_split_pair_errors_match():
    for bad in ("EURUSDX", "EU/USD"):
        with pytest.raises(ValueError) as want:
            JF.split_pair(bad)
        with pytest.raises(ValueError) as ours:
            TF.split_pair(bad)
        assert str(ours.value) == str(want.value)


def _tape(tmp_path, n, start, name="tape.csv", level=1.10, tick=1e-5, seed=0, minutes=1):
    """A generated tape of ``n`` bars ``minutes`` apart on the trading
    week's grid, written as a CSV: its path."""
    path = tmp_path / name
    cases.write_bar_csv(path, cases.tick_walk_columns(n, seed=seed, level=level, tick=tick),
                        cases.m1_week_grid(n * minutes, start=start)[::minutes])
    return str(path)


def test_tape_accrual_column_and_bar_interval_match(tmp_path):
    # rollovers on Jan 31 and Feb 1 at 22:00: bars 24 and 312
    config = dict(DEFAULT_VALUES, input_data_file=_tape(tmp_path, 400, "2024-01-31T20:00",
                                                        minutes=5))
    host = load_market_dataset(config).build_market_data(
        window_size=32, device=None, financing_rate_data=TF.read_rate_table(RATES),
        instrument="EUR_USD")
    with x64_off():
        jds = jax_load(config)
        jhost = jds.build_market_data(window_size=32, device=False,
                                      financing_rate_data=pd.read_csv(RATES), instrument="EUR_USD")
    ours, want = np.asarray(host.rollover_accrual), np.asarray(jhost.rollover_accrual)
    assert ours.dtype == want.dtype == np.float32 and ours.tobytes() == want.tobytes()
    assert np.flatnonzero(ours).tolist() == [24, 312] and ours[24] != ours[312]
    # the timeframe label when there is one, else the timestamps' median spacing
    assert load_market_dataset(config).bar_interval_ms() == jds.bar_interval_ms() == 60_000.0
    config["timeframe"] = None
    assert load_market_dataset(config).bar_interval_ms() == jax_load(config).bar_interval_ms() \
        == 300_000.0


@pytest.mark.parametrize("latency,ok", [(60_000, True), (60_001, False)])
def test_profile_latency_is_honored_or_rejected_alike(tmp_path, latency, ok):
    raw = dict(TF_PROFILE, latency_ms=latency, financing_enabled=False)
    config = dict(DEFAULT_VALUES, input_data_file=_tape(tmp_path, 200, "2024-01-02T00:00"),
                  execution_cost_profile=raw)
    if ok:
        TR.Environment(config, device="cpu")
        return
    with pytest.raises(ValueError) as ours:
        TR.Environment(config, device="cpu")
    with x64_off(), pytest.raises(ValueError) as want:
        JR.Environment(config)
    assert str(ours.value) == str(want.value)


TF_PROFILE = {
    "schema_version": "execution_cost_profile.v1", "profile_id": "t",
    "commission_rate_per_side": 0.0, "full_spread_rate": 0.0, "slippage_bps_per_side": 0.0,
    "latency_ms": 0, "financing_enabled": True, "intrabar_collision_policy": "worst_case",
    "limit_fill_policy": "cross", "margin_model": "leveraged",
    "enforce_margin_preflight": False, "random_seed": 0,
}


def test_financing_without_a_rate_file_raises_the_jax_error():
    config = dict(DEFAULT_VALUES, input_data_file="examples/data/eurusd_sample.csv",
                  financing_enabled=True)
    with pytest.raises(ValueError) as ours:
        TR.Environment(config, device="cpu")
    with x64_off(), pytest.raises(ValueError) as want:
        JR.Environment(config)
    assert str(ours.value) == str(want.value)


def _assert_summaries_match(ours, want):
    assert sorted(ours) == sorted(want)
    for key in want:
        a, b = ours[key], want[key]
        if isinstance(b, float) and isinstance(a, float):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=key)
        elif isinstance(b, dict):
            _assert_summaries_match(a, b)
        else:
            assert a == b, key


@pytest.mark.parametrize("tape", [False, True], ids=["shipped", "two-rollovers"])
def test_financed_episode_summary_matches_jax(tmp_path, tape):
    argv = ["--load_config", "examples/configs/inference_financed_profile.json",
            "--results_file", str(tmp_path / "r.json"), "--save_config",
            str(tmp_path / "c.json"), "--quiet_mode"]
    if tape:
        # 5-minute bars over the Jan 31 and Feb 1 rollovers (two months' rates)
        argv += ["--input_data_file", _tape(tmp_path, 400, "2024-01-31T20:00", minutes=5),
                 "--steps", "399"]
    ours = main(argv, device="cpu")
    with x64_off():
        want = jax_main(argv)
    _assert_summaries_match(ours, want)
    if tape:
        # the two rollovers moved the held position's cash: without the
        # rate table's accrual the final equity differs
        plain = main(argv + ["--financing_enabled", "false"], device="cpu")
        assert abs(plain["final_equity"] - ours["final_equity"]) > 0.05


def test_lob_venue_financed_episode_matches_jax():
    """The LOB venue with financing: hourly bars from Jan 31 18:00 put
    rollovers at bars 4, 28 and 52 (Jan 31, Feb 1, Feb 2: two months'
    rates), and a long position is held through them."""
    import jax.numpy as jnp
    import torch

    from gymfx_tpu.core import rollout as JRO
    from gymfx_tpu_torch.core import rollout as TRO

    from test_torch_lob_venue import LOB, _grid_columns
    from test_torch_parity import assert_bitwise, paired_envs, to_np

    steps = 58
    over = dict(LOB, lob_messages_per_bar=8, window_size=8, financing_enabled=True,
                financing_rate_data_file=RATES, take_profit_pips=500.0, stop_loss_pips=500.0)
    jax_env, torch_env = paired_envs(_grid_columns(60, 5), start="2024-01-31T18:00",
                                     freq="1h", **over)
    acc = to_np(torch_env.data.rollover_accrual)
    assert np.flatnonzero(acc).tolist() == [4, 28, 52] and acc[4] != acc[28]
    assert_bitwise(jax_env.data.rollover_accrual, torch_env.data.rollover_accrual, "accrual")
    actions = np.ones(steps, np.int32)
    state, trace = torch_env.rollout(TRO.replay_driver(actions, "cpu"), steps)
    with x64_off():
        jstate, jtrace = jax_env.rollout(JRO.replay_driver(jnp.asarray(actions)), steps)
    for name in state._fields:
        ref, ours = getattr(jstate, name), getattr(state, name)[0]
        if ours.dtype in (torch.int32, torch.bool) or name.startswith(("bracket", "pending",
                                                                        "pos")):
            assert_bitwise(ref, ours, name)
        else:
            np.testing.assert_allclose(to_np(ours), to_np(ref), rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    for key in jtrace:
        np.testing.assert_allclose(to_np(trace[key])[:, 0], np.asarray(jtrace[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    # against the same episode without financing, the equity steps by
    # pos * close * accrual on the rollover bars and on no other bar (a
    # step's float32 ledger noise is ~4e-6 at these notionals)
    bar = to_np(trace["bar_index"])[:, 0].astype(np.int64) - 1
    pos = to_np(trace["pos_units"])[:, 0].astype(np.float64)
    close = to_np(torch_env.data.close).astype(np.float64)
    accrued = pos * close[bar] * acc[bar]
    plain_env = paired_envs(_grid_columns(60, 5), start="2024-01-31T18:00", freq="1h",
                            **dict(over, financing_enabled=False))[1]
    _, plain = plain_env.rollout(TRO.replay_driver(actions, "cpu"), steps)
    assert_bitwise(plain["pos_units"], trace["pos_units"], "pos_units without financing")
    gap = (to_np(trace["equity_delta"]) - to_np(plain["equity_delta"]))[:, 0].astype(np.float64)
    jumps = np.diff(gap, prepend=0.0)
    assert np.flatnonzero(np.abs(jumps) > 1e-4).tolist() == np.flatnonzero(accrued).tolist()
    assert np.count_nonzero(accrued) == 3 and np.abs(accrued[accrued != 0]).min() > 5e-4
    np.testing.assert_allclose(jumps, accrued, rtol=0, atol=2e-5)


def test_portfolio_with_a_profile_per_pair_and_financing_steps_as_jax(tmp_path):
    """Three pair tapes that cross a rollover at their 21st bar, each pair
    with its own profile (commission and spread differ, the static policy
    agrees): each pair's tape holds its own accrual column, the differing
    params are per-pair columns, and 22 steps of 3 books meet the JAX
    package's jitted step within rtol 1e-6 / atol 1e-5 (every leaf)."""
    import test_torch_portfolio as TPT

    files = {pair: _tape(tmp_path, 80, "2024-01-31T21:40", f"{pair}.csv", level, tick, i)
             for i, (pair, level, tick) in enumerate((("EUR_USD", 1.10, 1e-5),
                                                      ("GBP_USD", 1.27, 1e-5),
                                                      ("USD_JPY", 148.0, 1e-3)))}
    pess = TF_PROFILE | {"profile_id": "p", "commission_rate_per_side": 2e-4,
                         "full_spread_rate": 4e-4, "slippage_bps_per_side": 2.0}
    over = dict(portfolio_files=files, financing_rate_data_file=RATES, timeframe="M1",
                portfolio_profiles={"EUR_USD": pess,
                                    "GBP_USD": dict(pess, commission_rate_per_side=1e-4),
                                    "USD_JPY": dict(pess, full_spread_rate=6e-4)})
    _, tenv = TPT._envs(over)
    stride = tenv.data.stride
    acc = tenv.data.pair.rollover_accrual.numpy().reshape(3, stride)
    assert [np.flatnonzero(a).tolist() for a in acc] == [[20]] * 3
    assert len({float(a[20]) for a in acc}) == 3
    per_row = sorted(k for k in ("commission", "slippage")
                     if len(set(getattr(tenv.params.pair, k).tolist())) > 1)
    assert per_row == ["commission", "slippage"]
    assert tenv.cfg.pair_cfg.financing_enabled
    TPT._run(over, 22, op_by_op=False)


def test_portfolio_profiles_must_agree_on_static_fields():
    from gymfx_tpu.core.portfolio import PortfolioEnvironment as JPE
    from gymfx_tpu_torch.core.portfolio import PortfolioEnvironment as TPE

    a = TFP(TF_PROFILE)
    b = TFP(dict(TF_PROFILE, margin_model="standard"))
    with pytest.raises(ValueError) as want:
        JPE._check_static_profile_agreement([a, b])
    with pytest.raises(ValueError) as ours:
        TPE._check_static_profile_agreement([a, b])
    assert str(ours.value).split(" (")[0] == str(want.value).split(" (")[0]
    assert "margin_model" in str(ours.value)


def TFP(raw):
    """A port profile from a raw dict."""
    from gymfx_tpu_torch.contracts import ExecutionCostProfile

    return ExecutionCostProfile.from_dict(raw)


def test_profiles_dataclass_fields_are_the_jax_package_s():
    from gymfx_tpu.contracts import ExecutionCostProfile as J

    assert [f.name for f in dataclasses.fields(TFP(TF_PROFILE))] == \
        [f.name for f in dataclasses.fields(J)]
