"""The multi-pair portfolio env (gymfx_tpu_torch/core/portfolio.py) against
the JAX package's (gymfx_tpu/core/portfolio.py).

Small sizes: the three sample pairs (EUR_USD, GBP_USD, USD_JPY) cut to
their first 60 rows, window 8, three books stepped at once (nine pair
rows), actions drawn from a seed with numpy.

Ledgers stay of small notional (a few units a pair), so that the
jitted reference's fused multiply-adds stay within the stated atol.

* ``load_portfolio_frames``: the aligned frames equal the JAX package's
  pandas inner join (timestamps and every column, BITWISE) on the sample
  files and on files with gaps, a duplicate-free shuffle of shared
  timestamps and an unparseable timestamp.
* ``build_conversion_factors``: BITWISE (float64 numpy on both sides),
  USD_JPY's inverse and a cross bridged through another pair included.
* reset and 30 steps against ``gymfx_tpu.core.portfolio.reset/step``
  vmapped over the books: obs, reward, done, info and every state leaf
  BITWISE against the op-by-op JAX step (``jax.disable_jit``) for the
  margin account with distinct per-pair overrides (8 steps: the op-by-op
  reference costs ~1 s a step); against the jitted step within rtol 1e-6
  / atol 1e-5 (XLA contracts ``a ± b*c`` and may reorder the pair sums
  inside jit, ROADMAP.md Queue 3) for margin on and off, the realized-pnl
  sweep on and off, a book whose preflight denies orders and one that
  goes bankrupt (each asserted to happen), and OHLCV feature columns,
  whose window K1 computes over the pair rows.
* The rows' params: a param on which the pairs differ is an (R,) column,
  one they share stays 0-d (the two forms K2 and K3 take).
* The rejections of the JAX package (same messages), a portfolio tape
  library's and a generated book's among them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.core import portfolio as JP
from gymfx_tpu.train.common import build_portfolio_train_eval_envs as jax_build_envs

from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core import portfolio as TP
from gymfx_tpu_torch.core.types import EnvParams
from gymfx_tpu_torch.train.common import build_portfolio_train_eval_envs

from test_torch_parity import assert_bitwise, to_np, x64_off

FILES = {"EUR_USD": "examples/data/eurusd_sample.csv",
         "GBP_USD": "examples/data/gbpusd_sample.csv",
         "USD_JPY": "examples/data/usdjpy_sample.csv"}
BOOKS, STEPS = 3, 30
OVERRIDES = {"GBP_USD": {"commission": 1e-4}, "USD_JPY": {"slippage": 2e-4}}
BASE = dict(portfolio_files=FILES, window_size=8, max_rows=60)
CASES = {
    "margin": dict(margin_rate=0.02, leverage=20.0, portfolio_param_overrides=OVERRIDES),
    "margin_sweep": dict(margin_rate=0.02, leverage=20.0, sweep_realized_pnl=True,
                         portfolio_param_overrides=OVERRIDES),
    "no_margin": dict(portfolio_position_sizes=[3.0, 7.0, 0.5]),
    # margin 0.2 at leverage 0.00035: the greedy preflight grants
    # EUR_USD's ~5,000 of the 10,000, denies GBP_USD's ~5,800 and grants
    # USD_JPY's 57 after it
    "denied": dict(margin_rate=0.2, leverage=0.00035, sweep_realized_pnl=True,
                   portfolio_position_sizes=[8.0, 8.0, 0.1]),
    # a book whose first fill's commission takes it under min_equity
    "bankrupt": dict(portfolio_position_sizes=[10.0, 10.0, 0.1], commission=2e-4,
                     min_equity=9999.998),
    "features": dict(feature_columns=["OPEN", "HIGH", "LOW", "CLOSE", "VOLUME"],
                     margin_rate=0.02, leverage=20.0),
}


def _configs(over):
    return {**JAX_DEFAULTS, **BASE, **over}, {**DEFAULT_VALUES, **BASE, **over}


def _envs(over):
    jcfg, tcfg = _configs(over)
    with x64_off():
        jenv = JP.PortfolioEnvironment(jcfg)
    return jenv, TP.PortfolioEnvironment(tcfg, device="cpu")


def _assert_close(a, b, label):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, f"{label}: shape {a.shape} != {b.shape}"
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5, err_msg=label)
    else:
        np.testing.assert_array_equal(b, a, err_msg=label)


def _compare(jout, tout, check, label):
    js, jo, jr, jd, ji = jout
    ts, to, tr, td, ti = tout
    assert sorted(jo) == sorted(to), label
    for k in jo:
        check(jo[k], to[k], f"{label} obs {k}")
    check(jr, tr, f"{label} reward")
    check(jd, td, f"{label} done")
    if ji is not None:
        assert sorted(ji) == sorted(ti), label
        for k in ji:
            check(ji[k], ti[k], f"{label} info {k}")
    for f in js.acct._fields:
        check(getattr(js.acct, f), getattr(ts.acct, f), f"{label} acct {f}")
    for f in js.pairs._fields:
        x = np.asarray(getattr(js.pairs, f))
        check(x.reshape(BOOKS * x.shape[1], *x.shape[2:]), getattr(ts.pairs, f),
              f"{label} pairs {f}")
    check(js.swept_realized, ts.swept_realized, f"{label} swept_realized")
    check(js.prev_realized_q, ts.prev_realized_q, f"{label} prev_realized_q")


def _run(over, steps, *, op_by_op, seed=0):
    jenv, tenv = _envs(over)
    n_pairs = tenv.cfg.n_pairs
    check = assert_bitwise if op_by_op else _assert_close
    rng = np.random.default_rng(seed)
    with x64_off():
        js, jo = jax.vmap(lambda _: JP.reset(jenv.cfg, jenv.params, jenv.data))(jnp.arange(BOOKS))
        jstep = jax.vmap(lambda s, a: JP.step(jenv.cfg, jenv.params, jenv.data, s, a))
        if not op_by_op:
            jstep = jax.jit(jstep)
        ts, to = tenv.reset(BOOKS)
        for k in jo:
            check(jo[k], to[k], f"reset obs {k}")
        infos = []
        for t in range(steps):
            a = rng.integers(0, 4, (BOOKS, n_pairs)).astype(np.int32)
            if op_by_op:
                with jax.disable_jit():
                    jout = jstep(js, jnp.asarray(a))
            else:
                jout = jstep(js, jnp.asarray(a))
            tout = tenv.step(ts, torch.from_numpy(a))
            _compare(jout, tout, check, f"step {t}")
            js, ts = jout[0], tout[0]
            infos.append(tout[4])
    return tenv, ts, infos


def test_reset_and_steps_bitwise_against_the_op_by_op_jax_step():
    _run(CASES["margin"], 8, op_by_op=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reset_and_steps_match_the_jitted_jax_step(case):
    tenv, ts, infos = _run(CASES[case], STEPS, op_by_op=False, seed=1)
    if case == "denied":
        assert int(infos[-1]["blocked_margin"].sum()) > 0
        assert int(ts.pairs.exec_diag[:, 14].sum()) > 0  # preflight_denied
    if case == "bankrupt":
        assert bool((ts.acct.termination_reason == 1).any())
    if case == "features":
        assert tenv.cfg.pair_cfg.n_features == 5
    if case == "margin_sweep":
        assert bool((ts.swept_realized != 0).any())


def test_row_params_are_columns_only_where_the_pairs_differ():
    tenv = TP.PortfolioEnvironment(_configs(CASES["margin"])[1], device="cpu")
    params, data = tenv.rows(2)
    p = params.pair
    commission = [1e-4 if i % 3 == 1 else 0.0 for i in range(6)]
    assert p.commission.shape == (6,)
    assert torch.equal(p.commission, torch.tensor(commission, dtype=torch.float32))
    assert p.slippage.shape == (6,) and float(p.slippage[2]) == np.float32(2e-4)
    assert p.initial_cash.dim() == 0 and p.price_tick.dim() == 0
    assert data.pair.row0.tolist() == [-(i % 3) * data.stride for i in range(6)]
    assert tenv.rows(2) is tenv.rows(2) or tenv.rows(2)[0] is params
    assert all(isinstance(x, torch.Tensor) for x in EnvParams(*p))


def test_load_portfolio_frames_matches_the_pandas_join(tmp_path):
    pairs, aligned = TP.load_portfolio_frames(dict(FILES))
    jpairs, jaligned = JP.load_portfolio_frames(dict(FILES))
    assert pairs == jpairs

    def same(port, ref):
        assert len(port) == len(ref)
        np.testing.assert_array_equal(port.timestamps, ref.index.values.astype("datetime64[us]"))
        for col in ref.columns:
            assert_bitwise(ref[col].to_numpy(np.float64), port.columns[col], col)

    for p in pairs:
        same(aligned[p], jaligned[p])
    # gaps, a shifted start and a bad timestamp on one side
    rng = np.random.default_rng(0)
    stamps = pd.date_range("2024-01-01", periods=40, freq="min")
    paths = {}
    for name, drop in (("A_USD", {3, 4, 17}), ("B_USD", {0, 9, 30, 31})):
        keep = [i for i in range(40) if i not in drop]
        text = ["DATE_TIME,OPEN,HIGH,LOW,CLOSE"]
        for i in keep:
            c = 1 + rng.normal(0, 1e-3)
            stamp = "not a time" if (name == "B_USD" and i == 12) else str(stamps[i])
            # five decimals, as the sample files: pandas' C parser is
            # not correctly rounded at 17 significant digits
            text.append(f"{stamp},{c:.5f},{c + 1e-4:.5f},{c - 1e-4:.5f},{c:.5f}")
        paths[name] = tmp_path / f"{name}.csv"
        paths[name].write_text("\n".join(text) + "\n")
    files = {k: str(v) for k, v in paths.items()}
    pairs, aligned = TP.load_portfolio_frames(files)
    _, jaligned = JP.load_portfolio_frames(files)
    assert len(aligned["A_USD"]) == 40 - 3 - 4 - 1
    for p in pairs:
        same(aligned[p], jaligned[p])
    # a price_column backfill and max_rows
    pairs, aligned = TP.load_portfolio_frames(files, price_column="OPEN", max_rows=25)
    _, jaligned = JP.load_portfolio_frames(files, price_column="OPEN", max_rows=25)
    for p in pairs:
        same(aligned[p], jaligned[p])


def test_conversion_factors_match_including_inverse_and_bridge():
    rng = np.random.default_rng(2)
    closes = np.abs(rng.normal(1.2, 0.1, (7, 4)))
    closes[:, 2] *= 120
    for pairs in (["EUR_USD", "GBP_USD", "USD_JPY", "EUR_GBP"],
                  ["EUR/USD", "USD_JPY", "GBP_USD", "GBP_JPY"],
                  ["AUD_USD", "USD_CAD", "USD_JPY", "CAD_JPY"]):
        assert_bitwise(JP.build_conversion_factors(pairs, closes),
                       TP.build_conversion_factors(pairs, closes), str(pairs))
    assert_bitwise(JP.build_conversion_factors(["EUR_GBP", "USD_GBP"], closes[:, :2], "GBP"),
                   TP.build_conversion_factors(["EUR_GBP", "USD_GBP"], closes[:, :2], "GBP"))
    with pytest.raises(ValueError, match="no bridging pair"):
        TP.build_conversion_factors(["EUR_GBP", "USD_JPY"], closes[:, :2])


def test_split_cuts_the_aligned_bars_as_the_jax_package():
    over = dict(max_rows=None, eval_split=0.3)
    jcfg, tcfg = _configs(over)
    with x64_off():
        jtrain, jeval = jax_build_envs(jcfg)
    ttrain, teval = build_portfolio_train_eval_envs(tcfg, device="cpu")
    assert (ttrain.n_bars, teval.n_bars) == (jtrain.n_bars, jeval.n_bars)
    np.testing.assert_array_equal(teval.timestamps,
                                  np.asarray(jeval.timestamps.values, "datetime64[us]"))
    assert_bitwise(jeval.data.conv, teval.data.conv, "eval conv")
    assert_bitwise(np.asarray(jeval.data.pair.close).T, teval.data.close, "eval close")


@pytest.mark.parametrize("over,error,match", [
    (dict(data_compress="on"), ValueError, "no compressed form"),
    (dict(eval_data_file="x.csv"), ValueError, "eval_data_file is single-pair only"),
    (dict(eval_split=0.3, eval_portfolio_files=FILES), ValueError, "not both"),
    (dict(portfolio_profiles={p: {"name": "x"} for p in FILES}), ValueError,
     "execution cost profile missing fields"),
    # the portfolio's tape library (item 12) and generated books (item 14)
    (dict(feed="curriculum", tapes="scengen:multi_asset_calm,file:x.csv", scengen_bars=100),
     ValueError, "a 'file:' tape is a single CSV"),
    (dict(feed="scengen", scengen_pairs="not json"), ValueError, "scengen_pairs must be a JSON"),
    (dict(portfolio_files=None), ValueError, "requires config\\['portfolio_files'\\]"),
    (dict(eval_split=0.99), ValueError, "leaves too few aligned bars"),
])
def test_the_port_rejects_what_the_jax_package_rejects(over, error, match):
    jcfg, tcfg = _configs({"max_rows": None, **over})
    with pytest.raises(error, match=match):
        build_portfolio_train_eval_envs(tcfg, device="cpu")
    if error is ValueError:
        with x64_off(), pytest.raises(ValueError, match=match):
            jax_build_envs(jcfg)


def test_partial_profiles_are_refused_with_the_jax_message():
    """A profile bound to some pairs only (and no shared one) is refused
    with the JAX package's message (its check, :740-760, after the
    profile's parse)."""
    profile = "examples/configs/execution_cost_profiles/legacy_v1.json"
    jcfg, tcfg = _configs({"portfolio_profiles": {"EUR_USD": profile}})
    with pytest.raises(ValueError, match="must cover every pair .or bind one shared"):
        build_portfolio_train_eval_envs(tcfg, device="cpu")
    with x64_off(), pytest.raises(ValueError, match="must cover every pair .or bind one shared"):
        jax_build_envs(jcfg)
    with pytest.raises(ValueError, match="must cover every pair"):
        JP.PortfolioEnvironment._check_static_profile_agreement([object(), None, None])


def test_eval_portfolio_files_must_list_the_same_pairs():
    swapped = {"GBP_USD": FILES["GBP_USD"], "EUR_USD": FILES["EUR_USD"],
               "USD_JPY": FILES["USD_JPY"]}
    tcfg = _configs(dict(eval_portfolio_files=swapped))[1]
    with pytest.raises(ValueError, match="same pairs in the same order"):
        build_portfolio_train_eval_envs(tcfg, device="cpu")
    train, held = build_portfolio_train_eval_envs(dict(tcfg, eval_portfolio_files=dict(FILES)),
                                                  device="cpu")
    assert held.pairs == train.pairs and held.n_bars == train.n_bars
