"""The replay engine and the execution cross-checks (gymfx_tpu_torch/
simulation/, lob/oracle.py) against the JAX package's (gymfx_tpu/
simulation/, gymfx_tpu/lob/oracle.py).

* ``ReplayAdapter.run`` on every hand-built fixture under several
  profiles (latency, financing with the fixture's rates, fill
  probabilities, the slippage switches, a margin closeout): the whole
  result (every event, the summary, ``stable_hash``'s event and result
  hashes) equal to the JAX package's: bitwise float64, tolerance 0.
  ``reconcile_fills`` and ``export_execution_reports`` on those results
  equal too.
* ``crosscheck_episode`` on the same explicit action stream: the replay
  side (its balance, fills and result hash) equal to the JAX package's;
  the scan side's realized balance within rtol 1e-6 / atol 1e-5 (XLA:CPU
  contracts the ledger's ``a ± b * c`` into FMAs in the jitted episode,
  ROADMAP Queue 3), the divergence within that tolerance in money, and
  every count equal.
* ``main`` with ``verify_execution`` on a replayed action file: the
  ``execution_crosscheck`` summary as above, and a skip recorded for a
  configuration the check cannot take (financing).
* ``crosscheck_lob_episode`` on one small LOB case: the oracle side
  equal, the scan side within the same tolerance; the pure-Python book
  twin (``replay_messages``) equal to the JAX package's on seeded
  streams.
"""
import dataclasses
import json

import jax
import numpy as np
import pandas as pd
import pytest

from gymfx_tpu.app.main import main as jax_main
from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.lob import oracle as JO
from gymfx_tpu.simulation import crosscheck as JX
from gymfx_tpu.simulation import fixtures as JFX
from gymfx_tpu.simulation import replay as JRP
from gymfx_tpu.simulation.oracle import reconcile_fills as jax_reconcile
from gymfx_tpu.simulation.reports import export_execution_reports as jax_reports
from gymfx_tpu_torch.app.main import main
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.lob import oracle as TO
from gymfx_tpu_torch.simulation import crosscheck as TX
from gymfx_tpu_torch.simulation import fixtures as TFX
from gymfx_tpu_torch.simulation import replay as TRP
from gymfx_tpu_torch.simulation.oracle import reconcile_fills
from gymfx_tpu_torch.simulation.reports import export_execution_reports

from test_torch_parity import x64_off

CSV = "examples/data/eurusd_sample.csv"
RTOL, ATOL = 1e-6, 1e-5
PROFILE = {
    "schema_version": "execution_cost_profile.v1", "profile_id": "crosscheck-test",
    "commission_rate_per_side": 0.00002, "full_spread_rate": 0.0001,
    "slippage_bps_per_side": 0.2, "latency_ms": 0, "financing_enabled": False,
    "intrabar_collision_policy": "worst_case", "limit_fill_policy": "conservative",
    "margin_model": "leveraged", "enforce_margin_preflight": False, "random_seed": 0,
}

FIXTURES = {
    "multi_asset": ({}, {}),
    "intrabar_collision": ({}, {}),
    "margin_rejection": ({}, {}),
    "financing": ({"financing_enabled": True}, {}),
    "limit_policy": ({"full_spread_rate": 0.0, "slippage_bps_per_side": 0.0,
                      "limit_fill_policy": "touch"}, {"exact_touch": True}),
    "latency": ({"latency_ms": 60_000}, {}),
    "margin_closeout": ({"margin_model": "leveraged"}, {}),
}
RUN_OPTIONS = [
    {},
    {"slip_open": False, "slip_limit": True, "slip_match": True},
    {"prob": (0.5, 0.7, 0.3)},
]


def _fixture(module, name, kwargs):
    return getattr(module, f"build_{name}_fixture")(**kwargs)


@pytest.mark.parametrize("options", RUN_OPTIONS, ids=["default", "switches", "probabilities"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_replay_engine_is_the_jax_package_s(name, options):
    over, kwargs = FIXTURES[name]
    options = dict(options)
    limit_p, stop_p, slip_p = options.pop("prob", (1.0, 1.0, 0.0))
    runs = {}
    for side, mod, engine, rates in (("ours", TFX, TRP, TFX.build_rollover_rate_fixture()),
                                     ("want", JFX, JRP, JFX.build_rollover_rate_fixture())):
        specs, frames, actions = _fixture(mod, name, kwargs)
        profile = mod.default_profile(**over)
        runs[side] = (specs, profile, engine.ReplayAdapter(
            profile, prob_fill_on_limit=limit_p, prob_fill_on_stop=stop_p,
            prob_slippage=slip_p,
        ).run(instrument_specs=specs, frames=frames, actions=actions,
              initial_cash=1_000.0 if name == "margin_closeout" else 100_000.0,
              financing_rate_data=rates if over.get("financing_enabled") else None,
              **options))
    (specs, profile, ours), (jspecs, jprofile, want) = runs["ours"], runs["want"]
    assert json.dumps(ours, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert TRP.stable_hash(ours["events"]) == JRP.stable_hash(want["events"])
    assert TRP.ENGINE_VERSION == JRP.ENGINE_VERSION
    if name == "financing":
        assert any(e["event_type"] == "financing_applied" for e in ours["events"])
    assert reconcile_fills(ours, specs, profile, initial_cash=100_000.0) == \
        jax_reconcile(want, jspecs, jprofile, initial_cash=100_000.0)
    if name == "multi_asset":
        assert export_execution_reports(ours, specs, profile) == \
            jax_reports(want, jspecs, jprofile)


def test_fixtures_are_the_jax_package_s():
    for name, (_, kwargs) in FIXTURES.items():
        ours, want = _fixture(TFX, name, kwargs), _fixture(JFX, name, kwargs)
        assert [[dataclasses.asdict(x) for x in part] for part in ours] == \
            [[dataclasses.asdict(x) for x in part] for part in want], name
    assert TFX.build_rollover_rate_fixture() == \
        JFX.build_rollover_rate_fixture().to_dict("records")
    assert dataclasses.asdict(TFX.default_profile()) == dataclasses.asdict(JFX.default_profile())


def _config(**over):
    base = dict(input_data_file=CSV, position_size=1000.0)
    return {**JAX_DEFAULTS, **base, **over}, {**DEFAULT_VALUES, **base, **over}


def _assert_crosschecks_match(ours, want):
    assert sorted(ours) == sorted(want)
    for key in ("replay_final_balance", "replay_result_hash", "replay_fills",
                "replay_pending_unexecuted", "actions_submitted", "scan_trades", "steps",
                "instrument", "schema", "profile_id", "latency_ms", "within_bound"):
        assert ours[key] == want[key], key
    for key in ("scan_realized_balance", "quantization_bound"):
        np.testing.assert_allclose(ours[key], want[key], rtol=RTOL, atol=ATOL, err_msg=key)
    # the divergence inherits the scan balance's tolerance, in money
    scan_tol = RTOL * abs(want["scan_realized_balance"]) + ATOL
    assert abs(ours["divergence"] - want["divergence"]) <= scan_tol


@pytest.mark.parametrize("over", [
    {},
    {"execution_cost_profile": PROFILE},
    {"execution_cost_profile": PROFILE, "venue_quantization": True},
    {"strategy_plugin": "direct_fixed_sltp", "sl_pips": 10.0, "tp_pips": 20.0,
     "execution_cost_profile": PROFILE},
], ids=["frictionless", "costed", "quantized", "fixed-brackets"])
def test_crosscheck_episode_on_one_action_stream_matches(over):
    jcfg, tcfg = _config(**over)
    actions = np.random.default_rng(5).integers(0, 3, 250).tolist()
    ours = TX.crosscheck_episode(tcfg, actions, seed=3, device="cpu")
    with x64_off():
        want = JX.crosscheck_episode(jcfg, actions, seed=3)
    _assert_crosschecks_match(ours, want)
    assert ours["replay_fills"] > 20 and ours["within_bound"]


def test_verify_execution_through_main_matches(tmp_path):
    actions = tmp_path / "actions.csv"
    actions.write_text("action\n" + "\n".join(
        str(a) for a in np.random.default_rng(9).integers(0, 3, 200)) + "\n")
    argv = ["--input_data_file", CSV, "--driver_mode", "replay", "--replay_actions_file",
            str(actions), "--steps", "200", "--position_size", "1000", "--verify_execution",
            "true", "--results_file", str(tmp_path / "r.json"), "--save_config",
            str(tmp_path / "c.json"), "--quiet_mode"]
    ours = main(argv, device="cpu")["execution_crosscheck"]
    with x64_off():
        want = jax_main(argv)["execution_crosscheck"]
    _assert_crosschecks_match(ours, want)
    # financing is outside the check: a skip, never an abort
    fin = argv + ["--financing_enabled", "true", "--financing_rate_data_file",
                  "examples/data/fx_rollover_rates_smoke.csv"]
    ours = main(fin, device="cpu")["execution_crosscheck"]
    with x64_off():
        want = jax_main(fin)["execution_crosscheck"]
    assert ours == want and ours["status"] == "skipped"


def test_crosscheck_rejects_the_wrong_venue():
    _, tcfg = _config()
    with pytest.raises(ValueError, match="venue=lob"):
        TX.crosscheck_lob_episode(tcfg, [0], device="cpu")
    with pytest.raises(ValueError, match="crosscheck_lob_episode"):
        TX.crosscheck_episode(dict(tcfg, venue="lob"), [0], device="cpu")


def test_crosscheck_lob_episode_matches():
    over = dict(venue="lob", strategy_plugin="direct_fixed_sltp", sl_pips=40.0, tp_pips=40.0,
                commission=0.0002, lob_messages_per_bar=32, lob_flow_seed=7,
                lob_depth_levels=16, lob_queue_slots=4, position_size=1.0, window_size=8)
    jcfg, tcfg = _config(**over)
    actions = np.random.default_rng(2).integers(0, 3, 24).tolist()
    ours = TX.crosscheck_lob_episode(tcfg, actions, device="cpu")
    with x64_off():
        want = JX.crosscheck_lob_episode(jcfg, actions)
    assert sorted(ours) == sorted(want)
    for key, value in want.items():
        if isinstance(value, float):
            np.testing.assert_allclose(ours[key], value, rtol=RTOL, atol=ATOL, err_msg=key)
        else:
            assert ours[key] == value, key
    assert ours["oracle_realized_balance"] == want["oracle_realized_balance"]
    assert ours["scan_trades"] > 0 and ours["denied_match"] and ours["within_bound"]


@pytest.mark.parametrize("depth,slots", [(4, 2), (16, 4)])
def test_book_twin_replays_streams_as_the_jax_package_s(depth, slots):
    from gymfx_tpu_torch.lob.book import MSG_ADD, MSG_CANCEL, MSG_MARKET, MSG_NOOP

    rng = np.random.default_rng(depth)
    n = 300
    kinds = rng.choice([MSG_NOOP, MSG_ADD, MSG_CANCEL, MSG_MARKET], n, p=[0.1, 0.5, 0.2, 0.2])
    msgs = (kinds, rng.choice([1, -1], n), 100 + rng.integers(-6, 7, n),
            rng.integers(1, 9, n), 1 + np.arange(n) % 40)
    book, fills = TO.replay_messages(depth, slots, msgs)
    jbook, jfills = JO.replay_messages(depth, slots, msgs)
    assert fills == jfills
    assert sum(f[0] for f in fills) > 0
