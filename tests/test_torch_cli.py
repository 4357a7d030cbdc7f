"""The port's command line (gymfx_tpu_torch/app/main.py and config/) against
the JAX package's (gymfx_tpu/app/main.py).

* ``main(argv, device="cpu")`` against the JAX ``main(argv)`` on
  examples/data/eurusd_sample.csv: the diagnostic episode with buy_hold
  (300 steps, and past the tape's end with trading_metrics), flat, a
  replay of a recorded action file (recorded by the port's random
  episode, whose stream is torch's, then replayed by both), a
  ``num_envs=4`` buy_hold batch evaluation, and the event-context
  overlay with the scaled-feature export.  Every key of the results JSON
  is on both sides; integers, strings, bools and None are equal, floats
  within rtol 1e-6 (XLA:CPU contracts ``a ± b * c`` into an FMA in the
  jitted episode, ROADMAP Queue 3; every case here happens to agree
  bitwise).
* The config layer is the JAX package's: the parser's flags, the merge
  precedence, unknown ``--key value`` pairs flowing into the config, the
  saved non-default config, and the gym loop's host driver.
* A mode outside training|optimization|inference raises, and every
  option the port does not take raises ``NotImplementedError`` naming
  its ROADMAP Queue 1 item; the generated feed runs under the GA, the
  execution cross-check and training, and a portfolio tape library
  without tapes is refused with the JAX package's message.
* ``--trainer portfolio`` writes the JAX ``main``'s result keys, and its
  checkpoint's policy mode reproduces the held-out summary; ``--trainer
  pbt`` with ``portfolio_files`` trains the population.
* Without CUDA, ``main`` and every Python entry point (``run_mode``,
  ``train_from_config``, ``eval_policy_from_config``, ``replay_driver``)
  raise unless ``device="cpu"`` is passed.
"""
import csv
import json
import math

import numpy as np
import pytest

from gymfx_tpu.app.main import main as jax_main
from gymfx_tpu.app.main import make_cli_driver as jax_make_cli_driver
from gymfx_tpu.config.cli import parse_args as jax_parse_args
from gymfx_tpu.config.merger import convert_type as jax_convert_type
from gymfx_tpu.config.merger import process_unknown_args as jax_process_unknown_args
from gymfx_tpu_torch.app.main import main, make_cli_driver
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.config.cli import parse_args
from gymfx_tpu_torch.config.merger import convert_type, merge_config, process_unknown_args

from test_torch_parity import x64_off

CSV = str(__import__("pathlib").Path(__file__).resolve().parent.parent
          / "examples" / "data" / "eurusd_sample.csv")
RTOL = 1e-6


def _argv(tmp_path, *extra):
    return ["--input_data_file", CSV, "--results_file", str(tmp_path / "results.json"),
            "--save_config", str(tmp_path / "config.json"), "--quiet_mode", *extra]


def _json(summary):
    return json.loads(json.dumps(summary, default=str))


def assert_results_match(ref, ours, path="results"):
    """Every key on both sides, integers and strings equal, floats within
    RTOL."""
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref), f"{path}: keys {sorted(set(ours) ^ set(ref))}"
        for key in ref:
            assert_results_match(ref[key], ours[key], f"{path}/{key}")
    elif isinstance(ref, float) or isinstance(ours, float):
        assert isinstance(ref, float) and isinstance(ours, float), f"{path}: {ref!r} vs {ours!r}"
        assert math.isclose(ours, ref, rel_tol=RTOL, abs_tol=0.0) or (
            math.isnan(ours) and math.isnan(ref)), f"{path}: {ours!r} vs {ref!r}"
    else:
        assert ours == ref, f"{path}: {ours!r} vs {ref!r}"


def _both(tmp_path, *extra):
    with x64_off():
        ref = _json(jax_main(_argv(tmp_path, *extra)))
    ours = _json(main(_argv(tmp_path, *extra), device="cpu"))
    assert_results_match(ref, ours)
    assert json.loads((tmp_path / "results.json").read_text()) == ours
    return ref, ours


@pytest.mark.parametrize("extra", [
    ("--driver_mode", "buy_hold", "--steps", "300"),
    ("--driver_mode", "buy_hold", "--steps", "600", "--metrics_plugin", "trading_metrics"),
    ("--driver_mode", "flat", "--steps", "200"),
    # the default broker's slippage_perc (0.0, merged under the config)
    # outranks --slippage in both packages; the commission applies
    ("--driver_mode", "buy_hold", "--steps", "300", "--slippage", "0.001", "--commission", "2e-5"),
], ids=["buy_hold", "buy_hold_past_the_end", "flat", "plugin_defaults"])
def test_diagnostic_episode_results_match_jax(tmp_path, extra):
    ref, ours = _both(tmp_path, *extra)
    assert ours["action_diagnostics"]["steps"] > 0
    assert "batch" not in ours


def test_batch_evaluation_results_match_jax(tmp_path):
    ref, ours = _both(tmp_path, "--driver_mode", "buy_hold", "--steps", "300", "--num_envs", "4")
    assert ours["batch"]["num_envs"] == 4 and ours["batch"]["std_total_return"] == 0.0


def test_recorded_actions_replay_round_trip_matches_jax(tmp_path):
    record = tmp_path / "actions.csv"
    recorded = main(_argv(tmp_path, "--driver_mode", "random", "--steps", "250", "--seed", "3",
                          "--record_actions_file", str(record)), device="cpu")
    with open(record, encoding="utf-8") as fh:
        actions = [int(row["action"]) for row in csv.DictReader(fh)]
    assert len(actions) == 250 and set(actions) == {0, 1, 2}
    ref, ours = _both(tmp_path, "--driver_mode", "replay", "--steps", "250",
                      "--replay_actions_file", str(record))
    # the replayed episode is the recorded one
    for key in ("final_equity", "trades_total", "action_diagnostics", "execution_diagnostics"):
        assert ours[key] == _json(recorded)[key], key
    # and buy_hold records the same file on both sides
    for name, run in (("jax", jax_main), ("torch", main)):
        argv = _argv(tmp_path, "--driver_mode", "buy_hold", "--steps", "40",
                     "--record_actions_file", str(tmp_path / f"{name}.csv"))
        with x64_off():
            run(argv) if name == "jax" else run(argv, device="cpu")
    assert (tmp_path / "jax.csv").read_text() == (tmp_path / "torch.csv").read_text()


def test_event_context_overlay_and_feature_export_match_jax(tmp_path):
    ref, ours = _both(tmp_path, "--driver_mode", "buy_hold", "--steps", "120", "--window_size", "8",
                      "--event_context_execution_overlay", "true",
                      "--feature_columns", '["CLOSE", "VOLUME"]',
                      "--export_scaled_features", str(tmp_path / "windows.npz"))
    assert ours["event_context_diagnostics"] and ours["export_scaled_features"]["shape"] == [120, 8, 2]
    assert np.load(tmp_path / "windows.npz")["scaled_windows"].shape == (120, 8, 2)


def test_parser_takes_the_jax_packages_flags():
    ours, ref = vars(parse_args([])[0]), vars(jax_parse_args([])[0])
    assert ours == ref and set(ours) <= set(DEFAULT_VALUES)
    argv = ["--mode", "training", "--driver_mode", "policy", "--steps", "7", "--initial_cash",
            "5.5", "--headers", "--venue", "lob", "--data_compress", "on", "--policy",
            "transformer_ring", "--checkpoint_every", "2", "--elastic_resume", "--mesh_shape",
            '{"data": 2}', "--ppo_minibatch_scheme", "sample_permute", "--quiet_mode",
            "--telemetry_profile_every", "3", "--my_key", "0.25", "--flag"]
    a, unknown = parse_args(argv)
    b, jax_unknown = jax_parse_args(argv)
    assert vars(a) == vars(b) and unknown == jax_unknown == ["--my_key", "0.25", "--flag"]
    for bad in (["--mode", "bogus"], ["--steps", "x"], ["--policy", "lstm2"]):
        with pytest.raises(SystemExit):
            parse_args(bad)
        with pytest.raises(SystemExit):
            jax_parse_args(bad)


@pytest.mark.parametrize("tokens", [
    ["--a", "1", "--b", "--c", "x"], ["stray", "--flag"], ["--n", "none", "--t", "TRUE"],
    ["--f", "1e-3", "--s", "1.2.3", "--i", "-4"], [],
])
def test_unknown_args_and_type_coercion_match_jax(tokens):
    assert process_unknown_args(tokens) == jax_process_unknown_args(tokens)
    for value in ("3", "3.5", "false", "null", "abc", 7, None):
        assert convert_type(value) == jax_convert_type(value)


def test_merge_precedence_and_unknown_args_flow_into_the_config(tmp_path):
    merged = merge_config({"a": 1, "b": 1, "c": 1, "d": 1}, {"a": 0, "e": 0}, {}, {"b": 2, "c": 2},
                          {"c": 3, "d": None}, {"d": "4"})
    assert merged == {"a": 1, "b": 2, "c": 3, "d": 4, "e": 0}
    file_config = tmp_path / "file.json"
    file_config.write_text(json.dumps({"steps": 30, "initial_cash": 500.0}))
    out = main(_argv(tmp_path, "--load_config", str(file_config), "--initial_cash", "2000",
                     "--my_unknown_key", "0.5", "--reward_scale", "2"), device="cpu")
    saved = json.loads((tmp_path / "config.json").read_text())
    # the file beats the defaults, the flag beats the file, unknown args land
    assert saved["steps"] == 30 and saved["initial_cash"] == 2000.0
    assert saved["my_unknown_key"] == 0.5 and saved["reward_scale"] == 2
    assert out["initial_cash"] == 2000.0 and out["action_diagnostics"]["steps"] == 30


def test_a_mode_outside_the_three_raises(tmp_path):
    file_config = tmp_path / "bad.json"
    file_config.write_text(json.dumps({"mode": "bogus"}))
    with pytest.raises(ValueError, match="mode must be one of"):
        main(_argv(tmp_path, "--load_config", str(file_config)), device="cpu")


@pytest.mark.parametrize("extra,item", [
    # IMPALA over a tape library (item 11) and the gym loop (item 18) run
    # (tests/test_torch_impala_curriculum.py, test_torch_gym_env.py); PBT
    # (over the bar venue too), fault profiles, telemetry and the
    # performance observatory train; what of them item 17 still holds: a
    # profile's mesh events, a population on a mesh
    (("--mode", "training", "--fault_profile", "nan_bars=5;mesh=kill:1@2"), 17),
    (("--mode", "training", "--trainer", "pbt", "--mesh_shape", '{"data": 1}'), 17),
    (("--mode", "training", "--elastic_resume"), 17),
    (("--mode", "training", "--mesh_shape", '{"data": 1}'), 17),
    (("--metrics_plugin", "my_metrics"), 9),
], ids=lambda v: v if isinstance(v, int) else "-".join(v).replace("--", "")[:40])
def test_each_option_not_ported_raises_naming_its_item(tmp_path, extra, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 item {item}$"):
        main(_argv(tmp_path, "--num_envs", "4", *extra), device="cpu")


@pytest.mark.parametrize("extra", [
    ("--mode", "training", "--trainer", "portfolio", "--feed", "curriculum"),
    ("--driver_mode", "policy", "--portfolio_files", '{"EUR_USD": "x.csv"}', "--checkpoint_dir",
     "ckpt", "--feed", "curriculum"),
    ("--mode", "training", "--trainer", "impala", "--feed", "curriculum"),
], ids=["portfolio-training", "portfolio-policy", "impala-training"])
def test_a_portfolio_tape_library_without_tapes_is_refused_as_jax(tmp_path, extra):
    """The portfolio's tape library (item 12, ported) and IMPALA's (item
    11, ported): without ``tapes`` both packages refuse the configuration
    with the same message."""
    match = "feed=curriculum requires the 'tapes' config key"
    with pytest.raises(ValueError, match=match):
        main(_argv(tmp_path, "--num_envs", "4", *extra), device="cpu")
    with x64_off(), pytest.raises(ValueError, match=match):
        jax_main(_argv(tmp_path, "--num_envs", "4", *extra))


@pytest.mark.parametrize("extra", [
    ("--mode", "optimization", "--optimize_generations", "2", "--optimize_population", "8"),
    ("--verify_execution", "true", "--steps", "100"),
    ("--mode", "training", "--ppo_horizon", "8", "--train_total_steps", "32", "--eval_split", "0.25"),
], ids=["optimization", "verify_execution", "training"])
def test_the_generated_feed_runs_through_main(tmp_path, extra):
    """``--feed scengen`` (item 14, ported) under the GA, the execution
    cross-check and PPO training: a generated 300-bar tape."""
    out = _json(main(_argv(tmp_path, "--feed", "scengen", "--scengen_bars", "300",
                           "--window_size", "8", "--num_envs", "4", *extra), device="cpu"))
    if "optimization" in extra:
        assert out["mode"] == "optimization" and len(out["history"]) == 2
    elif "--verify_execution" in extra:
        assert out["execution_crosscheck"] and out["action_diagnostics"]["steps"] > 0
    else:
        assert out["eval_scope"] == "held_out" and (out["train_bars"], out["eval_bars"]) == (225, 75)
        assert math.isfinite(out["final_equity"])


def test_an_unknown_driver_mode_raises(tmp_path):
    file_config = tmp_path / "bad.json"
    file_config.write_text(json.dumps({"driver_mode": "momentum"}))
    with pytest.raises(ValueError, match="unknown driver_mode"):
        main(_argv(tmp_path, "--load_config", str(file_config)), device="cpu")


@pytest.mark.parametrize("mode", ["buy_hold", "flat", "random", "replay"])
def test_the_gym_loops_host_driver_matches_jax(tmp_path, mode):
    path = tmp_path / "actions.csv"
    path.write_text("action\n1\n2\n0\n2\n")
    config = dict(DEFAULT_VALUES, driver_mode=mode, seed=5, replay_actions_file=str(path))
    ours, ref = make_cli_driver(config), jax_make_cli_driver(config)
    assert [ours(None, None, i) for i in range(12)] == [ref(None, None, i) for i in range(12)]
    with pytest.raises(ValueError, match="unknown driver_mode"):
        make_cli_driver(dict(config, driver_mode="nope"))


@pytest.mark.parametrize("extra", [
    ("--driver_mode", "buy_hold"),
    ("--mode", "training", "--train_total_steps", "16"),
    ("--driver_mode", "policy", "--checkpoint_dir", "no_such_checkpoint"),
], ids=["diagnostic", "training", "policy"])
def test_the_command_line_without_cuda_and_without_device_raises(tmp_path, extra):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is CUDA here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(_argv(tmp_path, *extra))


def test_the_python_entry_points_without_cuda_and_without_device_raise(tmp_path):
    import torch

    from gymfx_tpu_torch.app.main import run_mode
    from gymfx_tpu_torch.core.rollout import replay_driver
    from gymfx_tpu_torch.train.ppo import eval_policy_from_config, train_from_config

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is CUDA here")
    config = dict(DEFAULT_VALUES, input_data_file=CSV, checkpoint_dir=str(tmp_path))
    for call in (lambda: run_mode(config), lambda: train_from_config(config),
                 lambda: eval_policy_from_config(config), lambda: replay_driver([1, 2])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


PORTFOLIO = {"portfolio_files": {"EUR_USD": "examples/data/eurusd_sample.csv",
                                 "GBP_USD": "examples/data/gbpusd_sample.csv",
                                 "USD_JPY": "examples/data/usdjpy_sample.csv"},
             "window_size": 8, "max_rows": 40, "num_envs": 4, "ppo_horizon": 8,
             "ppo_minibatches": 2, "eval_split": 0.4, "margin_rate": 0.02, "leverage": 20.0}


def _keys(tree):
    """The nested key structure of a results dict."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_the_portfolio_trainer_and_its_policy_mode_through_main(tmp_path):
    """``--trainer portfolio`` through ``main`` on the CPU: the JAX
    ``main``'s result keys (the numbers differ: torch's draws are not
    JAX's), a checkpoint after each of 2 iterations, and ``--driver_mode
    policy`` on it reproducing the held-out summary exactly."""
    config = tmp_path / "portfolio.json"
    config.write_text(json.dumps({**PORTFOLIO, "trainer": "portfolio", "policy": "transformer"}))
    common = ["--load_config", str(config), "--train_total_steps", "64", "--mode", "training",
              "--checkpoint_every", "1"]
    ours = main(_argv(tmp_path, *common, "--checkpoint_dir", str(tmp_path / "ck")), device="cpu")
    with x64_off():
        ref = jax_main(_argv(tmp_path / "jax", *common, "--checkpoint_dir",
                             str(tmp_path / "jax_ck")))
    ref["checkpoint_dir"] = ours["checkpoint_dir"]
    assert _keys(_json(ours)) == _keys(_json(ref))
    assert ours["trainer"] == "portfolio_ppo" and ours["eval_scope"] == "held_out"
    assert ours["train_metrics"]["last_checkpoint_step"] == 64
    assert sorted(p.name for p in (tmp_path / "ck").iterdir() if p.name.isdigit()) == ["32", "64"]
    policy = tmp_path / "policy.json"
    policy.write_text(json.dumps({**PORTFOLIO, "policy": None}))
    evaluated = main(_argv(tmp_path, "--load_config", str(policy), "--driver_mode", "policy",
                           "--checkpoint_dir", str(tmp_path / "ck"),
                           "--steps", str(ours["eval_bars"] - 1)), device="cpu")
    assert evaluated["checkpoint_step"] == 64 and evaluated["mode"] == "inference"
    for key in ("total_return", "final_equity", "max_drawdown_pct", "trades_total", "pairs",
                "sharpe_ratio_steps", "rap"):
        assert evaluated[key] == ours[key], key


def test_population_based_training_through_main(tmp_path):
    """``--trainer pbt`` with ``portfolio_files``: the best
    member's held-out summary and the ``pbt`` block; the results file
    holds the summary."""
    config = tmp_path / "pbt.json"
    config.write_text(json.dumps({**PORTFOLIO, "trainer": "pbt", "pbt_population": 2,
                                  "pbt_interval": 1}))
    out = main(_argv(tmp_path, "--load_config", str(config), "--mode", "training",
                     "--train_total_steps", "128"), device="cpu")
    assert out["trainer"] == "pbt_portfolio" and out["eval_scope"] == "held_out"
    assert out["pbt"]["iterations"] == 2 and len(out["pbt"]["learning_rates"]) == 2
    assert [r["iter"] for r in out["pbt"]["replacements"]] == [1]
    assert json.loads((tmp_path / "results.json").read_text()) == _json(out)
