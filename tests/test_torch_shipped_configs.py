"""Every shipped example config that does not train
(examples/configs/*.json) through the port's ``main`` on the CPU.

The two inference configs with a random driver draw torch's stream, not
JAX's, so their numbers are the port's own; the deterministic ones are
held to the JAX ``main`` in tests/test_torch_cli.py and
tests/test_torch_financing.py, the GA in tests/test_torch_optimize.py and
the cross-check in tests/test_torch_crosscheck.py.  Here each config runs
to its summary: the GA cut to one generation and two ``atr_period`` grid
points, the rest at their shipped sizes.
"""
import json
import math
import pathlib

import pytest

from gymfx_tpu_torch.app.main import main

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "examples" / "configs"
TRAINING = {"train_impala_lstm", "train_portfolio_transformer", "train_ppo_mlp"}
SHIPPED = sorted(p.stem for p in CONFIGS.glob("*.json") if p.stem not in TRAINING)


def test_the_five_non_training_configs_are_the_ones_shipped():
    assert SHIPPED == ["atr_strategy_eval", "inference_buy_hold",
                       "inference_financed_profile", "inference_verified_execution",
                       "optimize_atr"]


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_runs_through_main(tmp_path, name):
    argv = ["--load_config", str(CONFIGS / f"{name}.json"), "--results_file",
            str(tmp_path / "r.json"), "--save_config", str(tmp_path / "c.json"), "--quiet_mode"]
    if name == "optimize_atr":
        argv += ["--optimize_generations", "1", "--optimize_atr_periods", "[7, 14]"]
    summary = main(argv, device="cpu")
    assert json.loads((tmp_path / "r.json").read_text()) == json.loads(json.dumps(summary,
                                                                                  default=str))
    if name == "optimize_atr":
        assert summary["mode"] == "optimization" and summary["population"] == 64
        assert sorted(summary["best_params"]) == ["atr_period", "k_sl", "k_tp"]
        assert [s["atr_period"] for s in summary["atr_period_sweep"]] == [7, 14]
        assert len(summary["history"]) == 1 and math.isfinite(summary["best_rap"])
        return
    assert math.isfinite(summary["final_equity"])
    assert summary["action_diagnostics"]["steps"] > 0
    if name == "inference_verified_execution":
        check = summary["execution_crosscheck"]
        assert check.get("status") != "skipped", check
        assert check["within_bound"] and check["divergence"] <= check["quantization_bound"]
        assert check["replay_fills"] > 20
