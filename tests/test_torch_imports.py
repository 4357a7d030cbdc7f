"""The port stands alone: no JAX, flax, optax, pandas or gymfx_tpu inside.

* A subprocess imports gymfx_tpu_torch, runs a 50-step CPU rollout, a
  short PPO train step (rollout and update) with the MLP and with the
  ring transformer (K4's plain versions), a short LOB-venue episode
  (its threefry flow and K5's plain version), a streamed episode over a
  compressed tape (K6's plain version), curriculum training over two
  tapes, the scaled-feature export (K7's plain version), and the command
  line: one training iteration with a checkpoint, then the policy mode on
  that checkpoint, for PPO and for IMPALA (the LSTM policy on the sharpe
  reward), population-based training over the three-pair portfolio
  with the Transformer policy, and a LOB-venue episode on a generated
  tape (the scenario generator, its flags' flow) with the stress overlay;
  imports the telemetry and the fault harness and runs a population step
  of PBT over the bar venue; then checks that none of those packages was
  imported.
* An AST scan of every module of the package finds no such import.
* Entry points default to CUDA: without it and without ``device`` they
  raise; configurations and options the port does not take raise
  ``NotImplementedError`` naming a ROADMAP item.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core.runtime import Environment

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "gymfx_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pandas", "gymfx_tpu")

_PROBE = """
import sys
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core.rollout import buy_hold_driver
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

config = dict(DEFAULT_VALUES)
config.update(input_data_file="examples/data/eurusd_sample.csv", num_envs=4,
              ppo_horizon=4, feature_columns=["CLOSE", "VOLUME"],
              policy_kwargs={"hidden": [8, 8, 8]})
env = Environment(config, device="cpu")
state, out = env.rollout(buy_hold_driver(), 50)
assert out["equity"].shape == (50, 1)
tr = PPOTrainer(env, ppo_config_from(config))
tr.train_step(tr.init_state(0))
config.update(policy="transformer_ring", window_size=8,
              policy_kwargs={"d_model": 8, "n_heads": 2, "n_layers": 1})
tr = PPOTrainer(Environment(config, device="cpu"), ppo_config_from(config))
tr.train_step(tr.init_state(0))
config.update(venue="lob", rollout_env_kernel="off", lob_messages_per_bar=8,
              strategy_plugin="direct_fixed_sltp")
Environment(config, device="cpu").rollout(buy_hold_driver(), 5)
import tempfile
from gymfx_tpu_torch.app.main import export_scaled_features
config = dict(DEFAULT_VALUES)
config.update(input_data_file="examples/data/eurusd_sample.csv", window_size=8,
              feature_columns=["CLOSE", "VOLUME"], stream_hbm_budget_mb=0.03,
              data_compress="on")
Environment(config, device="cpu").rollout(buy_hold_driver(), 150)
config.update(stream_hbm_budget_mb=None, feed="curriculum", num_envs=4, ppo_horizon=4,
              tapes="file:examples/data/eurusd_sample.csv,file:examples/data/gbpusd_sample.csv",
              policy_kwargs={"hidden": [8, 8, 8]}, random_episode_start=True)
env = Environment(config, device="cpu")
PPOTrainer(env, ppo_config_from(config)).train(32)
export_scaled_features(env, config, 16, tempfile.mkdtemp() + "/x.npz")
import json
from gymfx_tpu_torch.app.main import main
d = tempfile.mkdtemp()
with open(d + "/small.json", "w") as fh:
    json.dump({"policy_kwargs": {"hidden": [8, 8, 8]}, "feature_columns": ["CLOSE"]}, fh)
cli = ["--input_data_file", "examples/data/eurusd_sample.csv", "--num_envs", "4",
       "--ppo_horizon", "4", "--window_size", "8", "--load_config", d + "/small.json",
       "--checkpoint_dir", d + "/ckpt", "--results_file", d + "/results.json",
       "--save_config", d + "/saved.json", "--quiet_mode"]
trained = main(cli + ["--mode", "training", "--train_total_steps", "16",
                      "--checkpoint_every", "1"], device="cpu")
assert trained["train_metrics"]["last_checkpoint_step"] == 16
assert main(cli + ["--driver_mode", "policy", "--steps", "50"], device="cpu")["checkpoint_step"] == 16
with open(d + "/impala.json", "w") as fh:
    json.dump({"policy": "lstm", "policy_kwargs": {"hidden": 8}, "trainer": "impala",
               "impala_unroll": 4, "reward_plugin": "sharpe_reward", "window": 5}, fh)
cli[cli.index(d + "/small.json")] = d + "/impala.json"
cli[cli.index(d + "/ckpt")] = d + "/impala_ckpt"
trained = main(cli + ["--mode", "training", "--train_total_steps", "16",
                      "--checkpoint_every", "1"], device="cpu")
assert trained["train_metrics"]["last_checkpoint_step"] == 16
assert main(cli + ["--driver_mode", "policy", "--steps", "50"], device="cpu")["checkpoint_step"] == 16
files = {"EUR_USD": "examples/data/eurusd_sample.csv",
         "GBP_USD": "examples/data/gbpusd_sample.csv",
         "USD_JPY": "examples/data/usdjpy_sample.csv"}
with open(d + "/pbt.json", "w") as fh:
    json.dump({"trainer": "pbt", "portfolio_files": files, "policy": "transformer",
               "pbt_population": 2, "pbt_interval": 1, "max_rows": 24, "eval_split": 0.5,
               "ppo_minibatches": 2}, fh)
cli[cli.index(d + "/impala.json")] = d + "/pbt.json"
pbt = main(cli + ["--mode", "training", "--train_total_steps", "64"], device="cpu")
assert pbt["trainer"] == "pbt_portfolio" and pbt["pbt"]["iterations"] == 2
from gymfx_tpu_torch.scengen import oracle, stress
config = dict(DEFAULT_VALUES)
config.update(feed="scengen", scengen_bars=300, window_size=8, venue="lob",
              rollout_env_kernel="off", lob_messages_per_bar=8, strategy_plugin="direct_fixed_sltp")
env = Environment(config, device="cpu")
env.rollout(buy_hold_driver(), 20)
stress.apply_scengen_stress(env.data, "flash_crash")
import gymfx_tpu_torch.telemetry, gymfx_tpu_torch.telemetry.http, gymfx_tpu_torch.telemetry.mfu
from gymfx_tpu_torch.resilience.faults import parse_fault_profile
from gymfx_tpu_torch.train.pbt import PBTConfig, PBTTrainer
assert parse_fault_profile("nan_bars=3;preempt_at=2")["preempt_at"] == 2
config = dict(DEFAULT_VALUES)
config.update(input_data_file="examples/data/eurusd_sample.csv", num_envs=4, ppo_horizon=4,
              window_size=8, feature_columns=["CLOSE"], policy_kwargs={"hidden": [8, 8]})
pbt = PBTTrainer(Environment(config, device="cpu"), ppo_config_from(config), PBTConfig(population=2))
state, _ = pbt.init_population(0)
state, metrics = pbt.trainer.train_step(state)
assert metrics["loss"].shape == (2,)
roots = {m.split(".")[0] for m in sys.modules}
print(sorted(roots & {"jax", "jaxlib", "flax", "optax", "pandas", "gymfx_tpu"}))
"""


def _is_forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in FORBIDDEN


def test_rollout_in_a_fresh_process_imports_no_jax_flax_pandas_or_gymfx_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_no_module_of_the_package_imports_a_forbidden_package():
    offenders = []
    files = sorted(PACKAGE.rglob("*.py"))
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}: {n}" for n in names if _is_forbidden(n)]
    assert not offenders, offenders


def test_is_forbidden_tells_gymfx_tpu_from_the_port():
    assert _is_forbidden("gymfx_tpu.core.env") and _is_forbidden("jax.numpy")
    assert not _is_forbidden("gymfx_tpu_torch.core.env")


def _config(**over):
    config = dict(DEFAULT_VALUES)
    config.update(input_data_file=str(REPO / "examples/data/eurusd_sample.csv"), **over)
    return config


def test_environment_without_cuda_and_without_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is CUDA here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Environment(_config())


@pytest.mark.parametrize("over,item", [
    # sharpe_reward runs since PR 13; bfloat16 envs are what item 7 still holds
    ({"reward_plugin": "sharpe_reward", "compute_dtype": "bfloat16"}, 7),
    ({"strategy_plugin": "my_plugin"}, 9),
    # financing runs; registered obs kernels are item 9's
    ({"obs_plugins": ["my_obs"]}, 9),
])
def test_configs_not_ported_raise_naming_the_roadmap_item(over, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        Environment(_config(**over), device="cpu")


@pytest.mark.parametrize("over", [
    {"venue": "lob", "feed": "scengen", "rollout_env_kernel": "off"},
    {"feed": "curriculum", "tapes": "scengen:flash_crash"},
], ids=["lob_from_scengen", "scengen_tapes"])
def test_generated_feeds_build(over):
    """Item 14 (ported): the LOB venue on a generated tape takes its flow
    from the tape's flags; a curriculum of scengen tapes builds."""
    env = Environment(_config(scengen_bars=300, window_size=8, **over), device="cpu")
    assert env.n_bars == 300 and env.cfg.lob_flow_from_scengen == (over.get("venue") == "lob")
    assert env.data.scen_flags.shape == (300,) and bool((env.data.scen_flags >= 0).all())


def test_float64_env_on_the_card_raises_before_any_kernel():
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        Environment(_config(compute_dtype="float64"), device="cuda")


def test_policies_other_than_mlp_raise():
    """Every policy builds now: the flax TransformerPolicy, and in
    continuous mode (item 11, ported) the Gaussian twins, the LSTM's
    among them; a name with no twin raises the JAX package's
    ValueError."""
    from gymfx_tpu_torch.train.policies import (
        ContinuousLSTMPolicy,
        TransformerPolicy,
        make_policy,
    )
    from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

    config = _config(policy="transformer", num_envs=4, window_size=8,
                     policy_kwargs={"d_model": 8, "n_heads": 2, "n_layers": 1})
    trainer = PPOTrainer(Environment(config, device="cpu"), ppo_config_from(config))
    assert isinstance(trainer.policy, TransformerPolicy)
    config = _config(policy="lstm", num_envs=4, action_space_mode="continuous",
                     policy_kwargs={"hidden": 8})
    trainer = PPOTrainer(Environment(config, device="cpu"), ppo_config_from(config))
    assert isinstance(trainer.policy, ContinuousLSTMPolicy) and trainer._continuous
    with pytest.raises(ValueError, match="unknown policy"):
        make_policy("nonexistent_continuous", 4)


@pytest.mark.parametrize("over,item", [
    ({"policy": "transformer_ring", "policy_kwargs": {"seq_axis": "seq", "seq_shards": 2}}, 17),
    ({"policy": "transformer_ulysses", "policy_kwargs": {"seq_axis": "seq"}}, 17),
])
def test_unported_trainer_options_raise_naming_the_roadmap_item(over, item):
    from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

    config = _config(num_envs=4, ppo_horizon=2, window_size=8, **over)
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        PPOTrainer(Environment(config, device="cpu"), ppo_config_from(config))
