"""The port stands alone: no JAX, flax, optax, pandas or gymfx_tpu inside.

* A subprocess imports gymfx_tpu_torch, runs a 50-step CPU rollout and
  a short PPO rollout phase, then checks that none of those packages was
  imported.
* An AST scan of every module of the package finds no such import.
* Entry points default to CUDA: without it and without ``device`` they
  raise; configurations the port does not take raise
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
from gymfx_tpu_torch.train.ppo import PPORollout, ppo_config_from

config = dict(DEFAULT_VALUES)
config.update(input_data_file="examples/data/eurusd_sample.csv", num_envs=4,
              ppo_horizon=4, feature_columns=["CLOSE", "VOLUME"],
              policy_kwargs={"hidden": [8, 8, 8]})
env = Environment(config, device="cpu")
state, out = env.rollout(buy_hold_driver(), 50)
assert out["equity"].shape == (50, 1)
ro = PPORollout(env, ppo_config_from(config))
ro.rollout_phase(ro.init_state(0))
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
    ({"reward_plugin": "sharpe_reward"}, 7),
    ({"venue": "lob"}, 13),
    ({"strategy_plugin": "my_plugin"}, 9),
    ({"financing_enabled": True}, 8),
])
def test_configs_not_ported_raise_naming_the_roadmap_item(over, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        Environment(_config(**over), device="cpu")


def test_float64_env_on_the_card_raises_before_any_kernel():
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        Environment(_config(compute_dtype="float64"), device="cuda")


def test_policies_other_than_mlp_raise():
    from gymfx_tpu_torch.train.ppo import PPORollout, ppo_config_from

    env = Environment(_config(), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        PPORollout(env, ppo_config_from(_config(policy="lstm")))
