"""The Gymnasium shell (gymfx_tpu_torch/gym_env.py, gym_compat.py) and
``main``'s ``gym_loop`` against the JAX package's
(gymfx_tpu/gym_env.py, app/main.py), on the CPU.

* Step by step over a fixed action script, discrete and continuous (the
  continuous script crosses both thresholds), on a 90-bar cut of
  eurusd_sample.csv with ``direct_fixed_sltp`` brackets: the spaces
  equal; obs, reward and every float of the info dict within rtol 1e-6 /
  atol 1e-5 of the JAX shell's ``jit_step`` (XLA:CPU contracts
  multiply-adds inside jit, ROADMAP Queue 3; tests/test_torch_env.py
  holds the step itself bitwise against the op-by-op JAX step);
  terminations, truncations and every integer, boolean and string of the
  info dict (the action and execution diagnostics among them) exact; the
  info's keys exact.  The episode runs to its end and past it.
* ``summary()`` against the JAX shell's: keys, integers equal, floats
  within rtol 1e-6 (tests/test_torch_cli.py's tolerance).
* ``GYMFX_BRACKET_AUDIT``: the JSONL records equal the JAX shell's
  (floats within rtol 1e-6).
* ``gymnasium.utils.env_checker.check_env`` passes, discrete and
  continuous; the gymnasium-free stand-ins of gym_compat.py (the card's
  machine has no gymnasium) run the same episode in a subprocess to the
  same obs and info.
* The card path's host side: ``StepProgram``'s packing of a step's
  outputs into one byte buffer and back is lossless (bitwise) for every
  output, on the CPU.
* ``build_environment``, the lazy top-level exports, an unknown metrics
  plugin (item 9), and ``main`` with ``gym_loop=true`` (the results JSON
  of the JAX ``main``: keys and integers exact, floats within rtol 1e-6)
  and its refusal of ``export_scaled_features``.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from gymfx_tpu.app.main import main as jax_main
from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.gym_env import GymFxEnv as JaxGymFxEnv

import gymfx_tpu_torch
from gymfx_tpu_torch import gym_env
from gymfx_tpu_torch.app.main import main
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.gym_env import GymFxEnv, StepProgram, build_environment

from test_torch_cli import assert_results_match
from test_torch_parity import x64_off

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
CSV = str(REPO / "examples" / "data" / "eurusd_sample.csv")
OVER = dict(input_data_file=CSV, max_rows=90, window_size=8, strategy_plugin="direct_fixed_sltp",
            sl_pips=4.0, tp_pips=8.0, feature_columns=["CLOSE", "VOLUME"],
            include_price_window=True, timeframe="M1")
DISCRETE = [1, 0, 0, 2, 2, 0, 1, 1, 0, 0, 2, 0, 1, 0, 0, 0, 2, 1, 0, 0] * 5
CONTINUOUS = [np.float32([x]) for x in np.sin(np.arange(100) * 0.7) * 0.9]


def _envs(**over):
    cfg = {**OVER, **over}
    with x64_off():
        jenv = JaxGymFxEnv(dict(JAX_DEFAULTS, **cfg))
    return jenv, GymFxEnv(dict(DEFAULT_VALUES, **cfg), device="cpu")


def _assert_tree_close(ref, ours, path):
    """Keys equal; floats within rtol 1e-6 / atol 1e-5; everything else
    (ints, bools, strings, None) equal."""
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref), f"{path}: {sorted(set(ours) ^ set(ref))}"
        for k in ref:
            _assert_tree_close(ref[k], ours[k], f"{path}/{k}")
    elif isinstance(ref, np.ndarray):
        assert ours.shape == ref.shape and ours.dtype == ref.dtype, path
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-5, err_msg=path)
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert isinstance(ours, float), f"{path}: {ours!r} vs {ref!r}"
        assert ours == pytest.approx(ref, rel=1e-6, abs=1e-5) or (
            np.isnan(ours) and np.isnan(ref)), f"{path}: {ours!r} vs {ref!r}"
    else:
        assert type(ours) is type(ref) and ours == ref, f"{path}: {ours!r} vs {ref!r}"


def _episode(jenv, env, actions):
    with x64_off():
        jobs, jinfo = jenv.reset(seed=0)
    obs, info = env.reset(seed=0)
    _assert_tree_close(jobs, obs, "reset obs")
    _assert_tree_close(jinfo, info, "reset info")
    ends = 0
    for i, a in enumerate(actions):
        with x64_off():
            jstep = jenv.step(a)
        step = env.step(a)
        _assert_tree_close(jstep[0], step[0], f"step {i} obs")
        _assert_tree_close(jstep[1], step[1], f"step {i} reward")
        assert step[2:4] == jstep[2:4], f"step {i} terminated / truncated"
        _assert_tree_close(jstep[4], step[4], f"step {i} info")
        ends += step[2]
    return ends


@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_the_shell_steps_as_the_jax_shell(mode):
    jenv, env = _envs(action_space_mode=mode)
    assert env.action_space == jenv.action_space
    assert env.observation_space == jenv.observation_space
    actions = DISCRETE if mode == "discrete" else CONTINUOUS
    assert _episode(jenv, env, actions) > 0  # the episode ended and stepped past its end
    info = env._last_info
    assert info["trades"] > 0 and info["action_diagnostics"]["long_actions"] > 0
    assert info["action_diagnostics"]["short_actions"] > 0
    if mode == "continuous":
        assert info["action_diagnostics"]["continuous_deadband_actions"] > 0
        assert info["action_diagnostics"]["continuous_action_threshold"] == 0.33
    with x64_off():
        ref = json.loads(json.dumps(jenv.summary(), default=str))
    assert_results_match(ref, json.loads(json.dumps(env.summary(), default=str)))


def test_the_calendar_and_stage_b_blocks_step_as_jax():
    jenv, env = _envs(oanda_fx_calendar_obs=True, stage_b_force_close_obs=True,
                      broker_profile="oanda_practice")
    assert env.observation_space == jenv.observation_space
    _episode(jenv, env, DISCRETE[:12])


def test_the_bracket_audit_records_match_jax(tmp_path, monkeypatch):
    records = {}
    for who in ("jax", "ours"):
        path = tmp_path / f"{who}.jsonl"
        monkeypatch.setenv("GYMFX_BRACKET_AUDIT", str(path))
        jenv, env = _envs(strategy_plugin="direct_atr_sltp", atr_period=3)
        shell = jenv if who == "jax" else env
        with x64_off():
            shell.reset(seed=0)
            for a in DISCRETE[:40]:
                shell.step(a)
        records[who] = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(records["ours"]) >= 2
    assert {r["kind"] for r in records["ours"]} >= {"long_bracket", "short_bracket"}
    _assert_tree_close({"r": dict(enumerate(records["jax"]))},
                       {"r": dict(enumerate(records["ours"]))}, "audit")


@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_check_env_passes(mode):
    from gymnasium.utils.env_checker import check_env

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        check_env(GymFxEnv(dict(DEFAULT_VALUES, **OVER, action_space_mode=mode), device="cpu"),
                  skip_render_check=True)


_NO_GYMNASIUM = """
import json, sys
sys.modules["gymnasium"] = None
import numpy as np
from gymfx_tpu_torch import gym_compat
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.gym_env import GymFxEnv
from gymfx_tpu_torch.vector_env import GymFxVectorEnv
assert not gym_compat.HAVE_GYMNASIUM
config = dict(DEFAULT_VALUES, **json.loads(sys.argv[1]))
env = GymFxEnv(config, device="cpu")
obs, info = env.reset(seed=0)
assert env.observation_space.contains(obs) and env.action_space.contains(1)
for a in json.loads(sys.argv[2]):
    obs, reward, done, trunc, info = env.step(a)
vec = GymFxVectorEnv(config, 3, device="cpu")
vobs, _ = vec.reset()
assert vec.observation_space.contains(vobs) and vec.action_space.contains(np.array([0, 1, 2]))
print(json.dumps({"obs": {k: v.tolist() for k, v in obs.items()}, "info": info,
                  "keys": sorted(env.observation_space.keys())}))
"""


def test_the_stand_ins_without_gymnasium_run_the_same_episode():
    config = dict(OVER)
    proc = subprocess.run([sys.executable, "-c", _NO_GYMNASIUM, json.dumps(config),
                           json.dumps(DISCRETE[:30])], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    env = GymFxEnv(dict(DEFAULT_VALUES, **config), device="cpu")
    env.reset(seed=0)
    for a in DISCRETE[:30]:
        obs, _, _, _, info = env.step(a)
    assert got["obs"] == {k: v.tolist() for k, v in obs.items()}
    assert got["info"] == json.loads(json.dumps(info))
    assert got["keys"] == sorted(obs)


def test_step_program_packs_every_output_losslessly():
    env = GymFxEnv(dict(DEFAULT_VALUES, **OVER), device="cpu")
    env.reset(seed=0)
    program = env._program
    action = torch.tensor([1.0])
    eager = program.fn(program.state, action)[1]
    packed = program._pack({"state": gymfx_tpu_torch.core.graphs.clone_tree(program.state),
                            "action": action})
    assert packed.dtype == torch.uint8 and packed.dim() == 1
    got = program._unpack(packed.numpy())
    assert [list(d) for d in (got[0], got[3])] == [list(d) for d in (eager[0], eager[3])]
    leaves = gym_env.tree_leaves
    assert len(leaves(got)) == len(leaves(eager)) > 60
    for ref, out in zip(leaves(eager), leaves(got)):
        assert out.dtype == ref.numpy().dtype and out.shape == tuple(ref.shape)
        np.testing.assert_array_equal(out.view(np.uint8), ref.numpy().view(np.uint8))
    assert not StepProgram(program.fn, None, torch.device("cpu")).graphed


def test_build_environment_and_the_lazy_exports():
    env = build_environment(config=dict(DEFAULT_VALUES, **OVER, simulation_engine="backtrader"),
                            device="cpu")
    assert isinstance(env, GymFxEnv)
    with pytest.raises(ValueError, match="unsupported simulation_engine 'zipline'"):
        build_environment(config=dict(DEFAULT_VALUES, **OVER, simulation_engine="zipline"),
                          device="cpu")
    for name in ("GymFxEnv", "GymFxVectorEnv", "build_environment", "Environment"):
        assert name in dir(gymfx_tpu_torch)
    assert gymfx_tpu_torch.GymFxEnv is GymFxEnv
    assert gymfx_tpu_torch.build_environment is build_environment
    from gymfx_tpu_torch.vector_env import GymFxVectorEnv

    assert gymfx_tpu_torch.GymFxVectorEnv is GymFxVectorEnv
    with pytest.raises(AttributeError):
        gymfx_tpu_torch.NoSuchThing  # noqa: B018
    env = GymFxEnv(dict(DEFAULT_VALUES, **OVER, metrics_plugin="my_metrics"), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9$"):
        env.summary()
    with pytest.raises(RuntimeError, match="reset"):
        GymFxEnv(dict(DEFAULT_VALUES, **OVER), device="cpu").step(0)


def _argv(tmp_path, *extra):
    return ["--input_data_file", CSV, "--results_file", str(tmp_path / "results.json"),
            "--save_config", str(tmp_path / "config.json"), "--quiet_mode", "--window_size", "8",
            "--gym_loop", "true", *extra]


@pytest.mark.parametrize("extra", [
    ("--driver_mode", "buy_hold", "--steps", "120"),
    ("--driver_mode", "random", "--steps", "80", "--seed", "3", "--metrics_plugin",
     "trading_metrics"),
], ids=["buy_hold", "random"])
def test_main_with_gym_loop_gives_the_jax_results(tmp_path, extra):
    with x64_off():
        ref = json.loads(json.dumps(jax_main(_argv(tmp_path, *extra)), default=str))
    ours = json.loads(json.dumps(main(_argv(tmp_path, *extra), device="cpu"), default=str))
    assert_results_match(ref, ours)
    assert ours["action_diagnostics"]["steps"] == int(extra[3])
    with pytest.raises(ValueError, match="scanned episode path only"):
        main(_argv(tmp_path, *extra, "--export_scaled_features", "x.npz"), device="cpu")
