"""The Gymnasium VectorEnv (gymfx_tpu_torch/vector_env.py) against the JAX
package's (gymfx_tpu/vector_env.py), on the CPU.

* Six envs on a 40-bar cut of eurusd_sample.csv, 100 steps of a seeded
  action script (discrete, and continuous across both thresholds), so
  every env terminates and autoresets more than once: the spaces equal;
  terminations and truncations exact; obs and rewards within rtol 1e-6 /
  atol 1e-5 of the JAX vector env's jitted step (XLA:CPU contracts
  multiply-adds inside jit, ROADMAP Queue 3).
* gymnasium's next-step autoreset: the step after an env's termination
  returns its fresh reset obs, reward 0 and done False, whatever its
  action.
"""
import numpy as np
import pytest

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.vector_env import GymFxVectorEnv as JaxVectorEnv

from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.vector_env import GymFxVectorEnv

from test_torch_parity import x64_off

CSV = str(__import__("pathlib").Path(__file__).resolve().parent.parent / "examples" / "data"
          / "eurusd_sample.csv")
OVER = dict(input_data_file=CSV, max_rows=40, window_size=8, strategy_plugin="direct_fixed_sltp",
            sl_pips=4.0, tp_pips=8.0, feature_columns=["CLOSE", "VOLUME"], timeframe="M1")
N = 6


def _close(a, b, label):
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5, err_msg=label)


@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_the_vector_env_steps_and_autoresets_as_jax(mode):
    cfg = dict(OVER, action_space_mode=mode)
    with x64_off():
        jenv = JaxVectorEnv(dict(JAX_DEFAULTS, **cfg), N)
    env = GymFxVectorEnv(dict(DEFAULT_VALUES, **cfg), N, device="cpu")
    assert env.single_observation_space == jenv.single_observation_space
    assert env.single_action_space == jenv.single_action_space
    assert env.observation_space == jenv.observation_space
    assert env.action_space == jenv.action_space
    rng = np.random.default_rng(4)
    with x64_off():
        jobs, _ = jenv.reset(seed=0)
    obs, info = env.reset(seed=0)
    assert info == {}
    fresh = {k: v[0].copy() for k, v in obs.items()}
    for k in jobs:
        _close(jobs[k], obs[k], f"reset {k}")
    prev_done, resets = np.zeros(N, bool), 0
    for i in range(100):
        if mode == "discrete":
            actions = rng.integers(0, 3, N)
        else:
            actions = rng.uniform(-1, 1, (N, 1)).astype(np.float32)
        with x64_off():
            jout = jenv.step(actions)
        out = env.step(actions)
        np.testing.assert_array_equal(out[2], jout[2], err_msg=f"step {i} terminations")
        np.testing.assert_array_equal(out[3], jout[3])
        _close(jout[1], out[1], f"step {i} reward")
        for k in jout[0]:
            _close(jout[0][k], out[0][k], f"step {i} obs {k}")
        for e in np.flatnonzero(prev_done):  # next-step autoreset
            resets += 1
            assert out[1][e] == 0.0 and not out[2][e]
            for k in fresh:
                np.testing.assert_array_equal(out[0][k][e], fresh[k], err_msg=f"reset {k}")
        prev_done = out[2]
        assert out[1].dtype == np.float32 and out[2].dtype == bool
    assert resets >= 2 * N
    env.close()
    with pytest.raises(RuntimeError, match="reset"):
        env.step(np.zeros(N, np.int64))
