"""The sharpe reward (``core/rewards.py``, the plain version of K3's sharpe
path) against the JAX package's (``gymfx_tpu/core/rewards.py:47-78``).

* The env step: the port's ``core/env.step`` (CPU, the plain kernel
  versions) against the jitted ``jax.vmap(gymfx_tpu.core.env.step)`` for
  8 envs over 220 bars of seeded actions, ring windows W = 2, 5 and 64,
  with envs that exhaust the tape (their later steps inactive, the ring
  left as it was on the terminal exhausted step, as the JAX package
  leaves it) and an auto-reset of half of the done envs (the ring zeroed
  through the fresh state).  Every EnvState field, the ring, its slot and
  length included, and the obs and done flags: BITWISE.
* The reward itself: the port sums the ring in one fixed order (slot 0
  to W - 1), ``jnp.sum`` in an order of XLA's, and XLA contracts
  ``Σx² - n·mean²`` into a fused multiply-add inside jit.  So the reward
  is held to the propagation of an absolute bound on those f32 sums: for
  the live slots x (Σ|x| and Σx² in float64 from the ring, which is equal
  on both sides), the mean within 2W·u·Σ|x|/n + 2u|mean| and the
  variance within 16·W·u·Σx²/max(n - 1, 1) (u = 2^-24, two f32 roundings
  of each side), then the Sharpe ratio within what those bounds give.
  The sample variance cancels where the ring's returns are nearly equal:
  the W = 2 windows whose two returns agree to a few parts in 10^4 reach
  it (0.6% relative difference observed between the two packages there).
  Where the float64 standard deviation is within twice the variance
  bound's square root of zero, each side's standard deviation (implied
  by its reward) is held within that square root of the float64 one: an
  absolute bound on the variance, not a relative one on the reward.
* Dyadic returns (an initial cash of 1,024 and deltas on a 2^-12 grid):
  every partial sum is exact, so the order does not matter, and the
  port's ``compute_reward`` equals the JAX package's op by op BITWISE
  (reward, ring, slot and length); ``ordered_sums`` equals the float64
  sums exactly there.
* The JAX package's validation: ``rollout_env_kernel`` with the sharpe
  reward raises its ``ValueError``; the ring's length is read from the
  ``window`` key first; ``annualization_factor`` is a param.
* K3's sharpe layout: the ``SharpeArgs`` pointer count and the reward
  codes against the kernel source, and the wrapper's new outputs.

The CUDA kernel against this plain version: tests/test_torch_cuda.py.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.core import env as jenv
from gymfx_tpu.core import rewards as jrewards
from gymfx_tpu.core.types import EnvConfig as JaxEnvConfig
from gymfx_tpu.core.types import initial_state as jax_initial_state
from gymfx_tpu.train.common import masked_reset as jax_masked_reset

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core import env as tenv
from gymfx_tpu_torch.core import rewards
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.core.types import EnvConfig, make_env_config, make_env_params
from gymfx_tpu_torch.ops import env_dynamics
from gymfx_tpu_torch.train.common import masked_reset

from test_torch_parity import assert_bitwise, paired_envs, random_walk_columns, to_np, x64_off

N_ENVS = 8
STEPS = 220
U = 2.0 ** -24
CSV = str(pathlib.Path(__file__).resolve().parent.parent / "examples" / "data" / "eurusd_sample.csv")


def sharpe_bounds(buf, n, annualization):
    """Per env, from the ring ``buf`` (N, W) and its length ``n``: (the
    float64 mean, the float64 standard deviation, the bound on the
    reward difference, the variance bound, degenerate); see the module
    docstring."""
    buf = np.asarray(buf, np.float64)
    w = buf.shape[1]
    nf = np.maximum(np.asarray(n, np.float64), 1.0)
    mean = buf.sum(1) / nf
    var = np.maximum((buf ** 2).sum(1) - nf * mean ** 2, 0.0) / np.maximum(nf - 1, 1.0)
    std = np.sqrt(var)
    d_mean = 2 * w * U * np.abs(buf).sum(1) / nf + 2 * U * np.abs(mean)
    d_var = 16 * w * U * (buf ** 2).sum(1) / np.maximum(nf - 1, 1.0)
    d_std = np.sqrt(d_var)
    degenerate = std <= 2 * d_std
    lo = np.maximum(std - d_std, 1e-150)  # the bound is used only where std > 2 d_std
    root = np.sqrt(annualization)
    bound = root * (d_mean / lo + (np.abs(mean) + d_mean) * d_std / (lo * lo))
    return mean, std, bound * (1 + 1e-3), d_std, degenerate


def assert_sharpe_close(ref, ours, buf, n, active, annualization, label):
    """The reward check of the module docstring; returns how many envs
    were in the degenerate regime."""
    ref, ours = np.asarray(ref, np.float64), np.asarray(ours, np.float64)
    assert np.all(ref[~active] == 0.0) and np.all(ours[~active] == 0.0), label
    mean, std, bound, d_std, degenerate = sharpe_bounds(buf, n, annualization)
    live2 = active & (np.asarray(n) >= 2)
    ok = ~live2 | degenerate | (np.abs(ref - ours) <= bound)
    assert ok.all(), f"{label}: env {np.argmax(~ok)} {ref[~ok][:3]} vs {ours[~ok][:3]} " \
                     f"(bound {bound[~ok][:3]})"
    root = np.sqrt(annualization)
    for side, r in (("jax", ref), ("port", ours)):
        implied = np.where(r != 0, np.abs(mean) * root / np.where(r != 0, np.abs(r), 1.0), 0.0)
        near = live2 & degenerate
        slop = 2 * d_std + 1e-5 * implied
        assert np.all(np.abs(implied - std)[near] <= slop[near]), f"{label}: {side} std"
    return int((live2 & degenerate).sum())


def _reset_one(jax_env, torch_env):
    with x64_off():
        jfresh, _ = jax.jit(jenv.reset, static_argnums=0)(jax_env.cfg, jax_env.params, jax_env.data)
    tfresh, _ = tenv.reset(torch_env.cfg, torch_env.params, torch_env.data, 1)
    return jfresh, tfresh


@pytest.mark.parametrize("window", [2, 5, 64])
def test_sharpe_step_matches_jax_vmap_step(window):
    columns = random_walk_columns(n=260, seed=11)
    jax_env, torch_env = paired_envs(
        columns, window_size=8, reward_plugin="sharpe_reward", window=window,
        strategy_plugin="direct_atr_sltp", atr_period=5, k_sl=2.0, k_tp=3.0,
        annualization_factor=365.0,
    )
    assert torch_env.cfg.sharpe_window == window and float(torch_env.params.annualization_factor) == 365.0
    rng = np.random.default_rng(5)
    t0 = rng.integers(0, 100, N_ENVS).astype(np.int32)
    actions = rng.choice([0, 1, 2, 1, 2, 0], size=(STEPS, N_ENVS)).astype(np.int32)
    auto_reset = np.arange(N_ENVS) % 2 == 0  # half the done envs start again
    cfg, params, data = jax_env.cfg, jax_env.params, jax_env.data
    jfresh, tfresh = _reset_one(jax_env, torch_env)
    counts = dict(live=0, inactive=0, exhausted=0, resets=0, degenerate=0, wraps=0)
    with x64_off():
        jst, _ = jax.jit(jax.vmap(jenv.reset_at, in_axes=(None, None, None, 0)),
                         static_argnums=0)(cfg, params, data, jnp.asarray(t0))
        vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, None, None, 0, 0)), static_argnums=0)
        tst, _ = tenv.reset_at(torch_env.cfg, torch_env.params, torch_env.data,
                               torch.from_numpy(t0))
        for i in range(STEPS):
            was_done = to_np(tst.terminated)
            jst, jobs, jr, jd, _ = vstep(cfg, params, data, jst, jnp.asarray(actions[i]))
            tst, tobs, tr, td, _ = tenv.step(torch_env.cfg, torch_env.params, torch_env.data,
                                             tst, torch.from_numpy(actions[i]))
            for name in tst._fields:
                assert_bitwise(getattr(jst, name), getattr(tst, name), f"W {window} step {i} {name}")
            for name in tobs:
                assert_bitwise(jobs[name], tobs[name], f"W {window} step {i} obs {name}")
            assert_bitwise(jd, td, f"W {window} step {i} done")
            active = ~was_done
            counts["degenerate"] += assert_sharpe_close(
                jr, to_np(tr), to_np(tst.reward_buffer), to_np(tst.reward_buffer_len), active,
                365.0, f"W {window} step {i} reward")
            counts["live"] += int(active.sum())
            counts["inactive"] += int((~active).sum())
            counts["exhausted"] += int((to_np(tst.termination_reason) == 2).sum())
            counts["wraps"] += int((active & (to_np(tst.reward_buffer_idx) == 0)).sum())
            # auto-reset half of the done envs (their ring zeroed through
            # the fresh state); the other half stay terminated
            reset = to_np(td) & auto_reset
            counts["resets"] += int(reset.sum())
            jst = jax_masked_reset(jnp.asarray(reset), jfresh, jst)
            tst = masked_reset(torch.from_numpy(reset), tfresh, tst)
            assert_bitwise(jst.reward_buffer, tst.reward_buffer, f"W {window} step {i} reset ring")
    assert counts["inactive"] > 0 and counts["exhausted"] > 0 and counts["resets"] > 0
    assert counts["wraps"] > N_ENVS  # the ring wrapped (more than W active steps)
    assert int(tst.trade_count.sum()) > N_ENVS  # the ledger trades, so returns vary
    if window == 2:
        assert counts["degenerate"] < counts["live"] // 4


def _dyadic_case(window, n=64, seed=0):
    """Ring states and equity deltas on a dyadic grid: initial cash 1,024,
    ring returns and equity deltas' differences multiples of 2^-22 below
    2^-15 (deltas in [-32, 32] x 2^-12), so every x² lies on the 2^-44
    grid below 2^-32 and every partial sum of 64 of them, and of the x,
    is exact in f32."""
    rng = np.random.default_rng(seed)
    grid = 2.0 ** -12
    buf = rng.integers(-64, 65, (n, window)) * grid / 1024.0
    length = rng.integers(0, window + 1, n).astype(np.int32)
    buf[np.arange(window)[None, :] >= length[:, None]] = 0.0  # empty slots hold 0
    idx = (length % window).astype(np.int32)
    full = length == window
    idx[full] = rng.integers(0, window, int(full.sum()))
    eq = rng.integers(-32, 33, n) * grid
    prev = rng.integers(-32, 33, n) * grid
    active = rng.random(n) < 0.8
    return buf.astype(np.float32), idx, length, eq.astype(np.float32), prev.astype(np.float32), active


@pytest.mark.parametrize("window", [2, 5, 64])
def test_ordered_sum_on_dyadic_returns_is_bitwise(window):
    buf, idx, length, eq, prev, active = _dyadic_case(window, seed=window)
    jcfg = JaxEnvConfig(reward="sharpe_reward", sharpe_window=window)
    tcfg = EnvConfig(reward="sharpe_reward", sharpe_window=window)
    config = dict(DEFAULT_VALUES, initial_cash=1024.0, annualization_factor=252.0)
    tparams = make_env_params(config, tcfg, torch.device("cpu"))
    from gymfx_tpu.core.types import make_env_params as jax_make_env_params

    with x64_off():
        jparams = jax_make_env_params(config, jcfg)
        base = jax_initial_state(jcfg)
        jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (len(eq), *x.shape)), base)
        jst = jst._replace(reward_buffer=jnp.asarray(buf), reward_buffer_idx=jnp.asarray(idx),
                           reward_buffer_len=jnp.asarray(length), equity_delta=jnp.asarray(eq),
                           prev_equity_delta=jnp.asarray(prev))
        with jax.disable_jit():
            ref_st, ref_r = jax.vmap(lambda s, a: jrewards.compute_reward(s, jcfg, jparams, a))(
                jst, jnp.asarray(active))
        tst = convert.env_state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    ours_st, ours_r = rewards.compute_reward(tst, tcfg, tparams, torch.from_numpy(active))
    assert_bitwise(ref_r, ours_r, "reward")
    for name in ("reward_buffer", "reward_buffer_idx", "reward_buffer_len"):
        assert_bitwise(getattr(ref_st, name), getattr(ours_st, name), name)
    total, total_sq = rewards.ordered_sums(ours_st.reward_buffer)
    ring = to_np(ours_st.reward_buffer).astype(np.float64)
    np.testing.assert_array_equal(to_np(total).astype(np.float64), ring.sum(1))
    np.testing.assert_array_equal(to_np(total_sq).astype(np.float64), (ring ** 2).sum(1))
    live = active & (to_np(ours_st.reward_buffer_len) >= 2)
    assert (to_np(ours_r)[live] != 0).sum() > live.sum() // 2  # the reward is not trivially 0


def test_mark_reward_sharpe_plain_is_the_step_chain():
    """K3's wrapper on the CPU is its plain version: the mark, then
    ``compute_reward`` with the ring, whose outputs are new tensors."""
    buf, idx, length, eq, prev, active = _dyadic_case(5, n=9, seed=3)
    cfg = EnvConfig(reward="sharpe_reward", sharpe_window=5)
    params = make_env_params(dict(DEFAULT_VALUES), cfg, torch.device("cpu"))
    env = Environment(dict(DEFAULT_VALUES, input_data_file=CSV, reward_plugin="sharpe_reward",
                           window=5), device="cpu")
    st, _ = tenv.reset(env.cfg, env.params, env.data, 9)
    st = st._replace(reward_buffer=torch.from_numpy(buf), reward_buffer_idx=torch.from_numpy(idx),
                     reward_buffer_len=torch.from_numpy(length), pos=torch.ones(9))
    close = torch.full((9,), 1.25)
    mark = torch.from_numpy(np.arange(9) % 3 != 0)
    live = torch.from_numpy(active[:9])
    before = st.reward_buffer.clone()
    ours_st, ours_r = env_dynamics.mark_reward(st, close, mark, live, cfg, params)
    ref_st, ref_r = env_dynamics.mark_reward_plain(st, close, mark, live, cfg, params)
    assert torch.equal(ours_r, ref_r)
    for name in ("reward_buffer", "reward_buffer_idx", "reward_buffer_len", "equity_delta"):
        assert torch.equal(getattr(ours_st, name), getattr(ref_st, name)), name
    assert torch.equal(st.reward_buffer, before)  # the input ring is left as it was
    slot = ours_st.reward_buffer[torch.arange(9), torch.from_numpy(idx).long()]
    r_norm = (ours_st.equity_delta - ours_st.prev_equity_delta) / params.initial_cash
    assert torch.equal(torch.where(live, slot, before[torch.arange(9), torch.from_numpy(idx).long()]),
                       torch.where(live, r_norm, slot))


def test_env_kernel_knob_with_the_sharpe_reward_raises_the_jax_packages_error():
    with pytest.raises(ValueError) as ours:
        EnvConfig(reward="sharpe_reward", rollout_env_kernel="on")
    with pytest.raises(ValueError) as ref:
        JaxEnvConfig(reward="sharpe_reward", rollout_env_kernel="on")
    assert str(ours.value) == str(ref.value)
    EnvConfig(reward="sharpe_reward", rollout_env_kernel="off")
    EnvConfig(reward="dd_penalized_reward", rollout_env_kernel="on")


def test_window_key_first_and_the_annualization_param():
    config = dict(DEFAULT_VALUES, reward_plugin="sharpe_reward", window=7, sharpe_window=9,
                  annualization_factor=52.0)
    cfg = make_env_config(config, n_bars=100)
    assert cfg.reward == "sharpe_reward" and cfg.sharpe_window == 7
    assert make_env_config(dict(DEFAULT_VALUES, sharpe_window=9), n_bars=100).sharpe_window == 9
    params = make_env_params(config, cfg, torch.device("cpu"))
    assert float(params.annualization_factor) == 52.0
    assert float(make_env_params(dict(DEFAULT_VALUES), cfg, torch.device("cpu"))
                 .annualization_factor) == 252.0


def test_sharpe_pointers_and_reward_codes_match_the_kernel_source():
    src = (pathlib.Path(env_dynamics.__file__).resolve().parent.parent / "csrc"
           / "env_kernels.cu").read_text()
    body = re.search(r"struct SharpeArgs \{([^}]*)\};", src).group(1)
    assert body.count(";") == env_dynamics.SHARPE_POINTERS == 7
    assert int(re.search(r"constexpr int kSharpePointers = (\d+);", src).group(1)) == 7
    codes = dict(re.findall(r"kReward(\w+) = (\d)", src))
    assert {k: int(v) for k, v in codes.items()} == {"Pnl": 0, "Dd": 1, "Sharpe": 2}
    assert env_dynamics._REWARD_CODES == {"pnl_reward": 0, "dd_penalized_reward": 1,
                                          "sharpe_reward": 2}
    ring, (slot, length) = env_dynamics.sharpe_outputs(13, 64, "cpu")
    assert ring.shape == (13, 64) and ring.dtype == torch.float32 and ring.is_contiguous()
    assert slot.dtype == length.dtype == torch.int32 and slot.shape == length.shape == (13,)
    assert length.data_ptr() == slot.data_ptr() + 13 * 4  # rows of one block


def test_sharpe_training_on_the_cpu_rewards_and_learns():
    """PPO on the sharpe reward at a small size: the reward is nonzero
    once the ATR warmup has passed, and the update is finite."""
    from gymfx_tpu_torch.config import flagship
    from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

    config = flagship.baseline_sharpe_config(CSV, num_envs=8, ppo_horizon=32, window=5,
                                             atr_period=4, policy_kwargs={"hidden": [16, 16, 16]})
    trainer = PPOTrainer(Environment(config, device="cpu"), ppo_config_from(config))
    state, metrics = trainer.train_step(trainer.init_state(0))
    assert float(metrics["nonfinite_skips"]) == 0.0 and np.isfinite(float(metrics["loss"]))
    inter, (traj, _) = trainer.rollout_phase(state)
    assert float((traj["reward"] != 0).to(torch.float32).mean()) > 0.1
    assert int(inter.env_states.reward_buffer_len.min()) == 5
