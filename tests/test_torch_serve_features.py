"""The port's serving featurizer (gymfx_tpu_torch/serve/features.py)
against the JAX package's (gymfx_tpu/serve/features.py) and the port's
own env, on the CPU.

The bit-identity contract: replaying a bar stream through the port's
``BarSession`` gives, bar by bar and bitwise, the JAX package's
``BarSession.obs`` and the port's training env's observation
(``core/obs.build_obs``, K1's plain version on the CPU): under
``none``, ``rolling_zscore`` and ``expanding_zscore``, with a binary
passthrough column, at the flagship config's OHLCV columns, and with no
feature columns.  Replay alignment is the env's: reset consumes bar 0,
the first step is the no-advance warm-up, every later step advances one
bar.  Also the refused obs blocks, the session's input checks,
``scale_feature_window_host`` against the JAX package's host and device
scalings and the port's plain version on NaN, ±inf, masks, neutral rows
and clips, and the host encoders against the device encoders.
"""
import dataclasses

import numpy as np
import pytest
import torch

from gymfx_tpu.core import env as jax_env_core
from gymfx_tpu.core.obs import scale_feature_window as jax_scale
from gymfx_tpu.core.obs import scale_feature_window_host as jax_scale_host
from gymfx_tpu.serve.features import BarFeaturizer as JaxFeaturizer
from gymfx_tpu.serve.features import make_host_encoder as jax_host_encoder

from gymfx_tpu_torch.core import env as env_core
from gymfx_tpu_torch.core.obs import scale_feature_window_host
from gymfx_tpu_torch.ops.window_zscore import scale_feature_window
from gymfx_tpu_torch.serve import BarFeaturizer, make_host_encoder
from gymfx_tpu_torch.train.policies import make_obs_encoder, make_obs_spec

from test_torch_parity import assert_bitwise, paired_envs, random_walk_columns, x64_off


def _columns(n=40, seed=3):
    rng = np.random.default_rng(seed)
    cols = random_walk_columns(n=n, seed=seed)
    cols["f1"] = rng.standard_normal(n) * 3.0 + 1.0
    cols["f2"] = np.abs(rng.standard_normal(n)) * 50.0
    cols["b1"] = (rng.random(n) > 0.5).astype(np.float64)
    return cols


def _assert_obs_bitwise(want, got, where):
    assert set(want) == set(got), (where, set(want) ^ set(got))
    for k in want:
        assert_bitwise(got[k], want[k], f"{where} {k}")


def _replay(cols, feature_columns, n_steps=None, **over):
    """The JAX env, the port's env and both featurizers off one bar
    stream (hold actions): every published obs bitwise alike."""
    jax_env, env = paired_envs(cols, feature_columns=list(feature_columns), **over)
    closes = np.asarray(cols["CLOSE"], np.float64)
    raw = (np.stack([np.asarray(cols[c], np.float64) for c in feature_columns], axis=1)
           if feature_columns else None)
    cfg, n = env.cfg, env.cfg.n_bars
    n_steps = n - 1 if n_steps is None else n_steps
    sess = BarFeaturizer.from_environment(env).new_session()
    with x64_off():
        jsess = JaxFeaturizer.from_environment(jax_env).new_session()
    state, obs = env_core.reset(cfg, env.params, env.data)
    hold = torch.zeros(1, dtype=torch.int32)
    for k in range(-1, n_steps):
        if k >= 0:
            state, obs, _r, _done, _info = env_core.step(cfg, env.params, env.data, state, hold)
        if k != 0:  # reset consumes bar 0; step 0 is the warm-up; step k >= 1 is bar k
            bar = max(k, 0)
            row = raw[bar] if raw is not None else None
            sess.push(closes[bar], row)
            jsess.push(closes[bar], row)
        served = sess.obs(total_bars=n)
        with x64_off():
            jserved = jsess.obs(total_bars=n)
        _assert_obs_bitwise(jserved, served, f"JAX featurizer, step {k}")
        _assert_obs_bitwise({key: v[0] for key, v in obs.items()}, served, f"env, step {k}")
    return env, jax_env


@pytest.mark.parametrize("scaling", ["none", "rolling_zscore", "expanding_zscore"])
def test_replay_is_bitwise_the_jax_featurizer_and_the_env(scaling):
    _replay(_columns(), ["f1", "f2", "b1"], feature_binary_columns=["b1"],
            feature_scaling=scaling, feature_scaling_window=6, window_size=4)


def test_replay_at_the_flagship_ohlcv_columns():
    _replay(_columns(n=72, seed=5), ["OPEN", "HIGH", "LOW", "CLOSE", "VOLUME"],
            feature_scaling="rolling_zscore", window_size=32)


def test_price_only_replay_is_bitwise():
    _replay(_columns(seed=11), [], window_size=4)


def test_agent_state_scalars_follow_the_broker_state():
    cols = _columns(seed=13)
    jax_env, env = paired_envs(cols, feature_columns=["f1"], window_size=4)
    sess = BarFeaturizer.from_environment(env).new_session()
    with x64_off():
        jsess = JaxFeaturizer.from_environment(jax_env).new_session()
    for i in range(6):
        sess.push(cols["CLOSE"][i], [cols["f1"][i]])
        jsess.push(cols["CLOSE"][i], [cols["f1"][i]])
    for pos, eq, total in ((1.0, 12.5, 0), (-3.0, -7.25, 40), (0.0, 0.0, 3)):
        got = sess.obs(pos_sign=pos, equity_delta=eq, total_bars=total)
        with x64_off():
            want = jsess.obs(pos_sign=pos, equity_delta=eq, total_bars=total)
        _assert_obs_bitwise(want, got, f"agent state {pos, eq, total}")


def test_unsupported_obs_blocks_are_rejected_at_boot():
    _jax_env, env = paired_envs(_columns(), feature_columns=["f1"], window_size=4)
    for block in ("stage_b_force_close_obs", "oanda_fx_calendar_obs"):
        cfg = dataclasses.replace(env.cfg, **{block: True})
        with pytest.raises(ValueError, match=block):
            BarFeaturizer(cfg, env.params)
    with pytest.raises(ValueError, match="feature_scaling"):
        BarFeaturizer(env.cfg, env.params, feature_scaling="minmax")


def test_session_input_validation():
    _jax_env, env = paired_envs(_columns(), feature_columns=["f1", "f2", "b1"],
                                feature_binary_columns=["b1"], window_size=4)
    sess = BarFeaturizer.from_environment(env).new_session()
    with pytest.raises(ValueError, match="no bars"):
        sess.obs()
    with pytest.raises(ValueError, match="feature columns"):
        sess.push(1.1)
    with pytest.raises(ValueError, match="expected 3"):
        sess.push(1.1, [1.0, 2.0])


SCALE_CASES = [((), False, 10.0), ((False, True, False, False), True, 10.0),
               ((False, True, False, True), False, 0.0), ((), False, 1.5),
               ((True, False, False, False), False, -2.0)]


@pytest.mark.parametrize("mask,neutral,clip", SCALE_CASES)
def test_host_scaling_twin_is_bitwise_every_scaling(mask, neutral, clip):
    rng = np.random.default_rng(0)
    win = rng.standard_normal((5, 4)).astype(np.float32) * 100.0
    win[0, 1], win[2, 3], win[4, 0], win[3, 2] = np.nan, np.inf, -np.inf, 1e-30
    mean = rng.standard_normal(4).astype(np.float32)
    std = (np.abs(rng.standard_normal(4)) + 0.1).astype(np.float32)
    std[2] = 0.0  # a zero std: x / 0 = ±inf or NaN, then clipped and cleaned
    _jax_env, env = paired_envs(_columns(), feature_columns=["f1"], window_size=4)
    cfg = dataclasses.replace(env.cfg, binary_mask=mask, n_features=4, feature_clip=clip)
    host = scale_feature_window_host(win, mean, std, neutral, cfg)
    assert host.dtype == np.float32 and host.shape == (5, 4)
    with x64_off():
        jcfg = dataclasses.replace(_jax_env.cfg, binary_mask=mask, n_features=4,
                                   feature_clip=clip)
        assert_bitwise(host, jax_scale_host(win, mean, std, neutral, jcfg), "JAX host twin")
        assert_bitwise(host, np.asarray(jax_scale(win, mean, std, neutral, jcfg)), "JAX device")
    plain = scale_feature_window(torch.from_numpy(win)[None], torch.from_numpy(mean)[None],
                                 torch.from_numpy(std)[None], torch.tensor([neutral]),
                                 binary_mask=mask, clip=clip)
    assert_bitwise(host, plain[0], "the port's plain version (K1's)")


@pytest.mark.parametrize("name", ["mlp", "lstm", "transformer_ring"])
def test_host_encoder_matches_the_device_encoder_and_the_jax_host_encoder(name):
    jax_env, env = paired_envs(_columns(), feature_columns=["f1", "f2", "b1"],
                               feature_binary_columns=["b1"], window_size=4)
    _state, obs = env_core.reset(env.cfg, env.params, env.data)
    spec = make_obs_spec(obs)
    dev = make_obs_encoder(name, env.cfg.window_size, spec)(obs)[0]
    one = {k: v[0].numpy() for k, v in obs.items()}
    host = make_host_encoder(name, env.cfg.window_size, spec)(one)
    assert host.dtype == np.float32 and tuple(host.shape) == tuple(dev.shape)
    assert_bitwise(host, dev, f"{name} host vs device encoder")
    with x64_off():
        from gymfx_tpu.train.policies import make_obs_spec as jax_make_obs_spec

        _js, jobs = jax_env_core.reset(jax_env.cfg, jax_env.params, jax_env.data)
        jhost = jax_host_encoder(name, jax_env.cfg.window_size, jax_make_obs_spec(jobs))(
            {k: np.asarray(v) for k, v in jobs.items()})
    assert_bitwise(host, jhost, f"{name} host encoder vs JAX's")
