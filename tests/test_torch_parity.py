"""Shared parity helpers for the PyTorch port's tests, and their own tests.

The port (``gymfx_tpu_torch``) is held against the JAX package on the
same inputs, made from a seed with numpy:

* the JAX side runs under ``jax.enable_x64(False)`` — the suite turns
  x64 on globally (tests/conftest.py), and under x64 ``broker.quantize``
  rounds in f64, which the f32 port does not;
* data crosses between the two as numpy arrays (``to_np``,
  ``gymfx_tpu_torch.convert``);
* ``assert_bitwise`` compares the bits of two arrays (float arrays by
  their integer view; NaN matches NaN of any payload) — the pin for
  MarketData, the kernels' plain versions and the per-step env.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.core.runtime import Environment as JaxEnvironment
from gymfx_tpu.data.feed import MarketDataset as JaxDataset
from gymfx_tpu.train.common import masked_reset as jax_masked_reset

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.data.feed import Frame, MarketDataset
from gymfx_tpu_torch.train.common import masked_reset


def x64_off():
    """The JAX reference's f32 mode (see the module docstring)."""
    return jax.enable_x64(False)


def to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    return np.asarray(x)


def assert_bitwise(a, b, label=""):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, f"{label}: shape {a.shape} != {b.shape}"
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        assert a.dtype == b.dtype, f"{label}: dtype {a.dtype} != {b.dtype}"
        ints = {4: np.uint32, 8: np.uint64, 2: np.uint16}[a.dtype.itemsize]
        same = (a.view(ints) == b.view(ints)) | (np.isnan(a) & np.isnan(b))
        if not same.all():
            idx = np.argwhere(~same)[:5]
            raise AssertionError(
                f"{label}: {int((~same).sum())} of {a.size} differ in bits, "
                f"first at {idx.tolist()}: {a[tuple(idx[0])]!r} vs {b[tuple(idx[0])]!r}"
            )
    else:
        np.testing.assert_array_equal(a, b, err_msg=label)


def assert_state_bitwise(jax_state, torch_state, label=""):
    for name in torch_state._fields:
        assert_bitwise(getattr(jax_state, name), getattr(torch_state, name), f"{label} {name}")


def random_walk_columns(n=240, seed=3, spread=2e-4):
    """OHLCV columns of a seeded random walk with wide enough bars for
    brackets to trigger."""
    rng = np.random.default_rng(seed)
    closes = 1.1 * np.exp(np.cumsum(rng.normal(0, 3e-4, n)))
    opens = np.concatenate([[closes[0]], closes[:-1]]) * (1 + rng.normal(0, 1e-4, n))
    wick = np.abs(rng.normal(0, spread, n)) + 5e-5
    return {
        "OPEN": opens,
        "HIGH": np.maximum(opens, closes) + wick,
        "LOW": np.minimum(opens, closes) - wick,
        "CLOSE": closes,
        "VOLUME": rng.integers(1, 2000, n).astype(np.float64),
    }


def paired_envs(columns, start="2024-01-01", freq="1min", **over):
    """(JAX Environment, port Environment on the CPU) over the same
    columns, timestamps and config overrides."""
    n = len(columns["CLOSE"])
    index = pd.date_range(start, periods=n, freq=freq)
    df = pd.DataFrame(dict(columns), index=pd.DatetimeIndex(index, name="DATE_TIME"))
    config = dict(JAX_DEFAULTS)
    config.update(timeframe="M1", **over)
    jax_env = JaxEnvironment(config, dataset=JaxDataset(df, config))
    tconfig = dict(DEFAULT_VALUES)
    tconfig.update(timeframe="M1", **over)
    frame = Frame(
        {k: np.asarray(v, np.float64) for k, v in columns.items()},
        index.to_numpy().astype("datetime64[us]"),
    )
    torch_env = Environment(tconfig, dataset=MarketDataset(frame, tconfig), device="cpu")
    return jax_env, torch_env


def test_assert_bitwise_sees_one_ulp():
    a = np.float32([1.0, 2.0])
    b = np.nextafter(a, np.float32(3.0))
    assert_bitwise(a, a.copy())
    assert_bitwise(np.float32([np.nan]), np.float32([-np.nan]))
    with pytest.raises(AssertionError, match="differ in bits"):
        assert_bitwise(a, b)


def test_paired_envs_share_market_data_bitwise():
    jax_env, torch_env = paired_envs(random_walk_columns(), window_size=8,
                                     feature_columns=["CLOSE", "VOLUME"])
    for name in torch_env.data._fields:
        if name == "row0":
            continue
        assert_bitwise(getattr(jax_env.data, name), getattr(torch_env.data, name), name)


def test_convert_env_state_round_trip():
    jax_env, torch_env = paired_envs(random_walk_columns(), window_size=8)
    with x64_off():
        st, _ = jax_env.reset()
    batched = jax.tree.map(lambda x: jnp.broadcast_to(x, (3, *x.shape)), st)
    ours = convert.env_state_from_numpy(jax.tree.map(np.asarray, batched), device="cpu")
    assert_state_bitwise(batched, ours, "converted")
    ref, _ = torch_env.reset(3)
    assert_state_bitwise(batched, ref, "port reset")


def test_masked_reset_matches_jax():
    rng = np.random.default_rng(0)
    done = rng.random(6) < 0.5
    fresh = rng.normal(size=(1, 4)).astype(np.float32)
    cur = rng.normal(size=(6, 4)).astype(np.float32)
    ref = jax_masked_reset(jnp.asarray(done), jnp.asarray(fresh[0]), jnp.asarray(cur))
    ours = masked_reset(torch.from_numpy(done), torch.from_numpy(fresh), torch.from_numpy(cur))
    assert_bitwise(ref, ours, "masked_reset")


def test_convert_market_data_round_trip():
    jax_env, torch_env = paired_envs(random_walk_columns(), window_size=8,
                                     feature_columns=["CLOSE", "VOLUME"])
    ours = convert.market_data_from_numpy(jax.tree.map(np.asarray, jax_env.data), device="cpu")
    for name in ours._fields:
        if name != "row0":
            assert_bitwise(getattr(torch_env.data, name), getattr(ours, name), name)
    assert ours.row0 == 0
