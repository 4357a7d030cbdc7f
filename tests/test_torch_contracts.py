"""Execution cost profiles, instrument specs and venue quantization
(gymfx_tpu_torch/contracts.py, core/types.py) against the JAX package's
(gymfx_tpu/contracts.py, gymfx_tpu/core/types.py).

* ``ExecutionCostProfile.from_dict``: equal fields and derived rates for
  valid profiles; for every bad profile of the JAX package's
  tests/test_contracts.py the same exception type and message.
* ``instrument_spec_from_config``: equal specs (and equal errors) over
  instrument names, JPY precision and the config keys.
* The profile's effect on ``make_env_config`` / ``make_env_params`` and
  ``venue_quantization``'s tick, size step and minimum quantity: every
  static field equal, every param bitwise (float32 values from the same
  Python floats; tolerance 0).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

from gymfx_tpu import contracts as JC
from gymfx_tpu.core import types as JT
from gymfx_tpu_torch import contracts as TC
from gymfx_tpu_torch.core import types as TT

PROFILES = "examples/configs/execution_cost_profiles"


def _valid_raw(**overrides):
    raw = {
        "schema_version": "execution_cost_profile.v1",
        "profile_id": "test.profile",
        "commission_rate_per_side": 0.00002,
        "full_spread_rate": 0.0001,
        "slippage_bps_per_side": 0.5,
        "latency_ms": 5,
        "financing_enabled": False,
        "intrabar_collision_policy": "worst_case",
        "limit_fill_policy": "conservative",
        "margin_model": "leveraged",
        "enforce_margin_preflight": True,
        "random_seed": 7,
    }
    raw.update(overrides)
    return raw


def _missing(field):
    raw = _valid_raw()
    del raw[field]
    return raw


@pytest.mark.parametrize("raw", [
    _valid_raw(),
    _valid_raw(financing_enabled=1, enforce_margin_preflight=0, latency_ms="12"),
    _valid_raw(intrabar_collision_policy="ohlc", limit_fill_policy="touch",
               margin_model="standard", random_seed="3"),
    _valid_raw(full_spread_rate=0.0, slippage_bps_per_side=0, commission_rate_per_side="1e-5"),
], ids=["default", "coerced", "policies", "zeros"])
def test_valid_profiles_parse_to_equal_fields(raw):
    ours, want = TC.ExecutionCostProfile.from_dict(raw), JC.ExecutionCostProfile.from_dict(raw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)
    assert ours.slippage_rate_per_side == want.slippage_rate_per_side
    assert ours.quote_adverse_rate_per_side == want.quote_adverse_rate_per_side


@pytest.mark.parametrize("raw", [
    _missing("latency_ms"),
    _valid_raw(schema_version="v2"),
    _valid_raw(commission_rate_per_side=-0.1),
    _valid_raw(full_spread_rate=1.5),
    _valid_raw(latency_ms=-1),
    _valid_raw(intrabar_collision_policy="magic"),
    _valid_raw(limit_fill_policy="magic"),
    _valid_raw(margin_model="magic"),
    _valid_raw(slippage_bps_per_side=float("nan")),
    _valid_raw(commission_rate_per_side="abc"),
    _valid_raw(slippage_bps_per_side=float("inf")),
], ids=["missing", "schema", "negative-commission", "spread", "latency", "collision",
        "limit", "margin", "nan", "not-numeric", "inf"])
def test_bad_profiles_raise_the_jax_error(raw):
    with pytest.raises(ValueError) as want:
        JC.ExecutionCostProfile.from_dict(raw)
    with pytest.raises(ValueError) as ours:
        TC.ExecutionCostProfile.from_dict(raw)
    assert str(ours.value) == str(want.value)


@pytest.mark.parametrize("name", ["pessimistic_v1", "legacy_v1"])
def test_shipped_profiles_load_equal(name):
    path = f"{PROFILES}/{name}.json"
    assert dataclasses.asdict(TC.load_execution_cost_profile(path)) == \
        dataclasses.asdict(JC.load_execution_cost_profile(path))


def test_a_profile_file_that_is_not_an_object_raises(tmp_path):
    path = tmp_path / "p.json"
    path.write_text(json.dumps([1, 2]))
    with pytest.raises(ValueError, match="JSON object"):
        TC.load_execution_cost_profile(path)


@pytest.mark.parametrize("config", [
    {},
    {"instrument": "USD_JPY"},
    {"instrument": "GBP/USD", "simulation_venue": "OANDA", "price_precision": 4,
     "size_precision": 2, "margin_init": 0.03, "margin_maint": 0.01, "min_quantity": 1000,
     "lot_size": None},
    {"instrument": "EUR_USD", "lot_size": 100000},
])
def test_instrument_spec_from_config_matches(config):
    ours, want = TC.instrument_spec_from_config(config), JC.instrument_spec_from_config(config)
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)
    assert ours.instrument_id == want.instrument_id


def test_instrument_spec_without_a_quote_currency_raises_the_jax_error():
    with pytest.raises(ValueError) as want:
        JC.instrument_spec_from_config({"instrument": "EURUSD"})
    with pytest.raises(ValueError) as ours:
        TC.instrument_spec_from_config({"instrument": "EURUSD"})
    assert str(ours.value) == str(want.value)


_STATIC = ("intrabar_collision_policy", "limit_fill_policy", "margin_model",
           "financing_enabled", "enforce_margin_preflight", "enforce_margin_closeout")


@pytest.mark.parametrize("config", [
    {"execution_cost_profile": f"{PROFILES}/pessimistic_v1.json"},
    {"execution_cost_profile": f"{PROFILES}/legacy_v1.json", "commission": 0.5},
    {"execution_cost_profile": _valid_raw(), "limit_fill_policy": "cross",
     "enforce_margin_closeout": False},
    {"commission": 2e-5, "slippage_perc": 1e-5, "margin_model": "standard"},
    {"venue_quantization": True},
    {"venue_quantization": True, "instrument": "USD_JPY", "size_precision": 2,
     "min_quantity": 10},
    {"venue_quantization": True, "execution_cost_profile": f"{PROFILES}/pessimistic_v1.json"},
], ids=["pessimistic", "legacy-over", "dict", "no-profile", "quantized", "quantized-jpy",
        "quantized-profile"])
def test_profile_and_quantization_bind_as_the_jax_package_binds(config):
    with jax.enable_x64(False):
        jcfg = JT.make_env_config(config, n_bars=100)
        jpar = JT.make_env_params(config, jcfg)
    tcfg = TT.make_env_config(config, n_bars=100)
    tpar = TT.make_env_params(config, tcfg, "cpu")
    for field in _STATIC:
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    for field in TT.EnvParams._fields:
        want = np.asarray(getattr(jpar, field))
        got = getattr(tpar, field).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), field
