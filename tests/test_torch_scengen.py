"""The scenario generator (gymfx_tpu_torch/scengen/, K10's plain version)
against the JAX package's (gymfx_tpu/scengen/).

Small sizes: 512 bars, 1 and 3 assets (4,096 x 3 for the draws' ulp
statistics).

* Presets: the eight equal the JAX package's, field by field.
* Draws: ``draw_shocks``' uniforms are ``jax.random.uniform``'s bit for
  bit; its normals are within 3 ulp of ``jax.random.normal``'s with at
  least 90% equal (XLA's float32 ``erf_inv`` op by op against XLA's own:
  log1p and the polynomial's contractions differ in their last bits;
  ``torch.erfinv`` is a different approximation, tens of ulp away).
* ``paths_plain`` (K10's plain version, through ``paths_from_shocks`` on
  CPU tensors) on JAX's own shocks against the jitted
  ``gymfx_tpu.scengen.engine.paths_from_shocks`` for every preset x
  A in {1, 3}, with and without a weekend mask: regime and flags EXACT,
  prices within rtol 2e-6 (the JAX oracle's test allows 5e-4): XLA's
  ``exp`` and torch's differ by an ulp or two, the 3-asset Cholesky
  factor differs from JAX's in its last bit at rho = 0.85 (LAPACK's
  potrf against jaxlib's; ROADMAP Queue 3), and the log-price sum
  carries those over the bars.
* The port's NumPy oracle equals JAX's bit for bit on the same shocks,
  and holds K10's plain version to the same contract (third witness).
* ``generate``'s argument checks and messages are the JAX package's; on
  CPU tensors the K10 wrapper is the plain version and launches nothing;
  its constants and argument layout match the kernel source; a tile of
  bars fits the shared-memory budget for every asset count the kernel
  takes.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.scengen import engine as JE
from gymfx_tpu.scengen import oracle as JO
from gymfx_tpu.scengen import params as JPm
from gymfx_tpu.scengen.feed import fx_timestamp_grid as jax_grid

from gymfx_tpu_torch.lob import prng
from gymfx_tpu_torch.ops import _build
from gymfx_tpu_torch.ops import scengen_scan as k10
from gymfx_tpu_torch.scengen import engine as TE
from gymfx_tpu_torch.scengen import oracle as TO
from gymfx_tpu_torch.scengen import params as TPm

from test_torch_parity import to_np, x64_off

N_BARS = 512
PRICE_RTOL = 2e-6
PRESETS = TPm.preset_names()
PRICE_FIELDS = ("open", "high", "low", "close")


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_presets_equal_the_jax_presets_field_by_field():
    assert PRESETS == JPm.preset_names() and len(PRESETS) == 8
    for name in PRESETS:
        ours, ref = TPm.scenario_params(name), JPm.scenario_params(name)
        for field in ref._fields:
            a, b = np.asarray(getattr(ref, field)), np.asarray(getattr(ours, field))
            assert a.dtype == b.dtype and np.array_equal(a, b), f"{name} {field}"
    assert (TPm.FLAG_TREND, TPm.FLAG_DROUGHT, TPm.FLAG_CRASH, TPm.FLAG_GAP, TPm.FLAG_HIGHVOL) == (
        JPm.FLAG_TREND, JPm.FLAG_DROUGHT, JPm.FLAG_CRASH, JPm.FLAG_GAP, JPm.FLAG_HIGHVOL)
    with pytest.raises(ValueError, match="unknown scengen preset"):
        TPm.scenario_params("nope")


def test_draws_uniforms_bitwise_and_normals_within_three_ulp():
    n, a = 4096, 3
    with x64_off():
        ref = JE.draw_shocks(jax.random.PRNGKey(3), n, a)
    ours = TE.draw_shocks(prng.PRNGKey(3), n, a)
    equal_share = []
    for field in ref._fields:
        x, y = np.asarray(getattr(ref, field)), to_np(getattr(ours, field))
        assert x.shape == y.shape and y.dtype == np.float32, field
        if field.endswith("_u"):
            assert np.array_equal(x.view(np.uint32), y.view(np.uint32)), field
        else:
            ulp = _ulps(x, y)
            assert ulp.max() <= 3, f"{field}: {ulp.max()} ulp"
            equal_share.append((ulp == 0).mean())
    assert min(equal_share) >= 0.90, equal_share
    # the XLA polynomial is what makes them close: torch.erfinv is not
    u = prng.bits_to_uniform(prng.random_bits(prng.PRNGKey(3), 20000)) * 2.0 + prng._NORMAL_LO
    with x64_off():
        z = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (20000,), jnp.float32))
    assert _ulps(z, (prng._SQRT2_F32 * torch.erfinv(u)).numpy()).max() > 3
    assert _ulps(z, prng.normal(prng.PRNGKey(3), 20000).numpy()).max() <= 3


def _monday(weekend: bool):
    # hourly bars: 512 of them cross three weekends
    return jax_grid(N_BARS, 1.0)[1] if weekend else np.zeros(N_BARS, bool)


@pytest.fixture(scope="module")
def jax_shocks():
    with x64_off():
        return {a: JE.draw_shocks(jax.random.PRNGKey(11), N_BARS, a) for a in (1, 3)}


def _as_torch(shocks):
    return TE.Shocks(*(torch.from_numpy(np.array(x)) for x in shocks))


@pytest.mark.parametrize("weekend", [False, True], ids=["no_weekend", "weekend"])
@pytest.mark.parametrize("n_assets", [1, 3])
@pytest.mark.parametrize("preset", PRESETS)
def test_paths_plain_on_jax_shocks_matches_jax_paths(jax_shocks, preset, n_assets, weekend):
    shocks, monday = jax_shocks[n_assets], _monday(weekend)
    assert monday.any() == weekend
    with x64_off():
        ref = JE._paths_jit(shocks, JPm.scenario_params(preset), jnp.asarray(monday))
    before = k10.scengen_scan.launches
    ours = TE.paths_from_shocks(_as_torch(shocks), TPm.scenario_params(preset), monday)
    assert k10.scengen_scan.launches == before
    for field in ref._fields:
        x, y = np.asarray(getattr(ref, field)), to_np(getattr(ours, field))
        assert x.dtype == y.dtype and x.shape == y.shape, field
        if field in ("flags", "regime"):
            assert np.array_equal(x, y), field
        elif field in PRICE_FIELDS:
            np.testing.assert_allclose(y, x, rtol=PRICE_RTOL, atol=0, err_msg=field)
        else:  # the spread and slippage multipliers: products of the table
            assert np.array_equal(x, y), field
    flags = to_np(ours.flags)
    if weekend:
        assert (flags[monday] & TPm.FLAG_GAP).all()


def test_the_flags_cover_every_overlay_family(jax_shocks):
    """The cases above see every FLAG bit somewhere (a run over no crash,
    drought or gap bar would test nothing of those paths)."""
    seen = 0
    for preset in PRESETS:
        ours = TE.paths_from_shocks(_as_torch(jax_shocks[3]), TPm.scenario_params(preset),
                                    _monday(True))
        seen |= int(np.bitwise_or.reduce(to_np(ours.flags)))
    assert seen == 31


@pytest.mark.parametrize("n_assets", [1, 3])
def test_oracles_agree_bitwise_and_witness_the_plain_version(jax_shocks, n_assets):
    shocks, monday = jax_shocks[n_assets], _monday(True)
    for preset in ("multi_asset_stress", "trend_calm"):
        p = TPm.scenario_params(preset)
        ours = TO.oracle_paths(shocks, p, monday)
        ref = JO.oracle_paths(shocks, JPm.scenario_params(preset), monday)
        for key in ref:
            assert np.array_equal(np.asarray(ref[key]), ours[key]), f"{preset} {key}"
        plain = TE.paths_from_shocks(_as_torch(shocks), p, monday)
        for field in plain._fields:
            x = to_np(getattr(plain, field))
            if field in PRICE_FIELDS:
                np.testing.assert_allclose(x, ours[field], rtol=PRICE_RTOL, err_msg=field)
            else:
                assert np.array_equal(x, ours[field]), field


@pytest.mark.parametrize("kwargs,match", [
    (dict(n_bars=1), "n_bars >= 2"),
    (dict(n_assets=0), "n_assets >= 1"),
    (dict(corr=1.0), "corr must be in"),
    (dict(corr=-0.1), "corr must be in"),
])
def test_generate_checks_its_arguments_as_jax(kwargs, match):
    n_bars, n_assets = kwargs.get("n_bars", 8), kwargs.get("n_assets", 2)
    tp = TPm.scenario_params("regime_mix")._replace(corr=kwargs.get("corr", 0.0))
    jp = JPm.scenario_params("regime_mix")._replace(corr=kwargs.get("corr", 0.0))
    with pytest.raises(ValueError, match=match):
        TE.generate(tp, prng.PRNGKey(0), n_bars, n_assets)
    with x64_off(), pytest.raises(ValueError, match=match):
        JE.generate(jp, jax.random.PRNGKey(0), n_bars, n_assets)


def test_generate_equals_the_transform_of_its_draws():
    p = TPm.scenario_params("flash_crash")._replace(s0=np.float32([1.1, 148.0]))
    monday = jax_grid(64, 1.0)[1]
    ours = TE.generate(p, prng.PRNGKey(5), 64, 2, monday)
    ref = TE.paths_from_shocks(TE.draw_shocks(prng.PRNGKey(5), 64, 2), p, monday)
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)
    assert abs(float(ours.open[0, 1]) / 148.0 - 1) < 0.01


def test_scan_constants_and_argument_layout_match_the_kernel_source():
    sp = k10.scan_params(TPm.scenario_params("multi_asset_stress"))
    words = np.array(k10.scan_constants(sp), np.int32)
    src = _build.SOURCES["scengen"].read_text()
    assert int(re.search(r"kScanConsts = (\d+);", src).group(1)) == len(words) == 43
    assert int(re.search(r"kScanPointers = (\d+);", src).group(1)) == 18
    floats = words[:39].view(np.float32)
    assert np.array_equal(floats[:16].reshape(4, 4), sp.trans)
    assert floats[28] == np.float32(1.2) and floats[30] == np.float32(0.02) / np.float32(6)
    assert floats[31] == np.float32(np.float32(0.02) * np.float32(0.6)) / np.float32(24)
    assert words[39:].tolist() == [6, 24, 32, 0]
    assert _build.FLAGS["scengen"].count("-fmad=false") == 1
    assert not any("fast_math" in f for f in _build.FLAGS["scengen"])
    assert "scengen" in _build.KERNEL_LIBRARIES
    # two tiles of (5 + 4 A) words a bar and a tile of 3-word records fit
    # the budget for every A <= 256
    per_lane = int(re.search(r"kMaxPerLane = (\d+);", src).group(1))
    for a in (1, 4, 33, 32 * per_lane):
        tile = k10.tile_bars(a)
        assert tile >= 1 and (2 * tile * (5 + 4 * a) + 3 * tile) * 4 <= k10.SMEM_BUDGET


def test_thresholds_are_float32_partial_sums_in_order():
    sp = k10.scan_params(TPm.scenario_params("range_chop"))
    f32 = np.float32
    for row, (c0, c1, c2) in zip(sp.trans, k10.thresholds(sp)):
        assert c0 == row[0] and c1 == f32(row[0] + row[1]) and c2 == f32(f32(row[0] + row[1]) + row[2])
