"""K7 (batched scaled windows) and the scaled-feature export against the JAX package.

* K7: its plain version (``reference_scaled_windows``, and the CPU path
  of ``batched_scaled_windows``) equals the JAX
  ``reference_scaled_windows`` and the Pallas ``batched_scaled_windows``
  in interpret mode BITWISE on seeded cases: neutral rows, NaN and +-inf
  features, a zero std, clip 0 and 10, steps at 0 and at n.  A window
  that is not a multiple of 8 is refused as the JAX function refuses it.
* Export: the .npz file ``export_scaled_features`` writes equals the one
  the JAX ``_export_scaled_features`` writes on eurusd_sample.csv with
  CLOSE and VOLUME, VOLUME binary, window 8 (the setting of
  tests/test_cli.py's export test), bitwise, and with no binary column.
  It refuses a config without feature columns and a streamed
  Environment.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.app.main import _export_scaled_features as jax_export
from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.core.runtime import Environment as JaxEnvironment
from gymfx_tpu.ops import window_zscore as jwz

from gymfx_tpu_torch.app.main import export_scaled_features
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.ops import cases, window_zscore

from test_torch_parity import assert_bitwise, x64_off

REPO = pathlib.Path(__file__).resolve().parent.parent
SAMPLE = str(REPO / "examples" / "data" / "eurusd_sample.csv")


@pytest.mark.parametrize("clip", [10.0, 0.0, 1.5])
@pytest.mark.parametrize("seed,window,f", [(0, 8, 3), (1, 16, 5), (2, 32, 1)])
def test_k7_plain_matches_jax_reference_and_pallas_interpret(seed, window, f, clip):
    feats, mean, std, neutral, steps = cases.scaled_windows_case(seed, window=window, f=f)
    t = [torch.from_numpy(x) for x in (feats, mean, std, neutral, steps)]
    before = window_zscore.batched_scaled_windows.launches
    ours = window_zscore.batched_scaled_windows(*t, window=window, clip=clip)
    plain = window_zscore.reference_scaled_windows(*t, window=window, clip=clip)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (len(steps), window, f)
    # the CPU runs the plain version: no launch
    assert window_zscore.batched_scaled_windows.launches == before
    with x64_off():
        j = [jnp.asarray(x) for x in (feats, mean, std, neutral, steps)]
        ref = jwz.reference_scaled_windows(*j, window=window, clip=clip)
        pallas = jwz.batched_scaled_windows(*j, window=window, clip=clip, interpret=True)
    assert_bitwise(ref, ours, "reference_scaled_windows")
    assert_bitwise(pallas, ours, "batched_scaled_windows interpret")
    assert_bitwise(plain, ours, "plain")
    assert np.isnan(ours.numpy()).any()  # no nan_to_num on the scaled windows


def test_k7_refuses_a_window_that_is_not_a_multiple_of_8():
    feats, mean, std, neutral, steps = cases.scaled_windows_case(window=12)
    args = [torch.from_numpy(x) for x in (feats, mean, std, neutral, steps)]
    with pytest.raises(ValueError, match="multiple of 8") as ours:
        window_zscore.batched_scaled_windows(*args, window=12)
    with x64_off(), pytest.raises(ValueError) as ref:
        jwz.batched_scaled_windows(*(jnp.asarray(x) for x in (feats, mean, std, neutral, steps)),
                                   window=12, interpret=True)
    assert str(ours.value) == str(ref.value)


def _configs(**over):
    jconfig = dict(JAX_DEFAULTS, input_data_file=SAMPLE, window_size=8, **over)
    return jconfig, dict(DEFAULT_VALUES, input_data_file=SAMPLE, window_size=8, **over)


@pytest.mark.parametrize("binary", [["VOLUME"], []])
def test_export_file_matches_jax_export(tmp_path, binary):
    jconfig, config = _configs(feature_columns=["CLOSE", "VOLUME"],
                               feature_binary_columns=binary)
    n_steps = 120
    with x64_off():
        ref_meta = jax_export(JaxEnvironment(jconfig), jconfig, n_steps, str(tmp_path / "jax.npz"))
    meta = export_scaled_features(Environment(config, device="cpu"), config, n_steps,
                                  str(tmp_path / "port.npz"))
    assert {k: meta[k] for k in ("shape", "columns")} == {k: ref_meta[k] for k in ("shape", "columns")}
    assert meta["shape"] == [n_steps, 8, 2] and set(meta["seconds"]) == {"windows", "save"}
    ref, ours = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(ours.files) == sorted(ref.files) == ["feature_columns", "scaled_windows"]
    assert_bitwise(ref["scaled_windows"], ours["scaled_windows"], "scaled_windows")
    assert list(ours["feature_columns"]) == list(ref["feature_columns"]) == ["CLOSE", "VOLUME"]


def test_export_refuses_no_features_and_a_streamed_env(tmp_path):
    _, config = _configs()
    with pytest.raises(ValueError, match="requires feature_columns"):
        export_scaled_features(Environment(config, device="cpu"), config, 10,
                               str(tmp_path / "x.npz"))
    _, config = _configs(feature_columns=["CLOSE"], stream_hbm_budget_mb=0.02)
    env = Environment(config, device="cpu")
    assert env.streaming
    with pytest.raises(ValueError, match="export_scaled_features requires the full bar history"):
        export_scaled_features(env, config, 10, str(tmp_path / "x.npz"))
