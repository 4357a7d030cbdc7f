"""K7 (batched scaled windows) and the scaled-feature export against the JAX package.

* K7: its plain version (``reference_scaled_windows``, and the CPU path
  of ``batched_scaled_windows``) equals the JAX
  ``reference_scaled_windows`` and the Pallas ``batched_scaled_windows``
  in interpret mode BITWISE on seeded cases: neutral rows, NaN and +-inf
  features, a zero std, clip 0 and 10, steps at 0 and at n, and the
  export's steps 1..n at 1,000 x 32 x 5.  A window that is not a
  multiple of 8 is refused as the JAX function refuses it.
* K7's tiling: the CPU model of its kernel (``ops/cases.
  scaled_windows_tiling``) covers each output element once with its
  step, window row and feature, and stages its windows from the right
  floats, at F 1, 3, 5, 7 and W 8, 32, 64 for the export's, random and
  clamped steps; walked by ``scaled_windows_emulated`` it equals the
  plain version BITWISE; the launch plan fits shared memory and spreads
  tiles evenly.
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


@pytest.mark.parametrize("clip", [10.0, 0.0])
def test_k7_plain_matches_jax_reference_and_pallas_interpret_on_the_exports_steps(clip):
    # the export's pattern: steps 1..n, every window inside the tape
    feats, mean, std, neutral, steps = cases.scaled_windows_case(3, n=1000, window=32, f=5,
                                                                 steps="export")
    assert np.array_equal(steps, np.arange(1, 1001))
    ours = window_zscore.batched_scaled_windows(*(torch.from_numpy(x) for x in
                                                  (feats, mean, std, neutral, steps)),
                                                window=32, clip=clip)
    assert tuple(ours.shape) == (1000, 32, 5)
    with x64_off():
        j = [jnp.asarray(x) for x in (feats, mean, std, neutral, steps)]
        ref = jwz.reference_scaled_windows(*j, window=32, clip=clip)
        pallas = jwz.batched_scaled_windows(*j, window=32, clip=clip, interpret=True)
    assert_bitwise(ref, ours, "reference_scaled_windows")
    assert_bitwise(pallas, ours, "batched_scaled_windows interpret")


# ---------------------------------------------------------------- K7's tiling
# (csrc/data_kernels.cu scaled_windows_kernel; the CPU model
# ops/cases.scaled_windows_tiling)
K7_SHAPES = [(w, f) for w in (8, 32, 64) for f in (1, 3, 5, 7)]


def _k7_launches(w, f):
    """(tile, grid, span floats, input offset) cases: the launch plan's
    tile over 132 SMs at 5 CTAs each, staged tiles of 8 and of 5 (ragged
    against every batch here) on fewer CTAs than tiles, the plan's tile
    unstaged, with the features 0-3 floats past a 16-byte boundary."""
    tile, span, _ = window_zscore.scaled_windows_tile(w, f)
    return [(tile, 660, span, 0), (8, 3, window_zscore.scaled_windows_buffer(8, w, f, True)[0], 1),
            (5, 2, window_zscore.scaled_windows_buffer(5, w, f, True)[0], 3), (tile, 1, 0, 2)]


@pytest.mark.parametrize("steps", cases.K7_STEP_PATTERNS)
@pytest.mark.parametrize("w,f", K7_SHAPES, ids=str)
def test_scaled_windows_tiling_covers_each_element_once_with_its_step_row_and_feature(w, f, steps):
    feats, mean, _, _, drawn = cases.scaled_windows_case(w + f, n=300, window=w, f=f, steps=steps)
    rows, m, b = feats.shape[0], mean.shape[0], drawn.size
    start = np.clip(drawn.astype(np.int64), 0, rows - w)
    row = np.clip(drawn.astype(np.int64), 0, m - 1)
    for tile, grid, span, offset in _k7_launches(w, f):
        t = cases.scaled_windows_tiling(drawn, rows, m, w, f, tile, grid, window_zscore.K7_THREADS,
                                        span, offset)
        idx, step = t["index"], t["step"]
        assert np.array_equal(np.sort(idx), np.arange(b * w * f))  # each element once
        assert np.array_equal(step, idx // (w * f))
        assert np.array_equal(t["feature"], idx % f)
        # the window row and feature it scales, the moments and flag of its step
        assert np.array_equal(t["src"], (start[step] + (idx // f) % w) * f + idx % f)
        assert np.array_equal(t["moment"], row[step] * f + idx % f)
        assert np.array_equal(t["flag"], row[step])
        assert (t["thread"] < window_zscore.K7_THREADS).all() and (t["cta"] < grid).all()
        assert np.array_equal(t["cta"] + grid * t["turn"], step // tile)  # tile k: CTA k % grid
        # each float4 store holds four neighbouring elements, and neighbouring
        # threads store neighbouring float4s of their tile
        assert np.array_equal(idx, 4 * t["quad"] + t["lane"])
        assert np.array_equal(t["thread"], (t["quad"] - (step // tile) * tile * w * f // 4)
                              % window_zscore.K7_THREADS)
        staged = t["span"] >= 0
        if steps == "export" and span:
            assert staged.all()  # every tile's windows run consecutively
        if steps == "random":
            assert not staged.any()
        if not staged.any():
            continue
        # the staged copies: each span float once, from the right feature,
        # 16-byte pieces aligned on both sides, and every staged element
        # reads the float of padded_features it scales
        dst, src, size = t["copy_dst"], t["copy_src"], t["copy_bytes"]
        assert np.unique(dst).size == dst.size
        assert ((dst % span) < span).all() and (dst // span < -(-b // tile)).all()
        wide = size == 16
        assert ((dst[wide] % 4 == 0) == ((offset + src[wide]) % 4 == 0)).all()
        pieces = dst[wide].reshape(-1, 4)
        assert (pieces[:, 0] % 4 == 0).all() and (np.diff(pieces, axis=1) == 1).all()
        assert ((offset + src[wide].reshape(-1, 4)[:, 0]) % 4 == 0).all()
        copied = dict(zip(dst.tolist(), src.tolist()))
        assert [copied[k] for k in t["span"][staged].tolist()] == t["src"][staged].tolist()


@pytest.mark.parametrize("clip", [10.0, 0.0, 1.5])
@pytest.mark.parametrize("steps", cases.K7_STEP_PATTERNS)
@pytest.mark.parametrize("w,f", [(8, 1), (32, 5), (64, 7), (32, 3)], ids=str)
def test_scaled_windows_emulated_tiling_equals_plain(w, f, steps, clip):
    feats, mean, std, neutral, drawn = cases.scaled_windows_case(7 * w + f, window=w, f=f,
                                                                 steps=steps)
    ref = window_zscore.reference_scaled_windows(
        *(torch.from_numpy(x) for x in (feats, mean, std, neutral, drawn)), window=w, clip=clip)
    for tile, grid, span, offset in _k7_launches(w, f):
        t = cases.scaled_windows_tiling(drawn, feats.shape[0], mean.shape[0], w, f, tile, grid,
                                        window_zscore.K7_THREADS, span, offset)
        ours = cases.scaled_windows_emulated(feats, mean, std, neutral, clip, t, drawn.size, w,
                                             max(span, 1))
        assert_bitwise(ref, torch.from_numpy(ours), f"tile {tile}, span {span}, offset {offset}")


@pytest.mark.parametrize("f", [3, 5])
def test_scaled_windows_turn_steps_alternate_staged_and_unstaged_tiles(f):
    # each CTA walks a staged tile, an unstaged one, a staged one (the
    # features 1 float past alignment, so the span's lead changes per tile)
    feats, mean, std, neutral, _ = cases.scaled_windows_case(f, n=300, window=32, f=f)
    tile, grid = 8, 3
    span = window_zscore.scaled_windows_buffer(tile, 32, f, True)[0]
    drawn = cases.scaled_windows_turn_steps(300, tile, grid, seed=f)
    t = cases.scaled_windows_tiling(drawn, feats.shape[0], mean.shape[0], 32, f, tile, grid,
                                    window_zscore.K7_THREADS, span, 1)
    assert np.array_equal(t["span"] >= 0, t["turn"] % 2 == 0) and t["turn"].max() >= 2
    ref = window_zscore.reference_scaled_windows(
        *(torch.from_numpy(x) for x in (feats, mean, std, neutral, drawn)), window=32, clip=10.0)
    ours = cases.scaled_windows_emulated(feats, mean, std, neutral, 10.0, t, drawn.size, 32, span)
    assert_bitwise(ref, torch.from_numpy(ours), "turns")


def test_scaled_windows_plan_fits_shared_memory_and_spreads_tiles_evenly():
    threads, limit = window_zscore.K7_THREADS, window_zscore.K7_SMEM_LIMIT
    # the export's shape: the largest tile, its windows staged
    assert window_zscore.scaled_windows_tile(32, 5)[:2] == (256, 1440)
    for w, f in K7_SHAPES + [(1024, 5), (4096, 5), (32, 64), (8, 2000)]:
        tile, span, size = window_zscore.scaled_windows_tile(w, f)
        assert tile <= threads and 2 * size <= limit and size % 16 == 0
        assert (span, size) == window_zscore.scaled_windows_buffer(tile, w, f, span > 0)
        if span:
            assert tile >= window_zscore.K7_MIN_STAGED_TILE and span >= 3 + (tile + w - 1) * f
    assert window_zscore.scaled_windows_tile(4096, 5)[1] == 0  # a window too long to stage
    with pytest.raises(ValueError, match="features"):
        window_zscore.scaled_windows_tile(8, 4000)
    for b, tile in [(262143, 256), (262143, 64), (1000, 64), (1, 256), (5000, 8)]:
        tiles, grid = window_zscore.scaled_windows_grid(b, tile, 132, 5)
        assert tiles == -(-b // tile) and 1 <= grid <= min(tiles, 660)
        rounds = -(-tiles // grid)
        assert tiles > (rounds - 1) * grid and rounds == -(-tiles // 660)  # no CTA idles a round
    assert window_zscore.scaled_windows_grid(262143, 256, 132, 5) == (1024, 512)


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
