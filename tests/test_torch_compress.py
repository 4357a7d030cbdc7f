"""The port's compressed tapes (data/compress.py) and K6 against the JAX package.

* Encode: the port's encoder gives the JAX ``CompressedTape`` BITWISE —
  the same ``columns`` tuple and equal slabs, bases, raws, tables and
  starts — on every bar CSV in examples/data, on a regular M1 grid of
  three FX trading weeks (the grid reaches the ``iperiodic`` codec and
  the packed ``bits``), on a gap-y grid (the ``periodic`` minute-of-week
  codec), and over a multi-shard plan.  An off-grid tape and a tape
  wider than int16 within a shard raise the JAX package's ValueError.
* K6: its plain version equals the JAX ``decode_q16_ref`` and the
  Pallas ``decode_q16_block`` in interpret mode bitwise on seeded
  blocks (int16 extremes, divisors 1, 60, 1440, f32(1e5), a ragged row
  count).
* Decode: each shard's decode, through the plain oracle and through the
  K6 path, equals the JAX ``decode_shard_ref`` field by field, and
  equals the uncompressed shard (``shard_market_data``).
* Accounting: ``market_data_nbytes`` counts what the JAX one counts
  (``row0`` as a 4-byte int32), so byte plans match.
"""
import pathlib

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.data import compress as JC
from gymfx_tpu.data.feed import MarketDataset as JaxDataset
from gymfx_tpu.data.feed import market_data_nbytes as jax_nbytes
from gymfx_tpu.data.feed import load_market_dataset as jax_load
from gymfx_tpu.ops.tape_decode import decode_q16_block as pallas_decode

from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.data import compress as C
from gymfx_tpu_torch.data.feed import (
    Frame,
    MarketDataset,
    load_market_dataset,
    market_data_nbytes,
    shard_market_data,
)
from gymfx_tpu_torch.ops import cases, tape_decode

from test_torch_parity import assert_bitwise, x64_off

REPO = pathlib.Path(__file__).resolve().parent.parent
BAR_FILES = sorted(p for p in (REPO / "examples" / "data").glob("*.csv")
                   if "rollover" not in p.name)
OHLCV = ["OPEN", "HIGH", "LOW", "CLOSE", "VOLUME"]
WINDOW = 16


def paired_hosts(columns, timestamps, window=WINDOW, features=("CLOSE", "VOLUME")):
    """(JAX host MarketData, port host MarketData) of the same columns."""
    df = pd.DataFrame(dict(columns), index=pd.DatetimeIndex(timestamps, name="DATE_TIME"))
    config = dict(JAX_DEFAULTS, timeframe="M1")
    jax_host = JaxDataset(df, config).build_market_data(
        window_size=window, feature_columns=list(features), device=False)
    frame = Frame({k: np.asarray(v, np.float64) for k, v in columns.items()},
                  np.asarray(timestamps).astype("datetime64[us]"))
    host = MarketDataset(frame, dict(DEFAULT_VALUES, timeframe="M1")).build_market_data(
        window_size=window, device=None, feature_columns=list(features))
    return jax_host, host


def grid_hosts(n=3 * 7200, seed=4, **kw):
    return paired_hosts(cases.tick_walk_columns(n, seed), cases.m1_week_grid(n), **kw)


def assert_tapes_equal(ref, ours):
    assert ours.columns == ref.columns
    for group in ("slabs", "bases", "raws", "tables"):
        a, b = getattr(ref, group), getattr(ours, group)
        assert len(a) == len(b), group
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bitwise(np.asarray(x), np.asarray(y), f"{group}[{i}]")
    assert_bitwise(np.asarray(ref.starts), np.asarray(ours.starts), "starts")
    for key in ("shard_bars", "window_size", "n_bars", "decoded_shard_nbytes", "nbytes"):
        assert getattr(ours, key) == getattr(ref, key), key
    assert ours.codec_report() == ref.codec_report()


@pytest.mark.parametrize("path", BAR_FILES, ids=lambda p: p.name)
def test_encode_tape_matches_jax_on_example_csvs(path):
    config = dict(JAX_DEFAULTS, input_data_file=str(path))
    kw = dict(window_size=WINDOW, feature_columns=OHLCV)
    jax_host = jax_load(config).build_market_data(device=False, **kw)
    host = load_market_dataset(config).build_market_data(device=None, **kw)
    assert market_data_nbytes(host) == jax_nbytes(jax_host)
    try:
        ref = JC.encode_tape(jax_host, window_size=WINDOW, tick_size=1e-5)
    except ValueError as e:
        # an off-grid CSV: the same refusal, word for word
        with pytest.raises(ValueError) as ours:
            C.encode_tape(host, window_size=WINDOW, tick_size=1e-5)
        assert str(ours.value) == str(e)
        return
    assert_tapes_equal(ref, C.encode_tape(host, window_size=WINDOW, tick_size=1e-5))


def test_encode_regular_m1_grid_matches_jax_and_reaches_the_table_codecs():
    jax_host, host = grid_hosts()
    ref = JC.encode_tape(jax_host, window_size=WINDOW, tick_size=1e-5)
    ours = C.encode_tape(host, window_size=WINDOW, tick_size=1e-5)
    assert_tapes_equal(ref, ours)
    kinds = set(ours.codec_report().values())
    assert {"q16", "iperiodic", "bits", "const", "raw"} <= kinds


def test_encode_gappy_grid_reaches_the_periodic_codec():
    # three weeks of M1 bars with every eleventh bar missing: bar index
    # and week no longer line up, the minute-of-week table still does
    n = 3 * 7200
    keep = np.arange(n) % 11 != 5
    cols = {k: v[keep] for k, v in cases.tick_walk_columns(n, 2).items()}
    jax_host, host = paired_hosts(cols, cases.m1_week_grid(n)[keep])
    ref = JC.encode_tape(jax_host, window_size=WINDOW, tick_size=1e-5)
    ours = C.encode_tape(host, window_size=WINDOW, tick_size=1e-5)
    assert_tapes_equal(ref, ours)
    assert "periodic" in ours.codec_report().values()


def test_encode_multishard_plan_matches_jax():
    jax_host, host = grid_hosts(n=2000)
    starts, shard_bars = [0, 300, 600, 900, 1200, 1500, 1699], 300
    kw = dict(starts=starts, shard_bars=shard_bars, window_size=WINDOW, tick_size=1e-5)
    assert_tapes_equal(JC.encode_market_data(jax_host, **kw),
                       C.encode_market_data(host, **kw))


@pytest.mark.parametrize("defect", ["off_grid", "too_wide"])
def test_encode_refusals_match_jax(defect):
    n = 600
    cols = cases.tick_walk_columns(n, 5)
    if defect == "off_grid":
        cols["CLOSE"] = cols["CLOSE"].copy()
        cols["CLOSE"][77] += 3e-6
    else:
        # a jump of 70,000 ticks inside one shard: beyond the int16 span
        for k in ("OPEN", "HIGH", "LOW", "CLOSE"):
            cols[k] = cols[k].copy()
            cols[k][300:] += 0.7
    jax_host, host = paired_hosts(cols, cases.m1_week_grid(n))
    with pytest.raises(ValueError) as ref:
        JC.encode_tape(jax_host, window_size=WINDOW, tick_size=1e-5, what=" (t)")
    with pytest.raises(ValueError) as ours:
        C.encode_tape(host, window_size=WINDOW, tick_size=1e-5, what=" (t)")
    assert str(ours.value) == str(ref.value)
    assert ("off the 1e-05 tick grid" if defect == "off_grid" else "spans more than") in str(ref.value)


def test_validate_compress_mode_matches_jax():
    for mode in (None, "off", "ON", "interpret"):
        assert C.validate_compress_mode(mode) == JC.validate_compress_mode(mode)
    with pytest.raises(ValueError, match="data_compress must be one of"):
        C.validate_compress_mode("zstd")


@pytest.mark.parametrize("rows", [1003, 1024, 1])
def test_k6_plain_matches_jax_ref_and_pallas_interpret(rows):
    delta, base, inv = cases.q16_case(seed=rows, rows=rows)
    ours = tape_decode.decode_q16_block(*(torch.from_numpy(x) for x in (delta, base, inv)))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == delta.shape
    with x64_off():
        args = (jax.numpy.asarray(delta), jax.numpy.asarray(base), jax.numpy.asarray(inv))
        ref = JC.decode_q16_ref(*args)
        pallas = pallas_decode(*args, interpret=True)
    assert_bitwise(ref, ours, "decode_q16_ref")
    assert_bitwise(pallas, ours, "decode_q16_block interpret")


@pytest.mark.parametrize("mode", ["off", "on", "interpret"])
def test_shard_decode_matches_jax_decode_shard_ref(mode):
    jax_host, host = grid_hosts(n=1500)
    starts, shard_bars = [0, 400, 800, 1098], 400
    kw = dict(starts=starts, shard_bars=shard_bars, window_size=WINDOW, tick_size=1e-5)
    jtape, tape = JC.encode_market_data(jax_host, **kw), C.encode_market_data(host, **kw)
    decoder = C.make_shard_decoder(tape, mode, "cpu")
    for k, start in enumerate(starts):
        with x64_off():
            ref = JC.decode_shard_ref(jtape, k)
        ours = decoder(C.shard_arrays(tape, k))
        plain = shard_market_data(host, start, shard_bars, WINDOW)
        assert ours.row0 == int(ref.row0) == start
        for name in ours._fields:
            if name == "row0":
                continue
            assert_bitwise(getattr(ref, name), getattr(ours, name), f"shard {k} {name}")
            assert_bitwise(getattr(plain, name), getattr(ours, name), f"shard {k} {name} host")


def test_whole_tape_decode_on_a_device_tape_equals_the_f32_build():
    _, host = grid_hosts(n=2 * 7200)
    tape = C.device_tape(C.encode_tape(host, window_size=WINDOW, tick_size=1e-5), "cpu")
    assert all(isinstance(s, torch.Tensor) for s in tape.slabs)
    before = tape_decode.decode_q16_block.launches
    decoded = C.make_shard_decoder(tape, "on")(C.shard_arrays(tape, 0))
    assert tape_decode.decode_q16_block.launches == before  # the CPU runs the plain version
    for name, a, b in zip(host._fields, host, decoded):
        if name != "row0":
            assert_bitwise(a, b, name)
    assert tape.compression_ratio > 1.5
