"""The port's native CSV loader (gymfx_tpu_torch/data/native_loader.py,
gymfx_tpu_torch/native/csv_loader.cpp) against the JAX package's
(gymfx_tpu/data/native_loader.py) and the port's numpy path.

* The arrays of a canonical file (the sample, and a generated M1 tick
  walk) equal the JAX loader's, bitwise: every OHLCV column and the
  timestamps.
* ``data/feed.load_dataframe`` through the native path equals its numpy
  path (``GYMFX_NATIVE_LOADER=0``), bitwise, columns and timestamps.
* The JAX tests' refusals: a non-canonical header (the numpy path keeps
  the extra column), a partial schema (the numpy path's backfill),
  garbage rows, trailing garbage in a number, a timezone suffix, and
  ``max_rows`` (the numpy path).  ``GYMFX_NATIVE_LOADER=require`` raises
  where the native path cannot serve a file, a failed build included;
  without it a failed build leaves the numpy path.
* The library is built once into ``build/native/`` under a name that
  hashes its source and flags.
"""
import numpy as np
import pytest

from gymfx_tpu.data.native_loader import load_ohlcv_csv as jax_load_ohlcv_csv

from gymfx_tpu_torch.data import native_loader
from gymfx_tpu_torch.data.feed import load_dataframe
from gymfx_tpu_torch.ops import cases

from test_torch_parity import assert_bitwise

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
SAMPLE = str(REPO / "examples" / "data" / "eurusd_sample.csv")
COLUMNS = ("OPEN", "HIGH", "LOW", "CLOSE", "VOLUME")
HEADER = "DATE_TIME,OPEN,HIGH,LOW,CLOSE,VOLUME\n"


def _tick_file(tmp_path, n=700):
    path = tmp_path / "ticks.csv"
    cases.write_bar_csv(path, cases.tick_walk_columns(n, seed=5, vol_ticks=30.0),
                        cases.m1_week_grid(n))
    return str(path)


@pytest.mark.parametrize("which", ["sample", "ticks"])
def test_the_arrays_equal_the_jax_loaders_bitwise(tmp_path, which):
    path = SAMPLE if which == "sample" else _tick_file(tmp_path)
    ref = jax_load_ohlcv_csv(path)
    assert ref is not None
    frame = native_loader.load_ohlcv_csv(path)
    assert frame is not None and sorted(frame.columns) == sorted(COLUMNS)
    for name in COLUMNS:
        assert frame.columns[name].dtype == np.float64
        assert_bitwise(ref[name].to_numpy(), frame.columns[name], name)
    assert frame.timestamps.dtype == np.dtype("datetime64[us]")
    np.testing.assert_array_equal(frame.timestamps,
                                  ref.index.to_numpy().astype("datetime64[us]"))


def test_load_dataframe_native_equals_its_numpy_path(tmp_path, monkeypatch):
    path = _tick_file(tmp_path)
    native = load_dataframe({"input_data_file": path})
    monkeypatch.setenv("GYMFX_NATIVE_LOADER", "0")
    assert native_loader.load_ohlcv_csv(path) is None
    numpy_path = load_dataframe({"input_data_file": path})
    assert sorted(native.columns) == sorted(numpy_path.columns)
    for name in native.columns:
        assert_bitwise(numpy_path.columns[name], native.columns[name], name)
    np.testing.assert_array_equal(native.timestamps, numpy_path.timestamps)


@pytest.mark.parametrize("body,why", [
    ("2024-01-01 00:00:00,1,1,1,1,0\nnot-a-date,1,1,1,1,0\n", "garbage row"),
    ("2024-01-01 00:00:00,1.1,1.2,1.0,1.5garbage,10\n", "trailing garbage"),
    ("2024-01-01 00:00:00+02:00,1.1,1.2,1.0,1.1,10\n", "timezone suffix"),
], ids=["garbage_row", "trailing_garbage", "timezone"])
def test_the_strict_parser_refuses_as_jax(tmp_path, monkeypatch, body, why):
    path = tmp_path / "bad.csv"
    path.write_text(HEADER + body)
    assert jax_load_ohlcv_csv(str(path)) is None, why
    assert native_loader.load_ohlcv_csv(str(path)) is None, why
    monkeypatch.setenv("GYMFX_NATIVE_LOADER", "require")
    with pytest.raises(RuntimeError, match="could not parse"):
        native_loader.load_ohlcv_csv(str(path))


def test_non_canonical_and_partial_headers_take_the_numpy_path(tmp_path, monkeypatch):
    extra = tmp_path / "extra.csv"
    extra.write_text("DATE_TIME,CLOSE,my_feature\n2024-01-01 00:00:00,1.5,3\n"
                     "2024-01-01 00:01:00,1.6,4\n")
    partial = tmp_path / "partial.csv"
    partial.write_text("DATE_TIME,CLOSE\n2024-01-01 00:00:00,1.5\n2024-01-01 00:01:00,1.6\n")
    for path in (extra, partial):
        assert not native_loader.header_is_canonical(str(path))
        assert native_loader.load_ohlcv_csv(str(path)) is None
        assert jax_load_ohlcv_csv(str(path)) is None
    assert "my_feature" in load_dataframe({"input_data_file": str(extra)}).columns
    df = load_dataframe({"input_data_file": str(partial)})
    np.testing.assert_array_equal(df.columns["OPEN"], df.columns["CLOSE"])
    monkeypatch.setenv("GYMFX_NATIVE_LOADER", "require")
    with pytest.raises(RuntimeError, match="non-canonical header"):
        native_loader.load_ohlcv_csv(str(extra))


def test_max_rows_takes_the_numpy_path(monkeypatch):
    monkeypatch.setenv("GYMFX_NATIVE_LOADER", "require")  # the native path is not asked
    assert len(load_dataframe({"input_data_file": SAMPLE, "max_rows": 17})) == 17


def test_the_build_is_hashed_and_a_failed_build_raises_only_under_require(tmp_path,
                                                                            monkeypatch):
    path = native_loader.build()
    assert path.parent == REPO / "build" / "native" and path.is_file()
    assert path.name.startswith("libgymfx_csv_") and path == native_loader.library_path()
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", broken)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    assert native_loader.library_path() != path
    assert native_loader.load_ohlcv_csv(SAMPLE) is None
    assert len(load_dataframe({"input_data_file": SAMPLE})) == 500  # the numpy path
    monkeypatch.setenv("GYMFX_NATIVE_LOADER", "require")
    with pytest.raises(RuntimeError, match="build failed"):
        native_loader.load_ohlcv_csv(SAMPLE)
    assert not list((tmp_path / "build").glob("*.so"))  # no half-written library left
