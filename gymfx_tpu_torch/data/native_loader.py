"""ctypes bindings for the native CSV loader.

The port of ``gymfx_tpu/data/native_loader.py``: the C++ columnar parser
(the port's own copy, ``gymfx_tpu_torch/native/csv_loader.cpp``) in
place of the numpy path of ``data/feed.load_dataframe`` for canonical bar
files.  It takes the canonical schema only (DATE_TIME, OPEN, HIGH, LOW,
CLOSE, VOLUME, with fixed-format timestamps) and refuses anything else,
in which case the caller takes its numpy path: exotic files load as they
always did, canonical files load faster.

The library is built with ``g++ -O3 -shared -fPIC -std=c++17`` at first
use into ``build/native/``, under a name that carries a hash of the
source and the flags (an edited source rebuilds), written to a temporary
name and renamed (concurrent first uses never load a half-written file).

``GYMFX_NATIVE_LOADER=0`` turns it off; ``=require`` raises where the
native path cannot serve a file (a non-canonical header, a row the
parser refuses, a failed build).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Optional

import numpy as np

_PACKAGE = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE / "native" / "csv_loader.cpp"
BUILD_DIR = _PACKAGE.parent / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
CANONICAL = {"DATE_TIME", "OPEN", "HIGH", "LOW", "CLOSE", "VOLUME"}

_lib: Optional[ctypes.CDLL] = None


def native_enabled() -> bool:
    return os.environ.get("GYMFX_NATIVE_LOADER", "1") != "0"


def _required() -> bool:
    return os.environ.get("GYMFX_NATIVE_LOADER") == "require"


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgymfx_csv_{digest}.so"


def build() -> pathlib.Path:
    """The library, built unless it is (raises on a failed build)."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", tmp], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native loader build failed: {proc.stderr.strip()}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_library() -> ctypes.CDLL:
    """The bound library (built at first use; raises on a failed build)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gymfx_csv_parse.restype = ctypes.c_void_p
        lib.gymfx_csv_parse.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        lib.gymfx_csv_fill.restype = None
        lib.gymfx_csv_fill.argtypes = [ctypes.c_void_p] + [
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        ] + [np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")] * 5
        lib.gymfx_csv_free.restype = None
        lib.gymfx_csv_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def header_is_canonical(path: str) -> bool:
    """Only the exact bar schema qualifies: a file with extra columns
    goes through the numpy path, which keeps them (and with a column
    absent, its price-column backfill applies)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            header = fh.readline().strip()
    except OSError:
        return False
    return {c.strip().upper() for c in header.split(",")} == CANONICAL


def load_ohlcv_csv(path: str):
    """The native parse of ``path`` as a ``data/feed.Frame`` (float64
    OHLCV columns, ``datetime64[us]`` timestamps), or None when the native
    path cannot serve it (``GYMFX_NATIVE_LOADER=require`` raises instead)."""
    from gymfx_tpu_torch.data.feed import Frame

    if not native_enabled():
        return None
    if not header_is_canonical(path):
        if _required():
            raise RuntimeError(f"native loader: non-canonical header in {path}")
        return None
    try:
        lib = load_library()
    except (OSError, RuntimeError):
        if _required():
            raise
        return None
    n = ctypes.c_int64(0)
    handle = lib.gymfx_csv_parse(str(path).encode(), ctypes.byref(n))
    if not handle:
        if _required():
            raise RuntimeError(f"native loader could not parse {path}")
        return None
    try:
        rows = int(n.value)
        epoch = np.empty(rows, np.int64)
        cols = {name: np.empty(rows, np.float64) for name in ("OPEN", "HIGH", "LOW", "CLOSE",
                                                             "VOLUME")}
        lib.gymfx_csv_fill(handle, epoch, *cols.values())
    finally:
        lib.gymfx_csv_free(handle)
    return Frame(cols, epoch.astype("datetime64[s]").astype("datetime64[us]"))
