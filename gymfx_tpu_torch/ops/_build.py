"""Build and bind the port's CUDA kernels (``csrc/env_kernels.cu``).

nvcc compiles the source into a shared library with a plain C interface
at first use, and ``ctypes`` loads it:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -o build/torch_kernels/libgymfx_env_<hash>.so

``-fmad=false`` keeps every multiply and add separate, as the plain
PyTorch versions compute them; ``--use_fast_math`` is never used (IEEE
division).  The library name carries a hash of the source and flags, so
an edited source rebuilds, and the build writes to a temporary name and
renames, so concurrent first uses never load a half-written file.
Nothing is built or loaded at import: the CPU tests import every module
on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional

_PACKAGE = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE / "csrc" / "env_kernels.cu"
BUILD_DIR = _PACKAGE.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgymfx_env_{digest.hexdigest()[:16]}.so"


def build_library(ptxas_verbose: bool = False) -> tuple[pathlib.Path, str]:
    """Compile the kernels (if this source has not been built yet) and
    return (library path, compiler output).  ``ptxas_verbose`` rebuilds
    with ``-Xptxas -v`` so the output lists registers and spills."""
    path = library_path()
    if path.exists() and not ptxas_verbose:
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS]
    if ptxas_verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        path, _ = build_library()
        lib = ctypes.CDLL(str(path))
        vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.gymfx_step_obs.argtypes = [vp, vp, vp, vp, vp, vp, ll, i, i, f, vp]
        lib.gymfx_step_obs.restype = i
        lib.gymfx_fill_brackets.argtypes = [vp, ll, i, i, i, vp]
        lib.gymfx_fill_brackets.restype = i
        lib.gymfx_mark_reward.argtypes = [vp, ll, i, vp]
        lib.gymfx_mark_reward.restype = i
        lib.gymfx_fill_pointer_count.restype = i
        lib.gymfx_mark_pointer_count.restype = i
        _lib = lib
    return _lib


def require(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device`` (what a kernel's raw pointer may point at)."""
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)} "
            f"on {device}; got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}"
        )


def pointer_array(tensors_or_none) -> ctypes.Array:
    """A C array of device pointers (null for None), kept alive by the caller."""
    ptrs = [0 if t is None else t.data_ptr() for t in tensors_or_none]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
