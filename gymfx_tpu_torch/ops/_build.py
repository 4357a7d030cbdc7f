"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is its own shared library with a plain C interface, compiled
by nvcc at first use and loaded with ``ctypes``:

    env        csrc/env_kernels.cu (K1-K3), bitwise to the plain versions:
               nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
                    -fmad=false -shared -Xcompiler -fPIC
    attention  csrc/attention_kernels.cu (K4 forward and backward: bf16 on
               the tensor cores, f32 on the CUDA cores), held to its plain
               versions by a tolerance, so FMA contraction stays on (the
               same flags without -fmad=false; --split-compile=0, as lob,
               since its 48 kernels are the longest build)
    lob        csrc/lob_kernels.cu (K5, K8), integer only (the attention
               flags, and --split-compile=0: its 32 templates' optimizer
               passes run on every core, 22 s against 54 s alone on the
               H100's 8-core host, with the same registers and spills)
    data       csrc/data_kernels.cu (K6 q16 tape decode, K7 batched scaled
               windows), bitwise to the plain versions (the env flags)
    flow       csrc/flow_kernels.cu (K9, the LOB flow's threefry draws and
               float32 path), bitwise to the plain version (the env flags)
    scengen    csrc/scengen_kernels.cu (K10, the scenario generator's scan
               over bars), bitwise to the plain version (the env flags)
    attention_probe  csrc/attention_probe.cu, K4's copies without its
               arithmetic and an empty kernel (the attention flags): a
               profiling tool, not on any path, built only when
               profile_attention.py loads it

``-fmad=false`` keeps every multiply and add separate, as the plain
PyTorch versions compute them; ``--use_fast_math`` is never used (IEEE
division, accurate ``expf``).  A library's name carries a hash of its
source and flags, so an edited source rebuilds, and a build writes to a
temporary name and renames, so concurrent first uses never load a
half-written file.  Each build, and each first use that finds the
library already built, is reported to the active compile watch
(``telemetry/compile_watch.py``).  :func:`build_all` starts one nvcc per kernel
library (:data:`KERNEL_LIBRARIES`, every source but the probe) at once.  Nothing is built or loaded at import: the CPU tests import every
module on a machine without nvcc.
"""
from __future__ import annotations

import array
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Optional, Tuple

import torch

_PACKAGE = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = _PACKAGE.parent / "build" / "torch_kernels"
_COMMON = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
_SHARED = ("-shared", "-Xcompiler", "-fPIC")
SOURCES = {
    "env": _PACKAGE / "csrc" / "env_kernels.cu",
    "attention": _PACKAGE / "csrc" / "attention_kernels.cu",
    "lob": _PACKAGE / "csrc" / "lob_kernels.cu",
    "data": _PACKAGE / "csrc" / "data_kernels.cu",
    "flow": _PACKAGE / "csrc" / "flow_kernels.cu",
    "scengen": _PACKAGE / "csrc" / "scengen_kernels.cu",
    "attention_probe": _PACKAGE / "csrc" / "attention_probe.cu",
}
# the libraries that hold the port's kernels (what build_all builds)
KERNEL_LIBRARIES = ("env", "attention", "lob", "data", "flow", "scengen")
FLAGS = {
    "env": (*_COMMON, "-fmad=false", *_SHARED),
    "attention": (*_COMMON, "--split-compile=0", *_SHARED),
    "lob": (*_COMMON, "--split-compile=0", *_SHARED),
    "data": (*_COMMON, "-fmad=false", *_SHARED),
    "flow": (*_COMMON, "-fmad=false", *_SHARED),
    "scengen": (*_COMMON, "-fmad=false", *_SHARED),
    "attention_probe": (*_COMMON, *_SHARED),
}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str = "env") -> pathlib.Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes() + " ".join(FLAGS[name]).encode())
    return BUILD_DIR / f"libgymfx_{name}_{digest.hexdigest()[:16]}.so"


def _start(name: str, ptxas_verbose: bool) -> Optional[Tuple[subprocess.Popen, str, float]]:
    """Start nvcc for library ``name`` unless it is built (and no
    register report is asked for); returns (process, temporary path,
    start time)."""
    if library_path(name).exists() and not ptxas_verbose:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *FLAGS[name]]
    if ptxas_verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, str(SOURCES[name])]
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, time.perf_counter())


def _finish(name: str, started) -> Tuple[pathlib.Path, str]:
    """Wait for ``started`` (None: the library was built before) and report
    the build, or the cache hit, to the active compile watch."""
    from gymfx_tpu_torch.telemetry import compile_watch

    path = library_path(name)
    watch = compile_watch.active()
    if started is None:
        if watch is not None:
            watch.record_build(name, cached=True)
        return path, ""
    proc, tmp, t0 = started
    try:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name].name} ({proc.returncode}):\n{out}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if watch is not None:
        watch.record_build(name, cached=False, duration_s=time.perf_counter() - t0)
    return path, out


def build_library(name: str = "env", ptxas_verbose: bool = False) -> Tuple[pathlib.Path, str]:
    """Compile library ``name`` (if this source has not been built yet)
    and return (library path, compiler output).  ``ptxas_verbose``
    rebuilds with ``-Xptxas -v`` so the output lists registers and spills."""
    return _finish(name, _start(name, ptxas_verbose))


def build_all(ptxas_verbose: bool = False) -> Dict[str, Tuple[pathlib.Path, str]]:
    """Every kernel library at once: one nvcc per source, all started
    together."""
    started = {name: _start(name, ptxas_verbose) for name in KERNEL_LIBRARIES}
    try:
        return {name: _finish(name, s) for name, s in started.items()}
    finally:
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()


def _bind_env(lib: ctypes.CDLL) -> None:
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.gymfx_step_obs.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp]
    lib.gymfx_step_obs.restype = i
    lib.gymfx_fill_brackets.argtypes = [vp, ll, i, i, i, i, vp]
    lib.gymfx_fill_brackets.restype = i
    lib.gymfx_mark_reward.argtypes = [vp, vp, ll, i, i, i, vp]
    lib.gymfx_mark_reward.restype = i
    lib.gymfx_fill_pointer_count.restype = i
    lib.gymfx_mark_pointer_count.restype = i
    lib.gymfx_sharpe_pointer_count.restype = i
    lib.gymfx_step_obs_constants.argtypes = [ctypes.POINTER(i)]
    lib.gymfx_step_obs_constants.restype = None
    lib.gymfx_fill_threads.restype = i
    lib.gymfx_mark_threads.restype = i
    lib.gymfx_mark_skeleton.argtypes = [vp, ll, vp]
    lib.gymfx_mark_skeleton.restype = i
    lib.gymfx_step_obs_blocks_per_sm.argtypes = [i, i]
    lib.gymfx_step_obs_blocks_per_sm.restype = i
    lib.gymfx_launch_floor.argtypes = [i, i, i, vp]
    lib.gymfx_fill_skeleton.argtypes = [vp, ll, i, i, vp]
    lib.gymfx_fill_skeleton.restype = i
    lib.gymfx_launch_floor.restype = i


def _bind_attention(lib: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.gymfx_attn_fwd_f32.argtypes = [vp, vp, vp, vp, strides, i, i, i, i, i, f, vp]
    lib.gymfx_attn_bwd_f32.argtypes = [vp, vp, vp, vp, vp, vp, vp, strides, i, i, i, i, i, f, vp]
    lib.gymfx_attn_fwd_bf16.argtypes = [vp, vp, vp, vp, strides, i, i, i, i, i, f, vp]
    lib.gymfx_attn_bwd_bf16.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, strides, i, i, i, i, i,
                                        f, f, vp]
    lib.gymfx_attn_fwd_f32_window.argtypes = [vp, vp, vp, vp, strides, i, i, i, i, i, f, vp]
    lib.gymfx_attn_bwd_f32_window.argtypes = [vp, vp, vp, vp, vp, vp, vp, strides, i, i, i, i, i,
                                              f, vp]
    lib.gymfx_attn_bf16_smem.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    lib.gymfx_attn_f32_window_smem.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    for fn in ("fwd_f32", "bwd_f32", "fwd_f32_window", "bwd_f32_window", "fwd_bf16", "bwd_bf16",
               "bf16_smem", "f32_window_smem"):
        getattr(lib, f"gymfx_attn_{fn}").restype = i


def _bind_lob(lib: ctypes.CDLL) -> None:
    for fn in (lib.gymfx_lob_stream, lib.gymfx_lob_bar):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.gymfx_lob_pointer_count.restype = ctypes.c_int
    lib.gymfx_lob_bar_pointer_count.restype = ctypes.c_int


def _bind_data(lib: ctypes.CDLL) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gymfx_q16_decode.argtypes = [vp, vp, vp, vp, i, ll, i, vp]
    lib.gymfx_q16_decode.restype = i
    lib.gymfx_scaled_windows.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp]
    lib.gymfx_scaled_windows.restype = i
    lib.gymfx_scaled_windows_constants.argtypes = [ctypes.POINTER(i)]
    lib.gymfx_scaled_windows_constants.restype = None
    lib.gymfx_scaled_windows_blocks_per_sm.argtypes = [i, i]
    lib.gymfx_scaled_windows_blocks_per_sm.restype = i


def _bind_flow(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.gymfx_bar_flow.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp]
    lib.gymfx_bar_flow.restype = ctypes.c_int
    lib.gymfx_flow_pointer_count.restype = ctypes.c_int
    lib.gymfx_flow_const_count.restype = ctypes.c_int
    lib.gymfx_flow_set_count.restype = ctypes.c_int


def _bind_scengen(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.gymfx_scengen_scan.argtypes = [vp, vp, ctypes.c_longlong, i, i, vp]
    lib.gymfx_scengen_smem_bytes.argtypes = [i, i]
    lib.gymfx_scengen_smem_bytes.restype = ctypes.c_longlong
    for fn in (lib.gymfx_scengen_scan, lib.gymfx_scengen_pointer_count,
               lib.gymfx_scengen_const_count, lib.gymfx_scengen_max_assets):
        fn.restype = i


def _bind_attention_probe(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.gymfx_attn_probe_skeleton.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
    lib.gymfx_attn_probe_f32_window.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, vp]
    lib.gymfx_attn_probe_floor.argtypes = [i, i, i, vp]
    for fn in (lib.gymfx_attn_probe_skeleton, lib.gymfx_attn_probe_f32_window,
               lib.gymfx_attn_probe_floor):
        fn.restype = i


_BINDERS = {"env": _bind_env, "attention": _bind_attention, "lob": _bind_lob, "data": _bind_data,
            "flow": _bind_flow, "scengen": _bind_scengen, "attention_probe": _bind_attention_probe}


def load_library(name: str = "env") -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first call."""
    if name not in _libs:
        path, _ = build_library(name)
        lib = ctypes.CDLL(str(path))
        _BINDERS[name](lib)
        _libs[name] = lib
    return _libs[name]


def require(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    (a tuple) on ``device`` (what a kernel's raw pointer may point at).
    The test is one expression of cheap attribute reads; the message is
    built only when it fails."""
    if t.dtype is not dtype or t.shape != shape or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)} "
            f"on {device}; got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}"
        )


def require_all(tensors, names, dtype, shape, device) -> None:
    """:func:`require` for each of ``tensors`` (named by ``names``), its
    test inline, which saves a Python call for each tensor that passes."""
    for t, name in zip(tensors, names):
        if t.dtype is not dtype or t.shape != shape or t.device != device or not t.is_contiguous():
            require(t, name, dtype, shape, device)


def pointer_array(tensors_or_none) -> ctypes.Array:
    """A C array of device pointers (null for None), kept alive by the
    caller; filled through an ``array.array``, several times faster than
    the ctypes array's own constructor."""
    ptrs = [0 if t is None else t.data_ptr() for t in tensors_or_none]
    return (ctypes.c_uint64 * len(ptrs)).from_buffer(array.array("Q", ptrs))


def stream_handle(device) -> int:
    """The raw handle of the current CUDA stream on ``device`` (a CUDA
    torch.device): one call, where ``torch.cuda.current_stream`` builds a
    Stream object first."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    return raw(torch.cuda.current_device() if device.index is None else device.index)


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
