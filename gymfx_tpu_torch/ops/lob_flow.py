"""K9: one bar's order-flow messages for every env of the LOB venue.

The JAX package has no ``ops/lob_flow``: its reference is
``gymfx_tpu/lob/flow.py::bar_messages`` under ``bar_key``, whose
``jax.random`` draws XLA compiles into the jitted step
(``gymfx_tpu/lob/venue.py:263-267``).  K9 is the port's counterpart of
that compiled program, as K8 is of the venue's ``lax.scan``; it has no
Pallas counterpart and adds nothing the JAX package lacks.

The kernel is ``bar_flow_kernel`` in ``csrc/flow_kernels.cu`` (library
``flow``, built with ``-fmad=false``; see the source for its design):
one warp per env, the threefry words uint32 in registers, the keys
derived once a warp and shared.  Its plain version :func:`bar_flow_plain`
is ``lob/flow.py``'s ``bar_messages(bar_key(seed, t), ...)`` as it is,
whose bits the CPU tests hold to ``jax.random``; ``ops/cases.bar_flow_emulated``
models the kernel's lanes on the CPU in numpy uint32.

:func:`bar_flow` dispatches by device: CPU ticks run the plain version;
CUDA ticks launch the kernel or raise.  The scenario's FlowParams reach
the kernel as the 18 words of :func:`flow_constants`, computed on the
host once per scenario and seed: nothing is copied to or from the
device, so a CUDA graph captures the launch.
"""
from __future__ import annotations

import array
import ctypes
import functools
import struct
from typing import Tuple

import torch

from gymfx_tpu_torch.lob import prng
from gymfx_tpu_torch.lob.book import Messages
from gymfx_tpu_torch.lob.flow import FlowParams, _f32, bar_key, bar_messages
from gymfx_tpu_torch.ops import _build

_MASK = 0xFFFFFFFF
_TICK_NAMES = tuple(f"bar_flow: {n}" for n in ("o_t", "h_t", "l_t", "c_t"))


def _f32_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", x))[0]


def _i32(x: int) -> int:
    return ((int(x) + (1 << 31)) & _MASK) - (1 << 31)


@functools.lru_cache(maxsize=64)
def flow_constants(fp: FlowParams, flow_seed: int) -> Tuple[int, ...]:
    """The kernel's FlowConsts as 18 int32 words: PRNGKey(flow_seed)'s
    second word; the three kind thresholds (bar_messages' float64 sums
    rounded once to float32, as their bits); randint's spans, multipliers
    and minvals of the price jitter [-2, 3), the qty jitter and the band;
    base_qty, market_qty, crash_at, crash_len, crash_qty."""
    thresholds = (_f32(fp.p_noop), _f32(fp.p_noop + fp.p_add),
                  _f32(fp.p_noop + fp.p_add + fp.p_cancel))
    draws = ((-2, 3), (0, max(int(fp.qty_jitter), 1)), (0, max(int(fp.band_ticks), 1)))
    spans, mults = zip(*(prng.randint_constants(lo, hi) for lo, hi in draws))
    words = (int(flow_seed) & _MASK, *map(_f32_bits, thresholds), *spans, *mults,
             *(lo for lo, _ in draws), int(fp.base_qty), int(fp.market_qty), int(fp.crash_at),
             int(fp.crash_len), int(fp.crash_qty))
    return tuple(map(_i32, words))


@functools.lru_cache(maxsize=64)
def _const_array(fp: FlowParams, flow_seed: int) -> ctypes.Array:
    words = flow_constants(fp, flow_seed)
    return (ctypes.c_int * len(words)).from_buffer(array.array("i", words))


def bar_flow_plain(flow_seed: int, t_global, o_t, h_t, l_t, c_t, n_msgs: int,
                   fp: FlowParams) -> Messages:
    """Plain version of K9: ``bar_messages`` under each env's ``bar_key``."""
    return bar_messages(bar_key(flow_seed, t_global), o_t, h_t, l_t, c_t, n_msgs, fp)


def bar_flow(flow_seed: int, t_global, o_t, h_t, l_t, c_t, n_msgs: int,
             fp: FlowParams) -> Messages:
    """(N,) bar rows (int32 or int64; their low 32 bits key the flow) and
    (N,) int32 OHLC ticks -> (N, ``n_msgs``) int32 Messages: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    device = o_t.device
    if device.type == "cpu":
        return bar_flow_plain(flow_seed, t_global, o_t, h_t, l_t, c_t, n_msgs, fp)
    if device.type != "cuda":
        raise ValueError(f"bar_flow: unsupported device {device}")
    n = o_t.shape[0]
    i32 = torch.int32
    _build.require_all((o_t, h_t, l_t, c_t), _TICK_NAMES, i32, (n,), device)
    t_dtype = torch.int64 if t_global.dtype is torch.int64 else i32
    _build.require(t_global, "bar_flow: t_global", t_dtype, (n,), device)
    out = torch.empty((len(Messages._fields), n, n_msgs), dtype=i32, device=device)
    if n and n_msgs > 0:
        lib = _build.load_library("flow")
        ptrs = _build.pointer_array([t_global, o_t, h_t, l_t, c_t, *out])
        consts = _const_array(fp, flow_seed)
        if (len(ptrs), len(consts)) != (lib.gymfx_flow_pointer_count(),
                                        lib.gymfx_flow_const_count()):
            raise RuntimeError("bar_flow: argument layout does not match the kernel source")
        t_stride = 2 if t_global.dtype is torch.int64 else 1
        _build.check_launch(lib.gymfx_bar_flow(ptrs, consts, n, n_msgs,
                                               t_stride, _build.stream_handle(device)),
                            "bar_flow")
        bar_flow.launches += 1
    return Messages(*out.unbind(0))


bar_flow.launches = 0
