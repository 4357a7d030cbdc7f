"""K10: the scenario generator's scan over bars, one generation's tape.

The JAX package has no ``ops/scengen_scan``: its reference is the
``jax.lax.scan`` in ``gymfx_tpu/scengen/engine.py::paths_from_shocks``
(:232), which XLA compiles into one loop.  K10 is the port's counterpart
of that loop, as K8 is of the LOB venue's; it has no Pallas counterpart
and adds nothing the JAX package lacks.

The kernel is ``scengen_scan_kernel`` in ``csrc/scengen_kernels.cu``
(library ``scengen``, built with ``-fmad=false``; see the source for its
design): one CTA a generation, the shocks staged in double-buffered
shared-memory tiles; three warps walk a tile's regime, crash and drought
chains at once, every thread computes the elements' returns and gaps,
warp 0 carries the log prices (an asset a lane), and every thread the
exponentials and the stores.

Its plain version :func:`paths_plain` is the JAX step written out in
torch.  The scan's carry is the regime, the three counters and the log
prices; the plain version walks the bars one by one for what the carry
feeds (the regime and overlay chain, in Python numbers: every comparison
is of float32 values, every counter an int; then the log-price
recurrence, two float32 adds a bar on the host, in numpy views of the
host tensors), and computes the rest,
which is elementwise in the bar, over all bars at once on the shocks'
device (the same operations on the same values: the same bits).  Float
adds and multiplies round the same on every device; the ``exp`` calls run
on the shocks' device, as the kernel's ``expf`` does.

:func:`scengen_scan` dispatches by device: CPU shocks run the plain
version, CUDA shocks launch the kernel or raise.  The scenario reaches
the kernel as the 43 words of :func:`scan_constants`, computed on the
host; nothing is copied to or from the device.
"""
from __future__ import annotations

import array
import ctypes
import struct
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from gymfx_tpu_torch.ops import _build
from gymfx_tpu_torch.scengen.params import (
    FLAG_CRASH,
    FLAG_DROUGHT,
    FLAG_GAP,
    FLAG_HIGHVOL,
    FLAG_TREND,
    HIGHVOL,
    TREND_DOWN,
    TREND_UP,
    ScenarioParams,
)

F32 = np.float32
# the kernel's shared memory: two staged tiles of (5 + 4 A) words a bar and
# one tile of the chains' records (3 words a bar)
SMEM_BUDGET = 96 * 1024
_BAR_NAMES = tuple(f"scengen_scan: {n}" for n in ("regime_u", "crash_u", "gap_u", "drought_u"))
_ASSET_NAMES = tuple(f"scengen_scan: {n}" for n in ("eps", "gap_z", "hi_z", "lo_z"))


class ScanParams(NamedTuple):
    """A scenario as the scan reads it: float32 numbers (numpy scalars and
    (4,) / (4, 4) arrays) and ints, the derived ones computed in float32
    as engine.py computes them."""

    trans: Any
    drift: Any
    vol: Any
    spread: Any
    hl_range: Any
    p_crash: Any
    crash_drop: Any   # crash_size / max(crash_len, 1)
    recov_gain: Any   # crash_size * recovery_frac / max(recovery_len, 1)
    crash_spread: Any
    p_gap: Any
    gap_size: Any
    weekend_gap_size: Any
    p_drought: Any
    drought_spread: Any
    drought_vol: Any
    crash_len: int
    recovery_len: int
    drought_len: int
    regime0: int


def scan_params(p: ScenarioParams) -> ScanParams:
    def f(x):
        return F32(np.asarray(x, F32))

    one = F32(1.0)
    return ScanParams(
        trans=np.asarray(p.trans, F32).reshape(4, 4),
        drift=np.asarray(p.drift, F32).reshape(4),
        vol=np.asarray(p.vol, F32).reshape(4),
        spread=np.asarray(p.spread, F32).reshape(4),
        hl_range=f(p.hl_range),
        p_crash=f(p.p_crash),
        crash_drop=F32(f(p.crash_size) / max(f(p.crash_len), one)),
        recov_gain=F32(F32(f(p.crash_size) * f(p.recovery_frac)) / max(f(p.recovery_len), one)),
        crash_spread=f(p.crash_spread),
        p_gap=f(p.p_gap),
        gap_size=f(p.gap_size),
        weekend_gap_size=f(p.weekend_gap_size),
        p_drought=f(p.p_drought),
        drought_spread=f(p.drought_spread),
        drought_vol=f(p.drought_vol),
        crash_len=int(np.int32(p.crash_len)),
        recovery_len=int(np.int32(p.recovery_len)),
        drought_len=int(np.int32(p.drought_len)),
        regime0=int(np.int32(p.regime0)),
    )


def _f32_bits(x) -> int:
    return struct.unpack("<i", struct.pack("<f", float(x)))[0]


def scan_constants(sp: ScanParams) -> Tuple[int, ...]:
    """The kernel's ScanConsts as 43 int32 words: the transition matrix
    (row-major), the drifts, vols and spreads, the 11 float scalars and
    the 4 ints, in the source's order."""
    floats = (*sp.trans.reshape(-1), *sp.drift, *sp.vol, *sp.spread, sp.hl_range, sp.p_crash,
              sp.crash_drop, sp.recov_gain, sp.crash_spread, sp.p_gap, sp.gap_size,
              sp.weekend_gap_size, sp.p_drought, sp.drought_spread, sp.drought_vol)
    ints = (sp.crash_len, sp.recovery_len, sp.drought_len, sp.regime0)
    return tuple(map(_f32_bits, floats)) + ints


def thresholds(sp: ScanParams):
    """Each regime's transition thresholds (c0, c1, c2): the row's partial
    sums in float32, in engine.py's order.  A (4, 3) list."""
    row = torch.from_numpy(sp.trans)
    c0 = row[:, 0]
    c1 = c0 + row[:, 1]
    c2 = c1 + row[:, 2]
    return torch.stack([c0, c1, c2], 1).tolist()


def tile_bars(n_assets: int) -> int:
    """Bars a staged tile: the largest power of two whose two tiles fit
    :data:`SMEM_BUDGET` (the wrapper's choice; any tile >= 1 is right)."""
    per_bar = (2 * (5 + 4 * n_assets) + 3) * 4
    tile = 1
    while tile * 2 * per_bar <= SMEM_BUDGET and tile < 1024:
        tile *= 2
    return tile


def _chain(sp: ScanParams, regime_u, crash_u, gap_u, drought_u, monday):
    """The scan's regime and overlay chain, bar by bar: per bar the
    regime and the in_crash, in_recov, in_drought and gap-event bits,
    (n,) CPU tensors."""
    thr = thresholds(sp)
    u_reg, u_crash, u_gap, u_drought = (x.cpu().tolist() for x in
                                        (regime_u, crash_u, gap_u, drought_u))
    mon = (monday.cpu() != 0).tolist()
    p_crash, p_gap, p_drought = float(sp.p_crash), float(sp.p_gap), float(sp.p_drought)
    n = len(u_reg)
    regimes, crash, recov, drought, gap = ([0] * n for _ in range(5))
    regime, crash_left, recov_left, drought_left = sp.regime0, 0, 0, 0
    for t in range(n):
        c0, c1, c2 = thr[regime]
        u = u_reg[t]
        regime = 0 if u < c0 else (1 if u < c1 else (2 if u < c2 else 3))
        if crash_left == 0 and recov_left == 0 and u_crash[t] < p_crash:
            crash_left = sp.crash_len
        in_crash = crash_left > 0
        crash_next = max(crash_left - in_crash, 0)
        if in_crash and crash_next == 0:
            recov_left = sp.recovery_len
        in_recov = not in_crash and recov_left > 0
        recov_next = recov_left - 1 if in_recov else recov_left
        if drought_left == 0 and u_drought[t] < p_drought:
            drought_left = sp.drought_len
        in_drought = drought_left > 0
        drought_next = max(drought_left - in_drought, 0)
        regimes[t], crash[t], recov[t], drought[t] = regime, in_crash, in_recov, in_drought
        gap[t] = u_gap[t] < p_gap or mon[t]
        crash_left, recov_left, drought_left = crash_next, recov_next, drought_next
    as_bool = lambda x: torch.tensor(x, dtype=torch.bool)  # noqa: E731
    return (torch.tensor(regimes, dtype=torch.int64), as_bool(crash), as_bool(recov),
            as_bool(drought), as_bool(gap))


def paths_plain(regime_u, crash_u, gap_u, drought_u, monday, eps, gap_z, hi_z, lo_z, logp0,
                sp: ScanParams):
    """Plain version of K10 (see the module docstring): the same inputs,
    (open, high, low, close, spread_mult, slip_mult, flags, regime) on
    the shocks' device."""
    dev = eps.device
    regime, in_crash, in_recov, in_drought, gap_evt = (
        x.to(dev) for x in _chain(sp, regime_u, crash_u, gap_u, drought_u, monday))
    table = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    drift, vol, spread = table(sp.drift)[regime], table(sp.vol)[regime], table(sp.spread)[regime]
    vol_t = vol * torch.where(in_drought, float(sp.drought_vol), 1.0)
    overlay = (torch.where(in_crash, -float(sp.crash_drop), 0.0)
               + torch.where(in_recov, float(sp.recov_gain), 0.0))
    ret = drift[:, None] + vol_t[:, None] * eps + overlay[:, None]
    is_monday = monday != 0
    gsz = torch.where(is_monday, float(sp.weekend_gap_size), float(sp.gap_size))
    gap = torch.where(gap_evt[:, None], gap_z * gsz[:, None], 0.0)

    # the carried log prices, bar by bar: open's log = logp + gap, then
    # logp = (logp + gap) + ret
    # (float32 numpy views of the host tensors: the same adds, fewer calls)
    gap_h, ret_h = gap.cpu().numpy(), ret.cpu().numpy()
    open_log, close_log = np.empty_like(gap_h), np.empty_like(gap_h)
    lp = logp0.cpu().numpy()
    for t in range(gap_h.shape[0]):
        a = lp + gap_h[t]
        lp = a + ret_h[t]
        open_log[t], close_log[t] = a, lp
    open_ = torch.exp(torch.from_numpy(open_log).to(dev))
    close = torch.exp(torch.from_numpy(close_log).to(dev))
    hl = float(sp.hl_range)
    high = torch.maximum(open_, close) * torch.exp((hl * vol_t)[:, None] * hi_z.abs())
    low = torch.minimum(open_, close) * torch.exp((-hl * vol_t)[:, None] * lo_z.abs())

    spread_t = (spread * torch.where(in_drought, float(sp.drought_spread), 1.0)
                * torch.where(in_crash, float(sp.crash_spread), 1.0))
    slip_t = 1.0 + 0.5 * (spread_t - 1.0)
    trend = (regime == TREND_UP) | (regime == TREND_DOWN)
    flags = (trend.to(torch.int32) * FLAG_TREND | in_drought.to(torch.int32) * FLAG_DROUGHT
             | in_crash.to(torch.int32) * FLAG_CRASH | gap_evt.to(torch.int32) * FLAG_GAP
             | (regime == HIGHVOL).to(torch.int32) * FLAG_HIGHVOL)
    return open_, high, low, close, spread_t, slip_t, flags, regime.to(torch.int32)


def _const_array(sp: ScanParams) -> ctypes.Array:
    words = scan_constants(sp)
    return (ctypes.c_int * len(words)).from_buffer(array.array("i", words))


def scengen_scan(regime_u, crash_u, gap_u, drought_u, monday, eps, gap_z, hi_z, lo_z, logp0,
                 sp: ScanParams):
    """(n,) float32 uniforms and int32 Monday mask, (n, A) float32 shocks
    (``eps`` mixed), (A,) float32 log(s0) -> the tape (open, high, low,
    close (n, A) float32; spread_mult, slip_mult (n,) float32; flags,
    regime (n,) int32): the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    device = eps.device
    if device.type == "cpu":
        return paths_plain(regime_u, crash_u, gap_u, drought_u, monday, eps, gap_z, hi_z, lo_z,
                           logp0, sp)
    if device.type != "cuda":
        raise ValueError(f"scengen_scan: unsupported device {device}")
    n, n_assets = eps.shape
    f32 = torch.float32
    _build.require_all((regime_u, crash_u, gap_u, drought_u), _BAR_NAMES, f32, (n,), device)
    _build.require(monday, "scengen_scan: monday", torch.int32, (n,), device)
    _build.require_all((eps, gap_z, hi_z, lo_z), _ASSET_NAMES, f32, (n, n_assets), device)
    _build.require(logp0, "scengen_scan: logp0", f32, (n_assets,), device)
    out = torch.empty((4, n, n_assets), dtype=f32, device=device)
    scalars = torch.empty((2, n), dtype=f32, device=device)
    ints = torch.empty((2, n), dtype=torch.int32, device=device)
    if n and n_assets:
        lib = _build.load_library("scengen")
        if n_assets > lib.gymfx_scengen_max_assets():
            raise ValueError(f"scengen_scan: {n_assets} assets; the kernel takes at most "
                             f"{lib.gymfx_scengen_max_assets()}")
        ptrs = _build.pointer_array([regime_u, crash_u, gap_u, drought_u, monday, eps, gap_z,
                                     hi_z, lo_z, logp0, *out, *scalars, *ints])
        consts = _const_array(sp)
        if (len(ptrs), len(consts)) != (lib.gymfx_scengen_pointer_count(),
                                        lib.gymfx_scengen_const_count()):
            raise RuntimeError("scengen_scan: argument layout does not match the kernel source")
        _build.check_launch(lib.gymfx_scengen_scan(ptrs, consts, n, n_assets, tile_bars(n_assets),
                                                   _build.stream_handle(device)),
                            "scengen_scan")
        scengen_scan.launches += 1
    return (*out.unbind(0), *scalars.unbind(0), *ints.unbind(0))


scengen_scan.launches = 0
