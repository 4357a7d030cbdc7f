"""Generative market engine: seeded shocks -> OHLC scenario paths.

The port of ``gymfx_tpu/scengen/engine.py`` (see its module docstring for
the two-stage design):

  ``draw_shocks``       every random number the generator uses, from ONE
                        key with the JAX package's split order: the
                        threefry bits of ``lob/prng.py``, so the uniforms
                        are ``jax.random.uniform``'s bit for bit and the
                        normals within 3 ulp of ``jax.random.normal``'s
                        (XLA's float32 ``erf_inv``, op by op);
  ``paths_from_shocks`` the deterministic transform: the Cholesky mix of
                        the return shocks, then the scan over bars, K10
                        (``ops/scengen_scan.py``) on the card and its plain
                        version on the CPU.

A key is a (2,) int64 tensor of two uint32 words (``prng.PRNGKey``); the
draws run on its device.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from gymfx_tpu_torch.lob import prng
from gymfx_tpu_torch.ops import scengen_scan as k10
from gymfx_tpu_torch.scengen.params import ScenarioParams


class Shocks(NamedTuple):
    """Every random draw the generator consumes, time-major, float32."""

    regime_u: Any   # (n,)    uniform — regime transition draw
    ret_z: Any      # (n, A)  normal — per-asset return shocks (pre-mix)
    gap_z: Any      # (n, A)  normal — per-asset gap magnitudes
    hi_z: Any       # (n, A)  normal — high-wick extension
    lo_z: Any       # (n, A)  normal — low-wick extension
    crash_u: Any    # (n,)    uniform — crash start draw
    gap_u: Any      # (n,)    uniform — random gap-open draw
    drought_u: Any  # (n,)    uniform — drought start draw


class ScenPaths(NamedTuple):
    """Generated tape: OHLC per asset plus the scenario channels."""

    open: Any         # (n, A) float32
    high: Any         # (n, A)
    low: Any          # (n, A)
    close: Any        # (n, A)
    spread_mult: Any  # (n,) float32 — event-overlay spread multiplier
    slip_mult: Any    # (n,) float32 — event-overlay slippage multiplier
    flags: Any        # (n,) int32 — FLAG_* bitmask per bar
    regime: Any       # (n,) int32 — active regime state per bar


def draw_shocks(key, n_bars: int, n_assets: int) -> Shocks:
    """All randomness up front, in the JAX package's split order: key j
    of ``split(key, 8)`` draws field j.  An (n, A) normal takes the counts
    of its flat index (``jax_threefry_partitionable``)."""
    n, a = int(n_bars), int(n_assets)
    ks = prng.split(key, 8)
    u = prng.uniform(ks[[0, 5, 6, 7]], n)
    z = prng.normal(ks[1:5], n * a).reshape(4, n, a)
    return Shocks(regime_u=u[0], ret_z=z[0], gap_z=z[1], hi_z=z[2], lo_z=z[3],
                  crash_u=u[1], gap_u=u[2], drought_u=u[3])


def correlation_cholesky(corr, n_assets: int):
    """Cholesky factor of the equicorrelated (A, A) shock-mixing matrix
    ``(1 - rho) I + rho J``, in float32 on the host (tiny, once a
    generation)."""
    f32 = torch.float32
    rho = torch.tensor(float(np.float32(np.asarray(corr))), dtype=f32)
    eye = torch.eye(n_assets, dtype=f32)
    cmat = (1.0 - rho) * eye + rho * torch.ones((n_assets, n_assets), dtype=f32)
    return torch.linalg.cholesky(cmat)


def scan_inputs(shocks: Shocks, p: ScenarioParams, monday_open) -> tuple:
    """The scan's arguments (``ops/scengen_scan.scengen_scan``'s) on the
    shocks' device: the uniforms, the Monday mask as int32, the return
    shocks mixed by the Cholesky factor (outside the scan, as engine.py
    mixes them), the other shocks, log(s0) and the scenario's
    ``ScanParams``."""
    n, n_assets = shocks.ret_z.shape
    dev = shocks.ret_z.device
    chol = correlation_cholesky(p.corr, n_assets).to(dev)
    eps = shocks.ret_z @ chol.T  # (n, A) correlated return shocks
    if not isinstance(monday_open, torch.Tensor):
        monday_open = torch.from_numpy(np.asarray(monday_open, bool))
    s0 = torch.broadcast_to(torch.as_tensor(np.asarray(p.s0, np.float32)), (n_assets,))
    return (shocks.regime_u, shocks.crash_u, shocks.gap_u, shocks.drought_u,
            monday_open.to(dev, torch.int32), eps.contiguous(), shocks.gap_z, shocks.hi_z,
            shocks.lo_z, torch.log(s0.to(dev)).contiguous(), k10.scan_params(p))


def paths_from_shocks(shocks: Shocks, p: ScenarioParams, monday_open) -> ScenPaths:
    """Deterministic transform: shocks + params + weekend mask -> tape, on
    the shocks' device (K10 on the card).  ``monday_open`` is a (n,) bool
    mask of bars that open after a weekend close (feed.fx_timestamp_grid)."""
    return ScenPaths(*k10.scengen_scan(*scan_inputs(shocks, p, monday_open)))


def generate(p: ScenarioParams, key, n_bars: int, n_assets: int = 1,
             monday_open: Optional[Any] = None) -> ScenPaths:
    """Draw the shocks and run the transform on the key's device."""
    if int(n_bars) < 2:
        raise ValueError(f"scengen needs n_bars >= 2, got {n_bars}")
    if int(n_assets) < 1:
        raise ValueError(f"scengen needs n_assets >= 1, got {n_assets}")
    if not (0.0 <= float(np.asarray(p.corr)) < 1.0):
        raise ValueError(f"corr must be in [0, 1), got {p.corr!r}")
    shocks = draw_shocks(key, int(n_bars), int(n_assets))
    if monday_open is None:
        monday_open = np.zeros(int(n_bars), bool)
    return paths_from_shocks(shocks, p, monday_open)
