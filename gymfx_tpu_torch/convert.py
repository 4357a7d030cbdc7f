"""Carry weights and state across from the JAX package, through numpy.

Every function takes numpy arrays (or anything ``np.asarray`` reads,
addressed by field name) and imports nothing of JAX.  The tensors land
on ``device``: CUDA unless the caller names another, as for the entry
points (``gymfx_tpu_torch.resolve_device``).

  mlp_params_from_flax   a flax MLPPolicy param tree -> MLPPolicy state_dict
                         (Dense_0..k-1 hidden, Dense_k logits, Dense_k+1
                         value; a Dense kernel is (in, out), a Linear weight
                         (out, in))
  env_state_from_numpy   a batched EnvState's arrays -> EnvState tensors
  market_data_from_numpy a MarketData's arrays -> MarketData tensors
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from gymfx_tpu_torch import resolve_device
from gymfx_tpu_torch.core.types import EnvState
from gymfx_tpu_torch.data.feed import MarketData


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), copy=True)).to(device)


def mlp_params_from_flax(tree: Mapping[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """State dict for :class:`~gymfx_tpu_torch.train.policies.MLPPolicy`
    from a flax ``{"params": {"Dense_i": {"kernel", "bias"}}}`` tree (the
    outer "params" level is optional)."""
    device = resolve_device(device)
    params = tree.get("params", tree)
    dense = sorted((k for k in params if k.startswith("Dense_")), key=lambda k: int(k[6:]))
    if len(dense) < 3 or dense != [f"Dense_{i}" for i in range(len(dense))]:
        raise ValueError(f"not an MLPPolicy param tree: {list(params)}")
    names = [f"hidden.{i}" for i in range(len(dense) - 2)] + ["logits", "value"]
    out = {}
    for key, name in zip(dense, names):
        out[f"{name}.weight"] = _tensor(np.asarray(params[key]["kernel"]).T, device)
        out[f"{name}.bias"] = _tensor(params[key]["bias"], device)
    return out


def env_state_from_numpy(state: Any, device=None) -> EnvState:
    """EnvState tensors from a batched EnvState (or mapping) of arrays
    with the same field names."""
    device = resolve_device(device)
    get = state.__getitem__ if isinstance(state, Mapping) else lambda k: getattr(state, k)
    return EnvState(*(_tensor(get(name), device) for name in EnvState._fields))


def market_data_from_numpy(data: Any, device=None) -> MarketData:
    """MarketData tensors from a MarketData (or mapping) of arrays."""
    device = resolve_device(device)
    get = data.__getitem__ if isinstance(data, Mapping) else lambda k: getattr(data, k)
    fields = {name: _tensor(get(name), device) for name in MarketData._fields
              if name not in ("row0",)}
    if int(np.asarray(get("row0"))) != 0:
        raise ValueError("streamed shards (row0 != 0) are not ported")
    return MarketData(row0=0, **fields)
