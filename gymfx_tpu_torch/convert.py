"""Carry weights and state across from the JAX package, through numpy.

Every function takes numpy arrays (or anything ``np.asarray`` reads,
addressed by field name) and imports nothing of JAX.  The tensors land
on ``device``: CUDA unless the caller names another, as for the entry
points (``gymfx_tpu_torch.resolve_device``).

  mlp_params_from_flax   a flax MLPPolicy param tree -> MLPPolicy state_dict
                         (Dense_0..k-1 hidden, Dense_k logits, Dense_k+1
                         value; a Dense kernel is (in, out), a Linear weight
                         (out, in))
  lstm_params_from_flax  a flax LSTMPolicy param tree -> LSTMPolicy state_dict
                         (Dense_0 the embedding, OptimizedLSTMCell_0's eight
                         gate kernels stacked i, f, g, o, Dense_1 logits,
                         Dense_2 value)
  ring_transformer_params_from_flax
                         a flax RingTransformerPolicy (or the portfolio's
                         PortfolioRingTransformerPolicy) tree -> state_dict
  transformer_params_from_flax
                         a flax TransformerPolicy (or PortfolioTransformerPolicy)
                         tree -> state_dict (MultiHeadDotProductAttention's
                         query/key/value/out as Linear layers)
  gaussian_params_from_flax
                         a flax Gaussian twin's tree (ContinuousMLPPolicy:
                         the trunk's Dense_0..n-1, Dense_n the mean,
                         log_std, Dense_n+1 the value; the LSTM and ring
                         twins: their trunk's names plus
                         GaussianValueHead_0/{Dense_0, Dense_1, log_std})
                         -> state_dict
  policy_params_from_flax
                         a policy's name and its flax tree -> state_dict,
                         through the converter of that policy family (a
                         ``<name>_continuous`` name: its Gaussian twin's)
  stack_members          P members' state dicts -> one with a leading (P,)
                         member axis (the portfolio trainers' params; the
                         portfolio MLP converts through mlp_params_from_flax)
  env_state_from_numpy   a batched EnvState's arrays -> EnvState tensors
  market_data_from_numpy a MarketData's arrays -> MarketData tensors (a
                         streamed shard's row0 kept, as an int)
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


def lstm_params_from_flax(tree: Mapping[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """State dict for :class:`~gymfx_tpu_torch.train.policies.LSTMPolicy`
    from a flax LSTMPolicy tree (the outer "params" level is optional).
    ``OptimizedLSTMCell_0`` holds the input kernels ``ii, if, ig, io`` (no
    bias) and the hidden kernels ``hi, hf, hg, ho`` with biases, each
    (hidden, hidden); the port stacks each set along its output axis in
    that gate order."""
    device = resolve_device(device)
    params = tree.get("params", tree)
    cell = params["OptimizedLSTMCell_0"]
    out: Dict[str, torch.Tensor] = {}
    for key, name in (("Dense_0", "embed"), ("Dense_1", "logits"), ("Dense_2", "value")):
        out[f"{name}.weight"] = _tensor(np.asarray(params[key]["kernel"]).T, device)
        out[f"{name}.bias"] = _tensor(params[key]["bias"], device)
    for part in ("i", "h"):
        kernels = [np.asarray(cell[f"{part}{gate}"]["kernel"]) for gate in "ifgo"]
        out[f"cell_{part}.weight"] = _tensor(np.concatenate(kernels, axis=1).T, device)
    out["cell_h.bias"] = _tensor(np.concatenate([np.asarray(cell[f"h{g}"]["bias"])
                                                 for g in "ifgo"]), device)
    return out


def ring_transformer_params_from_flax(tree: Mapping[str, Any],
                                      device=None) -> Dict[str, torch.Tensor]:
    """State dict for :class:`~gymfx_tpu_torch.train.policies.RingTransformerPolicy`
    from a flax RingTransformerPolicy tree (the outer "params" level is
    optional).  Flax names the encoder's modules in call order: Dense_0
    the token embedding; per layer l, LayerNorm_{2l}, DenseGeneral_{4l..4l+2}
    (q, k, v; kernels (d_model, H, Dh)), DenseGeneral_{4l+3} (the output,
    kernel (H, Dh, d_model)), LayerNorm_{2l+1}, Dense_{2l+1} and
    Dense_{2l+2} (the MLP); LayerNorm_{2L} last.  The policy's own
    Dense_0 / Dense_1 are the logits and value heads."""
    device = resolve_device(device)
    params = tree.get("params", tree)
    enc = params["RingTransformerEncoder_0"]
    n_layers = sum(1 for k in enc if k.startswith("DenseGeneral_")) // 4
    out: Dict[str, torch.Tensor] = {}

    def linear(name: str, dense, in_axes: int = 1) -> None:
        _linear(out, name, dense, device, in_axes)

    def norm(name: str, key: str) -> None:
        _norm(out, name, enc[key], device)

    linear("encoder.embed", enc["Dense_0"])
    out["encoder.pos_embed"] = _tensor(enc["pos_embed"], device)
    for l in range(n_layers):
        pre = f"encoder.layers.{l}"
        norm(f"{pre}.ln1", f"LayerNorm_{2 * l}")
        for j, proj in enumerate(("q", "k", "v", "out")):
            linear(f"{pre}.{proj}", enc[f"DenseGeneral_{4 * l + j}"], 2 if proj == "out" else 1)
        norm(f"{pre}.ln2", f"LayerNorm_{2 * l + 1}")
        for j, fc in enumerate(("fc1", "fc2")):
            linear(f"{pre}.{fc}", enc[f"Dense_{2 * l + 1 + j}"])
    norm("encoder.norm", f"LayerNorm_{2 * n_layers}")
    for key, head in (("Dense_0", "logits"), ("Dense_1", "value")):
        linear(head, params[key])
    return out


def transformer_params_from_flax(tree: Mapping[str, Any],
                                 device=None) -> Dict[str, torch.Tensor]:
    """State dict for :class:`~gymfx_tpu_torch.train.policies.TransformerPolicy`
    or the portfolio's ``PortfolioTransformerPolicy`` (train/portfolio_ppo.py)
    from the flax tree of either (the outer "params" level is optional).
    Flax names the modules in call order: Dense_0 the token embedding,
    ``pos_embed``; per layer l, LayerNorm_{2l}, MultiHeadDotProductAttention_l
    (query/key/value kernels (d_model, H, Dh), out (H, Dh, d_model)),
    LayerNorm_{2l+1}, Dense_{2l+1} and Dense_{2l+2} (the MLP); LayerNorm_{2L}
    last, then Dense_{2L+1} and Dense_{2L+2}, the logits and value heads."""
    device = resolve_device(device)
    params = tree.get("params", tree)
    n_layers = sum(1 for k in params if k.startswith("MultiHeadDotProductAttention_"))
    out: Dict[str, torch.Tensor] = {}
    _linear(out, "encoder.embed", params["Dense_0"], device)
    out["encoder.pos_embed"] = _tensor(params["pos_embed"], device)
    for l in range(n_layers):
        pre = f"encoder.layers.{l}"
        _norm(out, f"{pre}.ln1", params[f"LayerNorm_{2 * l}"], device)
        mha = params[f"MultiHeadDotProductAttention_{l}"]
        for proj, name in (("query", "q"), ("key", "k"), ("value", "v"), ("out", "out")):
            _linear(out, f"{pre}.{name}", mha[proj], device, 2 if proj == "out" else 1)
        _norm(out, f"{pre}.ln2", params[f"LayerNorm_{2 * l + 1}"], device)
        for j, fc in enumerate(("fc1", "fc2")):
            _linear(out, f"{pre}.{fc}", params[f"Dense_{2 * l + 1 + j}"], device)
    _norm(out, "encoder.norm", params[f"LayerNorm_{2 * n_layers}"], device)
    for j, head in enumerate(("logits", "value")):
        _linear(out, head, params[f"Dense_{2 * n_layers + 1 + j}"], device)
    return out


def gaussian_params_from_flax(family: str, tree: Mapping[str, Any],
                              device=None) -> Dict[str, torch.Tensor]:
    """State dict of the Gaussian twin of ``family`` (``mlp``, ``lstm``,
    ``transformer``, ``transformer_ring``, ``transformer_ulysses``) from
    its flax tree (the outer "params" level is optional)."""
    device = resolve_device(device)
    params = dict(tree.get("params", tree))
    refused = ValueError(f"no converter for policy {family + '_continuous'!r} from a tree of "
                         f"{sorted(params)} (not a Gaussian twin's)")
    if family == "mlp":
        dense = sorted((k for k in params if k.startswith("Dense_")), key=lambda k: int(k[6:]))
        if len(dense) < 3 or dense != [f"Dense_{i}" for i in range(len(dense))] \
                or "log_std" not in params:
            raise refused
        names = [f"hidden.{i}" for i in range(len(dense) - 2)] + ["mu", "value"]
        out: Dict[str, torch.Tensor] = {}
        for key, name in zip(dense, names):
            _linear(out, name, params[key], device)
        out["log_std"] = _tensor(params["log_std"], device)
        return out
    if "GaussianValueHead_0" not in params:
        raise refused
    head = params.pop("GaussianValueHead_0")
    # the trunk through its discrete converter, with placeholder heads
    # where the discrete policy has its logits and value layers
    zero = {"kernel": np.zeros((1, 1), np.float32), "bias": np.zeros((1,), np.float32)}
    if family == "lstm":
        params.update(Dense_1=zero, Dense_2=zero)
        trunk = lstm_params_from_flax(params, device=device)
    elif family in ("transformer", "transformer_ring", "transformer_ulysses"):
        params.update(Dense_0=zero, Dense_1=zero)
        trunk = ring_transformer_params_from_flax(params, device=device)
    else:
        raise ValueError(f"no Gaussian twin of policy {family!r}")
    out = {k: v for k, v in trunk.items() if k.split(".")[0] not in ("logits", "value")}
    _linear(out, "head.mu", head["Dense_0"], device)
    out["head.log_std"] = _tensor(head["log_std"], device)
    _linear(out, "head.value", head["Dense_1"], device)
    return out


def policy_params_from_flax(name: str, tree: Mapping[str, Any],
                            device=None) -> Dict[str, torch.Tensor]:
    """State dict of the policy ``name`` (as ``train/policies.make_policy``
    names it) from its flax tree: the converter of its family (a
    ``<family>_continuous`` name: :func:`gaussian_params_from_flax`)."""
    if name.endswith("_continuous"):
        return gaussian_params_from_flax(name[: -len("_continuous")], tree, device=device)
    converters = {
        "mlp": mlp_params_from_flax,
        "lstm": lstm_params_from_flax,
        "transformer": transformer_params_from_flax,
        "transformer_ring": ring_transformer_params_from_flax,
        "transformer_ulysses": ring_transformer_params_from_flax,
    }
    if name not in converters:
        raise ValueError(f"no converter for policy {name!r} (expected one of {sorted(converters)})")
    return converters[name](tree, device=device)


def stack_members(members) -> Dict[str, torch.Tensor]:
    """One state dict of P members' state dicts (each a dict of tensors of
    one structure), every leaf stacked on a leading (P,) member axis: the
    population's params (train/pbt.py), or one member's as P = 1."""
    members = list(members)
    return {k: torch.stack([m[k] for m in members]) for k in members[0]}


def _linear(out: Dict[str, torch.Tensor], name: str, dense, device, in_axes: int = 1) -> None:
    """``name``.weight / .bias from a flax Dense or DenseGeneral whose
    kernel's first ``in_axes`` axes are contracted: (in..., out...)."""
    kernel = np.asarray(dense["kernel"])
    fan_in = int(np.prod(kernel.shape[:in_axes]))
    out[f"{name}.weight"] = _tensor(kernel.reshape(fan_in, -1).T, device)
    out[f"{name}.bias"] = _tensor(np.asarray(dense["bias"]).reshape(-1), device)


def _norm(out: Dict[str, torch.Tensor], name: str, layer_norm, device) -> None:
    out[f"{name}.weight"] = _tensor(layer_norm["scale"], device)
    out[f"{name}.bias"] = _tensor(layer_norm["bias"], device)


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
    fields = {name: _tensor(get(name), device) for name in MarketData._fields if name != "row0"}
    # a streamed shard carries its global start row; the port keeps it an int
    return MarketData(row0=int(np.asarray(get("row0"))), **fields)
