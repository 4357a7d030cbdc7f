"""gymfx_tpu_torch: the PyTorch/CUDA port of gymfx_tpu for NVIDIA Hopper.

Module paths mirror the JAX package (``gymfx_tpu/core/env.py`` <->
``gymfx_tpu_torch/core/env.py``).  The port imports torch and numpy
only: nothing from jax, flax, optax, pandas or ``gymfx_tpu``.

Device rule: entry points run on ``torch.device("cuda")`` unless the
caller passes ``device="cpu"``.  On a CUDA tensor every kernel wrapper
launches its hand-written kernel (``csrc/env_kernels.cu``) or raises; on
a CPU tensor it runs the kernel's plain PyTorch version.

``Environment``, ``GymFxEnv``, ``GymFxVectorEnv`` and ``build_environment``
are lazy top-level exports, as the JAX package's are
(``gymfx_tpu/__init__.py``): importing the package loads none of them.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The entry points' device: CUDA unless the caller names another.
    Raises when CUDA is absent and no device was given — there is no
    silent move to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the "
                "port's plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


# lazy top-level exports (PEP 562)
_LAZY = {
    "Environment": "gymfx_tpu_torch.core.runtime",
    "GymFxEnv": "gymfx_tpu_torch.gym_env",
    "GymFxVectorEnv": "gymfx_tpu_torch.vector_env",
    "build_environment": "gymfx_tpu_torch.gym_env",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module 'gymfx_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
