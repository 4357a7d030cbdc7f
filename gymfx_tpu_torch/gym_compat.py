"""Gymnasium's ``Env``, ``spaces``, ``VectorEnv`` and ``batch_space`` for
the shells (``gym_env.py``, ``vector_env.py``).

Where the ``gymnasium`` package is installed these are its own classes,
so the shells are gymnasium environments (``check_env`` passes, external
RL libraries take them).  Where it is not, they are the stand-ins below,
cut to what the shells declare and an agent reads off them: ``Box``
(``low``, ``high``, ``shape``, ``dtype``), ``Discrete`` (``n``),
``MultiDiscrete`` (``nvec``) and ``Dict`` (``spaces``), each with
``contains``; ``batch_space``; ``Env`` and ``VectorEnv`` with
``reset`` / ``close``.  No sampling or seeding: a caller that needs them
installs gymnasium.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional

import numpy as np

try:
    import gymnasium as _gymnasium
    from gymnasium import spaces
    from gymnasium.vector import VectorEnv
    from gymnasium.vector.utils import batch_space

    Env = _gymnasium.Env
    HAVE_GYMNASIUM = True
except ImportError:
    HAVE_GYMNASIUM = False

    class Box:
        def __init__(self, low, high, shape=None, dtype=np.float32):
            self.dtype = np.dtype(dtype)
            self.shape = tuple(int(x) for x in (np.shape(low) if shape is None else shape))
            self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
            self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

        def contains(self, x) -> bool:
            x = np.asarray(x)
            return (x.shape == self.shape and np.can_cast(x.dtype, self.dtype)
                    and bool(np.all(x >= self.low)) and bool(np.all(x <= self.high)))

    class Discrete:
        shape, dtype = (), np.dtype(np.int64)

        def __init__(self, n: int):
            self.n = int(n)

        def contains(self, x) -> bool:
            x = np.asarray(x)
            return x.shape == () and np.issubdtype(x.dtype, np.integer) and 0 <= int(x) < self.n

    class MultiDiscrete:
        dtype = np.dtype(np.int64)

        def __init__(self, nvec):
            self.nvec = np.asarray(nvec, np.int64)
            self.shape = self.nvec.shape

        def contains(self, x) -> bool:
            x = np.asarray(x)
            return (x.shape == self.shape and np.issubdtype(x.dtype, np.integer)
                    and bool(np.all((x >= 0) & (x < self.nvec))))

    class Dict:
        def __init__(self, spaces_: Dict[str, Any]):
            self.spaces = dict(spaces_)

        def contains(self, x) -> bool:
            return (isinstance(x, dict) and set(x) == set(self.spaces)
                    and all(self.spaces[k].contains(v) for k, v in x.items()))

        def keys(self):
            return self.spaces.keys()

        def __getitem__(self, key):
            return self.spaces[key]

    spaces = SimpleNamespace(Box=Box, Discrete=Discrete, MultiDiscrete=MultiDiscrete, Dict=Dict)

    def batch_space(space, n: int):
        """``space`` batched ``n`` times, as gymnasium's ``batch_space``."""
        if isinstance(space, Box):
            return Box(np.stack([space.low] * n), np.stack([space.high] * n),
                       (n, *space.shape), space.dtype)
        if isinstance(space, Discrete):
            return MultiDiscrete(np.full((n,), space.n))
        if isinstance(space, Dict):
            return Dict({k: batch_space(s, n) for k, s in space.spaces.items()})
        raise TypeError(f"cannot batch {type(space).__name__}")

    class Env:
        """The surface of ``gymnasium.Env`` the shells use."""

        metadata: Dict[str, Any] = {"render_modes": []}
        render_mode = None

        def reset(self, *, seed: Optional[int] = None, options=None):
            pass

        @property
        def unwrapped(self):
            return self

        def close(self):
            pass

    class VectorEnv:
        """The surface of ``gymnasium.vector.VectorEnv`` the shells use."""

        metadata: Dict[str, Any] = {"autoreset_mode": "NextStep"}
        closed = False

        def close(self, **kwargs):
            if not self.closed:
                self.close_extras(**kwargs)
            self.closed = True

        def close_extras(self, **kwargs):
            pass

        @property
        def unwrapped(self):
            return self
