from gymfx_tpu_torch.simulation.replay import ReplayAdapter, stable_hash  # noqa: F401
from gymfx_tpu_torch.simulation import fixtures  # noqa: F401
from gymfx_tpu_torch.simulation.oracle import reconcile_fills  # noqa: F401
