"""Batched low-latency policy serving: the port of ``gymfx_tpu/serve/``
(docs/serving.md) without the blue/green deployer and the decision fleet
(ROADMAP.md Queue 1 item 16).

A bucket ladder of CUDA graphs over the policy's forward pass
(:mod:`engine`), a micro-batching scheduler coalescing concurrent
requests into one replay (:mod:`batcher`), a per-session O(1)
featurizer producing observations bit-identical to the training env's
(:mod:`features`), and device-resident session carry (:mod:`slots`)."""
from gymfx_tpu_torch.serve.batcher import (
    MicroBatcher,
    RequestRecord,
    batcher_from_config,
)
from gymfx_tpu_torch.serve.config import (
    FleetConfig,
    ServeConfig,
    fleet_config_from,
    serve_config_from,
)
from gymfx_tpu_torch.serve.engine import (
    DEFAULT_BUCKETS,
    Decision,
    EngineBundle,
    EngineDispatch,
    InferenceEngine,
    WeightSwapError,
    engine_from_config,
    resolve_batch_mode,
)
from gymfx_tpu_torch.serve.features import (
    BarFeaturizer,
    BarSession,
    flatten_obs_host,
    make_host_encoder,
    tokens_from_obs_host,
)
from gymfx_tpu_torch.serve.overload import (
    OVERLOAD_ERRORS,
    BatcherClosedError,
    DeadlineExceeded,
    DrainWhilePausedError,
    NoHealthyReplicaError,
    ShedError,
)
from gymfx_tpu_torch.serve.slots import SlotCache

__all__ = [
    "DEFAULT_BUCKETS",
    "OVERLOAD_ERRORS",
    "BarFeaturizer",
    "BarSession",
    "BatcherClosedError",
    "DeadlineExceeded",
    "Decision",
    "DrainWhilePausedError",
    "EngineBundle",
    "EngineDispatch",
    "FleetConfig",
    "InferenceEngine",
    "MicroBatcher",
    "NoHealthyReplicaError",
    "RequestRecord",
    "ServeConfig",
    "ShedError",
    "SlotCache",
    "WeightSwapError",
    "batcher_from_config",
    "engine_from_config",
    "fleet_config_from",
    "flatten_obs_host",
    "make_host_encoder",
    "resolve_batch_mode",
    "serve_config_from",
    "tokens_from_obs_host",
]
