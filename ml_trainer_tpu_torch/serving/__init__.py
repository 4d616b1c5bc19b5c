"""Serving: the slot/paged decode engine, the threaded ``Server`` with
its HTTP front end and watchdog, the weighted multi-tenant scheduler,
SLO accounting, the overload ladder and the LoRA adapter pool."""

from ml_trainer_tpu_torch.serving.adapter_pool import (
    AdapterConfig,
    AdapterPool,
    AdapterPoolExhausted,
    UnknownAdapter,
)
from ml_trainer_tpu_torch.serving.api import Server, TokenStream
from ml_trainer_tpu_torch.serving.engine import SlotDecodeEngine
from ml_trainer_tpu_torch.serving.kv_pool import KVPagePool
from ml_trainer_tpu_torch.serving.metrics import ServingMetrics
from ml_trainer_tpu_torch.serving.overload import (
    CircuitBreaker,
    DegradationConfig,
    DegradationLadder,
    OverloadShed,
    RollingQuantile,
)
from ml_trainer_tpu_torch.serving.prefix_cache import PrefixCache
from ml_trainer_tpu_torch.serving.scheduler import (
    AdmissionError,
    DeadlineExceeded,
    EngineUnhealthy,
    Request,
    TenantConfig,
    TenantScheduler,
)
from ml_trainer_tpu_torch.serving.slo import (
    SloPolicy,
    SloTracker,
    aggregate_timelines,
)

__all__ = [
    "AdapterConfig", "AdapterPool", "AdapterPoolExhausted",
    "AdmissionError", "CircuitBreaker", "DeadlineExceeded",
    "DegradationConfig", "DegradationLadder", "EngineUnhealthy",
    "KVPagePool", "OverloadShed", "PrefixCache", "Request",
    "RollingQuantile", "Server", "ServingMetrics", "SloPolicy",
    "SloTracker", "SlotDecodeEngine", "TenantConfig", "TenantScheduler",
    "TokenStream", "UnknownAdapter", "aggregate_timelines",
]
