"""Serving: the slot/paged decode engine, the threaded ``Server`` with
its HTTP front end and watchdog, the weighted multi-tenant scheduler,
SLO accounting, the overload ladder, the LoRA adapter pool, KV migration
(``transfer.py``), the disaggregated ``Router`` with its deploy
generations (``deploy.py``) and ``Autoscaler``, the open-loop load
generator (``loadgen.py``) and the multi-process ``Fleet``
(``RemoteServer``; imported at first use, so that ``python -m
ml_trainer_tpu_torch.serving.fleet`` runs the module once)."""

from ml_trainer_tpu_torch.serving.adapter_pool import (
    AdapterConfig,
    AdapterPool,
    AdapterPoolExhausted,
    UnknownAdapter,
)
from ml_trainer_tpu_torch.serving.api import Server, TokenStream
from ml_trainer_tpu_torch.serving.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
)
from ml_trainer_tpu_torch.serving.deploy import DeployConfig, Deployment
from ml_trainer_tpu_torch.serving.engine import SlotDecodeEngine
from ml_trainer_tpu_torch.serving.kv_pool import KVPagePool
from ml_trainer_tpu_torch.serving.loadgen import (
    ScheduledRequest,
    TenantLoad,
    poisson_schedule,
    run_open_loop,
    schedule_from_trace,
    schedule_to_records,
)
from ml_trainer_tpu_torch.serving.metrics import ServingMetrics
from ml_trainer_tpu_torch.serving.overload import (
    CircuitBreaker,
    DegradationConfig,
    DegradationLadder,
    OverloadShed,
    RollingQuantile,
)
from ml_trainer_tpu_torch.serving.prefix_cache import PrefixCache
from ml_trainer_tpu_torch.serving.router import Router
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
from ml_trainer_tpu_torch.serving.transfer import (
    KVSlotExport,
    MigrationCorrupt,
    WeightsMismatch,
)


def __getattr__(name):
    if name in ("Fleet", "RemoteServer"):
        from ml_trainer_tpu_torch.serving import fleet

        return getattr(fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "AdapterConfig", "AdapterPool", "AdapterPoolExhausted",
    "AdmissionError", "Autoscaler", "AutoscalerConfig", "CircuitBreaker",
    "DeadlineExceeded", "DegradationConfig", "DegradationLadder",
    "DeployConfig", "Deployment", "EngineUnhealthy", "Fleet",
    "KVPagePool", "KVSlotExport", "MigrationCorrupt", "OverloadShed",
    "PrefixCache", "RemoteServer", "Request", "RollingQuantile", "Router",
    "ScheduledRequest", "Server", "ServingMetrics", "SloPolicy",
    "SloTracker", "SlotDecodeEngine", "TenantConfig", "TenantLoad",
    "TenantScheduler", "TokenStream", "UnknownAdapter", "WeightsMismatch",
    "aggregate_timelines", "poisson_schedule", "run_open_loop",
    "schedule_from_trace", "schedule_to_records",
]
