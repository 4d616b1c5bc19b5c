"""Serving: the slot/paged decode engine, the threaded ``Server`` and
the LoRA adapter pool."""

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
from ml_trainer_tpu_torch.serving.prefix_cache import PrefixCache
from ml_trainer_tpu_torch.serving.scheduler import (
    AdmissionError,
    DeadlineExceeded,
    FifoScheduler,
    Request,
)

__all__ = [
    "AdapterConfig", "AdapterPool", "AdapterPoolExhausted",
    "AdmissionError", "DeadlineExceeded", "FifoScheduler", "KVPagePool",
    "PrefixCache", "Request", "Server", "ServingMetrics", "SlotDecodeEngine",
    "TokenStream", "UnknownAdapter",
]
