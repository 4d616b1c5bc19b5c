"""Telemetry, as far as the serving front end's ``GET /metrics`` needs it:
the metrics registry (``registry.py``) and its Prometheus text
exposition (``export.py``)."""

from ml_trainer_tpu_torch.telemetry.export import prometheus_text
from ml_trainer_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    reset_default_registry,
)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "prometheus_text", "reset_default_registry"]
