"""Telemetry: the metrics registry (``registry.py``) and its Prometheus
text exposition (``export.py``), the exposition parser of metrics
federation (``federation.py``), the flight recorder (``flight.py``),
the Watchtower time-series store (``watchtower.py``) and the alert
engine over it (``alerts.py``)."""

from ml_trainer_tpu_torch.telemetry.alerts import (
    AlertEngine,
    AlertRule,
    default_fleet_rules,
)
from ml_trainer_tpu_torch.telemetry.export import prometheus_text
from ml_trainer_tpu_torch.telemetry.flight import (
    FLIGHT_DIR_ENV,
    FlightRecorder,
    get_recorder,
)
from ml_trainer_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    reset_default_registry,
)
from ml_trainer_tpu_torch.telemetry.watchtower import (
    TimeSeriesStore,
    default_store,
    install_flight_context,
    render_dashboard,
    reset_default_store,
    save_dashboard,
    watch_context,
)

__all__ = ["AlertEngine", "AlertRule", "Counter", "FLIGHT_DIR_ENV",
           "FlightRecorder", "Gauge", "Histogram", "MetricsRegistry",
           "TimeSeriesStore", "default_fleet_rules", "default_registry",
           "default_store", "get_recorder", "install_flight_context",
           "prometheus_text",
           "render_dashboard", "reset_default_registry",
           "reset_default_store", "save_dashboard", "watch_context"]
