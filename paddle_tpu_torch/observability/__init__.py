"""Host-only telemetry of the port: the metrics registry and trace spans
that the paged generator and the scheduler write into (copies of
``paddle_tpu/observability/{metrics,tracing}.py``)."""

from . import metrics, tracing
from .metrics import MetricsRegistry, Sample, registry
from .tracing import Tracer, tracer

__all__ = ["metrics", "tracing", "MetricsRegistry", "Sample", "registry",
           "Tracer", "tracer"]
