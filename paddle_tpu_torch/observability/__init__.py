"""Host-only telemetry of the port (copies of
``paddle_tpu/observability/{metrics,tracing,server}.py``): the metrics
registry, trace spans, and the live HTTP endpoints.

* ``metrics``  — Counter/Gauge/Histogram registry with label sets,
  Prometheus text exposition + JSON snapshot; dict stats surfaces
  contribute via scrape-time collectors.
* ``tracing``  — ring-buffered spans with Chrome-trace/Perfetto export.
* ``server``   — ``ObservabilityServer`` exposing ``/metrics``,
  ``/healthz``, ``/statusz``, ``/trace``; scrape with
  ``python -m paddle_tpu_torch.tools.obs``.
"""

from . import metrics, tracing
from .metrics import MetricsRegistry, Sample, registry
from .server import ObservabilityServer, resolve_source
from .tracing import Tracer, tracer

__all__ = ["metrics", "tracing", "MetricsRegistry", "Sample", "registry",
           "ObservabilityServer", "resolve_source", "Tracer", "tracer"]
