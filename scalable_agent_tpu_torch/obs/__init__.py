"""Observability: the producers a training run arms.

The counterpart of ``scalable_agent_tpu/obs/``'s producers.  The runtime
instruments itself against process-global objects: ``get_tracer()``
(Chrome-trace spans, disabled by default), ``get_registry()`` (counters,
gauges, histograms; always live), ``get_flight_recorder()`` (the ring of
recent runtime events, dumped with every thread's stack on a signal, an
exception or a watchdog stall), ``get_watchdog()`` (heartbeats and the
stale-thread monitor, disabled by default) and ``get_ledger()`` (each
trajectory's stage stamps and their queueing-model derivation).  The
exporters write the registry as ``metrics.prom`` and as rows of
``metrics.jsonl``; the stall attributor names each log interval's
bottleneck; ``device_telemetry`` keeps the learner's instruments on the
card.

The run-health plane (``health``, with the verdict rules of ``learning``)
reads that stream at log cadence, and ``kernels`` turns a profile window
into a per-kernel table.  The ``aggregate``, ``report``, ``diagnose`` and
``watch`` CLIs and ``MetricsHTTPServer`` are not ported yet (ROADMAP.md,
queue 1).
"""

from scalable_agent_tpu_torch.obs.device_telemetry import (
    DeviceTelemetry,
    TelemetryPublisher,
)
from scalable_agent_tpu_torch.obs.exporters import (
    MetricsWriter,
    PrometheusExporter,
    render_prometheus,
)
from scalable_agent_tpu_torch.obs.flightrec import (
    FlightRecorder,
    configure_flight_recorder,
    get_flight_recorder,
    install_crash_handlers,
)
from scalable_agent_tpu_torch.obs.health import (
    ANOMALIES_JSONL,
    DetectorSpec,
    HealthMonitor,
    default_detectors,
    read_anomalies,
)
from scalable_agent_tpu_torch.obs.kernels import (
    KERNELS_JSON_NAME,
    build_kernel_table,
    publish_kernel_metrics,
    write_kernels_json,
)
from scalable_agent_tpu_torch.obs.ledger import (
    PipelineLedger,
    configure_ledger,
    get_ledger,
)
from scalable_agent_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from scalable_agent_tpu_torch.obs.stall import CATEGORIES, StallAttributor
from scalable_agent_tpu_torch.obs.trace import (
    Tracer,
    configure_tracer,
    get_tracer,
    load_trace_events,
    span,
)
from scalable_agent_tpu_torch.obs.watchdog import (
    Watchdog,
    configure_watchdog,
    get_watchdog,
)

__all__ = [
    "ANOMALIES_JSONL",
    "CATEGORIES",
    "Counter",
    "DetectorSpec",
    "DeviceTelemetry",
    "FlightRecorder",
    "Gauge",
    "HealthMonitor",
    "Histogram",
    "KERNELS_JSON_NAME",
    "MetricsRegistry",
    "MetricsWriter",
    "PipelineLedger",
    "PrometheusExporter",
    "StallAttributor",
    "TelemetryPublisher",
    "Tracer",
    "Watchdog",
    "build_kernel_table",
    "configure_flight_recorder",
    "configure_ledger",
    "configure_tracer",
    "configure_watchdog",
    "default_detectors",
    "get_flight_recorder",
    "get_ledger",
    "get_registry",
    "get_tracer",
    "get_watchdog",
    "install_crash_handlers",
    "load_trace_events",
    "publish_kernel_metrics",
    "read_anomalies",
    "render_prometheus",
    "span",
    "write_kernels_json",
]
