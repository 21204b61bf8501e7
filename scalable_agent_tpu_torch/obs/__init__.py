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

The consumers (``health``, ``learning``, the ``aggregate``, ``report``,
``diagnose`` and ``watch`` CLIs, ``MetricsHTTPServer``) and the kernel
ledger (``kernels``) are not ported yet (ROADMAP.md, queue 1).
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
    "CATEGORIES",
    "Counter",
    "DeviceTelemetry",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsWriter",
    "PipelineLedger",
    "PrometheusExporter",
    "StallAttributor",
    "TelemetryPublisher",
    "Tracer",
    "Watchdog",
    "configure_flight_recorder",
    "configure_ledger",
    "configure_tracer",
    "configure_watchdog",
    "get_flight_recorder",
    "get_ledger",
    "get_registry",
    "get_tracer",
    "get_watchdog",
    "install_crash_handlers",
    "load_trace_events",
    "render_prometheus",
    "span",
]
