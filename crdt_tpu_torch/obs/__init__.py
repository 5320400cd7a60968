"""Host-side observability for the port's node and cluster (own copies of
the parts of ``crdt_tpu.obs`` they use): the metrics registry and its
Prometheus exposition, trace IDs and spans, the event log, the flight
recorder, the replication-health gauges and scrape-time samplers, and the
merge dispatch's device attribution.  ``NULL_REGISTRY`` is the telemetry
opt-out: ``utils.metrics.Metrics(registry=NULL_REGISTRY)`` records nothing
and keeps every gate on ``registry.enabled`` off."""
from crdt_tpu_torch.obs.assemble import (
    assemble_trace,
    blame_report,
    load_node_logs,
    write_postmortem,
)
from crdt_tpu_torch.obs.events import SCHEMA_VERSION, EventLog, read_jsonl
from crdt_tpu_torch.obs.provenance import (
    BirthLedger,
    FlightRecorder,
    propagation_summary,
)
from crdt_tpu_torch.obs.registry import (
    NULL_REGISTRY,
    Histogram,
    MetricsRegistry,
    NullRegistry,
)
from crdt_tpu_torch.obs.trace import TRACE_HEADER, current_trace, mint_trace_id, span

__all__ = [
    "EventLog",
    "SCHEMA_VERSION",
    "read_jsonl",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "NULL_REGISTRY",
    "TRACE_HEADER",
    "current_trace",
    "mint_trace_id",
    "span",
    "BirthLedger",
    "FlightRecorder",
    "propagation_summary",
    "assemble_trace",
    "blame_report",
    "load_node_logs",
    "write_postmortem",
]
