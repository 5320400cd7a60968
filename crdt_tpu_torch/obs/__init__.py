"""Host-side observability for the port's node and cluster (own copies of
the parts of ``crdt_tpu.obs`` they use): the metrics registry and its
Prometheus exposition, trace IDs and spans, the event log, the flight
recorder, the replication-health gauges and scrape-time samplers, and the
merge dispatch's device attribution."""
