"""Observability of the port: the flight recorder, spans, the heartbeater,
liveness, fleet telemetry, the crash black box, the cross-host trace and the
Prometheus exporter."""
