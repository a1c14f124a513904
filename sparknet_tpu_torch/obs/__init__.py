"""Observability: the metrics registry, the host-side span tracer, request
tracing, the status server, run metadata and the pod view."""
