"""Observability: the metrics registry and the host-side span tracer."""
