"""Observability: the host-side counters/gauges registry."""
