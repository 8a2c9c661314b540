"""Core services of the port (so far: the metrics registry)."""
