"""Runtime of the port (so far: colocated continuous batching)."""
