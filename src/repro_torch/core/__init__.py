"""Core services of the port: the torus all-to-all (dims, simulator,
tuning, cache, factorized, plan, comm) and the metrics registry."""
