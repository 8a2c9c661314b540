"""Core services of the port: the torus all-to-all (dims, simulator,
tuning, cache, factorized, overlap, pipelined, ragged, sparse, plan,
comm) and the metrics registry."""
