"""Parallelism helpers of the port (so far: the sharding rules MoE reads)."""
