"""Logical-axis sharding rules: the part of ``repro.parallel.sharding``
that the MoE block reads.

The reference maps logical tensor axes ("batch", "expert", ...) to
physical mesh axes and lets GSPMD shard arrays by them.  The port runs
SPMD by hand: each rank already holds its shard, so only the mapping is
needed — which mesh dims a batch is split over (the MoE aux loss averages
over them) and which form the expert-parallel group.  ``resolve_spec``,
``constrain`` and ``use_mesh`` have no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass

# Default rules: logical name -> preferred physical axes, in priority order.
# Tuples mean "shard over the product of these axes".
DEFAULT_RULES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("batch", ("pod", "data")),
    ("fsdp", ("pod", "data")),      # parameter sharding (ZeRO/FSDP dim)
    ("seq", ()),                    # replicated by default
    ("seq_sp", ("model",)),         # sequence parallelism (Ulysses / decode KV)
    ("embed", ()),                  # activation d_model: replicated
    ("embed_tp", ("model",)),       # param d_model rows under TP
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("mlp", ("model",)),
    ("vocab", ("model",)),
    ("act_embed", ("model",)),      # activation d_model between layers
    ("expert", ("data",)),          # stored expert dim (owner axis)
    ("expert_virtual", ("pod", "data")),  # virtual expert dim (EP group)
    ("embed_fsdp", ("pod", "data")),      # param row dim: FSDP sharding
    ("conv", ()),
    ("state", ()),
)


def ep_axes(mesh) -> tuple[str, ...]:
    """EP all-to-all axes, fastest digit first (owner axis, then replicas).

    The virtual-expert rank is ``data_coord + |data| * pod_coord``: experts
    are owned along "data" and replicated across "pod", so the multi-pod
    dispatch is a d=2 factorized all-to-all (the "data" round, then the
    "pod" round)."""
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("data", "pod") if a in names)


@dataclass(frozen=True)
class ShardingRules:
    rules: tuple[tuple[str, tuple[str, ...]], ...] = DEFAULT_RULES

    def lookup(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        for name, axes in self.rules:
            if name == logical:
                return tuple(axes)
        raise KeyError(f"no rule for logical axis {logical!r}")

    def override(self, **kw) -> "ShardingRules":
        new = []
        seen = set()
        for name, axes in self.rules:
            if name in kw:
                new.append((name, tuple(kw[name]) if kw[name] else ()))
                seen.add(name)
            else:
                new.append((name, axes))
        for name in kw:
            if name not in seen:
                new.append((name, tuple(kw[name]) if kw[name] else ()))
        return ShardingRules(tuple(new))
