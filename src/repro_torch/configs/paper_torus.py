"""The paper's own experiment (§5) as a config: p = 36 x 32 = 1152
processes, factorizations from Table 1, message deciles 1..10^4 MPI_INT,
8 warmup + 40 measured repetitions, best-of.

The reference's ``benchmarks/alltoall_cmp.py`` runs the CPU-feasible
scale (p=16) with the same protocol; this config records the full-scale
plan for a real cluster run and feeds the tuning-model predictions.  A
copy of ``repro.configs.paper_torus`` on the port's ``core.dims`` and
``core.tuning``.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.dims import dims_create
from repro_torch.core.tuning import ICI, LinkModel, choose_algorithm


@dataclass(frozen=True)
class AlltoallBenchConfig:
    p: int = 1152                      # 36 nodes x 32 ranks
    dims_sweep: tuple[int, ...] = (2, 3, 4, 9)
    element_deciles: tuple[int, ...] = (1, 10, 100, 1000, 10000)
    elem_bytes: int = 4                # MPI_INT
    warmup: int = 8
    reps: int = 40

    def factorizations(self):
        return {d: dims_create(self.p, d) for d in self.dims_sweep}

    def predicted_crossovers(self, link: LinkModel = ICI):
        """Tuning-model prediction of the direct/factorized crossover per
        factorization (the paper's empirical ~100-element boundary)."""
        out = {}
        for d, dims in self.factorizations().items():
            links = (link,) * d
            for n in self.element_deciles:
                s = choose_algorithm(dims, links, n * self.elem_bytes)
                out[(d, n)] = s.kind
        return out


PAPER_BENCH = AlltoallBenchConfig()

# This repo's production tori, same protocol.
SINGLE_POD_BENCH = AlltoallBenchConfig(p=256, dims_sweep=(2, 3, 4, 8))
MULTI_POD_BENCH = AlltoallBenchConfig(p=512, dims_sweep=(2, 3, 9))
