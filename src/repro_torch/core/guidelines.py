"""Self-consistent performance guidelines (paper viewpoint 3, refs [5,12]).

A guideline states: a collective must not be slower than an implementation
of itself in terms of other library functionality.  Here:

    MPI_Alltoall(p)  <=~  Alltoall_torus(D)        for every factorization D

i.e. the library-native (direct) all-to-all should never lose to the
factorized composition by more than a tolerance; when it does (as OpenMPI
4.1.6 does by >10x for 80..800-int blocks, paper Fig. 2), that is a
*guideline violation* — a performance bug surfaced automatically.

``check_guidelines`` consumes measured timings (from benchmarks, or the
rows of an ``autotune`` search table) and produces a violation report.

A copy of ``repro.core.guidelines`` (plain Python): the same
measurements give the same violations and the same report.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Measurement:
    impl: str                 # "direct" | "factorized[d=2:16x16]" | ...
    block_elems: int
    seconds: float


@dataclass(frozen=True)
class Violation:
    block_elems: int
    native_seconds: float
    best_composed_seconds: float
    best_composed_impl: str

    @property
    def factor(self) -> float:
        return self.native_seconds / self.best_composed_seconds


def check_guidelines(measurements: list[Measurement],
                     tolerance: float = 1.10) -> list[Violation]:
    """Native must satisfy t_native <= tolerance * min(t_composed)."""
    by_block: dict[int, list[Measurement]] = {}
    for m in measurements:
        by_block.setdefault(m.block_elems, []).append(m)
    out = []
    for block, ms in sorted(by_block.items()):
        native = [m for m in ms if m.impl == "direct"]
        composed = [m for m in ms if m.impl != "direct"]
        if not native or not composed:
            continue
        t_native = min(m.seconds for m in native)
        best = min(composed, key=lambda m: m.seconds)
        if t_native > tolerance * best.seconds:
            out.append(Violation(block, t_native, best.seconds, best.impl))
    return out


def format_report(violations: list[Violation]) -> str:
    if not violations:
        return "no guideline violations: native all-to-all is never beaten " \
               "by its factorized composition (within tolerance)"
    lines = ["GUIDELINE VIOLATIONS (native slower than composed):"]
    for v in violations:
        lines.append(
            f"  block={v.block_elems:>8} elems: native {v.native_seconds*1e6:10.1f}us"
            f" vs {v.best_composed_impl} {v.best_composed_seconds*1e6:10.1f}us"
            f"  ({v.factor:.2f}x)")
    return "\n".join(lines)
