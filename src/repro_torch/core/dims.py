"""``MPI_Dims_create`` — balanced factorization of a process count.

The paper (§5, Table 1) relies on ``MPI_Dims_create`` returning a
factorization "where the factors are as close to each other as possible"
and observes that OpenMPI 4.1.6 violates this (48x24 instead of 36x32 for
p=1152, d=2).  Following Träff & Lübbe [15] we implement the *correct*
specification semantics: minimize the largest factor, then recursively the
next largest, subject to feasibility (an exact divisor factorization).

Factors are returned in non-increasing order, matching MPI convention.
"""

from __future__ import annotations

import functools
import math


def divisors(n: int) -> list[int]:
    """All divisors of ``n`` in increasing order."""
    small, large = [], []
    i = 1
    while i * i <= n:
        if n % i == 0:
            small.append(i)
            if i != n // i:
                large.append(n // i)
        i += 1
    return small + large[::-1]


@functools.lru_cache(maxsize=None)
def _best(n: int, d: int, cap: int) -> tuple[int, ...] | None:
    """Lexicographically smallest non-increasing factorization of ``n`` into
    exactly ``d`` factors, each ``<= cap`` (compared largest-first)."""
    if d == 1:
        return (n,) if n <= cap else None
    # The largest factor must be at least ceil(n ** (1/d)).
    lo = max(1, math.ceil(n ** (1.0 / d) - 1e-9))
    for f in divisors(n):
        if f < lo or f > cap:
            continue
        rest = _best(n // f, d - 1, f)
        if rest is not None:
            return (f,) + rest
    return None


def dims_create(nnodes: int, ndims: int) -> tuple[int, ...]:
    """Balanced factorization of ``nnodes`` into ``ndims`` factors.

    >>> dims_create(1152, 2)
    (36, 32)
    >>> dims_create(1152, 3)
    (12, 12, 8)
    >>> dims_create(1152, 4)
    (8, 6, 6, 4)
    """
    if nnodes <= 0:
        raise ValueError(f"nnodes must be positive, got {nnodes}")
    if ndims <= 0:
        raise ValueError(f"ndims must be positive, got {ndims}")
    out = _best(nnodes, ndims, nnodes)
    assert out is not None  # always feasible with 1-factors
    assert math.prod(out) == nnodes
    return out


def max_dims(nnodes: int) -> int:
    """ceil(log2 p): the paper's maximum meaningful dimension count."""
    return max(1, math.ceil(math.log2(nnodes))) if nnodes > 1 else 1


def prime_factorization(n: int) -> list[int]:
    """Prime factors of n, non-increasing (the d = ceil(log2 p) case)."""
    out = []
    f = 2
    while f * f <= n:
        while n % f == 0:
            out.append(f)
            n //= f
        f += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)
