"""The chunk count of the software-pipelined all-to-all under its legacy
signature (port of ``repro.core.pipelined``).  The chunked scheduler
itself is the overlap engine (``core.overlap``), run through
``plan_all_to_all(..., backend="pipelined" | "overlap")``."""

from __future__ import annotations

from .dims import dims_create
from .tuning import LinkModel, resolve_links
from .tuning import choose_chunks as _choose_chunks

__all__ = ["choose_chunks"]


def choose_chunks(p: int, d: int, block_bytes: float,
                  link: LinkModel, max_chunks: int = 4, *,
                  links=None) -> int:
    """Pick n_chunks minimizing the overlapped alpha-beta estimate for a
    d-way factorization of ``p`` (legacy signature; see
    ``tuning.choose_chunks`` for the per-axis form).  ``link`` prices
    every axis alike; ``links=`` (a length-d sequence) overrides per
    axis."""
    dims = dims_create(p, d)
    return _choose_chunks(dims,
                          resolve_links(link if links is None else links,
                                        dims),
                          block_bytes, max_chunks=max_chunks)
