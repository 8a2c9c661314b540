"""The one traffic generator: every mix is a data file of parameters
(``traffic/<mix>.json``) that this module reads.  Inputs are drawn from
the run's seed on the device; the same seed gives the same inputs.

Sizes are fixed by the mix and not by the seed: a seed only orders them
and draws the token ids, so runs with different seeds do the same work.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import torch

from .weights import generator


def tokens(spec: dict, gen: torch.Generator, shape, vocab: int,
           device) -> torch.Tensor:
    """Token ids of a mix's ``tokens`` spec (``dist`` ``zipf``, with its
    ``exponent``)."""
    if spec["dist"] != "zipf":
        raise ValueError(f"unknown token distribution {spec['dist']!r}")
    return zipf_tokens(gen, shape, vocab, spec["exponent"], device)


def zipf_tokens(gen: torch.Generator, shape, vocab: int, exponent: float,
                device) -> torch.Tensor:
    """Ids drawn from a Zipf unigram over the vocabulary (int32): id
    ``k - 1`` with probability proportional to ``k ** -exponent``, by the
    inverse of its cumulative distribution.  At exponent 1 the most
    frequent id is ``1 / H_vocab`` of the tokens (8.1% at 131072, 9.1% at
    32064), as the most frequent word is of English text."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks.pow_(-exponent), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=device)
    ids = torch.searchsorted(cdf, u.reshape(-1), right=True).reshape(shape)
    return ids.clamp_(max=vocab - 1).to(torch.int32)


def block_lengths(spec: dict) -> list[int]:
    """One block of prompt lengths: the log-normal's quantiles at
    ``(j + 1/2) / block``, clipped to ``[min, max]``; every block holds
    the same lengths."""
    dist = NormalDist(math.log(spec["median"]), spec["sigma"])
    n = spec["block"]
    return [int(min(spec["max"], max(spec["min"],
                                     round(math.exp(dist.inv_cdf((j + 0.5)
                                                                 / n))))))
            for j in range(n)]


def prompt_lengths(mix: dict, seed: int, n_blocks: int) -> list[int]:
    """``n_blocks`` blocks of :func:`block_lengths`, each in an order
    drawn from the seed."""
    base = block_lengths(mix["lengths"])
    out = []
    for b in range(n_blocks):
        perm = torch.randperm(len(base),
                              generator=generator("cpu", seed, "order", b))
        out += [base[i] for i in perm.tolist()]
    return out


def prompt(mix: dict, vocab: int, seed: int, index: int, length: int,
           device) -> torch.Tensor:
    """Request ``index``'s prompt, (1, length) int32."""
    return tokens(mix["tokens"], generator(device, seed, "prompt", index),
                  (mix["batch"], length), vocab, device)


def a2a_block(shape, seed: int, rank: int, device) -> torch.Tensor:
    """Rank ``rank``'s send buffer, normal bf16 values."""
    return torch.empty(shape, dtype=torch.bfloat16, device=device).normal_(
        generator=generator(device, seed, "a2a", rank))
