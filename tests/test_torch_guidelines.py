"""The port's guideline checker (repro_torch.core.guidelines) and the
paper's benchmark config (repro_torch.configs.paper_torus) against the
JAX package: plain Python, so every output must equal the reference's.

The checker is held on the reference's own cases
(tests/test_core_units.py::TestGuidelines) and on seeded random
measurement lists (several implementations and blocks, repeated
measurements, exact ties, tolerances 1.0 / 1.10 / 2.0): the violations
field for field and the ``format_report`` string character for
character.  The configs: ``factorizations()`` and
``predicted_crossovers()`` under ``ICI`` and ``DCN``, for
``PAPER_BENCH``, ``SINGLE_POD_BENCH`` and ``MULTI_POD_BENCH``.
"""

import dataclasses

import numpy as np
import pytest

from repro.configs import paper_torus as jax_paper
from repro.core import guidelines as jax_gl
from repro.core import tuning as jax_tuning
from repro_torch.configs import paper_torus
from repro_torch.core import guidelines, tuning

REFERENCE_CASES = [
    ([("direct", 100, 10e-6), ("factorized[d=2]", 100, 1e-6),
      ("direct", 10000, 1e-6), ("factorized[d=2]", 10000, 5e-6)], 1.10),
    ([("direct", 1, 1.05e-6), ("factorized[d=2]", 1, 1.00e-6)], 1.10),
]
IMPLS = ("direct", "factorized[d=2:4x4]", "factorized[d=3:4x2x2]",
         "overlap[n=2]")


def _random_case(seed: int):
    """A seeded measurement list: 1-6 block sizes, each measured 0-3
    times per implementation, times drawn from a few levels so that
    exact ties occur (also between native and the best composition)."""
    rng = np.random.default_rng(seed)
    blocks = rng.choice([1, 10, 80, 100, 800, 1000, 10000],
                        size=rng.integers(1, 7), replace=False)
    levels = rng.choice([0.5e-6, 1e-6, 1.05e-6, 2e-6, 7.3e-6, 40e-6], 4)
    ms = []
    for b in blocks:
        for impl in IMPLS:
            for _ in range(rng.integers(0, 4)):
                ms.append((impl, int(b), float(rng.choice(levels))))
    rng.shuffle(ms)
    return ms


def _check(ms, tolerance):
    got = guidelines.check_guidelines(
        [guidelines.Measurement(*m) for m in ms], tolerance=tolerance)
    want = jax_gl.check_guidelines(
        [jax_gl.Measurement(*m) for m in ms], tolerance=tolerance)
    assert [dataclasses.astuple(v) for v in got] == \
        [dataclasses.astuple(v) for v in want]
    assert [v.factor for v in got] == [v.factor for v in want]
    assert guidelines.format_report(got) == jax_gl.format_report(want)
    return got


@pytest.mark.parametrize("case", range(len(REFERENCE_CASES)))
def test_reference_cases(case):
    ms, tol = REFERENCE_CASES[case]
    got = _check(ms, tol)
    if case == 0:
        assert len(got) == 1 and got[0].block_elems == 100
        assert got[0].factor == pytest.approx(10.0)
    else:
        assert got == []


@pytest.mark.parametrize("tolerance", [1.0, 1.10, 2.0])
@pytest.mark.parametrize("seed", range(8))
def test_random_measurements_match_reference(seed, tolerance):
    _check(_random_case(seed), tolerance)


def test_ties_and_empty_lists():
    tie = [("direct", 8, 1e-6), ("factorized[d=2]", 8, 1e-6),
           ("overlap[n=2]", 8, 1e-6)]
    assert _check(tie, 1.0) == []
    assert _check(tie + [("direct", 9, 2e-6), ("overlap[n=2]", 9, 1e-6),
                         ("factorized[d=2]", 9, 1e-6)], 1.0)[0] \
        .best_composed_impl == "overlap[n=2]"   # first of the tied best
    assert _check([], 1.10) == []
    assert _check([("direct", 4, 1e-6)], 1.10) == []


@pytest.mark.parametrize("name", ["PAPER_BENCH", "SINGLE_POD_BENCH",
                                  "MULTI_POD_BENCH"])
def test_paper_configs_match_reference(name):
    cfg, ref = getattr(paper_torus, name), getattr(jax_paper, name)
    assert dataclasses.astuple(cfg) == dataclasses.astuple(ref)
    assert cfg.factorizations() == ref.factorizations()
    for link, ref_link in ((tuning.ICI, jax_tuning.ICI),
                           (tuning.DCN, jax_tuning.DCN)):
        assert cfg.predicted_crossovers(link) == \
            ref.predicted_crossovers(ref_link)
    assert cfg.predicted_crossovers() == ref.predicted_crossovers()


def test_paper_bench_is_the_papers_experiment():
    cfg = paper_torus.PAPER_BENCH
    assert (cfg.p, cfg.warmup, cfg.reps, cfg.elem_bytes) == \
        (1152, 8, 40, 4)
    assert cfg.factorizations()[2] == (36, 32)
    kinds = set(cfg.predicted_crossovers(tuning.DCN).values())
    assert kinds <= {"direct", "factorized"}
