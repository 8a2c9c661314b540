"""The rest of a run with the timed path broken underneath: ``correct``
must come out false for each fault a cell can have (an answer altered
where it is produced, the exchange between cards left out)."""

import time

import torch

from portbench.drivers import a2a, prefill
from portbench.tests.helpers import SEED, gloo_world, small_cell


def test_prefill_answer_altered_fails(monkeypatch):
    import repro_torch.models as models
    real = models.make_prefill_fn

    def altered(model, mesh=None, rules=None):
        fn = real(model, mesh, rules)
        return lambda params, tokens: torch.roll(fn(params, tokens), 1, -1)
    monkeypatch.setattr(models, "make_prefill_fn", altered)
    out = prefill.run(small_cell("grok1-prefill"), SEED, 0.2, False,
                      start=time.perf_counter(), device="cpu")
    assert not out["correct"], out["checks"]


def test_a2a_exchange_left_out_fails():
    cell = small_cell("phi35moe-ep-a2a")
    out = a2a.summarize(cell, gloo_world(cell, SEED, no_exchange=True),
                        False)
    assert not out["correct"]
    assert out["readings"]["forward_mismatches"] > 0
