"""Each cell's driver against the reference at a toy width on the CPU
(the program's plain versions run there), and the control: the
reference computed with float8 products in the program's place, which
each cell's limits must refuse."""

import time

import pytest
import torch

from portbench.drivers import a2a, prefill
from portbench.reference import model as ref
from portbench.runtime import judge
from portbench.tests.helpers import SEED, gloo_world, small_cell


def test_prefill_cell_agrees_with_reference():
    c = small_cell("grok1-prefill")
    out = prefill.run(c, SEED, 0.3, False, start=time.perf_counter(),
                      device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    assert out["e2e"]["prefill_ms_p95"] > 0


def test_a2a_cell_agrees_with_definition():
    c = small_cell("phi35moe-ep-a2a")
    out = a2a.summarize(c, gloo_world(c, SEED), False)
    assert out["correct"], out["checks"]
    assert out["readings"] == {"forward_mismatches": 0,
                               "reverse_mismatches": 0}
    assert out["forbidden"] == []


def test_prefill_control_fails():
    c = small_cell("grok1-prefill")
    m = c.config["model"]
    g = torch.Generator().manual_seed(SEED)
    prompts = [torch.randint(0, m["vocab"], (1, L), generator=g)
               for L in (8, 24, 64, 40)]
    f32 = ref.prefill_last_logits(m, SEED, prompts, "cpu",
                                  near_tie=c.limits["near_tie"])
    fp8 = ref.prefill_last_logits(m, SEED, prompts, "cpu", precision="fp8")
    ok, checks = judge(prefill.readings([c[0][0] for c in fp8], f32),
                       c.limits)
    assert not ok, checks


def test_a2a_control_fails():
    """The definition's blocks rounded through float8 lose bits."""
    c = small_cell("phi35moe-ep-a2a")
    G, E_loc, C, D = a2a.geometry(c)
    want = a2a.definition((G, E_loc * C * D), SEED, 0, G, "cpu")
    fp8 = want.to(torch.float8_e4m3fn).to(torch.bfloat16)
    ok, _ = judge({"forward_mismatches": a2a.mismatches(fp8, want),
                   "reverse_mismatches": 0}, c.limits)
    assert not ok


@pytest.mark.card
def test_cells_on_the_card():
    """Every one-card cell of the manifest end to end on the card,
    briefly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import importlib

    from portbench import manifest
    for w in manifest.load_manifest()["workloads"]:
        c = manifest.cell(w["name"])
        if c.chips > torch.cuda.device_count():
            continue
        drv = importlib.import_module(f"portbench.drivers.{c.kind}")
        out = drv.run(c, SEED, 2.0, False, start=time.perf_counter())
        assert out["correct"], (c.name, out["checks"])


@pytest.mark.parametrize("S", [9, 40])
def test_last_token_layer_is_the_layer_at_the_last_position(S):
    """The last position's layer alone, from the prompt's keys, values
    and earlier assignments, gives what the whole layer gives there; a
    near tie adds the other expert choice."""
    c = small_cell("grok1-prefill")
    m = c.config["model"]
    x = torch.randn(1, S, m["d_model"],
                    generator=torch.Generator().manual_seed(S))
    w = ref.f32_layer(m, SEED, 0, "cpu")
    with ref.strict_f32():
        st = {}
        y, _ = ref.layer(x, w, m, "f32", None, st)
        own = ref.last_token_layer(x[:, -1], w, m, st, "f32")
        both = ref.last_token_layer(x[:, -1], w, m, st, "f32", near_tie=1.0)
    assert len(own) == 1 and len(both) == 2
    torch.testing.assert_close(own[0][0], y[:, -1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(both[0][0], own[0][0])
    assert both[1][1] > 0 and not torch.allclose(both[1][0], own[0][0])


def test_candidates_branch_only_at_near_ties():
    c = small_cell("grok1-prefill")
    m = c.config["model"]
    g = torch.Generator().manual_seed(SEED)
    prompts = [torch.randint(0, m["vocab"], (1, L), generator=g)
               for L in (8, 30)]
    plain = ref.prefill_last_logits(m, SEED, prompts, "cpu")
    every = ref.prefill_last_logits(m, SEED, prompts, "cpu", near_tie=1.0)
    assert [len(cs) for cs in plain] == [1, 1]
    assert [len(cs) for cs in every] == [ref.MAX_BRANCHES] * 2
    for p, e in zip(plain, every):
        torch.testing.assert_close(e[0][0], p[0][0])
        assert all(0 < mg < 1 for _, mg in e[1:])


def test_readings_take_the_nearest_candidate():
    """A request that matches another candidate reads 0; an answer
    altered in one request of three moves its first token, which the
    token gap reads while the median does not."""
    g = torch.Generator().manual_seed(1)
    a, b, d = (torch.randn(50, generator=g) for _ in range(3))
    ref_c = [[(a, 0.0), (b, 0.01)], [(d, 0.0)], [(a, 0.0)]]
    r = prefill.readings([b, d, a], ref_c)
    assert r["logit_err_median"] == 0.0 and r["token_gap"] == 0.0
    assert r["_branches"][0] == [2, 0.01] and r["_errs_own"][0] > 0
    r = prefill.readings([b, d, torch.roll(a, 1)], ref_c)
    assert r["logit_err_median"] == 0.0 and r["token_gap"] > 1.0


def test_a2a_traced_run_reads_the_plan_on_the_host():
    from portbench.manifest import metric_reader
    from portbench.run import Ctx
    c = small_cell("phi35moe-ep-a2a")
    out = a2a.summarize(c, gloo_world(c, SEED, trace=True), True)
    assert out["correct"], out["checks"]
    host = out["work"]["plan_host_us"]
    assert len(host) == 4 * 2 * c.traffic["host_pairs"]
    assert metric_reader("plan_host_us.a2a")(Ctx(c, out)) == \
        pytest.approx(sum(host) / len(host))
