"""Work counts, MFU arithmetic, the traffic's fixed sizes and the trace
reduction, on known shapes."""

import json
import math

import pytest

from portbench import peaks, readers, runtime, traffic, work
from portbench.trace import read_chrome_trace


def test_gmm_products_on_phi_shapes():
    ps = work.gmm_products(8192, 4096, 6400, 16)
    assert len(ps) == 3
    assert ps[0][0] == 2.0 * 8192 * 4096 * 6400
    assert ps[0][1] == (8192 * 4096 + 8192 * 6400 + 16 * 4096 * 6400) * 2
    assert ps[2][0] == ps[0][0]
    # compute-bound at these rows: each product's least time is its flops
    assert work.gmm_bound_s(8192, 4096, 6400, 16) == pytest.approx(
        3 * 2.0 * 8192 * 4096 * 6400 / peaks.BF16_FLOPS)
    # at 16 rows the weights' bytes bound it
    assert work.gmm_bound_s(16, 4096, 6400, 16) == pytest.approx(
        sum(b for _, b in work.gmm_products(16, 4096, 6400, 16))
        / peaks.HBM_BYTES)


def test_forward_flops():
    m = {"d_model": 4096, "n_layers": 2, "n_heads": 32, "n_kv_heads": 8,
         "d_ff": 6400, "n_experts": 16, "vocab": 32064}
    S = 4096
    per_layer = 2.0 * S * 4096 * 128 * 80 + 2.0 * S * 4096 * 16 \
        + 4.0 * 32 * S * (S + 1) / 2 * 128
    kept = 2 * 2 * S           # top-2 rows of both layers, none dropped
    want = 2 * per_layer + 2.0 * kept * 3 * 4096 * 6400 \
        + 2.0 * S * 4096 * 32064
    assert work.forward_flops(m, 1, S, kept, S) == pytest.approx(want)
    # the head on the one position returned
    assert work.forward_flops(m, 1, S, kept, 1) == pytest.approx(
        want - 2.0 * (S - 1) * 4096 * 32064)
    assert work.mfu(989e12, 2.0) == pytest.approx(50.0)


def test_p95_and_judge():
    assert runtime.p95(range(1, 101)) == 95
    assert runtime.p95([3.0]) == 3.0
    ok, checks = runtime.judge({"x": 0.1, "y": float("nan")},
                               {"numbers": {"x": {"limit": 0.2},
                                            "y": {"limit": 1.0}}})
    assert not ok and checks["x"] == {"value": 0.1, "limit": 0.2}


def test_prompt_lengths_are_the_same_work_for_every_seed():
    mix = json.loads(open(traffic.__file__.replace(
        "traffic.py", "traffic/prefill-lognormal-1k.json")).read())
    base = traffic.block_lengths(mix["lengths"])
    assert len(base) == 64 and min(base) >= 128 and max(base) <= 8192
    assert sorted(base)[32] == pytest.approx(1024, rel=0.05)
    a = traffic.prompt_lengths(mix, 1, 3)
    b = traffic.prompt_lengths(mix, 2 ** 31 + 5, 3)
    assert a != b
    for k in range(3):
        assert sorted(a[64 * k:64 * (k + 1)]) == sorted(base)
        assert sorted(b[64 * k:64 * (k + 1)]) == sorted(base)


def test_seeded_inputs_repeat():
    import torch
    g = traffic.zipf_tokens
    t1 = g(traffic.generator("cpu", 7, "x"), (2, 9), 100, 0.9, "cpu")
    t2 = g(traffic.generator("cpu", 7, "x"), (2, 9), 100, 0.9, "cpu")
    assert torch.equal(t1, t2) and t1.dtype == torch.int32
    assert int(t1.min()) >= 0 and int(t1.max()) < 100


def _chrome(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.window",
         "ts": 70, "dur": 80, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 10,
         "dur": 20, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 2, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 110, "dur": 2, "tid": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "void gmm_wgmma_kernel<1>",
         "ts": 20, "dur": 30, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "adam_kernel",
         "ts": 115, "dur": 25, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "void gmm_wgmma_kernel<1>",
         "ts": 40, "dur": 20, "args": {"correlation": 3}},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return read_chrome_trace(p, window_s=200e-6)


def test_trace_reduction(tmp_path):
    tr = _chrome(tmp_path)
    assert tr.device_seconds(("gmm_",)) == pytest.approx(50e-6)
    # kernels at [20, 50) u [40, 60) u [115, 140): 65 us busy
    assert tr.busy_s() == pytest.approx(65e-6)
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(55e-6)
    assert gaps[0][0] == "portbench.window"
    assert tr.top_ops(1)[0][0] == "void gmm_wgmma_kernel<1>"

    class Ctx:
        trace, window_s = tr, 200e-6
        work = {"gmm_bound_s": 25e-6, "model_flops": 989e12 * 100e-6}
    assert readers.roofline(Ctx, ("gmm_",), "gmm_bound_s") == \
        pytest.approx(50.0)
    assert readers.roofline(Ctx, ("nothing",), "gmm_bound_s") is None
    assert readers.idle(Ctx) == pytest.approx(100 * (1 - 65 / 200))
    assert readers.mfu(Ctx) == pytest.approx(50.0)
    assert math.isfinite(readers.mfu(Ctx))


@pytest.mark.parametrize("vocab", [32064, 131072])
def test_zipf_unigram_shares(vocab):
    """The most frequent id is ``1 / H_vocab`` of the tokens and the
    second half of it, as Zipf's law has it; every id is in range."""
    import torch
    t = traffic.zipf_tokens(traffic.generator("cpu", 5, "z"), (64, 4096),
                            vocab, 1.0, "cpu").reshape(-1).long()
    assert int(t.min()) >= 0 and int(t.max()) < vocab
    share = torch.bincount(t, minlength=vocab).double() / t.numel()
    top = 1.0 / sum(1.0 / k for k in range(1, vocab + 1))
    assert float(share[0]) == pytest.approx(top, rel=0.03)
    assert float(share[1]) == pytest.approx(top / 2, rel=0.05)
    assert float(share[0]) < 0.1
