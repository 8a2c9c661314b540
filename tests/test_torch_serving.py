"""Port serving path (repro_torch) against the JAX reference, plus the
port's own guarantees: entry points never fall back to the CPU quietly,
and the package never imports jax or repro.

The batcher runs phi3.5-moe-42b at the SMOKE size (f32) on the
reference's weights; greedy tokens must be identical, not close.
"""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.runtime.serving import ContinuousBatcher as JaxBatcher
from repro.runtime.serving import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core import telemetry
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gmm import grouped_matmul
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.serving import (ContinuousBatcher, Request,
                                         _reset_slot)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "phi3.5-moe-42b"
ROOT = Path(__file__).resolve().parents[1]
PROMPTS = [[1, 2, 3], [10, 11, 12, 13, 14], [5, 6], [20, 21, 22, 23]]
MAX_NEW = [5, 3, 6, 4]


def _models(window=None):
    jcfg = jax_get_config(ARCH, smoke=True).replace(window=window)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, smoke=True).replace(window=window)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, build_model(cfg), params


@pytest.mark.parametrize("window", [None, 3])
def test_batcher_tokens_identical_to_reference(window):
    # 4 requests of staggered prompt lengths on 2 slots: slots are reset
    # and refilled mid-run, and with window=3 the KV ring buffer wraps
    jmodel, jparams, model, params = _models(window)
    jb = JaxBatcher(jmodel, jparams, max_batch=2, max_seq=16)
    tb = ContinuousBatcher(model, params, max_batch=2, max_seq=16,
                           device="cpu")
    for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW)):
        jb.submit(JaxRequest(i, list(p), m))
        tb.submit(Request(i, list(p), m))
    ticks0 = telemetry.metrics().counter("serving.decode_ticks").value
    want, got = jb.run(), tb.run()
    assert got == want
    assert [len(got[i]) for i in range(4)] == MAX_NEW
    assert tb.ticks == jb.ticks
    assert telemetry.metrics().counter("serving.decode_ticks").value \
        == ticks0 + tb.ticks


def test_eos_stops_early():
    _, _, model, params = _models()
    b = ContinuousBatcher(model, params, max_batch=1, max_seq=16,
                          device="cpu")
    b.submit(Request(0, [1, 2], 8))
    ref = b.run()[0]
    eos = ref[2]
    b = ContinuousBatcher(model, params, max_batch=1, max_seq=16,
                          device="cpu")
    b.submit(Request(0, [1, 2], 8, eos_id=eos))
    assert b.run()[0] == ref[:ref.index(eos) + 1]


def test_reset_slot_restores_fresh_state_in_place():
    _, _, model, params = _models()
    caches = model.init_caches(2, 8, "cpu")
    fresh = model.init_caches(2, 8, "cpu")
    k = caches["states"]["pos0"]["k"]
    for _ in range(3):
        _, caches = model.decode_step(params, torch.tensor([[1], [2]]),
                                      caches)
    assert caches["states"]["pos0"]["k"] is k         # written in place
    out = _reset_slot(caches, fresh, 1)
    assert out["states"]["pos0"]["k"] is k
    assert not k[:, 1].any() and k[:, 0].any()
    assert (out["states"]["pos0"]["slot_pos"][:, 1] == -1).all()
    assert out["pos"].tolist() == [3, 0]


def test_serve_main_on_cpu_takes_no_kernel():
    gmm0, fa0 = grouped_matmul.launches, flash_attention.launches
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert ((0 <= out) & (out < get_config(ARCH, smoke=True).vocab)).all()
    assert (grouped_matmul.launches, flash_attention.launches) == (gmm0, fa0)


def test_default_device_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", ARCH, "--smoke"])
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_config(ARCH, smoke=True)).init(torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", ARCH, "--smoke", "--disaggregate"])
    # asked for the CPU, the disaggregated run answers every request
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--disaggregate", "--batch", "2", "--prompt-len", "4",
                      "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert ((0 <= out) & (out < get_config(ARCH, smoke=True).vocab)).all()


def _run(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_package_imports_neither_jax_nor_repro():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.kernels.moe_gmm" in names
    res = _run(["-c", (
        "import importlib, sys\n"
        f"for n in {['repro_torch'] + names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'msgpack', 'zstandard'))\n"
        "assert not bad, bad\n")])
    assert res.returncode == 0, res.stderr


def test_chip_smoke_imports_no_jax_and_fails_without_a_card():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    res = _run([str(ROOT / "chip_smoke.py")])
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
