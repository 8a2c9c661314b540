"""How the init conditions whisper-tiny's numerics, in the JAX reference
and against the port, on the CPU.

Run from the repo root (about 2 minutes; it gates nothing):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/encdec_numerics.py

It prints, at the reference's init (``EncDecModel.init``) and at the
fan-in init (``tests/torch_archs.py::fan_in_init``):

* the reference alone at whisper-tiny's full config (4 + 4 layers, 1500
  frames, B=1, 32 tokens): its bf16 forward against its f32 forward
  (largest gap over the largest f32 logit, and the share of positions
  whose argmax agrees), and its f32 forward against 32 ``decode_step``
  ticks on the same tokens (the KV cache's hand-off);
* at the SMOKE config (what ``tests/test_torch_encdec.py`` runs): the
  port's bf16 forward against the reference's bf16 forward, and the
  reference's own two attention impls (``"xla"``, ``"pallas_interpret"``)
  against each other in their f32 loss gradients (the worst leaf's
  largest gap over its largest |g|).

``chip_smoke.py [encdec]`` and ``tests/test_torch_encdec.py`` choose
their inits from these numbers.  It imports the JAX package, which the
port never does: it is a check of the reference's conditioning.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from torch_archs import fan_in_init  # noqa: E402

ARCH = "whisper-tiny"
T = 32
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _params(cfg, fan_in: bool):
    """The reference's parameters (numpy, drawn in ``cfg``'s dtype, as
    the tests and the card draw them) at seed 0, rescaled to fan-in where
    asked."""
    p = jax.tree.map(np.asarray, jax_build_model(cfg).init(
        jax.random.PRNGKey(0)))
    return fan_in_init(p, cfg.d_model) if fan_in else p


def _cast(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
                 .max() / np.abs(np.asarray(b, np.float32)).max())


def full_config(fan_in: bool) -> str:
    base = jax_get_config(ARCH).replace(remat=False)
    p = _params(base, fan_in)
    rng = np.random.default_rng(5)
    frames = jnp.asarray(rng.standard_normal(
        (1, base.n_frontend_tokens, base.d_model)).astype(np.float32))
    tokens = jnp.asarray(np.random.default_rng(3).integers(
        0, base.vocab, (1, T)), jnp.int32)
    logits = {}
    for name, kw in (("f32", F32), ("bf16", BF16)):
        cfg = base.replace(**kw)
        model = jax_build_model(cfg)
        pc = _cast(p, cfg.pdtype)
        logits[name] = np.asarray(jax.jit(lambda q: model.forward(
            q, tokens, frontend_embeds=frames)[0])(pc))
        if name == "f32":
            memory = jax.jit(model.encode)(pc, frames)
            caches, step, ticks = model.init_caches(1, T), \
                jax.jit(model.decode_step), []
            for t in range(T):
                lg, caches = step(pc, tokens[:, t:t + 1], caches, memory)
                ticks.append(np.asarray(lg))
            fvd = _gap(np.concatenate(ticks, 1), logits["f32"])
    top = float((logits["bf16"].argmax(-1) == logits["f32"].argmax(-1))
                .mean())
    return (f"full config: bf16 forward vs f32 "
            f"{_gap(logits['bf16'], logits['f32']):.3g} of the largest "
            f"logit, argmax shared at {top:.3f} of the positions; f32 "
            f"forward vs {T} decode ticks {fvd:.3g}")


def smoke_config(fan_in: bool) -> str:
    frames = np.random.default_rng(5).standard_normal(
        (2, 16, 64)).astype(np.float32)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 12))
    labels = np.random.default_rng(4).integers(0, 256, (2, 12))
    jcfg = jax_get_config(ARCH, smoke=True).replace(
        attention_impl="pallas_interpret", **BF16)
    p = _params(jcfg, fan_in)
    want = jax_build_model(jcfg).forward(
        _cast(p, jnp.bfloat16), jnp.asarray(tokens, jnp.int32),
        frontend_embeds=jnp.asarray(frames))[0]
    cfg = get_config(ARCH, smoke=True).replace(**BF16)
    with torch.no_grad():
        got = build_model(cfg).forward(
            params_from_jax(jax.tree.map(
                lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), p),
                cfg, "cpu"),
            torch.from_numpy(tokens),
            frontend_embeds=torch.from_numpy(frames))[0]
    grads = {}
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
             "frontend_embeds": jnp.asarray(frames)}
    p32 = _params(jax_get_config(ARCH, smoke=True), fan_in)
    for impl in ("xla", "pallas_interpret"):
        model = jax_build_model(jax_get_config(ARCH, smoke=True).replace(
            attention_impl=impl))
        g = jax.grad(lambda q: model.loss(q, batch)[0])(_cast(p32,
                                                              jnp.float32))
        grads[impl] = dict(tree_leaves(jax.tree.map(np.asarray, g)))
    worst = max((_gap(grads["pallas_interpret"][k], grads["xla"][k]), k)
                for k in grads["xla"])
    return (f"SMOKE: port bf16 forward vs the reference's "
            f"{_gap(got.float().numpy(), want):.3g} of the largest logit; the "
            f"reference's f32 gradients, xla vs pallas_interpret, "
            f"{worst[0]:.3g} of the largest |g| (worst {worst[1]})")


def main() -> int:
    for fan_in in (False, True):
        name = "fan-in init" if fan_in else "reference init"
        print(f"[encdec_numerics] {name}: {full_config(fan_in)}", flush=True)
        print(f"[encdec_numerics] {name}: {smoke_config(fan_in)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
