"""The archs' training path against the JAX reference: ``Model.loss``
and every leaf's gradient against ``jax.value_and_grad`` of the
reference loss, per case of ``torch_archs.CASES`` (the eight ``SMOKE``
configs, 12 / 2 heads, head dim 80, the chunkwise mLSTM), on the same
weights (attention biases drawn from numpy; the recurrent archs at a
fan-in init) and copy-task batches from numpy, with internvl2-2b's
patch embeddings (``torch_archs.frontend_embeds``) in its batch.  The recurrent archs'
SMOKE configs keep ``recurrent_step_remat``, so their scans run
checkpointed chunk by chunk, as the reference's steps do.

The reference runs ``attention_impl="xla"`` (autodiff of its oracles),
as ``test_torch_train.py``'s does, and for the head-dim-80 case also
``"pallas_interpret"``: its trainable flash kernel (forward and the FA2
backward) in interpret mode.  The port on the CPU runs its kernels'
plain versions inside ``FlashAttentionFn`` / ``GroupedMatmulFn``, so
the gradients come from the port's own backward formulas.

Tolerances as ``test_torch_train.py``'s: the loss at 1e-5 relative, each
gradient leaf within 2e-4 of its largest |g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build_model
from repro_torch.data import CopyTaskConfig, make_copy_task_batch
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves, tree_map
from torch_archs import CASES, case_setup, frontend_embeds

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RUNS = [(case, "xla") for case in CASES] + \
    [("h2o-danube-1.8b-dh80", "pallas_interpret")]


@pytest.mark.parametrize("case,impl", RUNS,
                         ids=[f"{c}-{i}" for c, i in RUNS])
def test_loss_and_grads_match_reference(case, impl):
    jcfg, jparams, cfg, params = case_setup(case, impl)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      params)
    batch = {k: v.numpy() for k, v in make_copy_task_batch(
        CopyTaskConfig(vocab=cfg.vocab, seq_len=16, global_batch=2),
        0).items()}
    if cfg.frontend is not None:
        batch["frontend_embeds"] = frontend_embeds(cfg, 2)
    (want, wm), wg = jax.jit(jax.value_and_grad(
        jax_build_model(jcfg).loss, has_aux=True))(
            jax.tree.map(jnp.asarray, jparams),
            {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = tree_leaves(params)
    total, metrics = build_model(cfg).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(total, [t for _, t in leaves])
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-5)
    for k in ("ce_loss", "aux_loss", "total_loss"):
        np.testing.assert_allclose(metrics[k].item(), float(wm[k]),
                                   rtol=1e-5, atol=1e-7)
    want_g = dict(tree_leaves(jax.tree.map(np.asarray, wg)))
    assert {p for p, _ in leaves} == set(want_g)
    for (path, _), g in zip(leaves, grads):
        w = want_g[path]
        assert float(np.abs(w).max()) > 0, path
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-4 * float(np.abs(w).max()),
                                   err_msg=path)
