"""A model with a recurrent mixer refuses a mesh: its leaves (mamba's and
the mLSTM's ``mlp`` / ``embed_fsdp`` dims) take no split in the port
yet, so every entry point that takes a mesh raises
``NotImplementedError`` naming the ROADMAP item instead of computing a
silently wrong split.  One 2-rank gloo world (``model`` = 2)."""

import pytest

from torch_dist import run_world

ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b")


def _refusals(rank, n):
    """Runs on every rank: the message of each entry point's refusal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.cache import cart_create
    from repro_torch.models import build_model, make_train_step
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.common import tree_map
    from repro_torch.optim import AdamW

    mesh = cart_create(n, (n,), ("model",), device_type="cpu")
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        toks = torch.zeros((2, 4), dtype=torch.int32)
        numpy_tree = tree_map(lambda t: t.numpy(), params)
        calls = {
            "forward": lambda: model.forward(params, toks, mesh=mesh),
            "init_caches": lambda: model.init_caches(2, 8, "cpu",
                                                     mesh=mesh),
            "decode_step": lambda: model.decode_step(
                params, toks[:, :1], model.init_caches(2, 8, "cpu"),
                mesh=mesh),
            "params_from_jax": lambda: params_from_jax(numpy_tree, cfg,
                                                       "cpu", mesh=mesh),
            "train_step": lambda: make_train_step(model, AdamW(), mesh),
        }
        for name, call in calls.items():
            try:
                call()
                out[(arch, name)] = None
            except NotImplementedError as e:
                out[(arch, name)] = str(e)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_mixers_refuse_a_mesh(arch, tmp_path_factory):
    results = _world(tmp_path_factory)
    for rank, r in enumerate(results):
        for (a, name), msg in r.items():
            if a != arch:
                continue
            assert msg is not None, f"rank {rank}: {name} ran on a mesh"
            assert "ROADMAP.md" in msg and "on a mesh" in msg, msg


_RESULTS = []


def _world(tmp_path_factory):
    if not _RESULTS:
        _RESULTS.append(run_world(_refusals, 2,
                                  tmp_path_factory.mktemp("world")))
    return _RESULTS[0]
