"""The recurrent mixers on a mesh: their layout.  Tensor parallelism over
``model`` splits each mixer's channels (mamba, spectral) or heads (the
mLSTM), with the fused ``[xs | z]`` projections (mamba's and spectral's
``in_proj``, the mLSTM's ``up``) split pairwise: rank m holds the m-th
slice of each half (``ParamSpec.column_groups``), while the global
leaf, and so ``params_from_jax``, the checkpoint and ``gather_tree``,
keeps the reference's layout.

Without a world: a paired shard is the reference global leaf's ``[xs_m |
z_m]`` columns and the blocks join back to it; the one-FSDP-group rule
holds at both archs' full and SMOKE widths; a recurrent mixer under
``use_ulysses`` is refused naming ROADMAP.md; the mLSTM's heads that do
not divide ``model`` are refused with the count.  One 4-rank gloo world
(``data=2, model=2``: EP, ``model`` and FSDP at once): every leaf's
shard gathers back to the global leaf bit for bit, ``init_caches(mesh=)``
holds the slices ``_position_state_logical`` names, and a jamba-smoke
training state restores from its checkpoint with and without the mesh
bit for bit.  The parity of the recurrent archs on 8-rank meshes
against the reference is in ``test_torch_tp.py``."""

import numpy as np
import pytest

from torch_dist import run_world

ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b")
# (arch, its changes, the paired leaf of position 0's mixer)
PAIRED = {"mamba": ("jamba-v0.1-52b", {}, "in_proj"),
          "spectral": ("jamba-v0.1-52b", {"spectral_long_conv": True},
                       "in_proj"),
          "mlstm": ("xlstm-1.3b", {}, "up")}
WORLD = ((2, 2), ("model", "data"))               # fastest digit first


@pytest.mark.parametrize("mixer", list(PAIRED))
def test_paired_shard_is_the_reference_columns(mixer):
    """On ``model`` = 2 and 4, rank m's shard of the reference's global
    ``[xs | z]`` leaf is ``[xs_m | z_m]`` (each half's m-th block of
    columns), and the ranks' shards, concatenated in ``model`` order,
    join back to the global leaf bit for bit."""
    import jax
    import torch
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel.sharding import (model_block, model_dim,
                                               model_join)
    arch, changes, leaf = PAIRED[mixer]
    jcfg = jax_get_config(arch, smoke=True).replace(**changes)
    path = f"blocks/pos0/mixer/{leaf}"
    glob = np.asarray(dict(tree_leaves(jax_build_model(jcfg).init(
        jax.random.PRNGKey(0))))[path])
    spec = dict(tree_leaves(build_model(get_config(arch, smoke=True).replace(
        **changes)).specs()))[path]
    assert spec.column_groups == 2 and spec.shape == glob.shape
    xs, z = np.split(glob, 2, axis=-1)
    for n in (2, 4):
        dim = model_dim(spec.shape, spec.logical, {"model": n})
        assert dim == glob.ndim - 1
        c = xs.shape[-1] // n
        shards = []
        for m in range(n):
            got = model_block(torch.tensor(glob), dim, 2, m, n) \
                .flatten(dim, dim + 1)
            want = np.concatenate([xs[..., m * c:(m + 1) * c],
                                   z[..., m * c:(m + 1) * c]], axis=-1)
            np.testing.assert_array_equal(got.numpy(), want)
            shards.append(got)
        back = model_join(torch.cat(shards, dim), dim, 2, n)
        np.testing.assert_array_equal(back.numpy(), glob)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_fsdp_group_at_full_and_smoke_width(arch, smoke):
    """Every leaf FSDP splits (``embed_fsdp``, experts aside) keeps the
    same mesh axes on the debug and production meshes, one pod or two,
    and the mixers' ``d_model`` leaves are among them."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import debug_shape, production_shape
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel.sharding import fsdp_dim
    leaves = tree_leaves(build_model(get_config(arch, smoke=smoke)).specs())
    for shape in (f(multi_pod=m) for f in (debug_shape, production_shape)
                  for m in (False, True)):
        kept, split = set(), set()
        for path, spec in leaves:
            got = fsdp_dim(spec.shape, spec.logical, shape)
            if got is not None and "expert" not in spec.logical:
                kept.add(got[1])
                split.add(path.rsplit("/", 1)[-1])
        assert kept == {tuple(a for a in ("pod", "data") if a in shape)}, \
            (shape, kept)
        mixers = {"in_proj", "out_proj"} if arch == ARCHS[0] else \
            {"up", "down", "w_gates", "up1", "up2"}
        assert mixers <= split, (shape, split)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_mixer_under_ulysses_is_refused(arch, monkeypatch):
    """No longer refused: a recurrent mixer beside Ulysses attention runs
    its tensor-parallel split over ``model`` unchanged, as the reference
    computes it.  ``check_mesh``, the launcher's ``check_trainable`` and
    ``make_train_step``'s mesh checks accept jamba / xlstm under
    ``use_ulysses`` on ``{"data": 2, "model": 4}`` (the steps themselves
    run in test_torch_tp.py's ``jamba-u`` / ``xlstm-u`` cases)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import check_trainable
    from repro_torch.models import build_model, make_train_step, model_api
    from repro_torch.optim import AdamW
    cfg = get_config(arch, smoke=True).replace(use_ulysses=True)
    model = build_model(cfg)
    shape = {"data": 2, "model": 4}
    assert model.check_mesh(shape) is None
    check_trainable(shape, cfg, 16)

    class Accepted(Exception):
        pass

    def past_the_model_checks(specs, mesh, rules):
        raise Accepted(mesh)
    # the step's first call on the mesh after the model's own check: the
    # parameters' layout
    monkeypatch.setattr(model_api, "param_shardings",
                        past_the_model_checks)
    with pytest.raises(Accepted):
        make_train_step(model, AdamW(), shape)
    model.check_mesh({"data": 2, "model": 1})      # no split over model


def test_mlstm_heads_that_do_not_divide_model_are_refused():
    """xlstm-1.3b's 4 heads split over ``model`` = 2 and 4 (the debug
    meshes); on 8 and 16 its leaves would split and its heads would not,
    so the launcher's check and every mesh entry point refuse, naming
    the count.  jamba has no mLSTM."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import (check_trainable, debug_shape,
                                         production_shape)
    from repro_torch.models import build_model
    jamba, xlstm = (get_config(a) for a in ARCHS)
    for multi in (False, True):
        for cfg in (xlstm, jamba):
            check_trainable(debug_shape(multi_pod=multi), cfg)
        check_trainable(production_shape(multi_pod=multi), jamba)
        with pytest.raises(ValueError, match=r"n_heads \(4\) divisible by "
                                             r"model \(16\)"):
            check_trainable(production_shape(multi_pod=multi), xlstm)
    with pytest.raises(ValueError, match=r"model \(8\)"):
        build_model(xlstm).check_mesh({"data": 2, "model": 8})


def _layout(rank, n, tmp):
    """Runs on every rank of the (data=2, model=2) world: per arch, each
    leaf's shard gathered back against the global leaf, the global shape
    from the shard's, and the shapes of ``init_caches`` with and without
    the mesh; for jamba the checkpoint round trip."""
    from pathlib import Path

    import torch
    from repro_torch.checkpoint.store import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.core.cache import cart_create
    from repro_torch.launch.train import build_training
    from repro_torch.models import build_model
    from repro_torch.models.common import param_shardings, tree_leaves
    from repro_torch.models.transformer import cache_logical_axes

    mesh = cart_create(n, *WORLD, device_type="cpu")
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg)
        sh = param_shardings(model.specs(), mesh)
        glob = model.init(torch.Generator().manual_seed(1), "cpu")
        local = sh.shard_tree(glob)
        back = dict(tree_leaves(sh.gather_tree(local)))
        out[arch] = {
            "paired": sorted(sh.model_groups),
            "gathered": {p: torch.equal(back[p], t)
                         for p, t in tree_leaves(glob)},
            "global_shape": {p: sh.global_shape(p, t.shape) == tuple(
                dict(tree_leaves(glob))[p].shape)
                for p, t in tree_leaves(local)},
            "caches": {p: tuple(t.shape) for p, t in tree_leaves(
                model.init_caches(2, 8, "cpu", mesh=mesh)["states"])},
            "whole_caches": {p: tuple(t.shape) for p, t in tree_leaves(
                model.init_caches(2, 8, "meta")["states"])},
            "logical": dict(tree_leaves(cache_logical_axes(cfg)["states"]))}

    cfg = get_config(ARCHS[0], smoke=True)
    model, _, params, opt_state, _ = build_training(
        cfg, mesh, lr=1e-3, warmup=1, total=10, seed=3, device="cpu")
    sh = param_shardings(model.specs(), mesh)
    state_sh = sh.prefixed("params").merged(sh.prefixed("opt_state/mu"),
                                            sh.prefixed("opt_state/nu"))
    live = {"params": params, "opt_state": opt_state}
    same = lambda a, b: all(torch.equal(x, y) for (_, x), (_, y) in
                            zip(tree_leaves(a), tree_leaves(b)))
    tmp = Path(tmp)
    save_checkpoint(tmp / "ck", 0, live, sharding=state_sh)
    restored, _, _ = restore_checkpoint(tmp / "ck", 0, live,
                                        sharding=state_sh)
    glob = state_sh.gather_tree(live)
    whole, _, _ = restore_checkpoint(tmp / "ck", 0, glob)
    paired = list(state_sh.model_groups)
    out["checkpoint"] = {
        "restore_mesh": same(live, restored),
        "restore_no_mesh": same(glob, whole),
        "paired_fsdp_model": any(p in state_sh.fsdp_axes for p in paired),
        "experts": bool(state_sh.axes),
        "moments_paired": any(p.startswith("opt_state/mu") for p in paired)}
    return out


_RESULTS = []


def _world(tmp_path_factory):
    if not _RESULTS:
        tmp = tmp_path_factory.mktemp("world")
        _RESULTS.append(run_world(_layout, 4, tmp, str(tmp)))
    return _RESULTS[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_shards_gather_back_to_the_global_leaves(arch, tmp_path_factory):
    for rank, r in enumerate(_world(tmp_path_factory)):
        got = r[arch]
        assert got["paired"], rank
        bad = [p for p, ok in got["gathered"].items() if not ok] + \
            [p for p, ok in got["global_shape"].items() if not ok]
        assert not bad, (rank, bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_hold_the_rank_slices(arch, tmp_path_factory):
    """Each recurrent state holds this rank's ``model`` slice of the dims
    ``_position_state_logical`` names (``mlp`` for mamba's and spectral's,
    ``heads`` for the mLSTM's), halved on ``model`` = 2; the sLSTM's is
    whole; the batch is the caller's."""
    from repro_torch.parallel.sharding import resolve_spec
    for r in _world(tmp_path_factory):
        got = r[arch]
        split = 0
        for path, shape in got["caches"].items():
            if path.rsplit("/", 1)[-1] in ("k", "v", "slot_pos"):
                continue                     # attention: head_layout's
            whole = got["whole_caches"][path]
            parts = resolve_spec(whole, got["logical"][path], {"model": 2})
            want = tuple(d // 2 if part == "model" else d
                         for d, part in zip(whole, parts))
            assert shape == want, (path, shape, want)
            split += want != whole
        assert split > 0


def test_checkpoint_round_trip_with_paired_leaves(tmp_path_factory):
    for rank, r in enumerate(_world(tmp_path_factory)):
        bad = [k for k, v in r["checkpoint"].items() if not v]
        assert not bad, (rank, bad)
