"""Port parity for ``distributed/context.py`` and ``distributed/
sharding.py`` (the counterparts of ``tests/test_distributed_context.py``,
whose ``shard_map`` wrapper cases have no port: the port runs one process
per rank), and for ``blocks._row_parallel_apply`` on a 2-rank gloo world
of CPU processes (``tests/torch_mesh_ranks.py``)."""

from __future__ import annotations

import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import archs as jax_archs
from repro.core import blocks as jax_blocks
from repro.distributed import sharding as jax_sharding
from repro.models import lm as jax_lm
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import serve_mesh, sharding
from repro_torch.tree import leaves_with_path

import torch_mesh_ranks as ranks


def _mesh(data, model):
    return serve_mesh.RankMesh(serve_mesh.MeshPlan(data, model), 0)


def test_axis_size_and_dp_axes():
    mesh = _mesh(2, 2)
    assert mesh_ctx.axis_size(mesh, "data") == 2
    assert mesh_ctx.axis_size(mesh, "model") == 2
    assert mesh_ctx.axis_size(mesh, "pod") == 1       # absent axis -> 1
    assert mesh_ctx.axis_size(None, "data") == 1      # no mesh -> 1
    assert mesh_ctx.dp_axes(mesh) == ("data",)
    pod = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                shape={"pod": 2, "data": 2, "model": 1})
    assert mesh_ctx.dp_axes(pod) == ("pod", "data")
    assert mesh_ctx.axis_size(pod, "pod") == 2


def test_use_mesh_nesting_restores():
    mesh = serve_mesh.MeshPlan(1, 1).build()
    assert mesh_ctx.current_mesh() is None
    with mesh_ctx.use_mesh(mesh, pure_dp=True):
        assert mesh_ctx.current_mesh() is mesh
        assert mesh_ctx.pure_dp()
        with mesh_ctx.use_mesh(None):
            assert mesh_ctx.current_mesh() is None
        assert mesh_ctx.current_mesh() is mesh
    assert mesh_ctx.current_mesh() is None
    assert not mesh_ctx.pure_dp()


def test_serving_tp_context_restores_on_error():
    group = object()
    assert mesh_ctx.serving_tp_group() is None
    with mesh_ctx.serving_tp(group):
        assert mesh_ctx.serving_tp_group() is group
        with mesh_ctx.serving_tp(None):
            assert mesh_ctx.serving_tp_group() is None
        assert mesh_ctx.serving_tp_group() is group
    assert mesh_ctx.serving_tp_group() is None
    with pytest.raises(RuntimeError):
        with mesh_ctx.serving_tp(group):
            raise RuntimeError("boom")
    assert mesh_ctx.serving_tp_group() is None


@functools.lru_cache(maxsize=None)
def _row_parallel():
    rng = np.random.default_rng(0)
    full = rng.standard_normal((8, 5)).astype(np.float32)
    bias = rng.standard_normal((5,)).astype(np.float32)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    got = serve_mesh.run_world(ranks.row_parallel_world, 2, (full, bias, x))
    return full, bias, x, got


def test_row_parallel_apply_all_reduces_under_tp():
    """Identity without the context or for a whole kernel; under the
    context the row blocks' partials are all-reduced, the bias added once
    after the reduction, on both ranks bit for bit; a list of positions
    reduces in one call."""
    full, bias, x, got = _row_parallel()
    ref = np.asarray(jax_blocks._row_parallel_apply(
        {"kernel": full, "bias": bias}, x, None, 8))
    for r in got:
        np.testing.assert_allclose(r["sharded"], ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["whole"], ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r["listed"][0], r["sharded"])
        np.testing.assert_allclose(r["listed"][1], 2 * ref - bias,
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[0]["sharded"], got[1]["sharded"])
    # no context: each rank's own partial plus the bias, as dense_apply
    half = full.shape[0] // 2
    for i, r in enumerate(got):
        part = x[:, i * half:(i + 1) * half] @ full[i * half:(i + 1) * half]
        np.testing.assert_allclose(r["no_context"], part + bias, rtol=1e-5,
                                   atol=1e-6)


def _jax_placement(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("arch", ["mingru-lm", "gemma-2b", "mamba2-370m"])
@pytest.mark.parametrize("shape,pure", [((2, 2), False), ((4, 1), False),
                                        ((1, 4), False), ((2, 2), True)])
def test_spec_for_param_matches_the_reference(arch, shape, pure):
    """``logical_mapping`` and ``spec_for_param`` place every leaf of the
    smoke params as the reference's do, divisibility fallback included."""
    jcfg = jax_archs.smoke(arch)
    shapes = jax.eval_shape(
        lambda: jax_lm.init_params(jax.random.PRNGKey(0), jcfg))
    jmesh = jax.make_mesh(shape, ("data", "model"))
    mesh = _mesh(*shape)
    jmap = jax_sharding.logical_mapping(jmesh, pure)
    pmap = sharding.logical_mapping(mesh, pure)
    assert pmap == jmap
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        path_s = jax_sharding._path_str(path)
        assert sharding._path_str(tuple(p.key for p in path)) == path_s
        want = jax_sharding.spec_for_param(path_s, leaf.shape, jmesh, jmap)
        got = sharding.spec_for_param(path_s, leaf.shape, mesh, pmap)
        assert got == _jax_placement(want, len(leaf.shape)), path_s
        n += any(g is not None for g in got)
    assert (n > 0) == (not pure)


@pytest.mark.parametrize("placement", [
    (("data", "model"), None), (None, ("model", "data")),
    ("model", "data"), ("data", None)])
def test_shard_of_takes_the_blocks_jax_places(placement):
    """``shard_of`` cuts, for each mesh position, the block a JAX
    ``NamedSharding`` puts on that device (several axes on one dim in
    row-major order), as a contiguous copy."""
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    jmesh = jax.make_mesh((2, 2), ("data", "model"))
    arr = jax.device_put(x, NamedSharding(jmesh, P(*placement)))
    blocks = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    mesh = _mesh(2, 2)
    for d in range(2):
        for m in range(2):
            got = sharding.shard_of(torch.from_numpy(x), placement, mesh,
                                    {"data": d, "model": m})
            assert got.is_contiguous()
            np.testing.assert_array_equal(got.numpy(),
                                          blocks[jmesh.devices[d, m]])


def test_cut_slot_state_places_leaves_as_the_reference():
    """The slot state's placement: batch-leading leaves split on axis 0,
    cache leaves on axis 1 (``pos`` on 0), ``h`` also by model under TP
    -- the reference's ``slot_state_pspecs``, leaf for leaf (rank 3 of
    2x2: the second half of each split dim)."""
    from repro.distributed import serve_mesh as jax_serve_mesh
    from repro.serving import draft as jax_draft
    from repro_torch.configs import archs
    from repro_torch.models import lm
    from repro_torch.serving import draft as draft_lib
    jcfg, cfg = jax_archs.smoke("mingru-lm"), archs.smoke("mingru-lm")
    jstate = jax.eval_shape(lambda: jax_lm.init_slot_state(
        jcfg, 4, 16, draft=jax_draft.NGramDraft(4)))
    plan = serve_mesh.MeshPlan(2, 2)
    jspecs = jax_serve_mesh.slot_state_pspecs(jcfg, jstate, plan)
    want = {tuple(p.key for p in path): tuple(s) for path, s in
            jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda v: isinstance(v, P))[0]}
    state = lm.init_slot_state(cfg, 4, 16, draft=draft_lib.NGramDraft(4),
                               device="cpu")
    mesh = serve_mesh.RankMesh(plan, 3)               # data 1, model 1
    cut = serve_mesh.cut_slot_state(cfg, state, mesh)
    got = dict(leaves_with_path(cut))
    # the port's one leaf the reference lacks: ``key_lag``, a per-slot
    # (B,) counter of emissions since the host-side keys last advanced
    extra = {path for path, _ in leaves_with_path(state)} - set(want)
    assert extra == {("key_lag",)}
    for path, leaf in leaves_with_path(state):
        spec = _jax_placement(want.get(path, ("data",)), leaf.dim())
        want_shape = tuple(n // (2 if s else 1)
                           for n, s in zip(leaf.shape, spec))
        assert tuple(got[path].shape) == want_shape, path
        idx = tuple(slice(n // 2, n) if s else slice(None)
                    for n, s in zip(leaf.shape, spec))
        assert torch.equal(got[path], leaf[idx]), path
