"""Port parity for MoE expert parallelism (``models/moe.py`` over a data x
model world; the counterpart of ``tests/test_spmd.py``'s EP case).

The reference's test config (d 16, 8 experts of 32, top-2, capacity
factor 16: no assignment drops) and tokens (2, 12, 16) go through the
port's ``moe_apply`` on worlds of CPU gloo ranks (``torch_train_ranks``,
spawned once per world size): 2x2 with ``ep_2d`` "off" and "on", and 1x2.
Each data rank holds its rows of the tokens; each model rank its experts
(and in 2D its d slice of them).  Held against the port's and JAX's
no-mesh ``moe_apply`` on the whole batch: y and aux at 2e-4 (the
reference's), the gradients of the ranks' summed loss ``sum(y * g) +
aux`` for x, the router and the three expert kernels at fp32 1e-5.  A
rank's gradient of a leaf whole on the data ranks is summed over them;
a block split over them is its own.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import moe as jax_moe
from repro_torch import tree
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import serve_mesh, sharding
from repro_torch.models import moe

import torch_train_ranks as ranks

pytestmark = pytest.mark.slow

FWD_TOL = 2e-4
GRAD_TOL = 1e-5


def _jcfg():
    return JaxModelConfig(d_model=16, moe=JaxMoEConfig(
        n_experts=8, top_k=2, d_expert=32, capacity_factor=16.0))


@functools.lru_cache(maxsize=None)
def _inputs():
    layer = jax.tree.map(np.asarray, jax_moe.moe_init(jax.random.PRNGKey(0),
                                                      _jcfg()))
    rng = np.random.RandomState(1)
    x = rng.randn(2, 12, 16).astype(np.float32)
    g = rng.randn(2, 12, 16).astype(np.float32)
    return layer, x, g


@functools.lru_cache(maxsize=None)
def _jax_no_mesh():
    layer, x, g = _inputs()

    def loss(p, x_):
        y, aux = jax_moe.moe_apply(p, _jcfg(), x_)
        return jnp.sum(y * g) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(layer, jnp.asarray(x))
    return (np.asarray(y), float(aux), np.asarray(gx),
            jax.tree.map(np.asarray, gp))


@functools.lru_cache(maxsize=None)
def _port_no_mesh():
    layer, x, g = _inputs()
    p = ranks._tensors(layer)
    for leaf in tree.leaves(p):
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(p, ranks.EP_CFG, xt)
    ((y * torch.from_numpy(g)).sum() + aux).backward()
    return (y.detach().numpy(), float(aux.detach()), xt.grad.numpy(),
            ranks._numpy(tree.tree_map(lambda a: a.grad, p)))


@functools.lru_cache(maxsize=None)
def _world(size):
    layer, x, g = _inputs()
    if size == 4:
        rng = np.random.RandomState(2)
        scan_in = (rng.uniform(0.5, 1.0, (2, 64, 4)).astype(np.float32),
                   rng.randn(2, 64, 4).astype(np.float32),
                   rng.randn(2, 4).astype(np.float32))
        return serve_mesh.run_world(ranks.world_4, 4,
                                    (layer, x, g, scan_in) + _lm_inputs())
    from test_torch_dp_training import dp_inputs
    params, batches = dp_inputs()
    return serve_mesh.run_world(ranks.world_2, 2,
                                (params, layer, x, g, batches))


def _case(key):
    return [r[key] for r in _world(2 if key == "ep_1x2" else 4)]


@functools.lru_cache(maxsize=None)
def _lm_inputs():
    """The smoke deepseek-moe-16b's JAX init as numpy and a B 4 x T 16
    batch of seeded ids, each labelled with the next."""
    from repro.configs import archs as jax_archs
    from repro.models import lm as jax_lm
    params = jax.tree.map(np.asarray, jax_lm.init_params(
        jax.random.PRNGKey(3), jax_archs.smoke("deepseek-moe-16b")))
    toks = np.random.RandomState(4).randint(0, 512, (4, 17))
    return params, {"tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("mode", ["off", "on"])
def test_mesh_train_step_matches_the_one_device_step(mode):
    """``make_mesh_train_step`` on a 2x2 world (the smoke deepseek-moe-16b,
    fp32, its experts split as ``ep_2d`` places them) against the port's
    one-device step on the whole batch: the loss and the global grad norm
    at 1e-5, the grads (``mesh_value_and_grad``) reassembled from the
    ranks' blocks at 1e-5, and the updated params at atol 1e-4, a tenth
    of lr (AdamW's first step moves a param by lr g / (|g| + eps): where
    |g| is near eps, a grad that agrees to 1e-7 moves it by a few percent
    of lr)."""
    from repro_torch.training import train_step as ts_lib
    params_np, batch = _lm_inputs()
    res = _case(f"step_{mode}")
    assert all(r["two_d"] == (mode == "on") for r in res)
    cfg = ranks.moe_lm_cfg(mode)
    p = ranks._tensors(params_np)
    (_, _), grads = ts_lib.value_and_grad(ts_lib.make_loss_fn(cfg), p,
                                          ts_lib.batch_to(batch, "cpu"))
    p, _, m = ts_lib.make_train_step(cfg, ranks.MOE_OPT)(
        p, ranks.opt_lib.init(ranks.MOE_OPT, p), batch)
    for r in res:
        np.testing.assert_allclose(r["loss"], float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], float(m["grad_norm"]),
                                   rtol=1e-5)
    for key, want_tree, tol in (("grads", grads, dict(rtol=GRAD_TOL,
                                                      atol=GRAD_TOL)),
                                ("params", p, dict(rtol=1e-5, atol=1e-4))):
        for path, want in tree.leaves_with_path(want_tree):
            np.testing.assert_allclose(_joined(res, key, path),
                                       want.detach().numpy(), **tol)


def _joined(res, key, path):
    """A 2x2 world's blocks of one leaf, reassembled; a leaf whole on an
    axis is equal bit for bit on that axis's ranks."""
    spec = tree.at(res[0]["specs"], path)
    grid = [[tree.at(res[i * 2 + j][key], path) for j in range(2)]
            for i in range(2)]
    cols = []
    for j in range(2):
        if "data" in spec:
            cols.append(np.concatenate([grid[i][j] for i in range(2)],
                                       axis=spec.index("data")))
        else:
            np.testing.assert_array_equal(grid[1][j], grid[0][j])
            cols.append(grid[0][j])
    if "model" in spec:
        return np.concatenate(cols, axis=spec.index("model"))
    np.testing.assert_array_equal(cols[1], cols[0])
    return cols[0]


def _gathered(results, plan):
    """(y, aux, x grad, param grads) of the whole batch from every rank's
    part, checking that the model ranks of a data row agree bit for bit
    on what they all hold."""
    d, m = plan
    y = np.concatenate([results[i * m]["y"] for i in range(d)])
    xg = np.concatenate([results[i * m]["x_grad"] for i in range(d)])
    for r, res in enumerate(results):
        row = results[r - r % m]
        np.testing.assert_array_equal(res["y"], row["y"])
        np.testing.assert_array_equal(res["x_grad"], row["x_grad"])
        assert res["aux"] == results[0]["aux"]
    specs = results[0]["specs"]

    def join(path, _):
        spec = tree.at(specs, path)
        blocks = [tree.at(res["grads"], path) for res in results]
        if "data" not in spec:            # whole on the data ranks: summed
            rows = [sum(blocks[i * m + j] for i in range(d))
                    for j in range(m)]
            rows = [rows[j] for j in range(m)]
            if "model" not in spec:
                for j in range(m):
                    np.testing.assert_array_equal(rows[j], rows[0])
                return rows[0]
            return np.concatenate(rows, axis=spec.index("model"))
        grid = [[blocks[i * m + j] for j in range(m)] for i in range(d)]
        cols = [np.concatenate([grid[i][j] for i in range(d)],
                               axis=spec.index("data")) for j in range(m)]
        return np.concatenate(cols, axis=spec.index("model"))

    grads = tree.map_with_path(join, results[0]["grads"])
    return y, results[0]["aux"], xg, grads


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _check_forward(key, plan):
    y, aux, _, _ = _gathered(_case(key), plan)
    for want_y, want_aux, _, _ in (_port_no_mesh(), _jax_no_mesh()):
        _close(y, want_y, FWD_TOL)
        np.testing.assert_allclose(aux, want_aux, rtol=1e-4)


def _check_grads(key, plan):
    _, _, xg, grads = _gathered(_case(key), plan)
    for _, _, want_xg, want in (_port_no_mesh(), _jax_no_mesh()):
        _close(xg, want_xg, GRAD_TOL)
        for path, gw in tree.leaves_with_path(grads):
            _close(gw, tree.at(want, path), GRAD_TOL)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_ep_2x2_forward_matches_no_mesh(mode):
    res = _case(f"ep_{mode}")
    assert all(r["ep"] for r in res)
    assert all(r["two_d"] == (mode == "on") for r in res)
    _check_forward(f"ep_{mode}", (2, 2))


@pytest.mark.parametrize("mode", ["off", "on"])
def test_ep_2x2_gradients_match_no_mesh(mode):
    _check_grads(f"ep_{mode}", (2, 2))


def test_ep_1x2_matches_no_mesh():
    res = _case("ep_1x2")
    assert all(r["ep"] and not r["two_d"] for r in res)
    _check_forward("ep_1x2", (1, 2))
    _check_grads("ep_1x2", (1, 2))


def test_ep_blocks_are_the_expert_placements():
    """A rank's expert kernels are its E / model experts (and in 2D its d
    slice); the router and nothing else stays whole."""
    layer, _, _ = _inputs()
    for mode, shape in (("off", (4, 16, 32)), ("on", (4, 8, 32))):
        res = _case(f"ep_{mode}")[3]
        assert res["grads"]["gate_w"]["kernel"].shape == shape
        assert res["grads"]["down_w"]["kernel"].shape == \
            (shape[0], 32, shape[1])
        assert res["grads"]["router"]["kernel"].shape == \
            layer["router"]["kernel"].shape


def test_ep_layout_follows_the_reference_rule():
    cfg = ranks.ep_cfg("auto")
    mesh = sharding.MeshShape(("data", "model"), (2, 2))
    # cap_est = 16 * 24 * 2 / 8 = 96: 96 * 4 >= 32 -> 1D
    assert moe.ep_layout(cfg, mesh, 24) == moe.EPLayout(True, False)
    small = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=0.25))
    # cap_est = int(0.25 * 2 * 2 / 8) -> 1 (at least): 4 < 32 -> 2D
    assert moe.ep_layout(small, mesh, 2).two_d
    assert not moe.ep_layout(
        small, sharding.MeshShape(("data", "model"), (1, 2)), 2).two_d
    assert moe.ep_layout(ranks.ep_cfg("on"), mesh, 24).two_d
    assert not moe.ep_layout(ranks.ep_cfg("off"), mesh, 2).two_d
    # EP off: pure DP, a model axis that does not divide E, no mesh
    with mesh_ctx.use_mesh(mesh, pure_dp=True):
        assert not moe.ep_layout(cfg, mesh, 24).ep
    assert not moe.ep_layout(
        cfg, sharding.MeshShape(("data", "model"), (1, 3)), 24).ep
    assert not moe.ep_layout(cfg, None, 24).ep


def test_ep_refuses_whole_expert_weights():
    """Under EP a rank must hold its blocks: whole expert weights raise
    before any collective, naming ``expert_placements``."""
    layer, x, _ = _inputs()
    mesh = serve_mesh.RankMesh(serve_mesh.MeshPlan(1, 2), 0)
    with pytest.raises(ValueError, match="expert_placements"):
        moe.moe_apply(ranks._tensors(layer), ranks.EP_CFG,
                      torch.from_numpy(x), mesh=mesh)


def test_expert_placements_of_a_stacked_lm_tree():
    """On an LM's params the routed experts' kernels split after the
    stacked-layer dim; everything else is whole."""
    from repro_torch.configs import archs
    from repro_torch.models import lm
    cfg = archs.smoke("deepseek-moe-16b")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    mesh = sharding.MeshShape(("data", "model"), (2, 2))
    specs = moe.expert_placements(params, moe.EPLayout(True, True))
    flat = dict(tree.leaves_with_path(specs))
    blocks = ("layers", "blocks", "moe")
    assert flat[blocks + ("gate_w", "kernel")] == (None, "model", "data",
                                                   None)
    assert flat[blocks + ("down_w", "kernel")] == (None, "model", None,
                                                   "data")
    split = {p for p, s in flat.items() if any(e is not None for e in s)}
    assert split == {blocks + (k, "kernel")
                     for k in ("gate_w", "up_w", "down_w")}
