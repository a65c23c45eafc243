"""Port parity for the training half of ``distributed/*`` (the
counterparts of ``tests/test_spmd.py`` and
``tests/test_training.py::test_dp_compressed_step_runs_single_device``),
the training layouts, restoring a checkpoint onto a world, the
``configs/<model>.py`` shims and the ported examples.

Worlds of CPU gloo ranks run ``tests/torch_train_ranks.py`` (one spawn
per world size; the 2- and 4-rank worlds are shared with
``test_torch_expert_parallel.py``); the JAX references run here, on the
virtual CPU devices ``tests/conftest.py`` forces.  Tolerances:

  * ``scan_sequence_parallel`` on 4 ranks: rtol = atol = 2e-5 against
    JAX's under ``shard_map`` and ``scan_sequential`` (the reference's);
    its gradients against autograd through the port's ``scan_sequential``
    at 2e-5;
  * ``make_dp_compressed_step`` at 2x1, 2 steps of the smoke minGRU LM:
    against JAX's (jitted) on a (2, 1) mesh with the bridged weights and
    the same batches, params and losses at rtol = atol = 5e-5 (both cast
    fp32 grads that agree to rounding to bf16: a grad near a bf16 tie
    rounds apart, and moves AdamW's second update by a few percent of
    lr 1e-3); against the port's one-device step
    with the reference's trend tolerance (rtol 0.1, atol 2e-3; loss
    1e-2), and with fp32 grads at 1e-5; replicas bit-equal;
  * the layouts: the reference's ``PartitionSpec`` entry for entry;
  * the checkpoint's blocks and the reassembled leaves: bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import archs as jax_archs
from repro.core import scan as jax_scan
from repro.data import lm_corpus as jax_corpus
from repro.distributed import context as jax_mesh_ctx
from repro.distributed import sharding as jax_sharding
from repro.models import encdec as jax_encdec
from repro.models import lm as jax_lm
from repro.training import checkpoint as jax_ckpt
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro_torch import bridge, tree
from repro_torch.configs import archs
from repro_torch.core import scan as scan_lib
from repro_torch.distributed import serve_mesh, sharding
from repro_torch.models import encdec, lm
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_step as ts_lib

import torch_train_ranks as ranks

pytestmark = pytest.mark.slow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN_TOL = 2e-5
# lr 1e-3: a grad that JAX and the port round to neighbouring bf16 values
# moves AdamW's second update by a few percent of lr (the largest seen:
# 2.3e-5); fp32 rounding apart, the params agree to ~3e-6
DP_JAX_TOL = 5e-5
DP_STEPS = 2


@functools.lru_cache(maxsize=None)
def dp_inputs():
    """The smoke mingru-lm's JAX init as numpy, and DP_STEPS corpus
    batches of B 8 x T 32."""
    jcfg = jax_archs.smoke("mingru-lm")
    params = jax.tree.map(np.asarray, jax_lm.init_params(
        jax.random.PRNGKey(0), jcfg))
    data, _ = jax_corpus.build_corpus(target_bytes=20_000)
    batches = tuple(jax_corpus.lm_batch(data, 0, i, 8, 32)
                    for i in range(DP_STEPS))
    return params, batches


def _world(size):
    import test_torch_expert_parallel as ep
    return ep._world(size)


# ---------------------------------------------------------------------------
# The sequence-parallel scan
# ---------------------------------------------------------------------------

def _scan_inputs():
    rng = np.random.RandomState(2)
    return (rng.uniform(0.5, 1.0, (2, 64, 4)).astype(np.float32),
            rng.randn(2, 64, 4).astype(np.float32),
            rng.randn(2, 4).astype(np.float32))


def test_sequence_parallel_scan_matches_jax_and_sequential():
    a, b, h0 = _scan_inputs()
    res = [r["sp_scan"] for r in _world(4)]
    got = np.concatenate([r["h"] for r in res], axis=-2)
    seq = scan_lib.scan_sequential(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(h0)).numpy()
    np.testing.assert_allclose(got, seq, rtol=SCAN_TOL, atol=SCAN_TOL)
    mesh = jax.make_mesh((4,), ("data",), devices=jax.devices()[:4])
    fn = jax_mesh_ctx.shard_map(
        lambda a_, b_, h_: jax_scan.scan_sequence_parallel(a_, b_, "data",
                                                           h0=h_),
        mesh=mesh, in_specs=(P(None, "data", None),) * 2 + (P(),),
        out_specs=P(None, "data", None))
    want = np.asarray(jax.jit(fn)(a, b, h0))
    np.testing.assert_allclose(got, want, rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(want, np.asarray(jax_scan.scan_sequential(
        a, b, h0)), rtol=SCAN_TOL, atol=SCAN_TOL)


def test_sequence_parallel_scan_gradients():
    a, b, h0 = _scan_inputs()
    res = [r["sp_scan"] for r in _world(4)]
    at, bt, ht = (torch.from_numpy(v).requires_grad_() for v in (a, b, h0))
    scan_lib.scan_sequential(at, bt, ht).sum().backward()
    for key, want in (("a_grad", at.grad), ("b_grad", bt.grad)):
        got = np.concatenate([r[key] for r in res], axis=-2)
        np.testing.assert_allclose(got, want.numpy(), rtol=SCAN_TOL,
                                   atol=SCAN_TOL)
    # h0 is whole on every rank: its gradient sums over them
    np.testing.assert_allclose(sum(r["h0_grad"] for r in res),
                               ht.grad.numpy(), rtol=SCAN_TOL, atol=SCAN_TOL)


def test_sequence_parallel_scan_of_one_rank_is_the_associative_scan():
    a, b, h0 = (torch.from_numpy(v) for v in _scan_inputs())
    assert torch.equal(scan_lib.scan_sequence_parallel(a, b, None, h0=h0),
                       scan_lib.scan_associative(a, b, h0))


# ---------------------------------------------------------------------------
# The bf16-compressed data-parallel step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_dp():
    params, batches = dp_inputs()
    jcfg = jax_archs.smoke("mingru-lm")
    ocfg = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    mesh = jax.make_mesh((2, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:2])
    step = jax.jit(jax_ts.make_dp_compressed_step(jcfg, ocfg, mesh))
    p = jax.tree.map(jnp.asarray, params)
    state = jax_opt.init(ocfg, p)
    losses = []
    for batch in batches:
        p, state, m = step(p, state, batch)
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, p)


@functools.lru_cache(maxsize=None)
def _port_single():
    params, batches = dp_inputs()
    cfg = archs.smoke("mingru-lm")
    p = bridge.params_from_jax(params, device="cpu")
    state = opt_lib.init(ranks.DP_OPT, p)
    step = ts_lib.make_train_step(cfg, ranks.DP_OPT)
    losses = []
    for batch in batches:
        p, state, m = step(p, state, batch)
        losses.append(float(m["loss"]))
    return losses, ranks._numpy(p)


def _dp(key):
    res = [r[key] for r in _world(2)]
    assert all(r["replicas_equal"] for r in res)
    return res[0]


def test_dp_compressed_step_matches_jax():
    got = _dp("dp_bf16")
    losses, want = _jax_dp()
    np.testing.assert_allclose(got["losses"], losses, rtol=DP_JAX_TOL,
                               atol=DP_JAX_TOL)
    for path, w in tree.leaves_with_path(want):
        np.testing.assert_allclose(tree.at(got["params"], path), w,
                                   rtol=DP_JAX_TOL, atol=DP_JAX_TOL)


def test_dp_compressed_step_matches_single_device_trend():
    got = _dp("dp_bf16")
    losses, want = _port_single()
    assert abs(got["losses"][0] - losses[0]) < 1e-2
    for path, w in tree.leaves_with_path(want):
        np.testing.assert_allclose(tree.at(got["params"], path), w,
                                   rtol=0.1, atol=2e-3)


def test_dp_step_with_fp32_grads_matches_single_device():
    got = _dp("dp_fp32")
    losses, want = _port_single()
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for path, w in tree.leaves_with_path(want):
        np.testing.assert_allclose(tree.at(got["params"], path), w,
                                   rtol=1e-5, atol=1e-5)


def test_dp_compressed_step_runs_single_device():
    """The DP step on a 1x1 mesh in one process, no world (the reference's
    ``test_dp_compressed_step_runs_single_device``)."""
    params, batches = dp_inputs()
    cfg = archs.smoke("mingru-lm")
    ocfg = opt_lib.AdamWConfig(lr=1e-3)
    p = bridge.params_from_jax(params, device="cpu")
    step = ts_lib.make_dp_compressed_step(
        cfg, ocfg, serve_mesh.MeshPlan(1, 1).build())
    p2, o2, m = step(p, opt_lib.init(ocfg, p), batches[0])
    assert np.isfinite(float(m["loss"])) and int(o2.step) == 1


# ---------------------------------------------------------------------------
# Training layouts
# ---------------------------------------------------------------------------

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "pod 2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _jax_path(path):
    return tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _entries(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


@functools.lru_cache(maxsize=None)
def _trees(name):
    jcfg, cfg = jax_archs.smoke(name), archs.smoke(name)
    jmod, mod = (jax_encdec, encdec) if cfg.family == "encdec" \
        else (jax_lm, lm)
    jparams = jax.eval_shape(lambda: jmod.init_params(jax.random.PRNGKey(0),
                                                      jcfg))
    params = mod.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    jcache = jax.eval_shape(lambda: jmod.init_cache(jcfg, 8, 16))
    cache = mod.init_cache(cfg, 8, 16, device="cpu")
    return jcfg, cfg, jparams, params, jcache, cache


def _same_specs(jspecs, jtree, specs):
    want = {_jax_path(p): _entries(s, len(leaf.shape)) for (p, s), leaf in
            zip(jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(x, P))[0],
                jax.tree.leaves(jtree))}
    got = dict(tree.leaves_with_path(specs, ))
    assert set(got) == set(want)
    for path, spec in got.items():
        assert spec == want[path], (path, spec, want[path])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", jax_archs.all_names())
def test_training_layouts_match_the_reference(name, mesh_name):
    """``params_pspecs`` (and pure DP), ``batch_pspec``, ``cache_pspecs``
    at a batch of 8 and of 1, ``token_pspec``: the reference's
    placements entry for entry, on every arch's smoke trees."""
    shape, axes = MESHES[mesh_name]
    jmesh = jax.make_mesh(shape, axes, devices=jax.devices()[:8])
    mesh = sharding.MeshShape(axes, shape)
    jcfg, cfg, jparams, params, jcache, cache = _trees(name)
    for pure in (False, True):
        _same_specs(jax_sharding.params_pspecs(jparams, jmesh, pure),
                    jparams, sharding.params_pspecs(params, mesh, pure))
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "labels": np.zeros((8, 16), np.int32)}
    for pure in (False, True):
        want = jax_sharding.batch_pspec(jmesh, batch, pure)
        got = sharding.batch_pspec(mesh, batch, pure)
        assert {k: _entries(v, 2) for k, v in want.items()} == got
    for bsz in (8, 1):
        _same_specs(jax_sharding.cache_pspecs(jcfg, jmesh, jcache, bsz),
                    jcache, sharding.cache_pspecs(cfg, mesh, cache, bsz))
        assert sharding.token_pspec(mesh, bsz) == \
            _entries(jax_sharding.token_pspec(jmesh, bsz), 1)


def test_params_shardings_cut_this_ranks_blocks():
    """On a world's ``RankMesh``, ``params_shardings`` is every leaf's
    block at this rank's coordinates (here rank 3 of a 2x2 mesh, built
    without a world)."""
    cfg = archs.smoke("mingru-lm")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    mesh = serve_mesh.RankMesh(serve_mesh.MeshPlan(2, 2), 3)
    specs = sharding.params_pspecs(params, mesh)
    blocks = sharding.params_shardings(params, mesh)
    wz = ("layers", "blocks", "rnn", "wz", "kernel")
    assert dict(tree.leaves_with_path(specs))[wz] == (None, "data", "model")
    full = dict(tree.leaves_with_path(params))[wz]
    got = dict(tree.leaves_with_path(blocks))[wz]
    d, h = full.shape[1] // 2, full.shape[2] // 2
    assert torch.equal(got, full[:, d:, h:]) and got.is_contiguous()
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_of(torch.zeros(3, 4), ("data", None), mesh,
                          mesh.coords)


# ---------------------------------------------------------------------------
# Checkpoints restored onto a world
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ckpt(tmp):
    params, _ = dp_inputs()
    ocfg = jax_opt.AdamWConfig()
    jp = jax.tree.map(jnp.asarray, params)
    state = jax_opt.init(ocfg, jp)
    state = state._replace(mu=jax.tree.map(lambda a: a + 1.5, state.mu))
    path = jax_ckpt.save(tmp, 3, jp, state)
    return path, serve_mesh.run_world(ranks.world_8, 8, (path,))


def test_checkpoint_saved_by_jax_restores_as_blocks_on_a_4x2_world(
        tmp_path_factory):
    path, res = _ckpt(str(tmp_path_factory.mktemp("ckpt")))
    params, _ = dp_inputs()
    mesh = jax.make_mesh((4, 2), ("data", "model"), devices=jax.devices())
    jspecs = jax_sharding.params_pspecs(params, mesh)
    assert sorted((r["coords"]["data"], r["coords"]["model"])
                  for r in res) == [(i, j) for i in range(4)
                                    for j in range(2)]
    _same_specs(jspecs, params, res[0]["specs"])
    n_split = 0
    for r in res:
        assert r["step"] == 3
        rm = serve_mesh.RankMesh(serve_mesh.MeshPlan(4, 2),
                                 r["coords"]["data"] * 2
                                 + r["coords"]["model"])
        for path, whole in tree.leaves_with_path(params):
            spec = tree.at(r["specs"], path)
            want = sharding.shard_of(torch.from_numpy(whole), spec, rm,
                                     rm.coords).numpy()
            np.testing.assert_array_equal(tree.at(r["blocks"], path), want)
            np.testing.assert_array_equal(tree.at(r["mu_blocks"], path),
                                          want * 0 + 1.5)
            np.testing.assert_array_equal(tree.at(r["joined"], path), whole)
            n_split += want.shape != whole.shape
    assert n_split > 0


def test_restore_onto_placements_needs_the_mesh(tmp_path):
    params, _ = dp_inputs()
    path = jax_ckpt.save(str(tmp_path), 1, jax.tree.map(jnp.asarray, params))
    with pytest.raises(ValueError, match="mesh"):
        ckpt_lib.restore(path, device="cpu", placements={})


# ---------------------------------------------------------------------------
# configs/<model>.py shims and the examples
# ---------------------------------------------------------------------------

SHIMS = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "src", "repro",
                                                       "configs"))
               if f.endswith(".py") and f not in ("__init__.py", "archs.py",
                                                  "base.py"))


def _fields(cfg):
    return {f.name: (dataclasses.asdict(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("shim", SHIMS)
def test_config_shim_equals_the_reference(shim):
    assert len(SHIMS) == 13
    ref = importlib.import_module(f"repro.configs.{shim}")
    port = importlib.import_module(f"repro_torch.configs.{shim}")
    for attr in ("CONFIG", "SMOKE"):
        p, j = getattr(port, attr), getattr(ref, attr)
        for name, value in _fields(p).items():
            want = getattr(j, name)
            if dataclasses.is_dataclass(want):
                want = {k: getattr(want, k) for k in value}
            assert value == want, (shim, attr, name)
    assert port.CONFIG == archs.get(port.CONFIG.name)


def _example(name, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_example_quickstart_runs_on_the_cpu():
    out = _example("torch_quickstart.py", "--device", "cpu", "--steps", "2",
                   "--max-new", "4")
    assert "step 2: loss" in out and "generated:" in out


def test_example_selective_copy_runs_on_the_cpu():
    out = _example("torch_selective_copy.py", "--device", "cpu", "--steps",
                   "2", "--eval-batches", "1")
    rows = [ln.split() for ln in out.splitlines()[1:]]
    assert [(r[0], r[1]) for r in rows] == [
        (c, str(n)) for c in ("minlstm", "mingru") for n in (1, 2, 3)]
    assert all(0.0 <= float(r[2]) <= 1.0 for r in rows)


def test_example_lm_shakespeare_runs_on_the_cpu(tmp_path):
    out = _example("torch_lm_shakespeare.py", "--device", "cpu", "--smoke",
                   "--steps", "2", "--seq", "16", "--ckpt-dir",
                   str(tmp_path / "ck"))
    assert os.listdir(tmp_path / "ck") and "To be, or not" in out


def test_example_serve_batched_runs_on_the_cpu():
    out = _example("torch_serve_batched.py", "--device", "cpu",
                   "--max-new", "4")
    assert "7 requests" in out and "kernel tier:" in out
    out = _example("torch_serve_batched.py", "--device", "cpu",
                   "--max-new", "4", "--trace", "4", "--mesh", "2x1")
    assert "mesh 2x1" in out and "identities ok: True" in out
