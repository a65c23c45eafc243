"""Port parity for the training slice: ``lm.loss_fn`` and its grads, the
train step, AdamW, checkpoints (both directions), the supervisor and the
data pipeline, against the JAX package.

JAX smoke params are bridged into the port (``bridge.params_from_jax``);
batches come from the (copied) numpy data pipeline.  The JAX side runs
its Pallas kernels in interpret mode, the port its plain versions (CPU
tensors).  Tolerances, fp32 throughout: loss at 1e-5 relative (a mean
of per-token NLLs, each the same arithmetic summed in another order);
grads at atol 1e-5 + rtol 1e-4 (sums over B*T positions and three
layers of such differences); the 5-step trajectory at 1e-4 (AdamW's
first steps move each weight by ~lr whatever the grad's size, so tiny
grads that differ in their last bits can flip a step's sign).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.data import lm_corpus as jax_corpus
from repro.data import synthetic as jax_synth
from repro.models import lm as jax_lm
from repro.training import checkpoint as jax_ckpt
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro_torch import bridge
from repro_torch.configs import archs as pt_archs
from repro_torch.data import lm_corpus as pt_corpus
from repro_torch.data import synthetic as pt_synth
from repro_torch.kernels.fused_mingru import ops as gru_ops
from repro_torch.kernels.fused_minlstm import ops as lstm_ops
from repro_torch.kernels.scan import ops as scan_ops
from repro_torch.models import lm as pt_lm
from repro_torch.training import checkpoint as pt_ckpt
from repro_torch.training import optimizer as pt_opt
from repro_torch.training import train_step as pt_ts
from repro_torch.training.fault_tolerance import TrainSupervisor

B, T = 2, 16
_CORPUS = {}


def _data():
    if "train" not in _CORPUS:
        _CORPUS["train"] = pt_corpus.build_corpus(target_bytes=20_000)[0]
    return _CORPUS["train"]


def _batch(step, batch=B, seq=T):
    return pt_corpus.lm_batch(_data(), 0, step, batch, seq)


def _pair(arch, **over):
    jcfg = jax_archs.smoke(arch).replace(**over)
    pcfg = pt_archs.smoke(arch).replace(**over)
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, pcfg, jparams, pparams


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _assert_trees_close(jtree, ptree, rtol, atol):
    jflat = dict(_flat(jax.tree.map(np.asarray, jtree)))
    pflat = dict(_flat(ptree))
    assert set(jflat) == set(pflat)
    for k, v in jflat.items():
        np.testing.assert_allclose(
            np.asarray(v, np.float32), pflat[k].detach().float().numpy(),
            rtol=rtol, atol=atol, err_msg=str(k))


@pytest.mark.parametrize("arch", ["mingru-lm", "minlstm-lm"])
@pytest.mark.parametrize("strategy", ["auto", "pallas"])
def test_step0_loss_and_grads_match_jax(arch, strategy):
    jcfg, pcfg, jparams, pparams = _pair(arch, scan_strategy=strategy)
    batch = _batch(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm.loss_fn(p, jcfg, b), has_aux=True))(
        jparams, batch)
    (pl, pm), pg = pt_ts.value_and_grad(pt_ts.make_loss_fn(pcfg), pparams,
                                        pt_ts.batch_to(batch, "cpu"))
    np.testing.assert_allclose(float(jl), float(pl), rtol=1e-5)
    assert float(jm["ntokens"]) == float(pm["ntokens"]) == B * T
    _assert_trees_close(jg, pg, rtol=1e-4, atol=1e-5)


def test_five_step_trajectory_matches_jax():
    jcfg, pcfg, jparams, pparams = _pair("mingru-lm", z_loss=1e-4)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    jstep = jax.jit(jax_ts.make_train_step(jcfg,
                                           jax_opt.AdamWConfig(**ocfg)))
    pstep = pt_ts.make_train_step(pcfg, pt_opt.AdamWConfig(**ocfg))
    jstate = jax_opt.init(jax_opt.AdamWConfig(**ocfg), jparams)
    pstate = pt_opt.init(pt_opt.AdamWConfig(**ocfg), pparams)
    for step in range(5):
        batch = _batch(step)
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        pparams, pstate, pm = pstep(pparams, pstate, batch)
        for k in ("loss", "nll", "z_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(jm[k]), float(pm[k]),
                                       rtol=1e-4, err_msg=f"{k} @ {step}")
    _assert_trees_close(jparams, pparams, rtol=1e-3, atol=1e-4)


def test_adamw_apply_matches_jax():
    rng = np.random.default_rng(0)
    params = {"w": {"kernel": rng.standard_normal((4, 3)),
                    "bias": rng.standard_normal((3,))},
              "norm": {"scale": rng.standard_normal((3,))}}
    params = jax.tree.map(lambda a: a.astype(np.float32), params)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=10, grad_clip=0.5)
    jstate = jax_opt.init(jax_opt.AdamWConfig(**cfg), params)
    pp = bridge.params_from_jax(params, device="cpu")
    pstate = pt_opt.init(pt_opt.AdamWConfig(**cfg), pp)
    jp = params
    for step in range(4):
        grads = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
        jp, jstate, jm = jax_opt.apply(jax_opt.AdamWConfig(**cfg), jstate,
                                       jp, grads)
        pp, pstate, pm = pt_opt.apply(
            pt_opt.AdamWConfig(**cfg), pstate, pp,
            bridge.params_from_jax(grads, device="cpu"))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(jm[k]), float(pm[k]),
                                       rtol=1e-6)
        _assert_trees_close(jp, pp, rtol=1e-6, atol=1e-7)
        _assert_trees_close(jstate.mu, pstate.mu, rtol=1e-6, atol=1e-7)
        _assert_trees_close(jstate.nu, pstate.nu, rtol=1e-6, atol=1e-9)
    assert int(jstate.step) == int(pstate.step) == 4


def test_microbatch_accumulation_matches_full_batch():
    _, pcfg, _, pparams = _pair("minlstm-lm")
    batch = _batch(3, batch=4)
    copy = pt_lm.tree_to(jax.tree.map(lambda t: t.clone(), pparams), "cpu")
    ocfg = pt_opt.AdamWConfig(lr=1e-3, warmup_steps=1)
    full, _, fm = pt_ts.make_train_step(pcfg, ocfg)(
        pparams, pt_opt.init(ocfg, pparams), batch)
    micro, _, mm = pt_ts.make_train_step(pcfg, ocfg, microbatches=2)(
        copy, pt_opt.init(ocfg, copy), batch)
    np.testing.assert_allclose(float(fm["loss"]), float(mm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(fm["grad_norm"]),
                               float(mm["grad_norm"]), rtol=1e-5)
    for (k, a), (_, b) in zip(_flat(full), _flat(micro)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=str(k))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(dtype, tmp_path):
    jcfg, pcfg, jparams, _ = _pair("mingru-lm", param_dtype=dtype)
    ocfg = jax_opt.AdamWConfig()
    jstate = jax_opt.init(ocfg, jparams)
    jstate = jax_opt.AdamWState(jnp.asarray(7, jnp.int32),
                                jax.tree.map(lambda a: a + 0.25, jstate.mu),
                                jstate.nu)
    # JAX writes, the port restores
    path = jax_ckpt.save(str(tmp_path / "j"), 7, jparams, jstate)
    step, pparams, pstate = pt_ckpt.restore(path, device="cpu")
    assert step == 7 and int(pstate.step) == 7
    for (k, a), (_, b) in zip(sorted(_flat(jax.tree.map(np.asarray,
                                                          jparams))),
                              sorted(_flat(pparams))):
        assert str(b.dtype).endswith(dtype), k
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    _assert_trees_close(jstate.mu, pstate.mu, rtol=0, atol=0)
    # the port writes, JAX restores
    path = pt_ckpt.save(str(tmp_path / "p"), 9, pparams, pstate)
    assert jax_ckpt.verify(path)
    step, back, bstate = jax_ckpt.restore(path)
    assert step == 9 and int(bstate.step) == 7
    for (k, a), (_, b) in zip(sorted(_flat(jax.tree.map(np.asarray, back))),
                              sorted(_flat(jax.tree.map(np.asarray,
                                                        jparams)))):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b)


def test_corrupt_checkpoint_falls_back(tmp_path):
    _, pcfg, _, pparams = _pair("mingru-lm")
    mgr = pt_ckpt.CheckpointManager(str(tmp_path), keep=3, save_interval=1,
                                    device="cpu")
    for s in (1, 2):
        mgr.maybe_save(s, pparams)
    with open(tmp_path / "step_00000002" / "arrays.npz", "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 16)
    step, _, _ = mgr.restore_latest()
    assert step == 1 and mgr.corrupt_skipped == [2]


def test_supervisor_recovers_from_a_failure(tmp_path):
    _, pcfg, _, pparams = _pair("mingru-lm")
    ocfg = pt_opt.AdamWConfig(lr=1e-3, warmup_steps=1)
    step_fn = pt_ts.make_train_step(pcfg, ocfg)

    def run(fail_at):
        params = pt_lm.tree_to(jax.tree.map(lambda t: t.clone(), pparams),
                               "cpu")
        mgr = pt_ckpt.CheckpointManager(str(tmp_path / str(fail_at)),
                                        keep=2, save_interval=2,
                                        device="cpu")
        sup = TrainSupervisor(step_fn, _batch, mgr)
        fired = []

        def hook(step):
            if step == fail_at and not fired:
                fired.append(step)
                raise RuntimeError("simulated node failure")

        sup.failure_hook = hook
        return sup.run(params, pt_opt.init(ocfg, params), 5)

    p_ok, _, rep_ok = run(-1)
    p_rec, _, rep = run(3)
    assert rep.failures_recovered == 1 and rep.restarts == [3]
    assert rep.steps_run == 6 and rep_ok.steps_run == 5
    for (k, a), (_, b) in zip(_flat(p_ok), _flat(p_rec)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(k))


def test_data_pipeline_matches_reference():
    jtrain, jtest = jax_corpus.build_corpus(target_bytes=30_000, seed=1)
    ptrain, ptest = pt_corpus.build_corpus(target_bytes=30_000, seed=1)
    np.testing.assert_array_equal(jtrain, ptrain)
    np.testing.assert_array_equal(jtest, ptest)
    for step in (0, 5):
        jb = jax_corpus.lm_batch(jtrain, 3, step, 4, 32)
        pb = pt_corpus.lm_batch(ptrain, 3, step, 4, 32)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(jb[k], pb[k])
        jb = jax_synth.selective_copy_batch(2, step, 3, seq_len=40)
        pb = pt_synth.selective_copy_batch(2, step, 3, seq_len=40)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(jb[k], pb[k])


def test_cpu_training_launches_no_kernel():
    for mod in (gru_ops, lstm_ops, scan_ops):
        mod.reset_launches()
    for arch, strategy in (("mingru-lm", "auto"), ("minlstm-lm", "pallas")):
        cfg = pt_archs.smoke(arch).replace(scan_strategy=strategy,
                                           remat="full")
        params = pt_lm.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
        ocfg = pt_opt.AdamWConfig()
        pt_ts.make_train_step(cfg, ocfg)(params, pt_opt.init(ocfg, params),
                                         _batch(0))
    for mod in (gru_ops, lstm_ops, scan_ops):
        assert all(n == 0 for n in mod.LAUNCHES.values()), mod.LAUNCHES


def test_remat_full_matches_no_remat():
    _, pcfg, _, pparams = _pair("mingru-lm")
    batch = pt_ts.batch_to(_batch(1), "cpu")
    outs = []
    for remat in ("none", "full"):
        (loss, _), grads = pt_ts.value_and_grad(
            pt_ts.make_loss_fn(pcfg.replace(remat=remat)), pparams, batch)
        outs.append((loss, grads))
    assert float(outs[0][0]) == float(outs[1][0])
    for (k, a), (_, b) in zip(_flat(outs[0][1]), _flat(outs[1][1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(k))


def test_train_launcher_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    report = train.main(["--smoke", "--device", "cpu", "--steps", "4",
                         "--batch", "2", "--seq", "16", "--ckpt-dir",
                         str(tmp_path), "--ckpt-every", "2",
                         "--simulate-failure", "3", "--log-every", "2"])
    assert report.failures_recovered == 1
    assert os.path.isdir(tmp_path / "step_00000004")
    assert "step 2:" in capsys.readouterr().out
