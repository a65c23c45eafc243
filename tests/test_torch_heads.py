"""Port parity for the task heads (``models/heads.py``) and their data
(``data/synthetic.py``'s Chomsky suite and ListOps, ``data/rl_proxy.py``).

Heads: the classifier at Table 4's block (conv on, MLP off) and Table
6's ablation block (conv and MLP x2), the Decision-Transformer model at
Table 3's (MLP x2, no conv), each for minGRU and minLSTM, at a smoke
width (d 32, 2 layers).  The JAX params are bridged into the port and
the same numpy-seeded inputs go through both: the JAX blocks run the
fused Pallas kernels in interpret mode, the port their plain versions.
Logits, outputs and losses at atol = rtol = 1e-5 (the same fp32
arithmetic, sums in another order); gradients at rtol 1e-4 / atol 1e-5.
The data generators are numpy in both packages: their arrays must be
equal bit for bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as jax_blocks
from repro.data import rl_proxy as jax_rl
from repro.data import synthetic as jax_syn
from repro.models import heads as jax_heads
from repro_torch import bridge, tree
from repro_torch.core import blocks as pt_blocks
from repro_torch.data import rl_proxy as pt_rl
from repro_torch.data import synthetic as pt_syn
from repro_torch.models import heads as pt_heads

TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
D = 32
# the block settings of benchmarks/table4_chomsky.py (Table 4; the Table
# 6 ablation adds the MLP x2) and benchmarks/table3_rl_proxy.py
CLS = dict(expansion=2.0, use_conv=True, use_mlp=False)
LISTOPS = dict(expansion=2.0, use_conv=True, use_mlp=True, mlp_factor=2.0)
DT = dict(expansion=2.0, use_conv=False, use_mlp=True, mlp_factor=2.0)


def _bcs(cell, kw):
    return (jax_blocks.MinRNNBlockConfig(d_model=D, cell=cell, **kw),
            pt_blocks.MinRNNBlockConfig(d_model=D, cell=cell, **kw))


@functools.lru_cache(maxsize=None)
def _classifier(cell, which):
    jbc, pbc = _bcs(cell, CLS if which == "cls" else LISTOPS)
    jp = jax_heads.classifier_init(jax.random.PRNGKey(0), vocab=16,
                                   n_classes=10, d_model=D, n_layers=2,
                                   block_cfg=jbc)
    return jbc, pbc, jp, bridge.params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _dt(cell):
    jbc, pbc = _bcs(cell, DT)
    jp = jax_heads.dt_init(jax.random.PRNGKey(1), state_dim=pt_rl.STATE_DIM,
                           act_dim=pt_rl.ACT_DIM, d_model=D, n_layers=2,
                           block_cfg=jbc)
    return jbc, pbc, jp, bridge.params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _grads_close(jg, pg):
    flat = jax.tree_util.tree_leaves_with_path(jg)
    got = dict(tree.leaves_with_path(pg))
    assert len(flat) == len(got)
    for path, w in flat:
        key = tuple(k.key for k in path)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=str(key))


def _grad_leaves(pp):
    return tree.tree_map(lambda a: a.clone().requires_grad_(True), pp)


# ---------------------------------------------------------------------------
# Heads against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell,which,with_lengths", [
    ("mingru", "cls", False), ("mingru", "cls", True),
    ("minlstm", "cls", False), ("minlstm", "cls", True),
    ("mingru", "listops", True), ("minlstm", "listops", False)])
def test_classifier_matches_jax(cell, which, with_lengths):
    jbc, pbc, jp, pp = _classifier(cell, which)
    task = pt_syn.majority if which == "cls" else pt_syn.listops
    kw = dict(max_len=12) if which == "cls" else dict(max_len=24,
                                                      max_depth=2)
    b = task(0, 0, 3, **kw)
    batch = {"tokens": b["tokens"], "label": b["label"]}
    if with_lengths:
        batch["lengths"] = np.array([12, 5, 1] if which == "cls"
                                    else [24, 9, 2], np.int32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}

    def jl(p):
        return jax_heads.classifier_loss(p, jbc, jbatch)

    ((jloss, jm), jg), jlogits = jax.jit(lambda p: (
        jax.value_and_grad(jl, has_aux=True)(p),
        jax_heads.classifier_apply(p, jbc, jbatch["tokens"],
                                   lengths=jbatch.get("lengths"))))(jp)
    pg_tree = _grad_leaves(pp)
    ploss, pm = pt_heads.classifier_loss(pg_tree, pbc, pbatch)
    grads = torch.autograd.grad(ploss, tree.leaves(pg_tree))
    plogits = pt_heads.classifier_apply(pp, pbc, pbatch["tokens"],
                                        lengths=pbatch.get("lengths"))
    _close(plogits, jlogits)
    _close(ploss, jloss)
    assert float(pm["acc"]) == float(jm["acc"])
    _grads_close(jg, tree.unflatten(pg_tree, grads))


@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
def test_dt_matches_jax(cell):
    jbc, pbc, jp, pp = _dt(cell)
    data = pt_rl.build_dataset("medium", n_episodes=4, seed=0)
    batch = {k: v[:, :8] for k, v in pt_rl.rl_batch(data, 0, 0, 3).items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ((jloss, _), jg), jpred = jax.jit(lambda p: (
        jax.value_and_grad(lambda q: jax_heads.dt_loss(q, jbc, jbatch),
                           has_aux=True)(p),
        jax_heads.dt_apply(p, jbc, jbatch["states"], jbatch["actions"],
                           jbatch["rtg"])))(jp)
    pg_tree = _grad_leaves(pp)
    ploss, _ = pt_heads.dt_loss(pg_tree, pbc, pbatch)
    grads = torch.autograd.grad(ploss, tree.leaves(pg_tree))
    ppred = pt_heads.dt_apply(pp, pbc, pbatch["states"], pbatch["actions"],
                              pbatch["rtg"])
    assert tuple(ppred.shape) == (3, 8, pt_rl.ACT_DIM)
    _close(ppred, jpred)
    _close(ploss, jloss)
    _grads_close(jg, tree.unflatten(pg_tree, grads))


def test_own_init_shares_the_reference_tree():
    for jp, pp, own in (
            (_classifier("mingru", "cls")[2], _classifier("mingru", "cls")[3],
             pt_heads.classifier_init(
                 torch.Generator().manual_seed(0), vocab=16, n_classes=10,
                 d_model=D, n_layers=2, block_cfg=_bcs("mingru", CLS)[1],
                 device="cpu")),
            (_dt("minlstm")[2], _dt("minlstm")[3],
             pt_heads.dt_init(torch.Generator().manual_seed(0),
                              state_dim=pt_rl.STATE_DIM,
                              act_dim=pt_rl.ACT_DIM, d_model=D, n_layers=2,
                              block_cfg=_bcs("minlstm", DT)[1],
                              device="cpu"))):
        want = {p: tuple(a.shape) for p, a in tree.leaves_with_path(pp)}
        assert {p: tuple(a.shape)
                for p, a in tree.leaves_with_path(own)} == want
        assert len(jax.tree.leaves(jp)) == len(want)


def test_block_init_state_device():
    """``blocks.init_state`` builds the state where the caller asks, and
    on the card by default: without one that default raises."""
    bc = pt_blocks.MinRNNBlockConfig(d_model=8, expansion=2.0, use_conv=True)
    st = pt_blocks.init_state(bc, (3,), device="cpu")
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {"h": (3, 16), "conv": (3, 3, 8)}
    assert all(v.device.type == "cpu" for v in st.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pt_blocks.init_state(bc, (3,))


# ---------------------------------------------------------------------------
# Data: the same arrays, bit for bit
# ---------------------------------------------------------------------------

def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("task", sorted(jax_syn.CHOMSKY_TASKS)
                         + ["bucket_sort", "listops"])
def test_synthetic_tasks_equal_jax(task):
    assert sorted(pt_syn.CHOMSKY_TASKS) == sorted(jax_syn.CHOMSKY_TASKS)
    for seed, step in ((0, 0), (3, 7), (555, 2)):
        _same(getattr(jax_syn, task)(seed, step, 6),
              getattr(pt_syn, task)(seed, step, 6))


def test_rl_proxy_equals_jax():
    assert (pt_rl.H, pt_rl.STATE_DIM, pt_rl.ACT_DIM) == \
        (jax_rl.H, jax_rl.STATE_DIM, jax_rl.ACT_DIM)
    for name in jax_rl.DATASETS:
        data_j = jax_rl.build_dataset(name, n_episodes=5, seed=1)
        data_p = pt_rl.build_dataset(name, n_episodes=5, seed=1)
        _same(data_j, data_p)
        _same(jax_rl.rl_batch(data_j, 0, 3, 4), pt_rl.rl_batch(data_p, 0, 3, 4))
    assert pt_rl.expert_score(episodes=2) == jax_rl.expert_score(episodes=2)
    assert pt_rl.random_score(episodes=2) == jax_rl.random_score(episodes=2)
    assert pt_rl.normalized(-3.0, -9.0, -1.0) == \
        jax_rl.normalized(-3.0, -9.0, -1.0)

    def act_fn(states, actions, rtg, t):       # a fixed linear policy
        s = states[0, t]
        return np.clip(np.array([s[0] - s[2], -s[1]], np.float32)
                       + 0.01 * rtg[0, t, 0], -1, 1)

    assert pt_rl.evaluate_policy(act_fn, episodes=2, target_rtg=-5.0) == \
        jax_rl.evaluate_policy(act_fn, episodes=2, target_rtg=-5.0)
