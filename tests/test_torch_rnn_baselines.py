"""Port parity for the sequential baselines, ``core/gru.py`` and
``core/lstm.py`` (the paper's Fig. 1 GRU / LSTM, trained by BPTT).

The JAX params are bridged into the port and the same numpy-seeded
inputs go through both: one step, the whole sequential forward (from
zeros and from a given state) and the gradients of a mean-square loss
through it (``jax.grad`` of the reference's ``lax.scan`` against
autograd through the port's loop).  Values at atol = rtol = 1e-5 (the
same fp32 arithmetic, sums in another order); gradients at rtol 1e-4 /
atol 1e-5.  Parameter counts must be equal.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gru as jax_gru
from repro.core import lstm as jax_lstm
from repro_torch import bridge, tree
from repro_torch.core import gru as pt_gru
from repro_torch.core import lstm as pt_lstm

TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
MODELS = {"gru": (jax_gru, pt_gru), "lstm": (jax_lstm, pt_lstm)}
DX, DH = 8, 12


@functools.lru_cache(maxsize=None)
def _pair(name):
    jm, _ = MODELS[name]
    jp = jm.init(jax.random.PRNGKey(0), DX, DH)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("bias", [False, True])
def test_n_params_match_and_count_the_tree(name, bias):
    jm, pm = MODELS[name]
    for dx, dh in ((DX, DH), (64, 64), (768, 1536)):
        assert pm.n_params(dx, dh, bias) == jm.n_params(dx, dh, bias)
    own = pm.init(torch.Generator().manual_seed(0), DX, DH, use_bias=bias)
    assert sum(a.numel() for a in tree.leaves(own)) == \
        pm.n_params(DX, DH, bias)
    _, pp = _pair(name)
    assert {p: tuple(a.shape) for p, a in tree.leaves_with_path(pp)} == \
        {p: tuple(a.shape) for p, a in tree.leaves_with_path(
            pm.init(torch.Generator().manual_seed(0), DX, DH))}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_matches_jax(name):
    jm, pm = MODELS[name]
    jp, pp = _pair(name)
    x = _x(1, (3, DX))
    h = _x(2, (3, DH))
    if name == "gru":
        want = jm.step(jp, jnp.asarray(x), jnp.asarray(h))
        _close(pm.step(pp, torch.from_numpy(x), torch.from_numpy(h)), want)
    else:
        c = _x(3, (3, DH))
        wh, wc = jm.step(jp, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
        gh, gc = pm.step(pp, torch.from_numpy(x),
                         (torch.from_numpy(h), torch.from_numpy(c)))
        _close(gh, wh)
        _close(gc, wc)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("with_state", [False, True])
def test_forward_and_bptt_grads_match_jax(name, with_state):
    jm, pm = MODELS[name]
    jp, pp = _pair(name)
    x = _x(4, (3, 17, DX))
    h0 = _x(5, (3, DH))
    c0 = _x(6, (3, DH))
    if not with_state:
        jstate = pstate = None
    elif name == "gru":
        jstate, pstate = jnp.asarray(h0), torch.from_numpy(h0)
    else:
        jstate = (jnp.asarray(h0), jnp.asarray(c0))
        pstate = (torch.from_numpy(h0), torch.from_numpy(c0))

    def jloss(p, x_):
        return jnp.mean(jm.forward(p, x_, jstate) ** 2)

    want = jax.jit(lambda p, x_: jm.forward(p, x_, jstate))(
        jp, jnp.asarray(x))
    wg, wgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    pg = tree.tree_map(lambda a: a.clone().requires_grad_(True), pp)
    xt = torch.tensor(x, requires_grad=True)
    h = pm.forward(pg, xt, pstate)
    _close(h, want)
    grads = torch.autograd.grad(torch.mean(h ** 2),
                                tree.leaves(pg) + [xt])
    got = dict(zip([p for p, _ in tree.leaves_with_path(pg)], grads))
    for path, w in jax.tree_util.tree_leaves_with_path(wg):
        key = tuple(k.key for k in path)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=str(key))
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(wgx),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
