"""Port parity for the SSD mixer (``models/ssd.py``).

The same numpy-seeded inputs go through ``repro.models.ssd`` and
``repro_torch.models.ssd``: the chunked dual form in both forms (T off
the chunk, with and without the final state), the sequential oracle, one
decode step and the whole mamba2 block (right-padded ``lengths``, the
decode state), values and gradients.  Values at atol = rtol = 1e-5 (the
same fp32 arithmetic, sums in another order); gradients at rtol 1e-4,
atol 1e-5.  Then the port's own counterparts of
``tests/test_ssd_forms.py``, at that file's tolerances: both forms
against the sequential oracle (3e-4; 1e-3 under strong decay), compact
against masked (2e-4), their gradients (2e-3 / 2e-4), and no NaN
gradient at extreme decay.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.models import lm as jax_lm
from repro.models import ssd as jax_ssd
from repro_torch import bridge, tree
from repro_torch.configs import archs as pt_archs
from repro_torch.models import ssd as pt_ssd

TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _inputs(seed, t=37, nh=8, hd=8, g=2, ds=8, dt_scale=1.0):
    """x, dt, a_log, b, c, d_skip as numpy fp32 (the order ssd_chunked
    takes them)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t, nh, hd)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((2, t, nh))))
          * dt_scale).astype(np.float32)
    b = rng.standard_normal((2, t, g, ds)).astype(np.float32)
    c = rng.standard_normal((2, t, g, ds)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, nh)).astype(np.float32)
    return x, dt, a_log, b, c, np.ones(nh, np.float32)


def _t(args, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in args]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Against the JAX module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["masked", "compact"])
@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("return_state", [False, True])
def test_chunked_matches_jax(form, chunk, return_state):
    args = _inputs(0)                       # T 37: off every chunk
    want = jax.jit(functools.partial(
        jax_ssd.ssd_chunked, chunk=chunk, return_state=return_state,
        form=form))(*map(jnp.asarray, args))
    got = pt_ssd.ssd_chunked(*_t(args), chunk=chunk,
                             return_state=return_state, form=form)
    if return_state:
        _close(got[0], want[0])
        _close(got[1], want[1])
    else:
        _close(got, want)


@pytest.mark.parametrize("form", ["masked", "compact"])
def test_chunked_grads_match_jax(form):
    args = _inputs(1, t=21)
    d_skip = args[-1]

    def jloss(x, dt, a_log, b, c):
        y = jax_ssd.ssd_chunked(x, dt, a_log, b, c, jnp.asarray(d_skip),
                                chunk=8, form=form)
        return jnp.mean(y ** 2)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, args[:-1]))
    leaves = _t(args[:-1], grad=True)
    y = pt_ssd.ssd_chunked(*leaves, torch.tensor(d_skip), chunk=8, form=form)
    got = torch.autograd.grad(torch.mean(y ** 2), leaves)
    for name, w, g in zip(("x", "dt", "a_log", "b", "c"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_sequential_and_step_match_jax():
    x, dt, a_log, b, c, dsk = _inputs(2, t=9)
    h0 = np.random.default_rng(3).standard_normal((2, 8, 8, 8)).astype(
        np.float32)
    want = jax_ssd.ssd_sequential(*map(jnp.asarray, (x, dt, a_log, b, c,
                                                     dsk)),
                                  h0=jnp.asarray(h0))
    got = pt_ssd.ssd_sequential(*_t((x, dt, a_log, b, c, dsk)),
                                h0=torch.tensor(h0))
    _close(got, want)
    wy, ws = jax_ssd.ssd_step(*map(jnp.asarray, (x[:, 0], dt[:, 0], a_log,
                                                 b[:, 0], c[:, 0], dsk, h0)))
    gy, gs = pt_ssd.ssd_step(*_t((x[:, 0], dt[:, 0], a_log, b[:, 0],
                                  c[:, 0], dsk, h0)))
    _close(gy, wy)
    _close(gs, ws)


@functools.lru_cache(maxsize=None)
def _block(form="masked"):
    """Layer 0's mixer of the smoke mamba2-370m, JAX and bridged."""
    jcfg = jax_archs.smoke("mamba2-370m")
    pcfg = pt_archs.smoke("mamba2-370m")
    s_j = jcfg.ssm.__class__(**{**jcfg.ssm.__dict__, "dual_form": form})
    s_p = pcfg.ssm.__class__(**{**pcfg.ssm.__dict__, "dual_form": form})
    jcfg, pcfg = jcfg.replace(ssm=s_j), pcfg.replace(ssm=s_p)
    params = jax.jit(jax_lm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["blocks"]["mixer"])
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, pcfg, jp, pp


@pytest.mark.parametrize("form", ["masked", "compact"])
@pytest.mark.parametrize("padded", [False, True])
def test_block_apply_matches_jax(form, padded):
    jcfg, pcfg, jp, pp = _block(form)
    u = np.random.default_rng(4).standard_normal((3, 13, 64)).astype(
        np.float32)
    lengths = np.array([13, 5, 1], np.int32) if padded else None
    jkw = {} if lengths is None else {"lengths": jnp.asarray(lengths)}
    pkw = {} if lengths is None else {"lengths": torch.from_numpy(lengths)}
    wy, wst = jax.jit(lambda p, u_, kw: jax_ssd.ssd_block_apply(
        p, jcfg, u_, return_state=True, **kw))(jp, jnp.asarray(u), jkw)
    gy, gst = pt_ssd.ssd_block_apply(pp, pcfg, torch.from_numpy(u),
                                     return_state=True, **pkw)
    _close(gy, wy)
    for k in ("conv", "ssm"):
        _close(gst[k], wst[k])
    assert float(jnp.abs(wst["ssm"]).max()) > 0


def test_block_grads_match_jax():
    jcfg, pcfg, jp, pp = _block()
    u = np.random.default_rng(5).standard_normal((2, 11, 64)).astype(
        np.float32)

    def jloss(p, u_):
        return jnp.mean(jax_ssd.ssd_block_apply(p, jcfg, u_) ** 2)

    wg, wgu = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(u))
    flat = jax.tree_util.tree_leaves_with_path(wg)
    ut = torch.tensor(u, requires_grad=True)
    pg = tree.tree_map(lambda a: a.clone().requires_grad_(True), pp)
    leaves = []
    for path, _ in flat:
        leaf = pg
        for k in path:
            leaf = leaf[k.key]
        leaves.append(leaf)
    y = pt_ssd.ssd_block_apply(pg, pcfg, ut)
    got = torch.autograd.grad(torch.mean(y ** 2), leaves + [ut])
    for (path, w), g in zip(flat, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=str(path))
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(wgu),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_block_step_matches_jax():
    jcfg, pcfg, jp, pp = _block()
    rng = np.random.default_rng(6)
    u = rng.standard_normal((3, 64)).astype(np.float32)
    st = {"conv": rng.standard_normal((3, 3, 160)).astype(np.float32),
          "ssm": rng.standard_normal((3, 8, 16, 16)).astype(np.float32)}
    wy, wst = jax.jit(lambda p, u_, s_: jax_ssd.ssd_block_step(
        p, jcfg, u_, s_))(jp, jnp.asarray(u),
                                     {k: jnp.asarray(v) for k, v in
                                      st.items()})
    gy, gst = pt_ssd.ssd_block_step(pp, pcfg, torch.from_numpy(u),
                                    {k: torch.from_numpy(v) for k, v in
                                     st.items()})
    _close(gy, wy)
    for k in ("conv", "ssm"):
        _close(gst[k], wst[k])
    zero = pt_ssd.ssd_block_init_state(pcfg, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in zero.items()} == \
        {k: v.shape for k, v in st.items()}


# ---------------------------------------------------------------------------
# The port's own counterparts of tests/test_ssd_forms.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["masked", "compact"])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_forms_match_sequential(form, chunk):
    x, dt, a_log, b, c, dsk = _t(_inputs(0, t=40))
    seq = pt_ssd.ssd_sequential(x, dt, a_log, b, c, dsk)
    y = pt_ssd.ssd_chunked(x, dt, a_log, b, c, dsk, chunk=chunk, form=form)
    torch.testing.assert_close(y, seq, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("form", ["masked", "compact"])
def test_forms_strong_decay(form):
    x, dt, a_log, b, c, dsk = _t(_inputs(1, t=40, dt_scale=20.0))
    seq = pt_ssd.ssd_sequential(x, dt, a_log, b, c, dsk)
    y = pt_ssd.ssd_chunked(x, dt, a_log, b, c, dsk, chunk=8, form=form)
    torch.testing.assert_close(y, seq, rtol=1e-3, atol=1e-3)


def test_forms_grads_match():
    args = _inputs(2, t=40)
    grads = []
    for form in ("masked", "compact"):
        leaves = _t(args[:-1], grad=True)
        y = pt_ssd.ssd_chunked(*leaves, torch.tensor(args[-1]), chunk=8,
                               form=form)
        grads.append(torch.autograd.grad(torch.mean(y ** 2), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("seed,chunk", [(0, 4), (1, 8), (2, 16), (3, 8),
                                        (4, 4)])
def test_compact_equals_masked(seed, chunk):
    args = _t(_inputs(seed, t=24, nh=4, hd=4, g=1, ds=4))
    y_m = pt_ssd.ssd_chunked(*args, chunk=chunk, form="masked")
    y_c = pt_ssd.ssd_chunked(*args, chunk=chunk, form="compact")
    torch.testing.assert_close(y_m, y_c, rtol=2e-4, atol=2e-4)


def test_masked_form_no_nan_gradient_at_extreme_decay():
    args = _inputs(3, t=40, dt_scale=50.0)
    leaves = _t(args[:-1], grad=True)
    y = pt_ssd.ssd_chunked(*leaves, torch.tensor(args[-1]), chunk=8,
                           form="masked")
    for g in torch.autograd.grad(torch.mean(y ** 2), leaves):
        assert bool(torch.isfinite(g).all()), "NaN/inf gradient"


def test_unknown_form_raises():
    with pytest.raises(ValueError, match="dual form"):
        pt_ssd.ssd_chunked(*_t(_inputs(0, t=8)), chunk=8, form="factored")
