"""Port parity: the whole-block decode kernel's plain PyTorch version
(what the port's wrappers run on CPU tensors) against the JAX kernels in
interpret mode, and the port's own chunk == C steps contract.

Inputs and params are drawn from a seed with numpy and handed to both
packages.  Tolerances:
  * fp32 -- atol = rtol = 1e-5: the same arithmetic, summed in another
    order by the two CPU matmul backends;
  * bf16 -- atol = rtol = 3e-2 (a few bf16 ulps, eps 2^-8): both round at
    the same cast points, but a sum taken in another order can land on
    the neighbouring bf16 value, and that one-ulp step can carry through
    the next cast (h -> down product -> residual).

The CUDA kernel itself runs only on the card: ``test_torch_gpu.py`` (marked
``gpu``, skipped without one) and ``chip_smoke.py`` hold it against the
same plain version.
"""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.block_step import ops as jax_ops
from repro_torch.kernels.block_step import ops as pt_ops

DX, EXP, MLP_F, K = 32, 2, 4, 4
# feature dims off the kernel's 16-column tile: the streamed body with a
# ragged last column tile, element by element
RAGGED = (40, 72, 100)
CELLS = ("mingru", "minlstm")
COMBOS = ((True, True), (True, False), (False, True))
GATES = {"mingru": ("wz", "wh"), "minlstm": ("wf", "wi", "wh")}
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _np_block_params(rng, cell, use_conv, use_mlp,
                     dims=(DX, DX * EXP, DX * MLP_F)):
    dx, dh, dm = dims
    p = {"norm_rnn": {"scale": 1.0 + 0.1 * rng.standard_normal(dx)},
         "rnn": {g: {"kernel": rng.standard_normal((dx, dh)) / np.sqrt(dx),
                     "bias": 0.1 * rng.standard_normal(dh)}
                 for g in GATES[cell]},
         "down": {"kernel": rng.standard_normal((dh, dx)) / np.sqrt(dh)}}
    if use_conv:
        p["conv"] = {"kernel": rng.standard_normal((K, dx)) / 2.0,
                     "bias": 0.1 * rng.standard_normal(dx)}
    if use_mlp:
        p["norm_mlp"] = {"scale": 1.0 + 0.1 * rng.standard_normal(dx)}
        p["mlp_in"] = {"kernel": rng.standard_normal((dx, dm)) / np.sqrt(dx),
                       "bias": 0.1 * rng.standard_normal(dm)}
        p["mlp_out"] = {"kernel": rng.standard_normal((dm, dx)) / np.sqrt(dm),
                        "bias": 0.1 * rng.standard_normal(dx)}
    return p


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _both(tree, dtype):
    """numpy tree -> (jax tree, torch tree) holding identical values."""
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    j = _map(lambda a: jnp.asarray(np.asarray(a, np.float32).astype(npdt)),
             tree)
    t = _map(lambda a: torch.tensor(np.asarray(a, np.float32)).to(tdt), tree)
    return j, t


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _close(a, b, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _inputs(rng, bsz, chunk, cell, use_conv, use_mlp,
            dims=(DX, DX * EXP, DX * MLP_F)):
    dx, dh, _ = dims
    params = _np_block_params(rng, cell, use_conv, use_mlp, dims)
    shape = (bsz, chunk, dx) if chunk else (bsz, dx)
    x = rng.standard_normal(shape)
    state = {"h": 0.5 * rng.standard_normal((bsz, dh))}
    if use_conv:
        state["conv"] = rng.standard_normal((bsz, K - 1, dx))
    return params, x, state


CASES = [(c, uc, um, "float32") for c in CELLS for uc, um in COMBOS] \
    + [(c, True, True, "bfloat16") for c in CELLS]


@pytest.mark.parametrize("cell,use_conv,use_mlp,dtype", CASES)
def test_step_ref_matches_jax_kernel(cell, use_conv, use_mlp, dtype):
    rng = np.random.default_rng(0)
    params, x, state = _inputs(rng, 3, 0, cell, use_conv, use_mlp)
    (pj, pt), (xj, xt), (sj, st) = (_both(params, dtype), _both(x, dtype),
                                    _both(state, dtype))
    cd = None if dtype == "float32" else "bfloat16"
    yj, nj = jax_ops.fused_block_step(
        pj, xj, sj, cell=cell, mode="log", use_conv=use_conv,
        use_mlp=use_mlp, compute_dtype=None if cd is None else jnp.bfloat16)
    yt, nt = pt_ops.fused_block_step(
        pt, xt, st, cell=cell, mode="log", use_conv=use_conv,
        use_mlp=use_mlp, compute_dtype=None if cd is None else torch.bfloat16)
    _close(yt, yj, dtype)
    _close(nt["h"], nj["h"], dtype)
    if use_conv:
        _close(nt["conv"], nj["conv"], dtype)


@pytest.mark.parametrize("cell,use_conv,use_mlp,dtype", CASES)
def test_chunk_ref_matches_jax_kernel(cell, use_conv, use_mlp, dtype):
    """Mixed valid lengths: per-position ys, hs and windows, with frozen
    rows re-emitting their final state."""
    rng = np.random.default_rng(1)
    params, x, state = _inputs(rng, 3, 5, cell, use_conv, use_mlp)
    valid = np.asarray([3, 5, 1], np.int32)
    (pj, pt), (xj, xt), (sj, st) = (_both(params, dtype), _both(x, dtype),
                                    _both(state, dtype))
    jcd = None if dtype == "float32" else jnp.bfloat16
    tcd = None if dtype == "float32" else torch.bfloat16
    yj, nj, posj = jax_ops.fused_block_chunk(
        pj, xj, sj, jnp.asarray(valid), cell=cell, mode="log",
        use_conv=use_conv, use_mlp=use_mlp, compute_dtype=jcd,
        return_positions=True)
    yt, nt, post = pt_ops.fused_block_chunk(
        pt, xt, st, torch.from_numpy(valid), cell=cell, mode="log",
        use_conv=use_conv, use_mlp=use_mlp, compute_dtype=tcd,
        return_positions=True)
    _close(yt, yj, dtype)
    _close(nt["h"], nj["h"], dtype)
    _close(post["h"], posj["h"], dtype)
    if use_conv:
        _close(post["conv"], posj["conv"], dtype)
        _close(nt["conv"], nj["conv"], dtype)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_chunk_equals_sequential_steps_exactly(cell, dtype):
    rng = np.random.default_rng(2)
    params, x, state = _inputs(rng, 4, 6, cell, True, True)
    to = lambda a: torch.tensor(np.asarray(a, np.float32)).to(dtype)  # noqa
    pt, xt, st = _map(to, params), to(x), _map(to, state)
    kw = dict(cell=cell, mode="log", use_conv=True, use_mlp=True,
              compute_dtype=dtype)
    ys, final, pos = pt_ops.fused_block_chunk(
        pt, xt, st, torch.full((4,), 6, dtype=torch.int32),
        return_positions=True, **kw)
    s = st
    for t in range(6):
        y, s = pt_ops.fused_block_step(pt, xt[:, t], s, **kw)
        assert torch.equal(y, ys[:, t])
        assert torch.equal(s["h"], pos["h"][:, t])
        assert torch.equal(s["conv"], pos["conv"][:, t])
    assert torch.equal(s["h"], final["h"])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_widths_step_and_chunk_ref_match_jax_kernel(cell, dtype):
    """Dx 40, Dh 72, Dm 100 (no dim on the 16-column tile; Dm not even on
    8): the block step and the varlen chunk, the port's plain version
    against the JAX kernel in interpret mode, at this file's tolerances.
    The RMSNorms divide by the true widths, and no ragged column leaks
    into h, the window or y."""
    rng = np.random.default_rng(3)
    params, x, state = _inputs(rng, 3, 4, cell, True, True, RAGGED)
    valid = np.asarray([4, 1, 3], np.int32)
    (pj, pt), (xj, xt), (sj, st) = (_both(params, dtype), _both(x, dtype),
                                    _both(state, dtype))
    jcd = None if dtype == "float32" else jnp.bfloat16
    tcd = None if dtype == "float32" else torch.bfloat16
    kw = dict(cell=cell, mode="log", use_conv=True, use_mlp=True)
    yj, nj = jax_ops.fused_block_step(pj, xj[:, 0], sj, compute_dtype=jcd,
                                      **kw)
    yt, nt = pt_ops.fused_block_step(pt, xt[:, 0], st, compute_dtype=tcd,
                                     **kw)
    for got, want in ((yt, yj), (nt["h"], nj["h"]),
                      (nt["conv"], nj["conv"])):
        _close(got, want, dtype)
    yj, nj, posj = jax_ops.fused_block_chunk(
        pj, xj, sj, jnp.asarray(valid), compute_dtype=jcd,
        return_positions=True, **kw)
    yt, nt, post = pt_ops.fused_block_chunk(
        pt, xt, st, torch.from_numpy(valid), compute_dtype=tcd,
        return_positions=True, **kw)
    for got, want in ((yt, yj), (nt["h"], nj["h"]), (post["h"], posj["h"]),
                      (post["conv"], posj["conv"]),
                      (nt["conv"], nj["conv"])):
        _close(got, want, dtype)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_widths_port_chunk_equals_sequential_steps_exactly(cell,
                                                                  dtype):
    rng = np.random.default_rng(4)
    params, x, state = _inputs(rng, 3, 5, cell, True, True, RAGGED)
    to = lambda a: torch.tensor(np.asarray(a, np.float32)).to(dtype)  # noqa
    pt, xt, st = _map(to, params), to(x), _map(to, state)
    kw = dict(cell=cell, mode="log", use_conv=True, use_mlp=True,
              compute_dtype=dtype)
    ys, final, pos = pt_ops.fused_block_chunk(
        pt, xt, st, torch.full((3,), 5, dtype=torch.int32),
        return_positions=True, **kw)
    s = st
    for t in range(5):
        y, s = pt_ops.fused_block_step(pt, xt[:, t], s, **kw)
        assert torch.equal(y, ys[:, t])
        assert torch.equal(s["h"], pos["h"][:, t])
        assert torch.equal(s["conv"], pos["conv"][:, t])
    assert torch.equal(s["h"], final["h"])

