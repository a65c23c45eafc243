"""Port parity for the fused minGRU / minLSTM layers: the port's
``autograd.Function``s (on CPU tensors they run the kernels' plain
versions, and their own custom backward) against the JAX ops
(``repro.kernels.fused_*.ops``, Pallas in interpret mode), forward and
VJP with one cotangent, in log and linear mode, ``normalize`` on and
off, ragged T and Dh, with and without h0.

Tolerance: fp32 at atol = rtol = 1e-5 -- the same fp32 arithmetic, with
matmuls and the scan summed in another order.  The float64 gradchecks
run the custom backward against finite differences and against
autograd through a sequential rollout (the reference's fp64 oracle is
red, ROADMAP.md queue 3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_mingru import ops as jax_gru
from repro.kernels.fused_minlstm import ops as jax_lstm
from repro_torch.kernels.fused_mingru import ops as pt_gru
from repro_torch.kernels.fused_mingru import ref as pt_gru_ref
from repro_torch.kernels.fused_minlstm import ops as pt_lstm
from repro_torch.kernels.fused_minlstm import ref as pt_lstm_ref

TOL = 1e-5
N_GATES = {"mingru": 2, "minlstm": 3}


def _case(seed, cell, bsz, t, dx, dh, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, t, dx))
    ws = [rng.standard_normal((dx, dh)) / np.sqrt(dx)
          for _ in range(N_GATES[cell])]
    bs = [0.1 * rng.standard_normal((dh,)) for _ in range(N_GATES[cell])]
    h0 = 0.5 * rng.standard_normal((bsz, dh))
    return [a.astype(dtype) for a in (x, *ws, *bs, h0)]


def _order(cell, x, *rest):
    """(x, w0, w1[, w2], b0, b1[, b2], h0) -> the ops' argument order
    (x, w0, b0, w1, b1, ...)."""
    g = N_GATES[cell]
    ws, bs = rest[:g], rest[g:2 * g]
    wb = [v for pair in zip(ws, bs) for v in pair]
    return x, wb


def _jax_fn(cell, mode, normalize, with_h0):
    def fn(x, *wb_h0):
        wb, h0 = (wb_h0[:-1], wb_h0[-1]) if with_h0 else (wb_h0, None)
        if cell == "mingru":
            return jax_gru.fused_mingru(x, *wb, h0, mode=mode)
        return jax_lstm.fused_minlstm(x, *wb, h0, mode=mode,
                                      normalize=normalize)
    return fn


def _pt_fn(cell, mode, normalize, with_h0):
    def fn(x, *wb_h0):
        wb, h0 = (wb_h0[:-1], wb_h0[-1]) if with_h0 else (wb_h0, None)
        if cell == "mingru":
            return pt_gru.fused_mingru(x, *wb, h0, mode=mode)
        return pt_lstm.fused_minlstm(x, *wb, h0, mode=mode,
                                     normalize=normalize)
    return fn


CASES = [  # (cell, mode, normalize, with_h0, (B, T, Dx, Dh))
    ("mingru", "log", True, False, (2, 16, 8, 12)),
    ("mingru", "log", True, True, (2, 13, 8, 20)),        # ragged T, Dh
    ("mingru", "linear", True, True, (1, 21, 6, 130)),    # Dh > one tile
    ("minlstm", "log", True, False, (2, 16, 8, 12)),
    ("minlstm", "log", True, True, (2, 13, 8, 20)),
    ("minlstm", "linear", False, True, (1, 21, 6, 10)),   # unnormalised
    ("minlstm", "log", False, False, (2, 9, 5, 7)),
]


@pytest.mark.parametrize("cell,mode,normalize,with_h0,shape", CASES)
def test_fused_forward_and_vjp_match_jax(cell, mode, normalize, with_h0,
                                         shape):
    arrs = _case(0, cell, *shape)
    x, wb = _order(cell, *arrs)
    inputs = [x, *wb] + ([arrs[-1]] if with_h0 else [])
    out_j, pull = jax.vjp(_jax_fn(cell, mode, normalize, with_h0), *inputs)
    ct = np.random.default_rng(1).standard_normal(out_j.shape).astype(
        np.float32)
    grads_j = pull(jnp.asarray(ct))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    out_p = _pt_fn(cell, mode, normalize, with_h0)(*ts)
    grads_p = torch.autograd.grad(out_p, ts, torch.from_numpy(ct))
    np.testing.assert_allclose(np.asarray(out_j), out_p.detach().numpy(),
                               rtol=TOL, atol=TOL)
    for j, p in zip(grads_j, grads_p):
        np.testing.assert_allclose(np.asarray(j), p.numpy(), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
@pytest.mark.parametrize("mode", ["log", "linear"])
def test_fused_gradcheck_float64_vs_sequential_rollout(cell, mode):
    """The custom backward (recomputed gates + reversed scan + autograd
    through the gates) against finite differences of the forward, and
    against autograd through the plain sequential rollout, in float64."""
    arrs = _case(2, cell, 2, 7, 4, 5, dtype=np.float64)
    x, wb = _order(cell, *arrs)
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in [x, *wb, arrs[-1]]]
    fn = _pt_fn(cell, mode, True, True)
    assert torch.autograd.gradcheck(fn, ts, eps=1e-6, atol=1e-8, rtol=1e-6)
    if cell == "mingru":
        roll = pt_gru_ref.fused_mingru_ref(*ts, mode=mode)
    else:
        roll = pt_lstm_ref.fused_minlstm_ref(*ts, mode=mode)
    ct = torch.from_numpy(np.random.default_rng(3).standard_normal(
        roll.shape))
    want = torch.autograd.grad(roll, ts, ct)
    got = torch.autograd.grad(fn(*ts), ts, ct)
    for w, g in zip(want, got):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


def test_scan_functions_gradcheck_float64():
    from repro_torch.kernels.scan import ops as scan_ops
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.uniform(0.1, 0.9, (2, 6, 3))).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((2, 6, 3))).requires_grad_()
    h0 = torch.from_numpy(rng.standard_normal((2, 3))).requires_grad_()
    assert torch.autograd.gradcheck(scan_ops.linear_scan, (a, b, h0))
    la = torch.log(a.detach()).requires_grad_()
    lb = torch.from_numpy(rng.standard_normal((2, 6, 3))).requires_grad_()
    lh0 = torch.from_numpy(rng.standard_normal((2, 3))).requires_grad_()
    assert torch.autograd.gradcheck(scan_ops.log_space_scan, (la, lb, lh0))


def test_missing_biases_are_zeros():
    x, wz, wh, _, _, h0 = [torch.from_numpy(a) for a in
                           _case(5, "mingru", 2, 6, 4, 5)]
    zero = torch.zeros(5)
    torch.testing.assert_close(
        pt_gru.fused_mingru(x, wz, None, wh, None, h0),
        pt_gru.fused_mingru(x, wz, zero, wh, zero, h0), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# what the wrappers keep beside the launch: waves and per-body counts
# ---------------------------------------------------------------------------

def test_waves_counts_rounds_of_resident_blocks():
    from repro_torch.kernels import fused_cell
    # the training widths: 128 tensor-core blocks fill 128 of 132 SMs in
    # one wave; the CUDA-core body's 192 blocks at one per SM need two
    assert fused_cell.waves(128, 1, 132) == 1
    assert fused_cell.waves(192, 1, 132) == 2
    assert fused_cell.waves(264, 2, 132) == 1
    with pytest.raises(ValueError):
        fused_cell.waves(128, 0, 132)


@pytest.mark.parametrize("mod,name", [(pt_gru, "fused_mingru_kernel"),
                                      (pt_lstm, "fused_minlstm_kernel")])
def test_launch_counts_name_each_body(mod, name):
    assert set(mod.LAUNCHES) == {name, f"{name}/tc", f"{name}/cuda_core"}
    mod.LAUNCHES[f"{name}/tc"] = 3
    mod.reset_launches()
    assert set(mod.LAUNCHES.values()) == {0}


def _raw_operands(cell, x):
    """Weights, biases and h0 matching x (B, T, Dx), in the order the raw
    launchers take them after x."""
    bsz, _, dx = x.shape
    w, b = torch.zeros((dx, 6), dtype=x.dtype), torch.zeros((6,),
                                                            dtype=x.dtype)
    return [w, b] * N_GATES[cell] + [torch.zeros((bsz, 6))]


@pytest.mark.parametrize("entry", ["launch", "occupancy"])
@pytest.mark.parametrize("fault,match", [
    ("mode", "unknown mode"), ("rank", "must be \\(B, T, Dx\\)"),
    ("dtype", "float32 or bfloat16"), ("device", "CUDA")])
@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
def test_fused_entry_points_check_operands_before_building(cell, fault,
                                                           match, entry):
    """The launch and the occupancy query share one operand check, made
    before the library is built or a pointer reaches C; here on the CPU
    every case raises, and nothing is counted."""
    mod = pt_gru if cell == "mingru" else pt_lstm
    dtype = torch.float16 if fault == "dtype" else torch.float32
    x = torch.zeros((2, 5, 4), dtype=dtype)
    args = [x[0] if fault == "rank" else x, *_raw_operands(cell, x)]
    kw = {"mode": "exp"} if fault == "mode" else {}
    mod.reset_launches()
    with pytest.raises(ValueError, match=match):
        getattr(mod, entry)(*args, **kw)
    assert set(mod.LAUNCHES.values()) == {0}
    assert mod._LIB is None
