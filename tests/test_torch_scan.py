"""Port parity for the scans: ``repro_torch.core.scan`` against
``repro.core.scan``, and the scan kernels' wrappers (``linear_scan`` /
``log_space_scan``, forward and VJP) against the JAX Pallas ops run in
interpret mode.  The port runs the kernels' plain versions (CPU tensors).
The kernels' segmented order (``ref.linear_scan_segmented`` /
``ref.log_scan_segmented``) is held against the sequential plain versions
and the JAX ops too, and ``ops.plan`` against the launch it describes.

Inputs come from numpy seeds.  Tolerance: fp32 at atol = rtol = 1e-5 --
the same recurrence, summed in another order (a sequential walk against
the Kogge-Stone ladder, the doubling ladder against XLA's associative
scan).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan as jax_scan
from repro.kernels.scan import ops as jax_scan_ops
from repro_torch.core import scan as pt_scan
from repro_torch.kernels.scan import ops as pt_scan_ops
from repro_torch.kernels.scan import ref as pt_scan_ref

TOL = 1e-5


def _close(jx, pt, tol=TOL):
    np.testing.assert_allclose(np.asarray(jx, np.float32),
                               pt.detach().float().numpy(), rtol=tol,
                               atol=tol)


def _linear_case(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 0.99, size=shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    h0 = rng.standard_normal(shape[:-2] + shape[-1:]).astype(np.float32)
    return a, b, h0


def _log_case(seed, shape):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(shape).astype(np.float32) * 2
    v = rng.standard_normal(shape).astype(np.float32)
    log_a = -np.logaddexp(0, k)                     # log sigma(-k)
    log_b = -np.logaddexp(0, -k) + np.log(np.abs(v) + 0.5)
    log_h0 = np.log(rng.uniform(0.1, 2.0, size=shape[:-2] + shape[-1:]))
    return (log_a.astype(np.float32), log_b.astype(np.float32),
            log_h0.astype(np.float32))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("strategy", ["sequential", "associative",
                                      "chunked"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_strategies_match_reference(strategy, with_h0):
    a, b, h0 = _linear_case(0, (2, 3, 29, 6))       # extra lead dim
    h0 = h0 if with_h0 else None
    kw = {"chunk": 8} if strategy == "chunked" else {}
    want = jax_scan.scan_linear(a, b, h0, strategy=strategy, **kw)
    got = pt_scan.scan_linear(*_t(a, b), None if h0 is None
                              else torch.from_numpy(h0), strategy=strategy,
                              **kw)
    _close(want, got)


@pytest.mark.parametrize("with_h0", [False, True])
def test_log_space_scan_matches_reference(with_h0):
    la, lb, lh0 = _log_case(1, (2, 31, 5))
    lh0 = lh0 if with_h0 else None
    want = jax_scan.scan_log_space(la, lb, lh0)
    got = pt_scan.scan_log_space(*_t(la, lb), None if lh0 is None
                                 else torch.from_numpy(lh0))
    _close(want, got)


def test_time_axis_other_than_minus_two():
    a, b, h0 = _linear_case(2, (3, 17, 4))
    a_t, b_t = np.moveaxis(a, 1, 0), np.moveaxis(b, 1, 0)   # (T, B, D)
    want = jax_scan.scan_linear(a_t, b_t, h0, axis=0, strategy="chunked",
                                chunk=4)
    got = pt_scan.scan_linear(*_t(a_t, b_t, h0), axis=0, strategy="chunked",
                              chunk=4)
    _close(want, got)


def test_logcumsumexp_matches_reference():
    x = np.random.default_rng(3).standard_normal((2, 19, 3)).astype(
        np.float32)
    x[0, :5] = -np.inf
    _close(jax_scan.logcumsumexp(x),
           pt_scan.logcumsumexp(torch.from_numpy(x)))


def _vjp_pair(jfn, pfn, inputs, seed):
    """Forward and VJP of both with the same cotangent."""
    out_j, pull = jax.vjp(jfn, *inputs)
    ct = np.random.default_rng(seed).standard_normal(
        out_j.shape).astype(np.float32)
    grads_j = pull(jnp.asarray(ct))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out_p = pfn(*ts)
    grads_p = torch.autograd.grad(out_p, ts, torch.from_numpy(ct))
    return out_j, out_p, grads_j, grads_p


@pytest.mark.parametrize("shape", [(2, 24, 7), (1, 33, 130)])
def test_linear_scan_forward_and_vjp_match_jax(shape):
    a, b, h0 = _linear_case(4, shape)
    out_j, out_p, gj, gp = _vjp_pair(
        lambda a_, b_, h_: jax_scan_ops.linear_scan(a_, b_, h_),
        pt_scan_ops.linear_scan, (a, b, h0), 5)
    _close(out_j, out_p)
    for j, p in zip(gj, gp):
        _close(j, p)


@pytest.mark.parametrize("shape", [(2, 24, 7), (1, 33, 130)])
def test_log_space_scan_forward_and_vjp_match_jax(shape):
    la, lb, lh0 = _log_case(6, shape)
    out_j, out_p, gj, gp = _vjp_pair(
        lambda a_, b_, h_: jax_scan_ops.log_space_scan(a_, b_, h_),
        pt_scan_ops.log_space_scan, (la, lb, lh0), 7)
    assert out_p.dtype == torch.float32
    _close(out_j, out_p)
    for j, p in zip(gj, gp):
        _close(j, p)


def test_pallas_strategy_routes_to_the_scan_ops():
    a, b, h0 = _linear_case(8, (2, 3, 12, 5))
    want = jax_scan.scan_linear(a, b, h0, strategy="pallas")
    got = pt_scan.scan_linear(*_t(a, b, h0), strategy="pallas")
    _close(want, got)
    la, lb, lh0 = _log_case(9, (2, 12, 5))
    _close(jax_scan.scan_log_space(la, lb, lh0, strategy="pallas"),
           pt_scan.scan_log_space(*_t(la, lb, lh0), strategy="pallas"))


def test_log_scan_zero_h0_is_neg_inf():
    """-inf log_h0 (h0 = 0) flows through logaddexp without a NaN, and its
    gradient is finite (as tests/test_kernels.py:207 for the kernel)."""
    la, lb, _ = _log_case(10, (2, 20, 6))
    want = jax_scan_ops.log_space_scan_auto(la, lb)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (la, lb)]
    got = pt_scan_ops.log_space_scan_auto(*ts)
    assert bool(torch.isfinite(got).all())
    _close(want, got)
    got.sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in ts)
    # all-(-inf) values: h stays exactly 0
    zero = pt_scan_ops.log_space_scan_auto(
        torch.from_numpy(la), torch.full_like(torch.from_numpy(lb),
                                              float("-inf")))
    assert torch.equal(zero, torch.zeros_like(zero))


def test_log_scan_saturated_gates_stable():
    """|preact| ~ 40 (as tests/test_kernels.py:217): products of a_t
    underflow any linear carry; the log-space carry stays finite and
    equals the JAX kernel's."""
    k = np.full((1, 64, 8), 40.0, np.float32)
    log_a = (-np.logaddexp(0, k)).astype(np.float32)
    log_b = (-np.logaddexp(0, -k) + 0.3).astype(np.float32)
    got = pt_scan_ops.log_space_scan_auto(*_t(log_a, log_b))
    assert bool(torch.isfinite(got).all())
    _close(jax_scan_ops.log_space_scan_auto(log_a, log_b), got)


def test_reverse_scan_grads_matches_jax():
    a, dh, h0 = _linear_case(11, (2, 15, 9))
    h = np.random.default_rng(12).standard_normal(a.shape).astype(
        np.float32)
    want = jax_scan_ops.reverse_scan_grads(a, dh, h, h0, 256, 128, True)
    got = pt_scan_ops.reverse_scan_grads(*_t(a, dh, h, h0))
    for j, p in zip(want, got):
        _close(j, p)


# (B, T, D): several T-tiles with a ragged last one and a ragged column
# tile; one short ragged tile; exactly one tile
SEGMENTED_SHAPES = [(2, 600, 70), (3, 37, 5), (1, 256, 33)]


@pytest.mark.parametrize("shape", SEGMENTED_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_linear_segmented_matches_sequential_and_jax(shape, reverse):
    """The kernel's order (segments of SEG steps, WARPS a tile, tiles over
    T, reversed by index) gives the sequential scan and the JAX kernel's
    result within fp32 rounding, in both directions."""
    a, b, h0 = _linear_case(13, shape)
    got = pt_scan_ref.linear_scan_segmented(*_t(a, b, h0), reverse=reverse)
    _close(pt_scan_ref.linear_scan_ref(*_t(a, b, h0), reverse=reverse)
           .numpy(), got)
    flip = (lambda x: np.flip(x, -2)) if reverse else (lambda x: x)
    want = flip(np.asarray(jax_scan_ops.linear_scan(flip(a), flip(b), h0)))
    _close(want, got)


@pytest.mark.parametrize("shape", SEGMENTED_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_log_segmented_matches_sequential_and_jax(shape, with_h0):
    la, lb, lh0 = _log_case(14, shape)
    if not with_h0:
        lh0 = np.full_like(lh0, -np.inf)
    got = pt_scan_ref.log_scan_segmented(*_t(la, lb, lh0))
    assert got.dtype == torch.float32
    _close(pt_scan_ref.log_scan_ref(*_t(la, lb, lh0)).numpy(), got)
    _close(jax_scan_ops.log_space_scan(la, lb, lh0), got)


def test_segmented_neg_inf_prefix_gives_exact_zeros():
    """log_b = -inf over a prefix that crosses segments and a tile, from
    h0 = 0: h is exactly 0 there (no NaN from -inf - -inf), then finite."""
    la, lb, _ = _log_case(15, (2, 300, 9))
    lb[:, :270] = -np.inf
    lh0 = np.full((2, 9), -np.inf, np.float32)
    got = pt_scan_ref.log_scan_segmented(*_t(la, lb, lh0))
    assert torch.equal(got[:, :270], torch.zeros_like(got[:, :270]))
    assert bool(torch.isfinite(got).all()) and bool((got[:, 270:] > 0).all())
    _close(jax_scan_ops.log_space_scan(la, lb, lh0), got)


def test_segmented_saturated_gates_stay_finite():
    """|preact| 40 over several tiles: the log-space prefixes and carry
    stay finite where products of a_t underflow."""
    k = np.full((1, 600, 8), 40.0, np.float32)
    log_a = (-np.logaddexp(0, k)).astype(np.float32)
    log_b = (-np.logaddexp(0, -k) + 0.3).astype(np.float32)
    lh0 = np.zeros((1, 8), np.float32)
    got = pt_scan_ref.log_scan_segmented(*_t(log_a, log_b, lh0))
    assert bool(torch.isfinite(got).all())
    _close(jax_scan_ops.log_space_scan(log_a, log_b, lh0), got)
    a = np.exp(log_a)
    b = np.exp(log_b)
    lin = pt_scan_ref.linear_scan_segmented(*_t(a, b, np.ones((1, 8),
                                                              np.float32)))
    assert bool(torch.isfinite(lin).all())


def test_segmented_order_is_the_kernels_and_independent_of_batch():
    """A row's result does not depend on the other rows (bit for bit), and
    the identity padding of a ragged tile is exact."""
    a, b, h0 = _linear_case(16, (4, 300, 6))
    full = pt_scan_ref.linear_scan_segmented(*_t(a, b, h0))
    row = pt_scan_ref.linear_scan_segmented(*_t(a[2:3], b[2:3], h0[2:3]))
    assert torch.equal(full[2:3], row)
    cut = pt_scan_ref.linear_scan_segmented(*_t(a[:, :257], b[:, :257], h0))
    assert torch.equal(cut, full[:, :257])
    la, lb, lh0 = _log_case(17, (4, 300, 6))
    full = pt_scan_ref.log_scan_segmented(*_t(la, lb, lh0))
    assert torch.equal(full[1:2], pt_scan_ref.log_scan_segmented(
        *_t(la[1:2], lb[1:2], lh0[1:2])))


def test_segmented_bf16_rounds_once_at_the_output():
    """bf16 inputs: fp32 prefixes and carry, the output rounded to bf16
    once, as the sequential plain version rounds it."""
    a, b, h0 = _linear_case(18, (2, 300, 40))
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    got = pt_scan_ref.linear_scan_segmented(ta, tb, torch.from_numpy(h0),
                                            reverse=True)
    assert got.dtype == torch.bfloat16
    want = pt_scan_ref.linear_scan_ref(ta, tb, torch.from_numpy(h0),
                                       reverse=True)
    torch.testing.assert_close(got.float(), want.float(), atol=6e-2,
                               rtol=2e-2)


def test_scan_plan_at_the_training_shape():
    """B 8, T 256, D 1536 (mingru-lm's training scans): one T-tile of 8
    segments of 32 steps, 32 columns a block, 48 x 8 = 384 blocks of 256
    threads; a ragged (B, T, D) rounds its tiles up."""
    assert pt_scan_ops.plan(8, 256, 1536) == {
        "seg": 32, "warps": 8, "threads": 256, "cols": 32, "tiles": 1,
        "grid": (48, 8), "blocks": 384}
    p = pt_scan_ops.plan(3, 1100, 70)
    assert (p["tiles"], p["grid"], p["blocks"]) == (5, (3, 3), 9)
    assert (pt_scan_ops.SEG, pt_scan_ops.WARPS) == (pt_scan_ref.SEG,
                                                    pt_scan_ref.WARPS)
