"""Tests of the port that need an NVIDIA GPU (marker ``gpu``).

They skip without one.  On the card, from the repository root:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs on a machine that has only PyTorch.
The kernels are built from source by their first call.  Tolerances are
those of ``chip_smoke.py``: fp32 1e-4 (the same arithmetic summed in
another order), bf16 atol 6e-2 / rtol 2e-2 (same cast points, a sum
landing on the neighbouring bf16 value).  Gradients are compared by
their largest error over the largest reference value (fp32 1e-4, bf16
2e-2: the backward reads the kernel's rounded h where the plain
version's autograd keeps it unrounded).
"""

from __future__ import annotations

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import archs
from repro_torch.core import blocks
from repro_torch.kernels.block_step import ops, ref
from repro_torch.kernels.decode_step import ops as step_ops
from repro_torch.kernels.decode_step import ref as step_ref
from repro_torch.kernels.fused_mingru import ops as gru_ops
from repro_torch.kernels.fused_mingru import ref as gru_ref
from repro_torch.kernels.fused_minlstm import ops as lstm_ops
from repro_torch.kernels.fused_minlstm import ref as lstm_ref
from repro_torch.kernels.scan import ops as scan_ops
from repro_torch.kernels.scan import ref as scan_ref
from repro_torch.models import lm
from repro_torch.serving import draft as draft_lib
from repro_torch.serving.engine import ServingEngine, generate_one
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_step as ts_lib

pytestmark = pytest.mark.gpu

DX, DH, DM, K = 64, 128, 256, 4
GATES = {"mingru": ("wz", "wh"), "minlstm": ("wf", "wi", "wh")}
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (6e-2, 2e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _params(gen, cell, dtype, dev, dx=DX, dh=DH, dm=DM):
    def w(shape):
        return (torch.randn(shape, generator=gen) / shape[0] ** 0.5).to(dtype)

    def v(n):
        return (0.1 * torch.randn(n, generator=gen)).to(dtype)

    p = {"norm_rnn": {"scale": (1.0 + v(dx)).to(dtype)},
         "rnn": {g: {"kernel": w((dx, dh)), "bias": v(dh)}
                 for g in GATES[cell]},
         "down": {"kernel": w((dh, dx))},
         "conv": {"kernel": w((K, dx)), "bias": v(dx)},
         "norm_mlp": {"scale": (1.0 + v(dx)).to(dtype)},
         "mlp_in": {"kernel": w((dx, dm)), "bias": v(dm)},
         "mlp_out": {"kernel": w((dm, dx)), "bias": v(dx)}}
    return lm.tree_to(p, dev)


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_and_chunk_equals_steps(cell, dtype,
                                                    cuda_device):
    gen = torch.Generator().manual_seed(0)
    params = _params(gen, cell, dtype, cuda_device)
    kp = ops.kernel_params(params, cell, dtype, True, True)
    kw = dict(cell=cell, mode="log", use_conv=True, use_mlp=True,
              compute_dtype=dtype)
    bsz, chunk = 5, 4
    x = torch.randn((bsz, chunk, DX), generator=gen).to(dtype).to(cuda_device)
    st = {"h": (0.5 * torch.randn((bsz, DH), generator=gen)).to(dtype)
          .to(cuda_device),
          "conv": torch.randn((bsz, K - 1, DX), generator=gen).to(dtype)
          .to(cuda_device)}
    valid = torch.tensor([4, 1, 3, 4, 2], dtype=torch.int32,
                         device=cuda_device)
    ys, fin, pos = ops.fused_block_chunk(params, x, st, valid,
                                         return_positions=True, **kw)
    ys_r, fin_r, pos_r = ref.block_chunk_ref(kp, x, st, valid, **kw)
    _close(ys, ys_r, dtype)
    _close(pos["h"], pos_r["h"], dtype)
    _close(pos["conv"], pos_r["conv"], dtype)
    s = st
    for t in range(chunk):
        y, s = ops.fused_block_step(params, x[:, t].contiguous(), s, **kw)
        for b in range(bsz):
            if t < int(valid[b]):
                assert torch.equal(y[b], ys[b, t])
                assert torch.equal(s["h"][b], pos["h"][b, t])
                assert torch.equal(s["conv"][b], pos["conv"][b, t])


# (Dx, Dh, Dm): mingru-lm's width, where the split body splits every
# phase's K (S 4, 8, 2, 8) in bf16 and fp32 takes the streamed body; a
# ragged one whose last K slices are short in every phase (split); a
# wide one whose weight slices fit no block's shared memory (streamed);
# one whose Dm (8192) stages phase D's input in two K slices (streamed);
# and two off the 16-column tile (streamed, element by element)
BLOCK_SHAPES = {"mingru-lm": (768, 1536, 3072), "ragged": (208, 80, 336),
                "wide": (1536, 3072, 6144), "wide-mlp": (1024, 2048, 8192),
                "off-tile": (200, 72, 520), "off-tile-small": (40, 72, 100)}
BLOCK_BODY = {("mingru-lm", torch.float32): "streamed",
              ("mingru-lm", torch.bfloat16): "split",
              ("ragged", torch.float32): "split",
              ("ragged", torch.bfloat16): "split",
              **{(shape, dt): "streamed"
                 for shape in ("wide", "wide-mlp", "off-tile",
                               "off-tile-small")
                 for dt in (torch.float32, torch.bfloat16)}}


def _block_case(gen, cell, dtype, dev, shape, bsz, chunk):
    dx, dh, dm = BLOCK_SHAPES[shape]
    params = _params(gen, cell, dtype, dev, dx, dh, dm)
    x = torch.randn((bsz, chunk, dx), generator=gen).to(dtype).to(dev)
    st = {"h": (0.5 * torch.randn((bsz, dh), generator=gen)).to(dtype)
          .to(dev),
          "conv": torch.randn((bsz, K - 1, dx), generator=gen).to(dtype)
          .to(dev)}
    return params, x, st


def _bound(params, cell, dtype):
    return ops.BlockOperands(params, cell=cell, compute_dtype=dtype,
                             use_conv=True, use_mlp=True)


def _raw(operands, x, st, valid):
    """One raw launch; raises on a CUDA error; returns (ys, hs, wins)."""
    launch, outs = ops.prepare_launch(operands, x, st, valid, mode="log")
    rc = launch()
    if rc != 0:
        raise RuntimeError(f"block kernel launch returned {rc}")
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("shape", list(BLOCK_SHAPES))
@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_kernels_match_plain_and_chunk_equals_steps_per_body(
        shape, cell, dtype, cuda_device):
    """Both bodies, each where the plan picks it (``BLOCK_BODY``)."""
    gen = torch.Generator().manual_seed(1)
    bsz, chunk = 5, 4
    params, x, st = _block_case(gen, cell, dtype, cuda_device, shape, bsz,
                                chunk)
    kp = ops.kernel_params(params, cell, dtype, True, True)
    kw = dict(cell=cell, mode="log", use_conv=True, use_mlp=True,
              compute_dtype=dtype)
    bound = _bound(params, cell, dtype)
    assert bound.body == BLOCK_BODY[(shape, dtype)]
    valid = torch.tensor([4, 1, 3, 4, 2], dtype=torch.int32,
                         device=cuda_device)
    ys, _, pos = ops.fused_block_chunk(params, x, st, valid, operands=bound,
                                       return_positions=True, **kw)
    ys_r, _, pos_r = ref.block_chunk_ref(kp, x, st, valid, **kw)
    _close(ys, ys_r, dtype)
    _close(pos["h"], pos_r["h"], dtype)
    _close(pos["conv"], pos_r["conv"], dtype)
    s = st
    for t in range(chunk):
        y, s = ops.fused_block_step(params, x[:, t].contiguous(), s,
                                    operands=bound, **kw)
        for b in range(bsz):
            if t < int(valid[b]):
                assert torch.equal(y[b], ys[b, t])
                assert torch.equal(s["h"][b], pos["h"][b, t])
                assert torch.equal(s["conv"][b], pos["conv"][b, t])


@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_kernel_row_independent_of_batch(cell, dtype, cuda_device):
    """B 1..16 (B > 8 is two batch tiles): each row's bits are B's own."""
    gen = torch.Generator().manual_seed(2)
    params, x, st = _block_case(gen, cell, dtype, cuda_device, "mingru-lm",
                                16, 2)
    bound = _bound(params, cell, dtype)
    full = _raw(bound, x, st, None)
    for bsz in (1, 3, 8, 11):
        sub = _raw(bound, x[:bsz].contiguous(),
                   {k: v[:bsz].contiguous() for k, v in st.items()}, None)
        for got, want in zip(sub, full):
            assert torch.equal(got, want[:bsz]), bsz


@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_kernel_launches_bit_identical(cell, dtype, cuda_device):
    """Two launches give the same bits: which block arrives last
    changes, never the order of a sum."""
    gen = torch.Generator().manual_seed(3)
    params, x, st = _block_case(gen, cell, dtype, cuda_device, "mingru-lm",
                                8, 3)
    bound = _bound(params, cell, dtype)
    valid = torch.tensor([3, 1, 2, 3, 3, 2, 1, 3], dtype=torch.int32,
                         device=cuda_device)
    first = _raw(bound, x, st, valid)
    again = _raw(bound, x, st, valid)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mingru-lm", "minlstm-lm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_plan_balanced_and_co_resident(arch, dtype, cuda_device):
    """At the LMs' full width the plan's grid fits the card at once.
    bf16 runs the split body: every phase split over K, a block's slices
    resident in shared memory, and in every phase the most weight bytes
    one block holds within 1.25x of the phase's bytes over the SMs.  fp32,
    whose slices do not fit, runs the streamed body: one unit per 16
    columns over all of K."""
    cfg = archs.get(arch)
    cell = cfg.minrnn.cell
    dx, dm = cfg.d_model, cfg.d_ff
    dh = int(dx * cfg.minrnn.expansion)
    gen = torch.Generator().manual_seed(4)
    params = _params(gen, cell, dtype, cuda_device, dx, dh, dm)
    pl = ops.plan(_bound(params, cell, dtype))
    assert pl["grid"] <= pl["blocks_per_sm"] * pl["sms"]
    assert pl["smem"] <= 232448
    assert [p["name"] for p in pl["phases"]] == ["A", "B", "C", "D"]
    elem = torch.tensor([], dtype=dtype).element_size()
    if dtype == torch.float32:
        assert pl["body"] == "streamed"
        assert all(p["S"] == 1 for p in pl["phases"]), pl
        return
    assert pl["body"] == "split"
    for p in pl["phases"]:
        assert p["S"] > 1, p
        share = p["K"] * p["N"] * p["gates"] * elem / pl["sms"]
        assert p["max_block_bytes"] <= 1.25 * share, p
    assert pl["ring_bytes"] == sum(p["max_block_bytes"]
                                   for p in pl["phases"])


def test_block_kernel_after_refused_launch(cuda_device):
    """A launch the C launcher refuses (here a chunk of no positions; it
    never runs) leaves the bound counters as they were: the next launch
    gives the same bits."""
    gen = torch.Generator().manual_seed(5)
    cell, dtype = "minlstm", torch.bfloat16
    params, x, st = _block_case(gen, cell, dtype, cuda_device, "mingru-lm",
                                8, 2)
    bound = _bound(params, cell, dtype)
    assert bound.body == "split"
    before = _raw(bound, x, st, None)
    launch, _ = ops.prepare_launch(bound, x[:, :0], st, None, mode="log")
    assert launch() != 0
    after = _raw(bound, x, st, None)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert int(bound._cnt.abs().sum()) == 0


def test_block_binding_refuses_beyond_both_bodies(cuda_device):
    """Weights too large for the split body's shared memory and a width
    whose 8 staged rows (Dm 8192 in fp32) exceed a block's shared memory
    once refused to bind (the name records that refusal, the fault this
    test now holds repaired); now the streamed body stages phase D's input
    in two K slices of 4096 (Dm 7120 still in whole rows): in bf16 and
    fp32, the kernel against the plain version, a C-token chunk equal to
    C step launches bit for bit, and a row launched alone equal to its
    row of the batch."""
    gen = torch.Generator().manual_seed(6)
    cell, bsz, chunk = "mingru", 9, 3
    for dtype in (torch.float32, torch.bfloat16):
        params = _params(gen, cell, dtype, cuda_device, 1024, 2048, 8192)
        bound = _bound(params, cell, dtype)
        assert bound.body == "streamed"
        phases = ops.plan(bound)["phases"]
        assert [(p["S"], p["slice_rows"]) for p in phases] == [
            (1, 1024), (1, 2048), (1, 1024), (2, 4096)], phases
        kp = ops.kernel_params(params, cell, dtype, True, True)
        kw = dict(cell=cell, mode="log", use_conv=True, use_mlp=True,
                  compute_dtype=dtype)
        x = torch.randn((bsz, chunk, 1024), generator=gen).to(dtype) \
            .to(cuda_device)
        st = {"h": (0.5 * torch.randn((bsz, 2048), generator=gen))
              .to(dtype).to(cuda_device),
              "conv": torch.randn((bsz, K - 1, 1024), generator=gen)
              .to(dtype).to(cuda_device)}
        full = torch.full((bsz,), chunk, dtype=torch.int32,
                          device=cuda_device)
        ys, _, pos = ops.fused_block_chunk(params, x, st, full,
                                           operands=bound,
                                           return_positions=True, **kw)
        ys_r, _, pos_r = ref.block_chunk_ref(kp, x, st, full, **kw)
        _close(ys, ys_r, dtype)
        _close(pos["h"], pos_r["h"], dtype)
        _close(pos["conv"], pos_r["conv"], dtype)
        s = st
        for t in range(chunk):
            y, s = ops.fused_block_step(params, x[:, t].contiguous(), s,
                                        operands=bound, **kw)
            assert torch.equal(y, ys[:, t]) and torch.equal(
                s["h"], pos["h"][:, t]) and torch.equal(
                s["conv"], pos["conv"][:, t]), (dtype, t)
        alone = _raw(bound, x[4:5].contiguous(),
                     {k: v[4:5].contiguous() for k, v in st.items()},
                     full[4:5])
        for got, want in zip(alone, (ys, pos["h"], pos["conv"])):
            assert torch.equal(got, want[4:5])
    narrower = _params(gen, "mingru", torch.bfloat16, cuda_device, 1024,
                       2048, 7120)
    pl = ops.plan(_bound(narrower, "mingru", torch.bfloat16))
    assert pl["body"] == "streamed"
    assert all(p["S"] == 1 for p in pl["phases"]), pl


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_kernel_copies_operands_off_16_byte_boundaries(dtype,
                                                             cuda_device):
    """Weights and activations two elements past a 16-byte boundary (views
    into larger buffers) at dims the vector loads take: the binding holds
    aligned copies of the weights, the launch of the activations, and
    the outputs equal the aligned operands' bit for bit."""
    gen = torch.Generator().manual_seed(7)
    cell = "minlstm"
    params, x, st = _block_case(gen, cell, dtype, cuda_device, "mingru-lm",
                                3, 2)

    def shifted(t):
        buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=t.device)
        view = buf[2:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        return view

    aligned = _raw(_bound(params, cell, dtype), x, st, None)
    moved = _raw(_bound(tree.tree_map(shifted, params), cell, dtype),
                 shifted(x),
                 {k: shifted(v) for k, v in st.items()}, None)
    for a, b in zip(aligned, moved):
        assert torch.equal(a, b)


def test_smoke_engine_streams_on_gpu(cuda_device):
    cfg = archs.smoke("mingru-lm")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device=cuda_device)
    prompts = [[5, 6, 7], [1], [9, 9, 9, 9, 9]]
    ops.reset_launches()
    outs = {}
    for c in (1, 4):
        eng = ServingEngine(cfg, params, max_batch=2, max_len=32,
                            decode_block=3, prompt_chunk=c,
                            device=cuda_device)
        rids = [eng.submit(p, max_new=5) for p in prompts]
        res = eng.run_to_completion()
        outs[c] = [res[r] for r in rids]
        assert eng.stats.shard_identities_ok()
    assert outs[1] == outs[4]
    assert ops.LAUNCHES["block_step_kernel"] > 0
    assert ops.LAUNCHES["block_chunk_kernel"] > 0
    for p, o in zip(prompts, outs[1]):
        assert o == generate_one(cfg, params, p, max_new=5, max_len=32,
                                 device=cuda_device)


GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_scan_kernel_matches_plain(reverse, dtype, cuda_device):
    gen = torch.Generator().manual_seed(1)
    a = torch.rand((3, 37, 70), generator=gen).to(dtype).to(cuda_device)
    b = torch.randn((3, 37, 70), generator=gen).to(dtype).to(cuda_device)
    h0 = torch.randn((3, 70), generator=gen).to(cuda_device)
    scan_ops.reset_launches()
    got = scan_ops.linear_scan_kernel(a, b, h0, reverse=reverse)
    assert scan_ops.LAUNCHES["linear_scan_kernel"] == 1
    _close(got, scan_ref.linear_scan_ref(a, b, h0, reverse=reverse), dtype)


def test_log_scan_kernel_matches_plain_and_neg_inf(cuda_device):
    gen = torch.Generator().manual_seed(2)
    k = 3 * torch.randn((2, 45, 33), generator=gen)
    la = (-torch.nn.functional.softplus(k)).to(cuda_device)
    lb = (-torch.nn.functional.softplus(-k)
          + 0.1 * torch.randn(k.shape, generator=gen)).to(cuda_device)
    lh0 = torch.full((2, 33), float("-inf"), device=cuda_device)
    lb[0, :4] = float("-inf")                  # h stays exactly 0 there
    got = scan_ops.log_scan_kernel(la, lb, lh0)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[0, :4], torch.zeros_like(got[0, :4]))
    _close(got, scan_ref.log_scan_ref(la, lb, lh0), torch.float32)
    sat = torch.full((1, 64, 8), 40.0, device=cuda_device)
    out = scan_ops.log_scan_kernel(-torch.nn.functional.softplus(sat),
                                   -torch.nn.functional.softplus(-sat) + 0.3,
                                   torch.zeros((1, 8), device=cuda_device))
    assert bool(torch.isfinite(out).all())


# (B, T, D): the training shape (one T-tile), five T-tiles with a ragged
# last one, a ragged column tile
SCAN_SHAPES = [(8, 256, 1536), (2, 1100, 96), (3, 300, 70)]


def _scan_fns(kind, variant):
    """(kernel, plain version, segmented rendering); linear's variant is
    ``reverse``."""
    if kind == "linear":
        return (lambda *v: scan_ops.linear_scan_kernel(*v, reverse=variant),
                lambda *v: scan_ref.linear_scan_ref(*v, reverse=variant),
                lambda *v: scan_ref.linear_scan_segmented(*v,
                                                          reverse=variant))
    return (scan_ops.log_scan_kernel, scan_ref.log_scan_ref,
            scan_ref.log_scan_segmented)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("variant", [False, True])
@pytest.mark.parametrize("kind", ["linear", "log"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_match_plain_and_segmented(kind, dtype, variant, shape,
                                                cuda_device):
    """The segmented kernels against the sequential plain versions at the
    stated tolerances, and equal to their segmented renderings bit for
    bit: the same operations in the same order, each rounded once (the
    linear combine a rounded multiply and a rounded add; torch's exp and
    log1p on the card are CUDA's expf and log1pf)."""
    gen = torch.Generator().manual_seed(11)
    ins = scan_ref.inputs(gen, kind, dtype, shape, variant, cuda_device)
    fn, plain, seg = _scan_fns(kind, variant)
    scan_ops.reset_launches()
    got = fn(*ins)
    assert scan_ops.LAUNCHES[f"{kind}_scan_kernel"] == 1
    _close(got, plain(*ins), dtype if kind == "linear" else torch.float32)
    assert got.dtype == (dtype if kind == "linear" else torch.float32)
    assert torch.equal(got, seg(*ins))


@pytest.mark.parametrize("variant", [False, True])
@pytest.mark.parametrize("kind", ["linear", "log"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_launches_bit_identical_and_rows_independent_of_batch(
        kind, dtype, variant, cuda_device):
    """The order is fixed by T alone: two launches agree bit for bit, and
    each row of a B 8 launch equals that row launched at B 1."""
    gen = torch.Generator().manual_seed(12)
    ins = scan_ref.inputs(gen, kind, dtype, (8, 600, 200), variant,
                         cuda_device)
    fn, _, _ = _scan_fns(kind, variant)
    one = fn(*ins)
    assert torch.equal(one, fn(*ins))
    for r in range(8):
        alone = fn(*(v[r:r + 1].contiguous() for v in ins))
        assert torch.equal(one[r:r + 1], alone)


@pytest.mark.parametrize("kind", ["linear", "log"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_training_shape_runs_in_one_wave(kind, dtype, cuda_device):
    """B 8, T 256, D 1536: the C launcher's constants are ops.plan's, 384
    blocks of 256 threads, 3 resident a SM: one wave on 132 SMs."""
    occ = scan_ops.occupancy(kind, dtype, 8, 256, 1536)
    assert occ["blocks"] == 384 and occ["tiles"] == 1
    assert occ["blocks_per_sm"] >= 3
    assert occ["waves"] == 1


def test_log_scan_kernel_neg_inf_prefix_across_tiles(cuda_device):
    """log_b = -inf over 600 steps (three T-tiles) from h0 = 0: exact
    zeros there, then finite and positive."""
    gen = torch.Generator().manual_seed(13)
    la, lb, lh0 = scan_ref.inputs(gen, "log", torch.float32, (2, 700, 40),
                                 False, cuda_device)
    lb[:, :600] = float("-inf")
    got = scan_ops.log_scan_kernel(la, lb, lh0)
    assert torch.equal(got[:, :600], torch.zeros_like(got[:, :600]))
    assert bool(torch.isfinite(got).all()) and bool((got[:, 600:] > 0).all())
    _close(got, scan_ref.log_scan_ref(la, lb, lh0), torch.float32)


def _fused_case(gen, cell, dtype, dev, bsz=2, t=70, dx=40, dh=72):
    n = 2 if cell == "mingru" else 3
    x = torch.randn((bsz, t, dx), generator=gen)
    wb = []
    for _ in range(n):
        wb += [torch.randn((dx, dh), generator=gen) / dx ** 0.5,
               0.1 * torch.randn((dh,), generator=gen)]
    h0 = 0.5 * torch.randn((bsz, dh), generator=gen)
    return [v.to(dtype).to(dev).requires_grad_(True) for v in (x, *wb, h0)]


def _fused_fns(cell, mode):
    """(kernel layer, plain version, ops module) for a cell; "minlstm-raw"
    is minLSTM with normalize off."""
    if cell == "mingru":
        return (lambda *a: gru_ops.fused_mingru(*a, mode=mode),
                lambda *a: gru_ref.fused_mingru_ref(*a, mode=mode), gru_ops)
    norm = cell == "minlstm"
    return (lambda *a: lstm_ops.fused_minlstm(*a, mode=mode, normalize=norm),
            lambda *a: lstm_ref.fused_minlstm_ref(*a, mode=mode,
                                                  normalize=norm),
            lstm_ops)


# (B, T, Dx, Dh) against the tensor-core body's tiling (128-row time
# chunks, 64-deep k stages, 96-column tiles): ragged T (70 in one chunk,
# 250 over two), Dx off the k stage (40, 200), Dh off the tile (72 in one,
# 232 = two tiles and 40); B 1.  The last is not 16-byte aligned (Dx 36,
# Dh 70), so bf16 takes the CUDA-core body there too.
FUSED_SHAPES = [(2, 70, 40, 72), (1, 250, 200, 232), (2, 130, 36, 70)]


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("cell", ["mingru", "minlstm", "minlstm-raw"])
@pytest.mark.parametrize("mode", ["log", "linear"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_and_grads_match_plain(cell, mode, dtype, shape,
                                             cuda_device):
    """Forward and gradients against the plain version, on the body the
    operands route to (bf16 aligned: tensor cores; else CUDA cores)."""
    gen = torch.Generator().manual_seed(3)
    bsz, t, dx, dh = shape
    ins = _fused_case(gen, cell, dtype, cuda_device, bsz, t, dx, dh)
    fn, plain, mod = _fused_fns(cell, mode)
    name = next(iter(mod.LAUNCHES))
    body = "tc" if dtype == torch.bfloat16 and dx % 8 == 0 \
        and dh % 8 == 0 else "cuda_core"
    mod.reset_launches()
    out = fn(*ins)
    assert mod.LAUNCHES[f"{name}/{body}"] == mod.LAUNCHES[name] == 1
    want = plain(*ins)
    _close(out, want, dtype)
    ct = torch.randn(out.shape, generator=gen).to(dtype).to(cuda_device)
    got_g = torch.autograd.grad(out, ins, ct)
    want_g = torch.autograd.grad(want, ins, ct)
    for g, w in zip(got_g, want_g):
        assert g.dtype == w.dtype
        assert _rel_err(g, w) < GRAD_TOL[dtype]


@pytest.mark.parametrize("shape", [(2, 250, 200, 232), (2, 130, 36, 70)])
@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_launches_are_bit_identical(cell, dtype, shape,
                                                 cuda_device):
    """Sums run in a fixed order in both bodies: the remat replay of the
    forward reproduces it bit for bit."""
    gen = torch.Generator().manual_seed(5)
    ins = [v.detach() for v in _fused_case(gen, cell, dtype, cuda_device,
                                           *shape)]
    launch = gru_ops.launch if cell == "mingru" else lstm_ops.launch
    assert torch.equal(launch(*ins), launch(*ins))


@pytest.mark.parametrize("where", ["x", "w"])
@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
def test_fused_misaligned_bf16_takes_cuda_core_body(cell, where,
                                                    cuda_device):
    """bf16 at widths the tensor-core body takes, but x or a weight 2 bytes
    off a 16-byte line: the launcher routes it to the CUDA-core body, and
    the output matches the plain version."""
    gen = torch.Generator().manual_seed(7)
    ins = [v.detach() for v in _fused_case(gen, cell, torch.bfloat16,
                                           cuda_device, 2, 70, 40, 72)]
    i = 0 if where == "x" else 1
    off = torch.empty(ins[i].numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(ins[i].shape)
    off.copy_(ins[i])
    ins[i] = off
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    fn, plain, mod = _fused_fns(cell, "log")
    name = next(iter(mod.LAUNCHES))
    mod.reset_launches()
    out = fn(*ins)
    assert mod.LAUNCHES[f"{name}/cuda_core"] == mod.LAUNCHES[name] == 1
    assert mod.occupancy(*ins)["body"] == "cuda_core"
    _close(out, plain(*ins), torch.bfloat16)


@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
def test_fused_training_shape_runs_in_one_wave(cell, cuda_device):
    """bf16 at the training widths (B 8, Dx 768, Dh 1536): the
    tensor-core body, 128 blocks, all resident at once."""
    gen = torch.Generator().manual_seed(6)
    ins = [v.detach() for v in _fused_case(gen, cell, torch.bfloat16,
                                           cuda_device, 8, 16, 768, 1536)]
    mod = gru_ops if cell == "mingru" else lstm_ops
    occ = mod.occupancy(*ins)
    assert occ["body"] == "tc"
    assert occ["grid_blocks"] == 128
    assert occ["blocks_per_sm"] >= 1 and occ["waves"] == 1


@pytest.mark.parametrize("arch", ["mingru-lm", "minlstm-lm"])
def test_smoke_training_step_on_gpu(arch, cuda_device):
    cfg = archs.smoke(arch).replace(remat="full")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device=cuda_device)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1)
    step = ts_lib.make_train_step(cfg, ocfg)
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, 256, (2, 33), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for mod in (gru_ops, lstm_ops, scan_ops):
        mod.reset_launches()
    state = opt_lib.init(ocfg, params)
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert all(torch.isfinite(torch.tensor(losses)))
    assert losses[-1] < losses[0]
    fused = gru_ops.LAUNCHES["fused_mingru_kernel"] if arch == "mingru-lm" \
        else lstm_ops.LAUNCHES["fused_minlstm_kernel"]
    assert fused == 2 * cfg.n_layers * 3          # forward + remat replay
    assert scan_ops.LAUNCHES["linear_scan_kernel"] == cfg.n_layers * 3


# ---------------------------------------------------------------------------
# the cell-only decode kernels (kernels/decode_step)
# ---------------------------------------------------------------------------

def _cell_case(gen, cell, dtype, dev, bsz, dx, dh, chunk, scale=1.0):
    n = 2 if cell == "mingru" else 3
    wb = []
    for _ in range(n):
        wb += [scale * torch.randn((dx, dh), generator=gen) / dx ** 0.5,
               0.1 * torch.randn((dh,), generator=gen)]
    x = torch.randn((bsz, chunk, dx), generator=gen)
    h = 0.5 * torch.randn((bsz, dh), generator=gen)
    return [v.to(dtype).to(dev) for v in (x, h, *wb)]


def _cell_fns(cell, normalize):
    kw = {} if cell == "mingru" else {"normalize": normalize}
    return (getattr(step_ops, f"fused_{cell}_step"),
            getattr(step_ops, f"fused_{cell}_chunk"),
            getattr(step_ref, f"{cell}_step_ref"),
            getattr(step_ref, f"{cell}_chunk_ref"), kw)


_CELL_VALID = [4, 1, 3, 2, 4, 1, 4, 3, 2, 1, 4]


def _tc_body(cell, dtype, dx, dh):
    """The body the wrappers' operands route to (weights fresh from the
    allocator, so 16-byte aligned; every Dx here is at most 4096): the
    tensor cores for bf16 minGRU and minLSTM alike."""
    return "tc" if dtype == torch.bfloat16 and dx % 8 == 0 \
        and dh % 8 == 0 else "cuda_core"


@pytest.mark.parametrize("cell,normalize", [("mingru", True),
                                            ("minlstm", True),
                                            ("minlstm", False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(11, 64, 128), (3, 200, 72),
                                   (3, 37, 70), (2, 2048, 48),
                                   (1, 40, 72), (11, 768, 72)])
@pytest.mark.parametrize("chunk", [1, 4, 8, 16])
def test_decode_step_kernels_match_plain_and_chunk_equals_steps(
        cell, normalize, dtype, shape, chunk, cuda_device):
    """Smoke width with two batch tiles (B 11); a ragged case (Dx 200 off
    the 64 k-lanes and the tensor-core body's 8-warp K split, Dh 72 off
    the 16-column units); odd widths, whose rows allow no 16-byte loads
    (the CUDA-core body in bf16 too); gemma's Dx, where the fp32 weight
    tiles do not fit in shared memory and stream instead; B 1 with Dx 40
    (three k16 steps: five of the eight warps own none); mingru-lm's Dx,
    where the tensor-core body runs C 8 in one pass on one block per unit
    (every gate) and C 4 / C 16 on gate blocks (one gate each, a cluster
    per unit).  C 1 to 16: one position up to several passes of positions
    in the tensor-core body (minLSTM's gate blocks take one position a
    pass), for minLSTM with and without normalize."""
    bsz, dx, dh = shape
    gen = torch.Generator().manual_seed(5)
    x, h, *wb = _cell_case(gen, cell, dtype, cuda_device, bsz, dx, dh, chunk)
    step, chunk_fn, step_plain, chunk_plain, kw = _cell_fns(cell, normalize)
    # the lengths 4, 1, 3, 2, ... at C 4, and the same edges at every C:
    # full, frozen right after the first token, 2, and one short of full
    edge = {1: 1, 2: min(2, chunk), 3: max(1, chunk - 1), 4: chunk}
    valid = torch.tensor([edge[v] for v in _CELL_VALID[:bsz]],
                         dtype=torch.int32, device=cuda_device)
    step_ops.reset_launches()
    got = step(x[:, 0], *wb, h, **kw)
    _close(got, step_plain(x[:, 0], *wb, h, **kw), dtype)
    hs = chunk_fn(x, *wb, h, valid, **kw)
    _close(hs, chunk_plain(x, *wb, h, valid, **kw), dtype)
    # a chunk equals C step launches bit for bit; frozen rows re-emit
    s = h
    for t in range(chunk):
        s = torch.where((t < valid)[:, None],
                        step(x[:, t].contiguous(), *wb, s, **kw), s)
        assert torch.equal(hs[:, t], s)
    # a row's result does not depend on B
    assert torch.equal(step(x[:1, 0], *wb, h[:1], **kw), got[:1])
    # every launch took the body the operands route to, by its own count
    body = _tc_body(cell, dtype, dx, dh)
    for form, n in (("step", 2 + chunk), ("chunk", 1)):
        name = f"{cell}_{form}_kernel"
        assert step_ops.LAUNCHES[name] == n
        assert step_ops.LAUNCHES[f"{name}/{body}"] == n
    # h_prev in fp32 beside bf16 x: read as it is, as the reference does
    _close(step(x[:, 0], *wb, h.float(), **kw),
           step_plain(x[:, 0], *wb, h.float(), **kw), dtype)


def _offset(t):
    """A contiguous copy of ``t`` that starts 2 bytes past a 16-byte line."""
    off = torch.empty(t.numel() + 1, dtype=t.dtype,
                      device=t.device)[1:].view(t.shape)
    off.copy_(t)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    return off


def test_decode_step_misaligned_bf16_weight_takes_cuda_core_body(
        cuda_device):
    """bf16 minGRU at widths the tensor-core body takes, but a weight 2
    bytes off a 16-byte line: bound to the CUDA-core body, for the step
    and the chunk alike, and still equal to the plain version."""
    gen = torch.Generator().manual_seed(8)
    x, h, wz, bz, wh, bh = _cell_case(gen, "mingru", torch.bfloat16,
                                      cuda_device, 3, 64, 72, 4)
    operands = step_ops.CellOperands("mingru", [wz, _offset(wh)], [bz, bh])
    assert operands.body == "cuda_core"
    valid = torch.tensor([4, 2, 1], dtype=torch.int32, device=cuda_device)
    step_ops.reset_launches()
    got = step_ops.fused_mingru_step(x[:, 0], *operands.args, h,
                                     operands=operands)
    hs = step_ops.fused_mingru_chunk(x, *operands.args, h, valid,
                                     operands=operands)
    assert step_ops.LAUNCHES["mingru_step_kernel/cuda_core"] == 1
    assert step_ops.LAUNCHES["mingru_chunk_kernel/cuda_core"] == 1
    assert step_ops.LAUNCHES["mingru_step_kernel/tc"] == 0
    _close(got, step_ref.mingru_step_ref(x[:, 0], wz, bz, wh, bh, h),
           torch.bfloat16)
    _close(hs, step_ref.mingru_chunk_ref(x, wz, bz, wh, bh, h, valid),
           torch.bfloat16)
    assert step_ops.occupancy(operands, 3, 4)["body"] == "cuda_core"


@pytest.mark.parametrize("dx,chunk", [(200, 3), (768, 8)])
def test_decode_step_tc_body_ignores_x_alignment(dx, chunk, cuda_device):
    """The body never depends on x: an x 2 bytes off a 16-byte line runs
    the tensor-core body too (the wrapper hands the kernel an aligned
    copy) and gives the same bits as an aligned x, on pairs of blocks
    (C 3) and on one block per unit (mingru-lm's Dx, C 8)."""
    gen = torch.Generator().manual_seed(9)
    x, h, *wb = _cell_case(gen, "mingru", torch.bfloat16, cuda_device, 5,
                           dx, 72, chunk)
    valid = torch.tensor([chunk, 1, 2, chunk, 3], dtype=torch.int32,
                         device=cuda_device)
    step_ops.reset_launches()
    want = step_ops.fused_mingru_chunk(x, *wb, h, valid)
    got = step_ops.fused_mingru_chunk(_offset(x), *wb, h, valid)
    assert step_ops.LAUNCHES["mingru_chunk_kernel/tc"] == 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,chunk,cols,per_sm,cluster", [
    ((768, 1536), 1, 8, 2, 2), ((768, 1536), 8, 16, 1, 4),
    ((2048, 2048), 1, 8, 2, 2)])
def test_decode_step_tc_body_runs_in_one_wave(shape, chunk, cols, per_sm,
                                              cluster, cuda_device):
    """bf16 minGRU at mingru-lm's and gemma-2b-mingru's widths, B 8: the
    tensor-core body in one wave; steps on pairs of blocks (one block per
    gate and 16 Dh columns, two per SM, a cluster each), mingru-lm's C 8
    chunk on one block per 16 columns (both gates, one per SM) in
    clusters of four."""
    dx, dh = shape
    gen = torch.Generator().manual_seed(10)
    _, _, wz, bz, wh, bh = _cell_case(gen, "mingru", torch.bfloat16,
                                      cuda_device, 8, dx, dh, chunk)
    occ = step_ops.occupancy(step_ops.CellOperands("mingru", [wz, wh],
                                                   [bz, bh]), 8, chunk)
    assert occ["body"] == "tc"
    assert occ["grid_blocks"] == dh // cols and occ["cluster"] == cluster
    assert occ["blocks_per_sm"] >= per_sm and occ["waves"] == 1


def test_decode_step_long_chunk_beyond_one_wave_stays_on_pairs(cuda_device):
    """mingru-lm's widths at B 16, C 8: one block per unit would take two
    waves, so the chunk runs on pairs of blocks in two passes, and still
    equals its C step launches bit for bit."""
    gen = torch.Generator().manual_seed(11)
    x, h, wz, bz, wh, bh = _cell_case(gen, "mingru", torch.bfloat16,
                                      cuda_device, 16, 768, 1536, 8)
    operands = step_ops.CellOperands("mingru", [wz, wh], [bz, bh])
    assert step_ops.occupancy(operands, 16, 8)["cluster"] == 2
    valid = torch.tensor([8, 1, 7, 2] * 4, dtype=torch.int32,
                         device=cuda_device)
    hs = step_ops.fused_mingru_chunk(x, *operands.args, h, valid,
                                     operands=operands)
    _close(hs, step_ref.mingru_chunk_ref(x, wz, bz, wh, bh, h, valid),
           torch.bfloat16)
    s = h
    for t in range(8):
        s = torch.where((t < valid)[:, None], step_ops.fused_mingru_step(
            x[:, t].contiguous(), *operands.args, s, operands=operands), s)
        assert torch.equal(hs[:, t], s)


@pytest.mark.parametrize("chunk,blocks,per_sm,cluster", [
    (1, 288, 3, 3), (8, 96, 1, 4)])
def test_decode_step_minlstm_tc_body_runs_in_one_wave(
        chunk, blocks, per_sm, cluster, cuda_device):
    """bf16 minLSTM at minlstm-lm's widths, B 8: the tensor-core body in
    one wave; the step on three gate blocks per 16 Dh columns (f, i, h~,
    a cluster each, three blocks per SM), the C 8 chunk on one block per
    16 columns (every gate, one per SM) in clusters of four."""
    gen = torch.Generator().manual_seed(12)
    _, _, *wb = _cell_case(gen, "minlstm", torch.bfloat16, cuda_device, 8,
                           768, 1536, chunk)
    occ = step_ops.occupancy(step_ops.CellOperands("minlstm", wb[0::2],
                                                   wb[1::2]), 8, chunk)
    assert occ["body"] == "tc"
    assert occ["grid_blocks"] == blocks and occ["cluster"] == cluster
    assert occ["blocks_per_sm"] >= per_sm and occ["waves"] == 1


def test_decode_step_minlstm_long_chunk_beyond_one_wave_stays_on_gate_blocks(
        cuda_device):
    """minlstm-lm's widths at B 16, C 8: one block per unit would take two
    waves, so the chunk runs on three gate blocks per unit, one position a
    pass (eight passes, the hand-off's mbarriers alternating by parity),
    and still equals its C step launches bit for bit."""
    gen = torch.Generator().manual_seed(13)
    x, h, *wb = _cell_case(gen, "minlstm", torch.bfloat16, cuda_device, 16,
                           768, 1536, 8)
    operands = step_ops.CellOperands("minlstm", wb[0::2], wb[1::2])
    assert step_ops.occupancy(operands, 16, 8)["cluster"] == 3
    valid = torch.tensor([8, 1, 7, 2] * 4, dtype=torch.int32,
                         device=cuda_device)
    for normalize in (True, False):
        hs = step_ops.fused_minlstm_chunk(x, *wb, h, valid,
                                          normalize=normalize,
                                          operands=operands)
        _close(hs, step_ref.minlstm_chunk_ref(x, *wb, h, valid,
                                              normalize=normalize),
               torch.bfloat16)
        s = h
        for t in range(8):
            s = torch.where((t < valid)[:, None], step_ops.fused_minlstm_step(
                x[:, t].contiguous(), *wb, s, normalize=normalize,
                operands=operands), s)
            assert torch.equal(hs[:, t], s)


def test_decode_step_misaligned_minlstm_third_weight_takes_cuda_core_body(
        cuda_device):
    """bf16 minLSTM at widths the tensor-core body takes, W_f and W_i
    aligned but W_h 2 bytes off a 16-byte line: bound to the CUDA-core
    body (the rule checks all three weights), step and chunk alike, and
    still equal to the plain version."""
    gen = torch.Generator().manual_seed(14)
    x, h, wf, bf, wi, bi, wh, bh = _cell_case(
        gen, "minlstm", torch.bfloat16, cuda_device, 3, 64, 72, 4)
    operands = step_ops.CellOperands("minlstm", [wf, wi, _offset(wh)],
                                     [bf, bi, bh])
    assert operands.body == "cuda_core"
    assert step_ops.CellOperands("minlstm", [wf, wi, wh],
                                 [bf, bi, bh]).body == "tc"
    valid = torch.tensor([4, 2, 1], dtype=torch.int32, device=cuda_device)
    step_ops.reset_launches()
    got = step_ops.fused_minlstm_step(x[:, 0], *operands.args, h,
                                      operands=operands)
    hs = step_ops.fused_minlstm_chunk(x, *operands.args, h, valid,
                                      operands=operands)
    assert step_ops.LAUNCHES["minlstm_step_kernel/cuda_core"] == 1
    assert step_ops.LAUNCHES["minlstm_chunk_kernel/cuda_core"] == 1
    assert step_ops.LAUNCHES["minlstm_step_kernel/tc"] == 0
    args = (wf, bf, wi, bi, wh, bh)
    _close(got, step_ref.minlstm_step_ref(x[:, 0], *args, h), torch.bfloat16)
    _close(hs, step_ref.minlstm_chunk_ref(x, *args, h, valid),
           torch.bfloat16)
    assert step_ops.occupancy(operands, 3, 4)["body"] == "cuda_core"


def test_saturated_minlstm_kernel_stays_finite(cuda_device):
    gen = torch.Generator().manual_seed(6)
    x, h, *wb = _cell_case(gen, "minlstm", torch.float32, cuda_device, 4, 64,
                           64, 3, scale=200.0)
    valid = torch.tensor([3, 1, 2, 3], dtype=torch.int32, device=cuda_device)
    hs = step_ops.fused_minlstm_chunk(x, *wb, h, valid)
    assert bool(torch.isfinite(hs).all())
    _close(hs, step_ref.minlstm_chunk_ref(x, *wb, h, valid), torch.float32)


@pytest.mark.parametrize("chunk", [8, 16])
def test_saturated_minlstm_tc_body_stays_finite(chunk, cuda_device):
    """bf16 minLSTM with |k| in the hundreds on the tensor-core body (the
    step on gate blocks; the C 8 chunk on one block per unit, the C 16
    chunk, more positions than one block per unit takes, on gate blocks):
    the stable normalised gates stay finite where the naive f/(f+i) is
    0/0, and agree with the plain version."""
    gen = torch.Generator().manual_seed(7)
    x, h, *wb = _cell_case(gen, "minlstm", torch.bfloat16, cuda_device, 4,
                           768, 64, chunk, scale=200.0)
    valid = torch.tensor([chunk, 1, 2, chunk], dtype=torch.int32,
                         device=cuda_device)
    step_ops.reset_launches()
    hs = step_ops.fused_minlstm_chunk(x, *wb, h, valid)
    got = step_ops.fused_minlstm_step(x[:, 0], *wb, h)
    assert step_ops.LAUNCHES["minlstm_chunk_kernel/tc"] == 1
    assert step_ops.LAUNCHES["minlstm_step_kernel/tc"] == 1
    assert bool(torch.isfinite(hs).all()) and bool(torch.isfinite(got).all())
    _close(hs, step_ref.minlstm_chunk_ref(x, *wb, h, valid), torch.bfloat16)
    _close(got, step_ref.minlstm_step_ref(x[:, 0], *wb, h), torch.bfloat16)


@pytest.mark.parametrize("arch", ["mingru-lm", "minlstm-lm"])
def test_cell_tier_engine_streams_on_gpu(arch, cuda_device):
    """fp32 smoke width: the cell tier's streams equal the block tier's,
    across C, and ``generate_one``; one cell launch per layer per round."""
    cfg = archs.smoke(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device=cuda_device)
    prompts = [[5, 6, 7], [1], [9, 9, 9, 9, 9]]
    cell = cfg.minrnn.cell
    outs = {}
    for tier, c in (("auto", 1), ("off", 1), ("off", 4)):
        step_ops.reset_launches()
        eng = ServingEngine(cfg, params, max_batch=2, max_len=32,
                            decode_block=3, prompt_chunk=c, fuse_block=tier,
                            device=cuda_device)
        rids = [eng.submit(p, max_new=5) for p in prompts]
        res = eng.run_to_completion()
        outs[(tier, c)] = [res[r] for r in rids]
        assert eng.stats.shard_identities_ok()
        cell_launches = step_ops.LAUNCHES[f"{cell}_step_kernel"] \
            + step_ops.LAUNCHES[f"{cell}_chunk_kernel"]
        if tier == "off":
            assert eng.kernel_tier == "cell-fused"
            assert cell_launches == cfg.n_layers * eng.stats.decode_steps
        else:
            assert cell_launches == 0
    assert outs[("off", 1)] == outs[("off", 4)] == outs[("auto", 1)]
    off = cfg.replace(fuse_block="off")
    for p, o in zip(prompts, outs[("off", 1)]):
        assert o == generate_one(off, params, p, max_new=5, max_len=32,
                                 device=cuda_device)


def test_gemma_mingru_smoke_streams_on_gpu(cuda_device):
    cfg = archs.smoke("gemma-2b-mingru")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = lm.init_params(gen, cfg, device=cuda_device)
    prompts = [[5, 600, 7], [1], [900, 9, 9, 9, 9]]
    step_ops.reset_launches()
    eng = ServingEngine(cfg, params, max_batch=2, max_len=32, decode_block=3,
                        device=cuda_device)
    rids = [eng.submit(p, max_new=5) for p in prompts]
    res = eng.run_to_completion()
    assert eng.kernel_tier == "cell-fused"
    assert step_ops.LAUNCHES["mingru_step_kernel"] \
        == cfg.n_layers * eng.stats.decode_steps
    for p, r in zip(prompts, rids):
        assert res[r] == generate_one(cfg, params, p, max_new=5, max_len=32,
                                      device=cuda_device)


# ---------------------------------------------------------------------------
# Prefill and speculative decoding
# ---------------------------------------------------------------------------

# (B, T, Dx, Dh): gemma-2b-mingru's width (22 column tiles of 96, the last
# 32 wide) and the LMs' width, at prompt lengths off the 128-row T chunk
PREFILL_SHAPES = [(2, 300, 2048, 2048), (3, 127, 768, 1536),
                  (2, 513, 768, 1536)]


@pytest.mark.parametrize("shape", PREFILL_SHAPES)
@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
def test_fused_kernels_prefill_shapes_with_bf16_h0(cell, shape, cuda_device):
    """The prefill's launches: bf16 on the tensor-core body, h0 given in
    bf16 (a resumed prefill reads it from the cache), against the plain
    version."""
    gen = torch.Generator().manual_seed(17)
    bsz, t, dx, dh = shape
    ins = [v.detach() for v in _fused_case(gen, cell, torch.bfloat16,
                                           cuda_device, bsz, t, dx, dh)]
    fn, plain, mod = _fused_fns(cell, "log")
    name = next(iter(mod.LAUNCHES))
    mod.reset_launches()
    with torch.no_grad():
        out = fn(*ins)
    assert mod.LAUNCHES[f"{name}/tc"] == mod.LAUNCHES[name] == 1
    _close(out, plain(*ins), torch.bfloat16)


@pytest.mark.parametrize("dims", [(DX, DH, DM), (768, 1536, 3072)])
@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_chunk_at_odd_width_states_equal_steps(cell, dtype, dims,
                                                     cuda_device):
    """The verify pass's chunk, C = 5: the per-position tables equal the
    block step's state after each position bit for bit, and a frozen row
    re-emits its final state."""
    gen = torch.Generator().manual_seed(19)
    dx, dh, dm = dims
    params = _params(gen, cell, dtype, cuda_device, dx, dh, dm)
    bsz, chunk = 8, 5
    x = torch.randn((bsz, chunk, dx), generator=gen).to(dtype).to(cuda_device)
    st = {"h": (0.5 * torch.randn((bsz, dh), generator=gen)).to(dtype)
          .to(cuda_device),
          "conv": torch.randn((bsz, K - 1, dx), generator=gen).to(dtype)
          .to(cuda_device)}
    valid = torch.tensor([5, 1, 3, 2, 5, 4, 1, 5], dtype=torch.int32,
                         device=cuda_device)
    kw = dict(cell=cell, use_conv=True, use_mlp=True)
    bound = ops.BlockOperands(params, compute_dtype=None, **kw)
    kw["mode"] = "log"
    ops.reset_launches()
    ys, _, pos = ops.fused_block_chunk(params, x, st, valid,
                                       return_positions=True, operands=bound,
                                       **kw)
    assert ops.LAUNCHES["block_chunk_kernel"] == 1
    cur = st
    for t in range(chunk):
        y_t, nxt = ops.fused_block_step(params, x[:, t].contiguous(), cur,
                                        operands=bound,
                                        **kw)
        keep = (t < valid)
        for k in ("h", "conv"):
            want = torch.where(keep.view((-1,) + (1,) * (nxt[k].dim() - 1)),
                               nxt[k], cur[k])
            assert torch.equal(pos[k][:, t], want), (k, t)
        assert torch.equal(ys[keep, t], y_t[keep])
        cur = {k: pos[k][:, t].contiguous() for k in ("h", "conv")}


@pytest.mark.parametrize("arch", ["mingru-lm", "minlstm-lm"])
@pytest.mark.parametrize("fuse_block", ["auto", "off"])
def test_prefill_and_decode_verify_on_gpu_match_cpu(arch, fuse_block,
                                                    cuda_device):
    """fp32 smoke width: ``lm.prefill`` (one fused-cell launch per layer)
    and ``lm.decode_verify`` (one chunk launch per layer) on the card
    against the same calls on the CPU's plain path."""
    cfg = archs.smoke(arch).replace(fuse_block=fuse_block)
    cpu = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    gpu = lm.tree_to(cpu, cuda_device)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(1, 256, (4, 9), generator=gen, dtype=torch.int32)
    lens = torch.tensor([9, 1, 5, 7], dtype=torch.int32)
    drafts = torch.randint(1, 256, (4, 5), generator=gen, dtype=torch.int32)
    valid = torch.tensor([5, 1, 3, 2], dtype=torch.int32)
    cell = cfg.minrnn.cell
    fused = gru_ops if cell == "mingru" else lstm_ops
    fused.reset_launches()
    ops.reset_launches()
    step_ops.reset_launches()
    lg, cg = lm.prefill(gpu, cfg, toks.to(cuda_device), 32,
                        lengths=lens.to(cuda_device))
    assert fused.LAUNCHES[f"fused_{cell}_kernel"] == cfg.n_layers
    vg, sg = lm.decode_verify(gpu, cfg, drafts.to(cuda_device),
                              valid.to(cuda_device), cg)
    chunk_launches = ops.LAUNCHES["block_chunk_kernel"] if fuse_block == \
        "auto" else step_ops.LAUNCHES[f"{cell}_chunk_kernel"]
    assert chunk_launches == cfg.n_layers
    lc, cc = lm.prefill(cpu, cfg, toks, 32, lengths=lens)
    vc, sc = lm.decode_verify(cpu, cfg, drafts, valid, cc)
    for got, want in [(lg, lc), (vg, vc)] + [(cg[k], cc[k]) for k in cc] \
            + [(sg[k], sc[k]) for k in sc]:
        _close(got.cpu(), want, torch.float32)


@pytest.mark.parametrize("arch", ["mingru-lm", "minlstm-lm"])
@pytest.mark.parametrize("fuse_block", ["auto", "off"])
def test_speculative_engine_streams_on_gpu(arch, fuse_block, cuda_device):
    """fp32 smoke width, both tiers: n-gram and oracle speculation stream
    as the non-speculative engine; one chunk launch per layer per verify
    round (the oracle's own commits add as many again)."""
    cfg = archs.smoke(arch).replace(fuse_block=fuse_block)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device=cuda_device)
    phrase = [5, 6, 7, 8, 9]
    prompts = [phrase * 3, [1, 2] * 4, phrase + [3]]
    cell = cfg.minrnn.cell

    def run(**kw):
        ops.reset_launches()
        step_ops.reset_launches()
        eng = ServingEngine(cfg, params, max_batch=2, max_len=48,
                            decode_block=3, device=cuda_device, **kw)
        rids = [eng.submit(p, max_new=8) for p in prompts]
        res = eng.run_to_completion()
        chunk = ops.LAUNCHES["block_chunk_kernel"] if fuse_block == "auto" \
            else step_ops.LAUNCHES[f"{cell}_chunk_kernel"]
        return [res[r] for r in rids], eng, chunk

    base, _, _ = run()
    spec, eng, chunk = run(speculative="ngram", draft_len=4)
    assert spec == base
    assert eng.stats.draft_proposed > 0
    assert chunk == cfg.n_layers * eng.stats.decode_steps
    oracle, eng, chunk = run(
        speculative=draft_lib.ModelDraft(cfg, params, draft_len=3))
    assert oracle == base
    assert eng.stats.draft_accepted == eng.stats.draft_proposed > 0
    assert chunk == 2 * cfg.n_layers * eng.stats.decode_steps


@pytest.mark.parametrize("arch", ["mingru-lm", "minlstm-lm"])
@pytest.mark.parametrize("chunk", [5, 8])
def test_cell_tier_chunk_equals_steps_at_full_width(arch, chunk,
                                                    cuda_device):
    """bf16 at the LMs' width, the cell tier: ``blocks.step_chunk`` (the
    chunk kernel, the tail a position at a time) equals ``chunk``
    ``blocks.step`` calls bit for bit, outputs and states.  cuBLAS sums
    the 3072-deep MLP product of 40 rows in another order than of 8."""
    cfg = archs.get(arch).replace(fuse_block="off")
    gen = torch.Generator().manual_seed(23)
    params = lm.init_params(gen, cfg, device=cuda_device)
    p0, o0 = lm.bind_layers(params, cfg)[0]
    bc = lm._minrnn_block_cfg(cfg)
    x = torch.randn((8, chunk, cfg.d_model), generator=gen).to(
        torch.bfloat16).to(cuda_device)
    st = {"h": torch.rand((8, bc.d_hidden), generator=gen).to(
              torch.bfloat16).to(cuda_device),
          "conv": torch.randn((8, 3, cfg.d_model), generator=gen).to(
              torch.bfloat16).to(cuda_device)}
    valid = torch.full((8,), chunk, dtype=torch.int32, device=cuda_device)
    ys, _, pos = blocks.step_chunk(p0, bc, x, st, valid,
                                   compute_dtype=torch.bfloat16,
                                   return_positions=True, operands=o0)
    cur = st
    for t in range(chunk):
        y_t, cur = blocks.step(p0, bc, x[:, t].contiguous(), cur,
                               compute_dtype=torch.bfloat16, operands=o0)
        assert torch.equal(y_t, ys[:, t]), t
        for k in ("h", "conv"):
            assert torch.equal(cur[k], pos[k][:, t]), (k, t)


# ---------------------------------------------------------------------------
# The robustness layer at full width: NaN quarantine, kill / restore
# ---------------------------------------------------------------------------

ROBUST_PROMPTS = [[(7 * i + j) % 250 + 1 for j in range(3 + i)]
                  for i in range(8)]


def _serve_full(cfg, params, device, prompts, max_new, **kw):
    eng = ServingEngine(cfg, params, max_batch=8, max_len=128, seed=0,
                        decode_block=4, device=device, **kw)
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    outs = eng.run_to_completion()
    return [outs[r] for r in rids], eng


@pytest.mark.parametrize("fuse_block", ["auto", "off"])
def test_full_width_nan_quarantine_leaves_other_rows_bit_identical(
        fuse_block, cuda_device):
    """bf16 mingru-lm at full width: NaN poured into two slots' h / conv
    rows at round 4 is caught by the health guard, those two requests are
    retried from scratch and every stream -- theirs after the retry, and
    the six untouched rows' -- equals the fault-free run's bit for bit,
    on the block and the cell tier."""
    from repro_torch.serving.faults import FaultInjector
    cfg = archs.get("mingru-lm")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = lm.init_params(gen, cfg, device=cuda_device)
    clean, _ = _serve_full(cfg, params, cuda_device, ROBUST_PROMPTS, 16,
                           fuse_block=fuse_block)
    inj = FaultInjector(nan_at=((4, 2), (4, 5)))
    hit, eng = _serve_full(cfg, params, cuda_device, ROBUST_PROMPTS, 16,
                           fuse_block=fuse_block, faults=inj,
                           max_retries=2, retry_backoff=2)
    assert inj.counts()["corrupt_state"] == 2
    assert eng.stats.quarantined == 2 and eng.stats.retried == 2
    assert eng.stats.completed == len(ROBUST_PROMPTS)
    assert eng.stats.shard_identities_ok()
    assert hit == clean


def test_full_width_kill_restore_bit_identical(cuda_device, tmp_path):
    """Block tier, bf16 mingru-lm at full width, greedy and seeded-sampled
    requests: an engine abandoned mid-run and restored from its snapshot
    + journal finishes with the uninterrupted run's streams and round
    clock; every restored state leaf sits on the card in the fresh
    engine's dtype, but the key chains, which live on the host."""
    from repro_torch.serving import recovery
    from repro_torch.training import checkpoint as ckpt
    cfg = archs.get("mingru-lm")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = lm.init_params(gen, cfg, device=cuda_device)

    def submit_all(eng):
        for i, p in enumerate(ROBUST_PROMPTS):
            eng.submit(p, max_new=24, temperature=0.8 if i % 2 else 0.0,
                       top_k=40 if i % 2 else 0)

    ref = ServingEngine(cfg, params, max_batch=8, max_len=128, seed=0,
                        decode_block=4, device=cuda_device)
    submit_all(ref)
    want = ref.run_to_completion()
    eng = ServingEngine(cfg, params, max_batch=8, max_len=128, seed=0,
                        decode_block=4, device=cuda_device,
                        recover_dir=str(tmp_path), snapshot_every=8)
    submit_all(eng)
    while eng.stats.decode_steps < 18:
        eng.step()
    eng.journal.close()
    del eng
    rec = ServingEngine.restore(str(tmp_path), cfg, params,
                                device=cuda_device)
    assert rec.recovery_report["snapshot_round"] == 16
    assert rec.recovery_report["replayed_rounds"] == 4
    fresh = ckpt.flatten_tree(ServingEngine(
        cfg, params, max_batch=8, max_len=128, device=cuda_device).state,
        "state")
    for k, leaf in ckpt.flatten_tree(rec.state, "state").items():
        assert leaf.dtype == fresh[k].dtype, k
        assert leaf.device.type == ("cpu" if k == "state|keys" else "cuda"), k
    assert rec.run_to_completion() == want
    assert rec.stats.decode_steps == ref.stats.decode_steps
    with pytest.raises(recovery.RecoveryError, match="device"):
        ServingEngine.restore(str(tmp_path), cfg,
                              lm.tree_to(params, "cpu"), device="cpu")


# ---------------------------------------------------------------------------
# The attention trunk at gemma width: training, the KV scatter, batch rows
# ---------------------------------------------------------------------------

def test_gemma_mingru_full_width_training_step_launches(cuda_device):
    """One AdamW step of full-width bf16 gemma-2b-mingru (remat "full"):
    two fused-cell launches per layer (forward, recompute), all on the
    tensor-core body, one reversed linear scan per layer, a finite loss."""
    cfg = archs.get("gemma-2b-mingru")
    params = lm.init_params(torch.Generator(device=cuda_device).manual_seed(0),
                            cfg, device=cuda_device)
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ocfg = opt_lib.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=1)
    for mod in (gru_ops, lstm_ops, scan_ops):
        mod.reset_launches()
    _, _, m = ts_lib.make_train_step(cfg, ocfg)(
        params, opt_lib.init(ocfg, params), batch)
    n = cfg.n_layers
    assert torch.isfinite(m["loss"])
    assert gru_ops.LAUNCHES["fused_mingru_kernel"] == 2 * n
    assert gru_ops.LAUNCHES["fused_mingru_kernel/tc"] == 2 * n
    assert scan_ops.LAUNCHES["linear_scan_kernel"] == n
    assert scan_ops.LAUNCHES["log_scan_kernel"] == 0
    assert lstm_ops.LAUNCHES["fused_minlstm_kernel"] == 0


def test_reversed_linear_scan_at_gemma_width_matches_plain(cuda_device):
    """The backward's scan at gemma-2b-mingru's training shape (fp32, B 8
    x T 512 x D 2048: 33.5 MB an operand): a block per (row, 32 columns),
    512 blocks, against the plain version and bit for bit its segmented
    rendering."""
    gen = torch.Generator().manual_seed(5)
    shape = (8, 512, 2048)
    a = torch.rand(shape, generator=gen).to(cuda_device)
    b = torch.randn(shape, generator=gen).to(cuda_device)
    h0 = torch.zeros((8, 2048), device=cuda_device)
    got = scan_ops.linear_scan_kernel(a, b, h0, reverse=True)
    _close(got, scan_ref.linear_scan_ref(a, b, h0, reverse=True),
           torch.float32)
    assert torch.equal(got, scan_ref.linear_scan_segmented(a, b, h0,
                                                           reverse=True))
    occ = scan_ops.occupancy("linear", torch.float32, *shape,
                             device=cuda_device)
    assert occ["blocks"] == 8 * 2048 // 32, occ


def test_kv_scatter_at_gemma_shapes_in_place_bit_equal_to_blend(cuda_device):
    """gemma-2b's KV cache rows (B 8, max_len 1024, 1 head of 256, bf16):
    the in-place scatter equals the reference's one-hot blend bit for bit,
    writes nothing at a position past the end, and keeps the storage."""
    from repro_torch.models import attention
    gen = torch.Generator().manual_seed(6)
    cache = torch.randn((8, 1024, 1, 256), generator=gen).to(
        torch.bfloat16).to(cuda_device)
    new = torch.randn((8, 1, 256), generator=gen).to(torch.bfloat16).to(
        cuda_device)
    pos = torch.tensor([0, 1, 511, 512, 1023, 1024, 3000, 7],
                       dtype=torch.int32, device=cuda_device)
    onehot = torch.nn.functional.one_hot(pos.long().clamp(max=1024), 1025)[
        :, :1024].to(cache.dtype)[..., None, None]
    blend = cache * (1.0 - onehot).to(cache.dtype) + onehot * new[:, None]
    ptr = cache.data_ptr()
    out = attention._cache_insert(cache, new, pos)
    assert out is cache and cache.data_ptr() == ptr
    assert torch.equal(cache, blend)


def test_gemma_decode_row_is_independent_of_batch(cuda_device):
    """Full-width bf16 gemma-2b: a row decoded in a batch of 8 gives the
    same logits and KV rows, bit for bit, as the row decoded alone -- the
    engine's greedy streams equal ``generate_one`` only so."""
    cfg = archs.get("gemma-2b")
    params = lm.init_params(torch.Generator(device=cuda_device).manual_seed(0),
                            cfg, device=cuda_device)
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (8, 6), generator=gen,
                         dtype=torch.int32).to(cuda_device)
    c8 = lm.init_cache(cfg, 8, 64, cuda_device)
    c1 = lm.init_cache(cfg, 1, 64, cuda_device)
    for t in range(toks.shape[1]):
        l8, c8 = lm.decode_step(params, cfg, toks[:, t], c8)
        l1, c1 = lm.decode_step(params, cfg, toks[3:4, t], c1)
        assert torch.equal(l8[3:4], l1), t
    for k in ("k", "v"):
        assert torch.equal(c8[k][:, 3:4], c1[k]), k


@pytest.mark.parametrize("bsz", [3, 8, 16, 21])
def test_decode_attention_rows_match_alone_at_gemma_shape(bsz, cuda_device):
    """Decode attention at gemma-2b's shape (8 heads on 1 KV head of 256,
    a cache of 1024, bf16), rows of mixed lengths: each row of a batch
    equals the row attended alone, bit for bit."""
    from repro_torch.models import attention
    gen = torch.Generator().manual_seed(8)
    q = torch.randn((bsz, 8, 256), generator=gen).to(torch.bfloat16)
    kc = torch.randn((bsz, 1024, 1, 256), generator=gen).to(torch.bfloat16)
    vc = torch.randn((bsz, 1024, 1, 256), generator=gen).to(torch.bfloat16)
    length = torch.randint(1, 1025, (bsz,), generator=gen, dtype=torch.int32)
    q, kc, vc, length = (t.to(cuda_device) for t in (q, kc, vc, length))
    both = attention.decode_attention(q, kc, vc, length)
    for b in range(bsz):
        one = attention.decode_attention(q[b:b + 1], kc[b:b + 1],
                                         vc[b:b + 1], length[b:b + 1])
        assert torch.equal(both[b:b + 1], one), b


# ---------------------------------------------------------------------------
# The SSD trunk (mamba2-370m), the task heads' shapes, blocks.init_state
# ---------------------------------------------------------------------------

def test_mamba2_decode_row_is_independent_of_batch(cuda_device):
    """Full-width bf16 mamba2-370m: a row decoded in a batch of 8 gives the
    same logits and conv / ssm state, bit for bit, as the row decoded
    alone (the trunk steps its rows in groups of 8) -- the engine's
    greedy streams equal ``generate_one`` only so."""
    cfg = archs.get("mamba2-370m")
    params = lm.init_params(torch.Generator(device=cuda_device).manual_seed(0),
                            cfg, device=cuda_device)
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (8, 6), generator=gen,
                         dtype=torch.int32).to(cuda_device)
    c8 = lm.init_cache(cfg, 8, 64, cuda_device)
    c1 = lm.init_cache(cfg, 1, 64, cuda_device)
    for t in range(toks.shape[1]):
        l8, c8 = lm.decode_step(params, cfg, toks[:, t], c8)
        l1, c1 = lm.decode_step(params, cfg, toks[3:4, t], c1)
        assert torch.equal(l8[3:4], l1), t
    for k in ("conv", "ssm"):
        assert torch.equal(c8[k][:, 3:4], c1[k]), k


@pytest.mark.parametrize("form,dtype", [
    ("masked", torch.float32), ("compact", torch.float32),
    ("masked", torch.bfloat16)])
def test_ssd_forms_match_sequential_on_gpu(form, dtype, cuda_device):
    """The dual forms against the sequential oracle on the card: T 300
    over chunks of 64 (ragged), 8 heads of 16 on 2 groups of 16; x, b, c
    in ``dtype``, dt in fp32.  fp32 at the reference's own tolerance of
    tests/test_ssd_forms.py (3e-4); bf16 (the masked form, the model's)
    as the largest error over the largest value, 5e-2 (chip_smoke.py's
    prefill limit).  The compact form is not held in bf16: as in the
    reference it rounds the cumulative log decay to bf16 before the
    segment differences, an error of half a bf16 unit of |cum| in each
    decay exponent."""
    from repro_torch.models import ssd
    gen = torch.Generator().manual_seed(9)
    bsz, t, h, p, g, n = 2, 300, 8, 16, 2, 16
    x = torch.randn((bsz, t, h, p), generator=gen).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((bsz, t, h), generator=gen)
                                      - 2.0)
    b = torch.randn((bsz, t, g, n), generator=gen).to(dtype)
    c = torch.randn((bsz, t, g, n), generator=gen).to(dtype)
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    d_skip = torch.ones((h,))
    args = [v.to(cuda_device) for v in (x, dt, a_log, b, c, d_skip)]
    seq = ssd.ssd_sequential(*args)
    y, st = ssd.ssd_chunked(*args, chunk=64, return_state=True, form=form)
    assert y.shape == seq.shape and bool(torch.isfinite(y).all())
    if dtype == torch.float32:
        torch.testing.assert_close(y, seq, rtol=3e-4, atol=3e-4)
    else:
        assert _rel_err(y, seq) < 5e-2
    # the state after the last position: the sequential roll-out's
    state = torch.zeros((bsz, h, p, n), device=cuda_device)
    for i in range(t):
        _, state = ssd.ssd_step(args[0][:, i], args[1][:, i], a_log.to(
            cuda_device), args[3][:, i], args[4][:, i], args[5], state)
    assert _rel_err(st, state) < (1e-4 if dtype == torch.float32 else 5e-2)


# ---------------------------------------------------------------------------
# The hybrid (zamba2), MoE (deepseek-moe-16b), LayerNorm (starcoder2-15b)
# and encoder-decoder (whisper-base) trunks
# ---------------------------------------------------------------------------

def _row_vs_alone(cfg, dev, keys):
    """Steps 8 rows and row 3 alone from seeded weights drawn on the card:
    the logits and the cache leaves ``keys`` bit for bit."""
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (8, 6), generator=gen,
                         dtype=torch.int32).to(dev)
    c8 = lm.init_cache(cfg, 8, 64, dev)
    c1 = lm.init_cache(cfg, 1, 64, dev)
    for t in range(toks.shape[1]):
        l8, c8 = lm.decode_step(params, cfg, toks[:, t], c8)
        l1, c1 = lm.decode_step(params, cfg, toks[3:4, t], c1)
        assert torch.equal(l8[3:4], l1), t
    for k in keys:
        assert torch.equal(c8[k][:, 3:4], c1[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_decode_row_is_independent_of_batch(dtype, cuda_device):
    """zamba2-2.7b smoke on the card (rows stepped in groups of 8, the
    shared block's KV rows of a padded group copied out and back): a row
    decoded in a batch of 8 equals the row decoded alone, bit for bit."""
    cfg = archs.smoke("zamba2-2.7b").replace(param_dtype=dtype,
                                             compute_dtype=dtype)
    _row_vs_alone(cfg, cuda_device, ("conv", "ssm", "k", "v"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_moe_decode_row_is_independent_of_batch(dtype,
                                                         cuda_device):
    """deepseek-moe-16b smoke at capacity factor 16 (no assignment drops):
    every product of the step in tiles of 8 rows, the experts' too, so a
    row decoded in a batch of 8 equals the row decoded alone, bit for
    bit."""
    cfg = archs.smoke("deepseek-moe-16b").replace(param_dtype=dtype,
                                                  compute_dtype=dtype)
    assert cfg.moe.capacity_factor == 16.0
    _row_vs_alone(cfg, cuda_device, ("k", "v"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_starcoder2_decode_row_is_independent_of_batch(dtype, cuda_device):
    """starcoder2-15b smoke on the card (LayerNorm, biased projections and
    MLP, every product of the step in tiles of 8 rows): a row decoded in
    a batch of 8 equals the row decoded alone, bit for bit."""
    cfg = archs.smoke("starcoder2-15b").replace(param_dtype=dtype,
                                                compute_dtype=dtype)
    _row_vs_alone(cfg, cuda_device, ("k", "v"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_decode_row_is_independent_of_batch(dtype, cuda_device):
    """whisper-base smoke on the card: from one B-8 prefill, row 3 decoded
    in the batch equals row 3 decoded alone with its own cross k / v, bit
    for bit (logits and the self-attention cache)."""
    from repro_torch.models import encdec
    cfg = archs.smoke("whisper-base").replace(param_dtype=dtype,
                                              compute_dtype=dtype)
    params = encdec.init_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg,
        device=cuda_device)
    gen = torch.Generator().manual_seed(7)
    frames = torch.randn((8, cfg.n_frontend_tokens, cfg.frontend_dim),
                         generator=gen).to(cuda_device)
    c8 = encdec.prefill(params, cfg, frames,
                        encdec.init_cache(cfg, 8, 64, cuda_device))
    c1 = {k: v[3:4].clone() if k == "pos" else v[:, 3:4].clone()
          for k, v in c8.items()}
    toks = torch.randint(0, cfg.vocab_size, (8, 6), generator=gen,
                         dtype=torch.int32).to(cuda_device)
    for t in range(toks.shape[1]):
        l8, c8 = encdec.decode_step(params, cfg, toks[:, t], c8)
        l1, c1 = encdec.decode_step(params, cfg, toks[3:4, t], c1)
        assert torch.equal(l8[3:4], l1), t
    for k in ("k", "v"):
        assert torch.equal(c8[k][:, 3:4], c1[k]), k


# ---------------------------------------------------------------------------
# MLA (deepseek-v3-671b), remat "dots", whisper past its learned positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_v3_decode_row_is_independent_of_batch(dtype, cuda_device):
    """deepseek-v3-671b smoke at capacity factor 16: the absorbed MLA
    decode in fp32 tiles of 8 rows, so a row decoded in a batch of 8
    equals the row decoded alone, bit for bit (logits, ckv, krope)."""
    cfg = archs.smoke("deepseek-v3-671b").replace(param_dtype=dtype,
                                                  compute_dtype=dtype)
    _row_vs_alone(cfg, cuda_device, ("ckv", "krope"))


def test_deepseek_v3_prefill_matches_the_step_path(cuda_device):
    """deepseek-v3-671b smoke in fp32: a prefill of 12 tokens against 12
    ``decode_step`` calls (the expanded form against the absorbed one),
    the last logits and the latent caches within 1e-4."""
    cfg = archs.smoke("deepseek-v3-671b")
    params = lm.init_params(torch.Generator(device=cuda_device).manual_seed(0),
                            cfg, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (3, 12), generator=torch.
                         Generator().manual_seed(2),
                         dtype=torch.int32).to(cuda_device)
    logits, cache = lm.prefill(params, cfg, toks, 16)
    c = lm.init_cache(cfg, 3, 16, cuda_device)
    for i in range(toks.shape[1]):
        l_seq, c = lm.decode_step(params, cfg, toks[:, i], c)
    torch.testing.assert_close(logits, l_seq, rtol=1e-4, atol=1e-4)
    for k in ("ckv", "krope"):
        torch.testing.assert_close(cache[k], c[k], rtol=1e-4, atol=1e-4)
    assert torch.equal(cache["pos"], c["pos"])


@pytest.mark.parametrize("arch", ["mingru-lm", "deepseek-v3-671b"])
def test_remat_dots_gradients_equal_full(arch, cuda_device):
    """One loss and its gradients under ``remat="dots"`` and ``"full"``
    (fp32 smoke; mingru-lm through its fused kernel and reversed scan):
    the same loss, gradients within 1e-4 of the largest."""
    cfg = archs.smoke(arch)
    params = lm.init_params(torch.Generator(device=cuda_device).manual_seed(0),
                            cfg, device=cuda_device)
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen,
                         dtype=torch.int32).to(cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for remat in ("full", "dots"):
        out[remat] = ts_lib.value_and_grad(
            ts_lib.make_loss_fn(cfg.replace(remat=remat)),
            tree.tree_map(torch.clone, params), batch)
    (lf, _), gf = out["full"]
    (ld, _), gd = out["dots"]
    assert float(lf) == float(ld)
    for a, b in zip(tree.leaves(gf), tree.leaves(gd)):
        assert _rel_err(b, a) <= 1e-4


def test_whisper_decodes_past_its_learned_positions(cuda_device):
    """whisper-base smoke: rows at max_seq_len - 1 and max_seq_len (a
    cache of max_seq_len + 4), 3 steps: the learned position clamps to
    the table's last row (no device-side assert), the logits finite and
    equal to the same steps on the CPU within 1e-4."""
    from repro_torch.models import encdec
    cfg = archs.smoke("whisper-base")
    s = cfg.max_seq_len
    params = encdec.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    frames = torch.randn((2, cfg.n_frontend_tokens, cfg.frontend_dim),
                         generator=torch.Generator().manual_seed(5))
    toks = torch.randint(0, cfg.vocab_size, (2, 3), generator=torch.
                         Generator().manual_seed(6), dtype=torch.int32)
    outs = []
    for dev in ("cpu", cuda_device):
        p = lm.tree_to(params, dev)
        cache = encdec.prefill(p, cfg, frames.to(dev),
                               encdec.init_cache(cfg, 2, s + 4, dev))
        cache["pos"] = torch.tensor([s - 1, s], dtype=torch.int32,
                                    device=dev)
        logits = []
        for i in range(toks.shape[1]):
            out, cache = encdec.decode_step(p, cfg, toks[:, i].to(dev),
                                            cache)
            logits.append(out.cpu())
        outs.append(torch.stack(logits, 1))
    assert bool(torch.isfinite(outs[1]).all())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_tok,rows", [(8, 8), (512, None)])
def test_moe_dispatch_is_bit_equal_on_the_card(n_tok, rows, cuda_device):
    """One full-width deepseek-moe-16b MoE layer (64 experts of 1408,
    top-6, 2 shared of 2816; bf16, drawn on the card) at the published
    capacity factor 1.25: two calls on the same tokens are bit-equal
    (the dispatch writes each kept (expert, position) once and drops
    into one junk row), at a decode step's 8 tokens (tiles of 8) and at
    512 tokens sharing one direction, which route alike and so overflow
    their experts' 60 rows."""
    from repro_torch.models import moe
    cfg = archs.get("deepseek-moe-16b")
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    layer = moe.moe_init(gen, cfg, dtype=torch.bfloat16)
    layer = lm.tree_to(layer, cuda_device)
    x = torch.randn((n_tok, 1, cfg.d_model), generator=gen,
                    device=cuda_device)
    x = (0.1 * x + torch.randn((cfg.d_model,), generator=gen,
                               device=cuda_device)).to(torch.bfloat16)
    with torch.no_grad(), moe.count_drops() as drops:
        y1, a1 = moe.moe_apply(layer, cfg, x, rows=rows)
        y2, a2 = moe.moe_apply(layer, cfg, x, rows=rows)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    assert bool(torch.isfinite(y1).all())
    assert int(drops[0][0]) == int(drops[1][0])
    if n_tok == 512:
        assert int(drops[0][0]) > 0


# the task heads' shapes (B, T, Dx, Dh): the Chomsky classifier (T 40),
# ListOps (T 128) and the Decision-Transformer model (3 x horizon 64), d 64
# with expansion 2, fp32 as the heads train
HEAD_SHAPES = [(64, 40, 64, 128), (64, 128, 64, 128), (64, 192, 64, 128)]


@pytest.mark.parametrize("shape", HEAD_SHAPES)
@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
def test_fused_kernels_at_head_shapes_match_plain(cell, shape, cuda_device):
    """The heads' fused-cell launches (fp32: the CUDA-core body) and their
    backward, h0 zero as the heads run it, against the plain version."""
    gen = torch.Generator().manual_seed(12)
    bsz, t, dx, dh = shape
    ins = _fused_case(gen, cell, torch.float32, cuda_device, bsz, t, dx, dh)
    ins = ins[:-1]                                   # no h0
    fn, plain, mod = _fused_fns(cell, "log")
    name = next(iter(mod.LAUNCHES))
    mod.reset_launches()
    scan_ops.reset_launches()
    out = fn(*ins)
    assert mod.LAUNCHES[f"{name}/cuda_core"] == mod.LAUNCHES[name] == 1
    want = plain(*ins)
    _close(out, want, torch.float32)
    ct = torch.randn(out.shape, generator=gen).to(cuda_device)
    got_g = torch.autograd.grad(out, ins, ct)
    want_g = torch.autograd.grad(want, ins, ct)
    assert scan_ops.LAUNCHES["linear_scan_kernel"] == 1
    for g, w in zip(got_g, want_g):
        assert _rel_err(g, w) < GRAD_TOL[torch.float32]


def test_block_init_state_defaults_to_the_card(cuda_device):
    bc = blocks.MinRNNBlockConfig(d_model=DX, expansion=2.0, use_conv=True)
    st = blocks.init_state(bc, (3,))
    assert all(v.device.type == "cuda" for v in st.values())
    assert all(v.device.type == "cpu"
               for v in blocks.init_state(bc, (3,), device="cpu").values())


# ---------------------------------------------------------------------------
# Mesh-sharded serving: worlds of ranks sharing the card (gloo)
# ---------------------------------------------------------------------------

def _card_single(dtype):
    import torch_mesh_ranks as ranks
    cfg = ranks.CFG.replace(param_dtype=dtype, compute_dtype=dtype)
    dev = torch.device("cuda")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    eng = ServingEngine(cfg, params, max_batch=4, max_len=96,
                        decode_block=4, device=dev)
    ranks.submit_all(eng, 9)
    return eng.run_to_completion()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dp_world_on_the_card_equals_one_card(dtype, cuda_device):
    """A 2x1 world, both ranks on cuda:0: the one-card engine's streams
    bit for bit, one block kernel a layer a round on each rank."""
    import torch_mesh_ranks as ranks
    from repro_torch.distributed import serve_mesh
    got = serve_mesh.run_world(ranks.card_world, 2, ("2x1", dtype))
    want = _card_single(dtype)
    for r in got:
        assert r["device"] == "cuda:0" and r["tier"] == "block-fused"
        assert r["streams"] == want
        assert r["identities_ok"] and r["mismatches"] == 0
        assert r["launches"]["block_step_kernel"] \
            == ranks.CFG.n_layers * r["rounds"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tp_world_model_ranks_agree_bit_for_bit(dtype, cuda_device):
    """A 1x2 world: the cell tier on each rank's d_hidden half, the model
    ranks' drained planes equal bit for bit (no mismatch on either), the
    streams complete; fp32 streams equal the one card's."""
    import torch_mesh_ranks as ranks
    from repro_torch.distributed import serve_mesh
    got = serve_mesh.run_world(ranks.card_world, 2, ("1x2", dtype))
    assert got[0]["streams"] == got[1]["streams"]
    for r in got:
        assert r["tier"] == "cell-fused" and r["mismatches"] == 0
        assert r["identities_ok"]
        assert r["launches"]["block_step_kernel"] == 0
        assert r["launches"]["mingru_step_kernel"] \
            == ranks.CFG.n_layers * r["rounds"]
        assert all(len(s) == 8 for s in r["streams"].values())
    if dtype == "float32":
        assert got[0]["streams"] == _card_single(dtype)


# ---------------------------------------------------------------------------
# Distributed training on worlds of ranks sharing the card
# ---------------------------------------------------------------------------

_TRAIN_WORLD = {}


def _train_inputs():
    """Seeded inputs of the card's training world: the EP test layer (d 16,
    8 experts, top-2, fp32), tokens and cotangents (2, 12, 16), scan
    inputs (2, 64, 4) and h0, and 2 corpus batches of B 8 x T 32."""
    import numpy as np
    import torch_train_ranks as ranks
    from repro_torch.data import lm_corpus
    from repro_torch.models import moe
    layer = tree.tree_map(lambda a: a.numpy(), moe.moe_init(
        torch.Generator().manual_seed(0), ranks.EP_CFG))
    rng = np.random.RandomState(1)
    x = rng.randn(2, 12, 16).astype(np.float32)
    g = rng.randn(2, 12, 16).astype(np.float32)
    scan_in = (rng.uniform(0.5, 1.0, (2, 64, 4)).astype(np.float32),
               rng.randn(2, 64, 4).astype(np.float32),
               rng.randn(2, 4).astype(np.float32))
    data, _ = lm_corpus.build_corpus(target_bytes=20_000)
    batches = [lm_corpus.lm_batch(data, 0, i, 8, 32) for i in range(2)]
    return layer, x, g, scan_in, batches


def _train_world():
    import torch_train_ranks as ranks
    from repro_torch.distributed import serve_mesh
    if not _TRAIN_WORLD:
        inputs = _train_inputs()
        _TRAIN_WORLD["inputs"] = inputs
        _TRAIN_WORLD["ranks"] = serve_mesh.run_world(ranks.card_world, 4,
                                                     inputs)
    return _TRAIN_WORLD["inputs"], _TRAIN_WORLD["ranks"]


def test_dp_compressed_step_world_on_the_card(cuda_device):
    """A 2x2 world of the bf16 smoke LM: every rank launches the one
    card's fused-cell and reversed-scan kernels a step, the replicas stay
    bit-equal, and the params follow the one card's step on the same
    halves (2 microbatches: a whole-batch step parts where a grad is
    rounding noise) within the reference's trend tolerance (rtol 0.1,
    atol 2e-3; loss 1e-2)."""
    (_, _, _, _, batches), got = _train_world()
    cfg = archs.smoke("mingru-lm").replace(param_dtype="bfloat16",
                                           compute_dtype="bfloat16")
    opt = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    params = lm.init_params(torch.Generator(device=cuda_device)
                            .manual_seed(0), cfg, device=cuda_device)
    state = opt_lib.init(opt, params)
    step = ts_lib.make_train_step(cfg, opt, microbatches=2)
    losses = []
    for batch in batches:
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    # remat "full" runs each layer's forward twice a step; the smoke
    # config's "none" once
    want = ((2 if cfg.remat == "full" else 1) * cfg.n_layers, cfg.n_layers)
    for r in got:
        d = r["dp"]
        assert d["device"] == "cuda:0" and d["replicas_equal"]
        assert d["per_step"] == [want] * len(batches)
        assert all(abs(a - b) < 1e-2 for a, b in zip(d["losses"], losses))
        for path, p in tree.leaves_with_path(params):
            got_p = torch.from_numpy(tree.at(d["params"], path))
            torch.testing.assert_close(got_p, p.float().cpu(), rtol=0.1,
                                       atol=2e-3)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_expert_parallel_world_on_the_card(mode, cuda_device):
    """EP at 2x2 on the card (fp32, the reference's test layer): each data
    row's y, the x grads and the gathered weight grads against the one
    card's ``moe_apply`` at 1e-4."""
    import numpy as np
    import torch_train_ranks as ranks
    from repro_torch.models import moe
    (layer, x, g, _, _), got = _train_world()
    res = [r[f"ep_{mode}"] for r in got]
    assert all(r["ep"] and r["two_d"] == (mode == "on") for r in res)
    p = tree.tree_map(lambda a: torch.from_numpy(a).to(cuda_device)
                      .requires_grad_(), layer)
    xt = torch.from_numpy(x).to(cuda_device).requires_grad_()
    y, aux = moe.moe_apply(p, ranks.EP_CFG, xt)
    ((y * torch.from_numpy(g).to(cuda_device)).sum() + aux).backward()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.concatenate([res[0]["y"], res[2]["y"]]), y.detach().cpu(), **tol)
    np.testing.assert_allclose(
        np.concatenate([res[0]["x_grad"], res[2]["x_grad"]]),
        xt.grad.cpu(), **tol)
    aux = float(aux.detach())
    assert abs(res[0]["aux"] - aux) <= 1e-4 * abs(aux)
    router = sum(res[i]["grads"]["router"]["kernel"] for i in (0, 2))
    np.testing.assert_allclose(router, p["router"]["kernel"].grad.cpu(),
                               **tol)
    for key, d_axis in (("gate_w", 1), ("up_w", 1), ("down_w", 2)):
        blocks = [r["grads"][key]["kernel"] for r in res]
        if mode == "on":       # d split over the data ranks
            cols = [np.concatenate([blocks[j], blocks[2 + j]], axis=d_axis)
                    for j in range(2)]
        else:                  # whole on the data ranks: summed
            cols = [blocks[j] + blocks[2 + j] for j in range(2)]
        np.testing.assert_allclose(np.concatenate(cols, axis=0),
                                   p[key]["kernel"].grad.cpu(), **tol)


def test_sequence_parallel_scan_world_on_the_card(cuda_device):
    """The scan split over 4 ranks on the card against the one-card
    ``linear_scan_kernel`` on the whole sequence (fp32 1e-4)."""
    import numpy as np
    (_, _, _, (a, b, h0), _), got = _train_world()
    want = scan_ops.linear_scan(*(torch.from_numpy(v).to(cuda_device)
                                  for v in (a, b, h0)))
    np.testing.assert_allclose(
        np.concatenate([r["sp_scan"]["h"] for r in got], axis=-2),
        want.cpu(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The minRNN mixer in the MoE trunks: deepseek-v3-671b's width, and a row
# of the swapped deepseek-moe-16b independent of B
# ---------------------------------------------------------------------------

# deepseek-v3-671b's d_model: the cell's Dx = Dh past the tensor-core
# decode body's Dx limit (4096), so its step takes the CUDA-core body in
# bf16 too; the fused kernel's 96-column tiles leave a ragged last one
V3_D = 7168


def test_cell_step_at_deepseek_v3_width_matches_plain(cuda_device):
    """B 8 x Dx 7168 x Dh 7168 (7168 terms in each gate's sum) on the
    CUDA-core body, bf16 and fp32, against the plain version, and a row
    launched alone equal to its row of the batch bit for bit.  In fp32
    the 8 rows of x do not fit the body's shared memory whole (binding
    once refused, naming Dx 7136): they are staged in three K slices of
    2432 columns (two blocks an SM), and
    a C-token chunk equals C step launches bit for bit."""
    gen = torch.Generator().manual_seed(7)
    for dtype in (torch.bfloat16, torch.float32):
        x, h, *wb = _cell_case(gen, "mingru", dtype, cuda_device, 8, V3_D,
                               V3_D, 3)
        step_ops.reset_launches()
        got = step_ops.fused_mingru_step(x[:, 0], *wb, h)
        _close(got, step_ref.mingru_step_ref(x[:, 0], *wb, h), dtype)
        assert torch.equal(step_ops.fused_mingru_step(x[3:4, 0], *wb,
                                                      h[3:4]), got[3:4])
        assert step_ops.LAUNCHES["mingru_step_kernel/cuda_core"] == 2
        if dtype == torch.float32:
            valid = torch.tensor([3, 1, 2, 3, 3, 2, 1, 3], dtype=torch.int32,
                                 device=cuda_device)
            hs = step_ops.fused_mingru_chunk(x, *wb, h, valid)
            _close(hs, step_ref.mingru_chunk_ref(x, *wb, h, valid), dtype)
            s_h = h
            for t in range(3):
                st = step_ops.fused_mingru_step(x[:, t].contiguous(), *wb,
                                                s_h)
                s_h = torch.where((t < valid)[:, None], st, s_h)
                assert torch.equal(hs[:, t], s_h), t


@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
def test_cell_step_bf16_at_dx_16384_matches_plain(cell, cuda_device):
    """bf16 past the widest x tile the CUDA-core body holds whole (14272):
    B 8 x Dx 16384 x Dh 64, x in three K slices of 5504 columns (two
    blocks an SM), against the plain version,
    a row alone bit-equal to its row of the batch."""
    gen = torch.Generator().manual_seed(8)
    x, h, *wb = _cell_case(gen, cell, torch.bfloat16, cuda_device, 8,
                           16384, 64, 1)
    step, _, plain, _, kw = _cell_fns(cell, True)
    step_ops.reset_launches()
    got = step(x[:, 0], *wb, h, **kw)
    _close(got, plain(x[:, 0], *wb, h, **kw), torch.bfloat16)
    assert torch.equal(step(x[5:6, 0], *wb, h[5:6], **kw), got[5:6])
    assert step_ops.LAUNCHES[f"{cell}_step_kernel/cuda_core"] == 2


@pytest.mark.parametrize("body_dtype", [torch.float32, torch.bfloat16])
def test_cell_step_past_65535_batch_tiles(body_dtype, cuda_device):
    """B 524,296 (65,537 tiles of 8: one launch of 65,535 tiles and one of
    the rest) at Dx 16, Dh 16 (bf16: the tensor-core body) against the
    plain version; the last rows launched alone bit-equal; the count
    holds the kernel launches, 2 + 1."""
    gen = torch.Generator().manual_seed(9)
    bsz = 65537 * 8
    x, h, *wb = _cell_case(gen, "mingru", body_dtype, cuda_device, bsz, 16,
                           16, 1)
    step_ops.reset_launches()
    got = step_ops.fused_mingru_step(x[:, 0], *wb, h)
    _close(got, step_ref.mingru_step_ref(x[:, 0], *wb, h), body_dtype)
    tail = step_ops.fused_mingru_step(x[-9:, 0].contiguous(), *wb,
                                      h[-9:].contiguous())
    assert torch.equal(tail, got[-9:])
    assert step_ops.LAUNCHES["mingru_step_kernel"] == 3


@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_and_scan_kernels_at_b_65544(cell, dtype, cuda_device):
    """B 65,544, past grid.y's 65,535 rows: the fused layer (T 3, Dx 32,
    Dh 64) and the linear and log scans (T 5, D 40) against their plain
    versions, a row alone bit-equal to its row of the batch."""
    gen = torch.Generator().manual_seed(10)
    bsz = 65544
    ins = [v.detach() for v in _fused_case(gen, cell, dtype, cuda_device,
                                           bsz, 3, 32, 64)]
    fn, plain, _ = _fused_fns(cell, "log")
    got = fn(*ins)
    _close(got, plain(*ins), dtype)
    alone = fn(ins[0][-1:].contiguous(), *ins[1:-1],
               ins[-1][-1:].contiguous())
    assert torch.equal(alone, got[-1:])
    for kind in ("linear", "log"):
        sins = scan_ref.inputs(gen, kind, dtype, (bsz, 5, 40), False,
                               cuda_device)
        kfn, splain, _ = _scan_fns(kind, False)
        out = kfn(*sins)
        _close(out, splain(*sins),
               dtype if kind == "linear" else torch.float32)
        assert torch.equal(kfn(*(v[-1:].contiguous() for v in sins)),
                           out[-1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_and_grads_at_deepseek_v3_width(dtype, cuda_device):
    """The fused minGRU layer at B 2 x T 130 x Dx 7168 x Dh 7168 (bf16:
    the tensor-core body, 74 whole column tiles of 96 and a last of 64;
    T over two 128-row chunks): forward and gradients against the plain
    version."""
    gen = torch.Generator().manual_seed(8)
    ins = _fused_case(gen, "mingru", dtype, cuda_device, 2, 130, V3_D, V3_D)
    fn, plain, mod = _fused_fns("mingru", "log")
    body = "tc" if dtype == torch.bfloat16 else "cuda_core"
    mod.reset_launches()
    out = fn(*ins)
    assert mod.LAUNCHES[f"fused_mingru_kernel/{body}"] == 1
    want = plain(*ins)
    _close(out, want, dtype)
    ct = torch.randn(out.shape, generator=gen).to(dtype).to(cuda_device)
    for g, w in zip(torch.autograd.grad(out, ins, ct),
                    torch.autograd.grad(want, ins, ct)):
        assert _rel_err(g, w) < GRAD_TOL[dtype]


@pytest.mark.parametrize("mixer", ["mingru", "minlstm"])
def test_moe_swap_decode_row_is_independent_of_batch(mixer, cuda_device):
    """The smoke deepseek-moe-16b with ``mixer`` in place of attention, in
    bf16 on the card at its no-drop capacity: a row decoded in a batch of
    8 (the cell one launch over all rows, norms and products in a tile of
    8, the MoE routing all 8) equals the row decoded alone (one row
    padded to a tile), logits and ``h``, bit for bit, 6 steps; one cell
    launch a layer a step."""
    cfg = archs.smoke("deepseek-moe-16b").replace(
        seq_mixer=mixer, param_dtype="bfloat16", compute_dtype="bfloat16")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = lm.init_params(gen, cfg, device=cuda_device)
    layers = lm.bind_layers(params, cfg)
    toks = torch.randint(0, cfg.vocab_size, (8, 6), generator=torch.
                         Generator().manual_seed(7)).to(cuda_device)
    c8 = lm.init_cache(cfg, 8, 16, cuda_device)
    c1 = lm.init_cache(cfg, 1, 16, cuda_device)
    step_ops.reset_launches()
    for t in range(toks.shape[1]):
        l8, c8 = lm.decode_step(params, cfg, toks[:, t], c8, layers=layers)
        l1, c1 = lm.decode_step(params, cfg, toks[3:4, t], c1,
                                layers=layers)
        assert torch.equal(l8[3:4], l1), t
    assert torch.equal(c8["h"][:, 3:4], c1["h"])
    name = f"{mixer}_step_kernel"
    assert step_ops.LAUNCHES[name] == step_ops.LAUNCHES[f"{name}/tc"] \
        == 2 * 6 * cfg.n_layers


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_dryrun_production_cell_on_fake_cuda(shape, cuda_device):
    """The dry run of mingru-lm on the 16x16 production mesh, fake CUDA
    tensors of rank 0 of a fake 256-rank world: the kernels' shape-only
    route shows in ``kernels`` (train: two fused-cell and one reversed
    scan a layer, counting the remat's forward; decode under serving TP:
    the cell tier, one step kernel a layer), no ``LAUNCHES`` move, and
    the collectives of the mesh are recorded."""
    from repro_torch.launch import dryrun
    cfg = archs.get("mingru-lm")
    before = {**gru_ops.LAUNCHES, **scan_ops.LAUNCHES, **step_ops.LAUNCHES,
              **ops.LAUNCHES}
    rec = dryrun.run_cell("mingru-lm", shape, "single", verbose=False)
    after = {**gru_ops.LAUNCHES, **scan_ops.LAUNCHES, **step_ops.LAUNCHES,
             **ops.LAUNCHES}
    assert before == after
    assert rec["ok"] and rec["n_devices"] == 256 and rec["fits"]
    kernels = {k: v["launches"] for k, v in rec["kernels"].items()}
    n = cfg.n_layers
    if shape == "train_4k":
        assert kernels == {"fused_mingru_kernel": 2 * n,
                           "linear_scan_kernel": n}
    else:
        assert kernels == {"mingru_step_kernel": n}
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert rec["flops_per_dev"] > rec["flops_ops"] > 0
