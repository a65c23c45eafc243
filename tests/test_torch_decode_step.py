"""Port parity for the cell-fused decode tier: the ``decode_step`` plain
versions, the cells' fused step forms, the block's cell tier and the
minRNN LMs served with ``fuse_block="off"``.

Inputs are made from a seed with numpy and go through both packages.  The
JAX side runs its ``decode_step`` Pallas kernels in interpret mode (the
CPU default of ``repro.kernels.decode_step.ops``), the port the kernels'
plain versions (CPU tensors).  Tolerance: fp32 at atol = rtol = 1e-5 (the
same arithmetic, matmuls summed in another order).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.core import blocks as jax_blocks
from repro.core import min_gru as jax_gru
from repro.core import min_lstm as jax_lstm
from repro.kernels.decode_step import ops as jax_ops
from repro.kernels.decode_step import ref as jax_ref
from repro.models import lm as jax_lm
from repro.serving import engine as jax_engine
from repro_torch import bridge
from repro_torch.configs import archs as pt_archs
from repro_torch.core import blocks as pt_blocks
from repro_torch.core import min_gru as pt_gru
from repro_torch.core import min_lstm as pt_lstm
from repro_torch.kernels.decode_step import ops as pt_ops
from repro_torch.kernels.decode_step import ref as pt_ref
from repro_torch.models import lm as pt_lm
from repro_torch.serving import engine as pt_engine

TOL = 1e-5
B, C, DX, DH = 3, 4, 40, 72            # ragged: DX, DH and B off every tile
VALID = np.asarray([4, 1, 3], np.int32)
CELLS = [("mingru", True), ("minlstm", True), ("minlstm", False)]


def _close(want, got):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def _inputs(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def a(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    ws = [a(DX, DH, s=scale * DX ** -0.5) for _ in range(3)]
    bs = [a(DH, s=0.1) for _ in range(3)]
    return a(B, DX), a(B, C, DX), a(B, DH, s=0.5), ws, bs


def _call(mod, cell, chunk, normalize, x, h, ws, bs, mode, valid=None):
    """One of the four functions of ``mod`` (the JAX ops / refs or the
    port's) on the cell's weights."""
    n = 2 if cell == "mingru" else 3
    wb = [t for pair in zip(ws[:n], bs[:n]) for t in pair]
    name = f"{cell}_{'chunk' if chunk else 'step'}"
    fn = getattr(mod, f"fused_{name}", None) or getattr(mod, f"{name}_ref")
    kw = {"mode": mode}
    if cell == "minlstm":
        kw["normalize"] = normalize
    args = (x, *wb, h) + ((valid,) if chunk else ())
    return fn(*args, **kw)


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


@pytest.mark.parametrize("mode", ["log", "linear"])
@pytest.mark.parametrize("cell,normalize", CELLS)
def test_step_plain_version_matches_jax(cell, normalize, mode):
    x, _, h, ws, bs = _inputs(0)
    want_ops = _call(jax_ops, cell, False, normalize, x, h, ws, bs, mode)
    want_ref = _call(jax_ref, cell, False, normalize, x, h, ws, bs, mode)
    tx, th = _torch(x, h)
    tws, tbs = _torch(*ws), _torch(*bs)
    got_ref = _call(pt_ref, cell, False, normalize, tx, th, tws, tbs, mode)
    got_ops = _call(pt_ops, cell, False, normalize, tx, th, tws, tbs, mode)
    for want in (want_ops, want_ref):
        _close(want, got_ref)
    assert torch.equal(got_ops, got_ref)       # CPU: the plain version
    # a missing bias means zeros, in both packages
    nb = [None] * 3
    _close(_call(jax_ops, cell, False, normalize, x, h, ws, nb, mode),
           _call(pt_ops, cell, False, normalize, tx, th, tws, nb, mode))


@pytest.mark.parametrize("mode", ["log", "linear"])
@pytest.mark.parametrize("cell,normalize", CELLS)
def test_chunk_plain_version_matches_jax_and_steps(cell, normalize, mode):
    _, xc, h, ws, bs = _inputs(1)
    want = _call(jax_ops, cell, True, normalize, xc, h, ws, bs, mode, VALID)
    _close(_call(jax_ref, cell, True, normalize, xc, h, ws, bs, mode, VALID),
           torch.from_numpy(np.array(want)))
    txc, th, tv = _torch(xc, h, VALID)
    tws, tbs = _torch(*ws), _torch(*bs)
    got = _call(pt_ops, cell, True, normalize, txc, th, tws, tbs, mode, tv)
    assert got.shape == (B, C, DH)
    _close(want, got)
    # a chunk equals C plain steps, bit for bit; frozen rows re-emit
    hs = th
    for t in range(C):
        step = _call(pt_ref, cell, False, normalize, txc[:, t], hs, tws, tbs,
                     mode)
        hs = torch.where(torch.from_numpy(t < VALID)[:, None], step, hs)
        assert torch.equal(got[:, t], hs)
    for b in range(B):
        for t in range(VALID[b], C):
            assert torch.equal(got[b, t], got[b, VALID[b] - 1])


def test_chunk_takes_leading_batch_dims():
    _, xc, h, ws, bs = _inputs(2)
    txc, th, tv = _torch(xc, h, VALID)
    tws, tbs = _torch(*ws), _torch(*bs)
    flat = _call(pt_ops, "mingru", True, True, txc, th, tws, tbs, "log", tv)
    lead = pt_ops.fused_mingru_chunk(
        txc[None], tws[0], tbs[0], tws[1], tbs[1], th[None], tv[None])
    assert lead.shape == (1, B, C, DH)
    assert torch.equal(lead[0], flat)


@pytest.mark.parametrize("scale", [80.0, 400.0])
def test_saturated_minlstm_gates_stay_finite(scale):
    """|k| ~ 80 and beyond: the naive f/(f+i) is 0/0 there."""
    x, xc, h, ws, bs = _inputs(3, scale=scale)
    tx, txc, th, tv = _torch(x, xc, h, VALID)
    tws, tbs = _torch(*ws), _torch(*bs)
    for chunk, xin, txin in ((False, x, tx), (True, xc, txc)):
        want = _call(jax_ref, "minlstm", chunk, True, xin, h, ws, bs, "log",
                     VALID if chunk else None)
        got = _call(pt_ops, "minlstm", chunk, True, txin, th, tws, tbs, "log",
                    tv if chunk else None)
        assert bool(torch.isfinite(got).all())
        assert np.isfinite(np.asarray(want)).all()
        _close(want, got)


# ---------------------------------------------------------------------------
# the kernel body a bound cell runs, and the per-body launch counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell,dtype,dx,dh,aligned,body", [
    ("mingru", torch.bfloat16, 768, 1536, True, "tc"),       # mingru-lm
    ("mingru", torch.bfloat16, 2048, 2048, True, "tc"),      # gemma-2b-mingru
    ("mingru", torch.bfloat16, 40, 72, True, "tc"),          # K, Dh tails
    ("mingru", torch.bfloat16, 4096, 8, True, "tc"),         # widest Dx
    ("mingru", torch.bfloat16, 4104, 1536, True, "cuda_core"),
    ("mingru", torch.bfloat16, 37, 72, True, "cuda_core"),   # Dx % 8
    ("mingru", torch.bfloat16, 64, 70, True, "cuda_core"),   # Dh % 8
    ("mingru", torch.bfloat16, 768, 1536, False, "cuda_core"),
    ("mingru", torch.float32, 768, 1536, True, "cuda_core"),  # exact path
    ("minlstm", torch.bfloat16, 768, 1536, True, "tc"),      # minlstm-lm
    ("minlstm", torch.bfloat16, 764, 1536, True, "cuda_core"),  # Dx % 8
    ("minlstm", torch.bfloat16, 768, 1536, False, "cuda_core"),
    ("minlstm", torch.float32, 768, 1536, True, "cuda_core"),  # exact path
    ("minlstm", torch.float32, 2048, 2048, True, "cuda_core"),
    # past the widest 8 rows of x the CUDA-core body's shared memory holds
    # (7136 fp32, 14272 bf16): x in K slices, the same body
    ("mingru", torch.float32, 7168, 7168, True, "cuda_core"),
    ("mingru", torch.bfloat16, 7168, 7168, True, "cuda_core"),
    ("minlstm", torch.float32, 16384, 16384, True, "cuda_core"),
    ("mingru", torch.bfloat16, 16384, 16384, True, "cuda_core")])
def test_cell_body_routes_by_cell_dtype_widths_and_alignment(
        cell, dtype, dx, dh, aligned, body):
    """The tensor-core body takes bf16 minGRU and minLSTM whose widths
    are multiples of 8 (Dx up to the shared-memory limit) and whose
    weights allow 16-byte copies; everything else runs on the CUDA
    cores, at any width.  The rule reads neither x nor C."""
    assert pt_ops.cell_body(cell, dtype, dx, dh, aligned) == body
    assert pt_ops.TC_MAX_DX == 4096


def test_cell_body_refuses_an_unknown_cell():
    with pytest.raises(ValueError, match="unknown cell"):
        pt_ops.cell_body("gru", torch.bfloat16, 768, 1536, True)


def test_launch_counts_name_each_kernel_and_body():
    assert set(pt_ops.LAUNCHES) == set(pt_ops.KERNELS) | {
        f"{k}/{b}" for k in pt_ops.KERNELS for b in ("tc", "cuda_core")}
    assert pt_ops.BODIES == ("cuda_core", "tc")     # the C launcher's codes
    pt_ops.LAUNCHES["mingru_step_kernel/tc"] = 3
    pt_ops.reset_launches()
    assert set(pt_ops.LAUNCHES.values()) == {0}


def test_cpu_calls_run_the_plain_versions_and_count_nothing():
    x, xc, h, ws, bs = _inputs(4)
    tx, txc, th, tv = _torch(x, xc, h, VALID)
    tws, tbs = _torch(*ws), _torch(*bs)
    pt_ops.reset_launches()
    for cell in ("mingru", "minlstm"):
        _call(pt_ops, cell, False, True, tx, th, tws, tbs, "log")
        _call(pt_ops, cell, True, True, txc, th, tws, tbs, "log", tv)
    assert set(pt_ops.LAUNCHES.values()) == {0}
    assert pt_ops._LIB is None
    with pytest.raises(ValueError, match="CUDA"):
        pt_ops.CellOperands("mingru", tws[:2], tbs[:2])


# ---------------------------------------------------------------------------
# the cells' decode forms under "auto"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
def test_cell_step_and_chunk_auto_match_jax(cell):
    jmod, pmod = (jax_gru, pt_gru) if cell == "mingru" else \
        (jax_lstm, pt_lstm)
    jp = jmod.init(jax.random.PRNGKey(4), DX, DH)
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x, xc, h, _, _ = _inputs(5)
    tx, txc, th, tv = _torch(x, xc, h, VALID)
    _close(jmod.step(jp, x, h, scan_strategy="auto"),
           pmod.step(pp, tx, th, scan_strategy="auto"))
    want = jmod.step_chunk(jp, xc, h, VALID, scan_strategy="auto")
    got = pmod.step_chunk(pp, txc, th, tv, scan_strategy="auto")
    _close(want, got)


# ---------------------------------------------------------------------------
# the block's cell tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
def test_block_cell_tier_matches_jax(cell):
    kw = dict(d_model=32, cell=cell, expansion=2.0, use_conv=True,
              use_mlp=True, fuse_block="off")
    jcfg = jax_blocks.MinRNNBlockConfig(**kw)
    pcfg = pt_blocks.MinRNNBlockConfig(**kw)
    assert pt_blocks.fuse_block_tier(pcfg) == "cell-fused"
    jp = jax_blocks.init(jax.random.PRNGKey(6), jcfg)
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert pt_blocks.bind(pp, pcfg) is None      # CPU: nothing to bind
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, C, 32)).astype(np.float32)
    st = {"h": (0.5 * rng.standard_normal((B, 64))).astype(np.float32),
          "conv": rng.standard_normal((B, 3, 32)).astype(np.float32)}
    pst = {k: torch.from_numpy(v) for k, v in st.items()}
    jy, js = jax_blocks.step(jp, jcfg, x[:, 0], st)
    py, ps = pt_blocks.step(pp, pcfg, torch.from_numpy(x[:, 0]), pst)
    _close(jy, py)
    for k in st:
        _close(js[k], ps[k])
    jy, js, jpos = jax_blocks.step_chunk(jp, jcfg, x, st, VALID,
                                         return_positions=True)
    py, ps, ppos = pt_blocks.step_chunk(pp, pcfg, torch.from_numpy(x), pst,
                                        torch.from_numpy(VALID),
                                        return_positions=True)
    for b in range(B):              # positions past valid are the caller's
        _close(np.asarray(jy)[b, :VALID[b]], py[b, :VALID[b]])
    for k in st:
        _close(js[k], ps[k])
        _close(jpos[k], ppos[k])


# ---------------------------------------------------------------------------
# the LMs on the cell tier
# ---------------------------------------------------------------------------

ARCHS = ("mingru-lm", "minlstm-lm")
MAX_LEN = 40
PROMPTS = ([5, 17, 200, 3], [9], [250, 1, 2, 3, 4, 5, 6], [42, 42])
MAX_NEW = (5, 4, 3, 6)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = jax_archs.smoke(arch).replace(fuse_block="off")
    pcfg = pt_archs.smoke(arch).replace(fuse_block="off")
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    refs = tuple(tuple(jax_engine.generate_one(jcfg, jparams, p, max_new=m,
                                               max_len=MAX_LEN))
                 for p, m in zip(PROMPTS, MAX_NEW))
    return jcfg, pcfg, jparams, pparams, refs


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_tier_decode_step_and_chunk_match_jax(arch):
    jcfg, pcfg, jparams, pparams, _ = _setup(arch)
    assert pt_lm.kernel_tier(pcfg) == "cell-fused"
    rng = np.random.default_rng(8)
    jc = jax_lm.init_cache(jcfg, B, 16)
    pc = pt_lm.init_cache(pcfg, B, 16, device="cpu")
    step = jax.jit(lambda p, t, c: jax_lm.decode_step(p, jcfg, t, c))
    for _ in range(3):
        t = rng.integers(0, 256, size=(B,)).astype(np.int32)
        jl, jc = step(jparams, jnp.asarray(t), jc)
        pl, pc = pt_lm.decode_step(pparams, pcfg, torch.from_numpy(t), pc)
        _close(jl, pl)
    toks = rng.integers(0, 256, size=(B, C)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t, v, c: jax_lm.decode_chunk(
        p, jcfg, t, v, c))(jparams, jnp.asarray(toks), jnp.asarray(VALID), jc)
    pl, pc = pt_lm.decode_chunk(pparams, pcfg, torch.from_numpy(toks),
                                torch.from_numpy(VALID), pc)
    _close(jl, pl)
    for k in ("h", "conv"):
        _close(jc[k], pc[k])


def _serve(pcfg, pparams, k, c):
    eng = pt_engine.ServingEngine(pcfg, pparams, max_batch=2,
                                  max_len=MAX_LEN, decode_block=k,
                                  prompt_chunk=c, device="cpu")
    rids = [eng.submit(p, max_new=m) for p, m in zip(PROMPTS, MAX_NEW)]
    outs = eng.run_to_completion()
    assert eng.stats.shard_identities_ok()
    return eng, tuple(tuple(outs[r]) for r in rids)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("c", [1, 4])
def test_cell_tier_engine_streams_equal_jax_generate_one(arch, k, c):
    _, pcfg, _, pparams, refs = _setup(arch)
    eng, streams = _serve(pcfg, pparams, k, c)
    assert eng.kernel_tier == "cell-fused"
    assert streams == refs
    assert eng.stats.prefill_rounds == sum(-(-len(p) // c) for p in PROMPTS)


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_tier_streams_equal_block_tier_streams(arch):
    """The reference's contract: the tier changes no greedy token."""
    _, pcfg, _, pparams, refs = _setup(arch)
    block_cfg = pcfg.replace(fuse_block="auto")
    assert pt_lm.kernel_tier(block_cfg) == "block-fused"
    _, block = _serve(block_cfg, pparams, 2, 4)
    assert block == _serve(pcfg, pparams, 2, 4)[1] == refs
