"""Tests of the port that need an NVIDIA GPU (marker ``gpu``).

They skip without one.  On the card, from the repository root:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs on a machine that has only PyTorch.
The kernels are built from source by their first call.  Tolerances are
those of ``chip_smoke.py``: fp32 1e-4 (the same arithmetic summed in
another order), bf16 atol 6e-2 / rtol 2e-2 (same cast points, a sum
landing on the neighbouring bf16 value).
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.configs import archs
from repro_torch.kernels.block_step import ops, ref
from repro_torch.models import lm
from repro_torch.serving.engine import ServingEngine, generate_one

pytestmark = pytest.mark.gpu

DX, DH, DM, K = 64, 128, 256, 4
GATES = {"mingru": ("wz", "wh"), "minlstm": ("wf", "wi", "wh")}
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (6e-2, 2e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _params(gen, cell, dtype, dev):
    def w(shape):
        return (torch.randn(shape, generator=gen) / shape[0] ** 0.5).to(dtype)

    def v(n):
        return (0.1 * torch.randn(n, generator=gen)).to(dtype)

    p = {"norm_rnn": {"scale": (1.0 + v(DX)).to(dtype)},
         "rnn": {g: {"kernel": w((DX, DH)), "bias": v(DH)}
                 for g in GATES[cell]},
         "down": {"kernel": w((DH, DX))},
         "conv": {"kernel": w((K, DX)), "bias": v(DX)},
         "norm_mlp": {"scale": (1.0 + v(DX)).to(dtype)},
         "mlp_in": {"kernel": w((DX, DM)), "bias": v(DM)},
         "mlp_out": {"kernel": w((DM, DX)), "bias": v(DX)}}
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
