"""The port stands alone: no JAX, no ``repro`` imports, no quiet CPU
fallback when CUDA is asked for, and no kernel launch counted for CPU
tensors."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import archs
from repro_torch.core import blocks
from repro_torch.kernels.block_step import ops as block_ops
from repro_torch.kernels.decode_step import ops as step_ops
from repro_torch.kernels.fused_mingru import ops as gru_ops
from repro_torch.kernels.fused_minlstm import ops as lstm_ops
from repro_torch.kernels.scan import ops as scan_ops
from repro_torch.models import lm
from repro_torch.serving import engine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py")


def _need_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_importing_the_port_loads_no_jax():
    assert {"repro_torch.serving.draft", "repro_torch.models.lm",
            "repro_torch.models.encdec",
            "repro_torch.serving.engine", "repro_torch.serving.tuning",
            "repro_torch.serving.faults", "repro_torch.serving.recovery",
            "repro_torch.serving.autotune"} <= set(MODULES)
    code = ("import sys, importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


def test_port_sources_import_neither_jax_nor_repro():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 4
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples \
        + [ROOT / "tests" / "torch_mesh_ranks.py",
           ROOT / "tests" / "torch_train_ranks.py"]
    assert len(files) > 10
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, (path, hits)


def test_cuda_request_without_cuda_raises():
    _need_no_cuda()
    cfg = archs.smoke("mingru-lm")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_params(gen, cfg)                 # device defaults to cuda
    params = lm.init_params(gen, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        engine.ServingEngine(cfg, params, max_batch=2, max_len=16)
    with pytest.raises(RuntimeError, match="cuda"):
        engine.generate_one(cfg, params, [1, 2], max_new=2, max_len=16)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_cache(cfg, 2, 16)
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--smoke", "--steps", "1"])   # --device defaults to cuda


def test_kernel_launcher_refuses_cpu_tensors():
    # the launch path binds its weights first, and binding refuses CPU ones
    bc = blocks.MinRNNBlockConfig(d_model=32, expansion=2.0)
    params = blocks.init(torch.Generator().manual_seed(0), bc)
    with pytest.raises(ValueError, match="CUDA"):
        block_ops.BlockOperands(params, cell="mingru", compute_dtype=None,
                                use_conv=False, use_mlp=False)
    assert blocks.bind(params, bc) is None     # on the CPU: nothing to bind
    # the raw launchers check their operands before building anything
    x = torch.zeros((2, 5, 4))
    w, b, h0 = torch.zeros((4, 6)), torch.zeros((6,)), torch.zeros((2, 6))
    with pytest.raises(ValueError, match="CUDA"):
        gru_ops.launch(x, w, b, w, b, h0)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_ops.launch(x, w, b, w, b, w, b, h0)
    with pytest.raises(ValueError, match="CUDA"):
        scan_ops.launch_linear_scan(x, x, h0[:, :4])
    with pytest.raises(ValueError, match="CUDA"):
        scan_ops.launch_log_scan(x, x, h0[:, :4])
    assert gru_ops.LAUNCHES["fused_mingru_kernel"] == 0
    # the cell-only decode kernels bind their weights the same way
    with pytest.raises(ValueError, match="CUDA"):
        step_ops.CellOperands("mingru", (w, w), (b, None))
    cell_cfg = blocks.MinRNNBlockConfig(d_model=32, fuse_block="off")
    assert blocks.bind(blocks.init(torch.Generator().manual_seed(0),
                                   cell_cfg), cell_cfg) is None


def test_cpu_serving_launches_no_kernel():
    cfg = archs.smoke("minlstm-lm")
    params = lm.init_params(torch.Generator().manual_seed(1), cfg,
                            device="cpu")
    block_ops.reset_launches()
    step_ops.reset_launches()
    for fuse_block in ("auto", "off"):
        eng = engine.ServingEngine(cfg, params, max_batch=2, max_len=32,
                                   decode_block=2, prompt_chunk=3,
                                   fuse_block=fuse_block, device="cpu")
        eng.submit([1, 2, 3, 4], max_new=3)
        eng.submit([5], max_new=2)
        eng.run_to_completion()
        assert eng.stats.completed == 2
    assert block_ops.LAUNCHES == {"block_step_kernel": 0,
                                  "block_chunk_kernel": 0}
    assert set(step_ops.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("kw", [
    {"mesh": "1x2"}, {"mesh": "2x1"}, {"faults": "seeded"},
    {"recover_dir": "journal"}, {"tune": "auto"}])
def test_left_out_features_raise_not_implemented(kw, tmp_path):
    """Every serving feature of the engine is ported now.  A serving mesh
    needs a world of its size, one process per rank: outside one it
    raises, naming the launcher's ``--mesh`` and ``torchrun`` (no quiet
    one-device fallback).  Fault injection, crash recovery and tune
    plans construct, and on the CPU the tune plans of the JAX package at
    the repo root are not picked up."""
    cfg = archs.smoke("mingru-lm")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    if "mesh" in kw:
        with pytest.raises(RuntimeError, match="torchrun"):
            engine.ServingEngine(cfg, params, max_batch=2, max_len=16,
                                 device="cpu", **kw)
        return
    from repro_torch.serving.faults import FaultInjector
    made = {"faults": FaultInjector(seed=0),
            "recover_dir": str(tmp_path / "journal"), "tune": "auto"}
    key = next(iter(kw))
    eng = engine.ServingEngine(cfg, params, max_batch=2, max_len=16,
                               device="cpu", **{key: made[key]})
    assert eng.tune_plan is None
    assert (eng.faults is not None) == (key == "faults")
    assert (eng.journal is not None) == (key == "recover_dir")
