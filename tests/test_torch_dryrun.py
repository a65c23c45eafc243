"""The port's multi-pod dry run (``launch/{dryrun,hlo_analysis,
input_specs,mesh}.py``) against the reference's shape-only trees, and
its counts against ``FlopCounterMode``.

* ``n_params`` equals JAX ``input_specs.n_params`` for every arch at full
  depth, and the params / train / prefill / decode spec trees equal JAX's
  ``eval_shape`` trees leaf for leaf (path, shape, dtype) at a cut depth.
* Each of the ten kernel wrappers' shape-only route, on fake CUDA
  operands (this CPU build makes them from factories), returns the
  plain version's output shape and dtype, loads no library, counts no
  ``LAUNCHES``, and records work whose FLOPs equal ``FlopCounterMode``'s
  count of the plain version at the same shapes.
* The dry run over a fake (2, 2, 2) world (pod folded into 4 data ranks,
  2 model ranks) completes for the reference's tiny-dry-run archs
  (``tests/test_spmd.py``) at a tiny train and a tiny decode shape, with
  FLOPs > 0 and the mesh's collectives; at 1x1 its FLOPs equal
  ``FlopCounterMode`` over the same step run for real on the CPU.

Whole steps are traced on fake CPU tensors: a CPU-only build of PyTorch
refuses ``.to("cuda")`` even for a fake tensor, so the card's fake
``cuda`` trace runs in ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import archs as jax_archs
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.launch import input_specs as jax_specs
from repro_torch.configs import archs as pt_archs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.kernels import launch as kl
from repro_torch.kernels.block_step import ops as block_ops
from repro_torch.kernels.decode_step import ops as step_ops
from repro_torch.kernels.fused_mingru import ops as gru_ops
from repro_torch.kernels.fused_minlstm import ops as lstm_ops
from repro_torch.kernels.scan import ops as scan_ops
from repro_torch.launch import dryrun, hlo_analysis, input_specs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_step as ts_lib
from repro_torch.tree import leaves_with_path

ALL = jax_archs.ASSIGNED + jax_archs.PAPER_OWN + jax_archs.EXTRAS


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(str(getattr(p, "key", p)) for p in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _pt_leaves(tree):
    return {path: (tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
            for path, leaf in leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ALL)
def test_n_params_equals_the_reference(arch):
    assert input_specs.n_params(pt_archs.get(arch)) == \
        jax_specs.n_params(jax_archs.get(arch))


def _cut(cfg):
    """Full width, the fewest layers that keep every kind of layer."""
    if cfg.family == "encdec":
        return cfg.replace(n_layers=1, n_encoder_layers=1)
    if cfg.block_kind == "hybrid":
        return cfg.replace(n_layers=cfg.hybrid_attn_every)
    if cfg.moe and cfg.moe.first_dense_layers:
        return cfg.replace(n_layers=cfg.moe.first_dense_layers + 1)
    return cfg.replace(n_layers=1)


@pytest.mark.parametrize("arch", ALL)
def test_spec_trees_equal_the_reference(arch):
    jcfg, pcfg = _cut(jax_archs.get(arch)), _cut(pt_archs.get(arch))
    with FakeTensorMode():
        for name, fn in (("params", None), ("train", "train_specs"),
                         ("prefill", "prefill_specs"),
                         ("decode", "decode_specs")):
            if fn is None:
                want = jax_specs.params_specs(jcfg)
                got = input_specs.params_specs(pcfg, "cpu")
            else:
                shape = {"train": "train_4k", "prefill": "prefill_32k",
                         "decode": "decode_32k"}[name]
                want = getattr(jax_specs, fn)(jcfg, JAX_SHAPES[shape])
                got = getattr(input_specs, fn)(pcfg, SHAPES[shape], "cpu")
            assert _pt_leaves(got) == _jax_leaves(want), (arch, name)


# ---------------------------------------------------------------------------
# the kernels' shape-only route
# ---------------------------------------------------------------------------

def _cell_case(cell, chunk):
    gates = step_ops.GATES[cell]
    b, dx, dh, c = 3, 40, 24, 4

    def make(dev, dt=torch.float32):
        g = torch.Generator().manual_seed(0)
        wb = []
        for _ in gates:
            wb += [torch.randn((dx, dh), generator=g).to(dev),
                   torch.randn((dh,), generator=g).to(dev)]
        if chunk:
            x = torch.randn((b, c, dx), generator=g).to(dev)
            valid = torch.tensor([4, 1, 2], dtype=torch.int32).to(dev)
            return (x, *wb, torch.randn((b, dh), generator=g).to(dev),
                    valid)
        return (torch.randn((b, dx), generator=g).to(dev), *wb,
                torch.randn((b, dh), generator=g).to(dev))

    fn = getattr(step_ops, f"fused_{cell}_{'chunk' if chunk else 'step'}")
    return fn, make


def _fake_like(args):
    return tuple(torch.empty(a.shape, dtype=a.dtype, device="cuda")
                 if isinstance(a, torch.Tensor) else a for a in args)


def _scan_case(kind):
    b, t, d = 2, 9, 5
    g = torch.Generator().manual_seed(0)
    a = torch.rand((b, t, d), generator=g)
    bb = torch.randn((b, t, d), generator=g)
    if kind == "linear":
        return scan_ops.linear_scan_kernel, (a, bb, torch.zeros(b, d))
    return scan_ops.log_scan_kernel, (a.log(), bb, torch.full(
        (b, d), float("-inf")))


def _fused_case(cell):
    b, t, dx, dh = 2, 7, 12, 8
    g = torch.Generator().manual_seed(0)
    n = 2 if cell == "mingru" else 3
    wb = []
    for _ in range(n):
        wb += [torch.randn((dx, dh), generator=g), torch.randn(dh,
                                                                 generator=g)]
    x = torch.randn((b, t, dx), generator=g)
    h0 = torch.randn((b, dh), generator=g)
    if cell == "mingru":
        return gru_ops.fused_mingru_kernel, (x, *wb, h0)
    return lstm_ops.fused_minlstm_kernel, (x, *wb, h0)


def _block_params(cell, dx=16, dh=24, dm=32, k=4):
    g = torch.Generator().manual_seed(1)

    def r(*s):
        return torch.randn(s, generator=g)

    return {"norm_rnn": {"scale": r(dx)},
            "rnn": {n: {"kernel": r(dx, dh), "bias": r(dh)}
                    for n in step_ops.GATES[cell]},
            "down": {"kernel": r(dh, dx)},
            "conv": {"kernel": r(k, dx), "bias": r(dx)},
            "norm_mlp": {"scale": r(dx)},
            "mlp_in": {"kernel": r(dx, dm), "bias": r(dm)},
            "mlp_out": {"kernel": r(dm, dx), "bias": r(dx)}}


def _block_call(chunk):
    b, c, dx, dh, k = 3, 4, 16, 24, 4
    kw = dict(cell="mingru", use_conv=True, use_mlp=True)

    def call(dev):
        params = _block_params("mingru")
        g = torch.Generator().manual_seed(2)
        state = {"h": torch.randn((b, dh), generator=g),
                 "conv": torch.randn((b, k - 1, dx), generator=g)}
        x = torch.randn((b, c, dx) if chunk else (b, dx), generator=g)
        valid = torch.tensor([4, 1, 2], dtype=torch.int32)
        if dev == "cuda":
            params = _fake_tree(params)
            state = _fake_tree(state)
            x, valid = _fake_like((x, valid))
        if chunk:
            return block_ops.fused_block_chunk(params, x, state, valid, **kw)
        return block_ops.fused_block_step(params, x, state, **kw)

    return call


def _fake_tree(tree):
    if isinstance(tree, dict):
        return {k: _fake_tree(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="cuda")


def _kernel_cases():
    cases = {"linear_scan_kernel": lambda: _scan_case("linear"),
             "log_scan_kernel": lambda: _scan_case("log"),
             "fused_mingru_kernel": lambda: _fused_case("mingru"),
             "fused_minlstm_kernel": lambda: _fused_case("minlstm")}
    for cell in ("mingru", "minlstm"):
        for chunk in (False, True):
            name = f"{cell}_{'chunk' if chunk else 'step'}_kernel"

            def case(cell=cell, chunk=chunk):
                fn, make = _cell_case(cell, chunk)
                return fn, make("cpu")
            cases[name] = case
    return cases


KERNELS = sorted(list(_kernel_cases())
                 + ["block_step_kernel", "block_chunk_kernel"])
_LIBS = {"linear_scan_kernel": scan_ops, "log_scan_kernel": scan_ops,
         "fused_mingru_kernel": gru_ops, "fused_minlstm_kernel": lstm_ops,
         "block_step_kernel": block_ops, "block_chunk_kernel": block_ops,
         **{k: step_ops for k in step_ops.KERNELS}}


def _flat(out):
    """The tensors of a wrapper's output (a tensor, or a tuple of
    tensors and state dicts), in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for _, t in leaves_with_path(out)]
    return [t for o in out for t in _flat(o)]


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_shape_only_route(name, monkeypatch):
    mod = _LIBS[name]

    def no_lib():
        raise AssertionError(f"{name}: the shape-only route loaded the "
                             f"library")

    monkeypatch.setattr(mod, "_lib", no_lib)
    before = dict(mod.LAUNCHES)
    if name.startswith("block_"):
        call = _block_call(name == "block_chunk_kernel")
        with FlopCounterMode(display=False) as fc:
            want = call("cpu")
        plain_flops = fc.get_total_flops()
        tally = kl.Tally()
        with FakeTensorMode(), kl.recording(tally):
            got = call("cuda")
    else:
        fn, args = _kernel_cases()[name]()
        with FlopCounterMode(display=False) as fc:
            want = fn(*args)
        plain_flops = fc.get_total_flops()
        tally = kl.Tally()
        with FakeTensorMode(), kl.recording(tally):
            got = fn(*_fake_like(args))
    flat_want, flat_got = _flat(want), _flat(got)
    assert [(tuple(t.shape), t.dtype) for t in flat_got] == \
        [(tuple(t.shape), t.dtype) for t in flat_want]
    assert all(t.device.type == "cuda" for t in flat_got)
    assert mod.LAUNCHES == before, "a shape-only call counted a launch"
    assert list(tally.kernels) == [name]
    row = tally.kernels[name]
    assert row["launches"] == 1 and row["bytes"] > 0
    assert row["flops"] == plain_flops


def test_fake_operand_outside_a_tally_raises():
    fn, args = _scan_case("linear")
    with FakeTensorMode(), pytest.raises(RuntimeError, match="tally"):
        fn(*_fake_like(args))


def test_cell_launches_split_past_the_tile_limit():
    """The C launcher's ``repro_cell_launches``: one launch up to 65,535
    tiles of 8 rows, then one per 65,535 tiles."""
    assert step_ops.launches(8) == 1
    assert step_ops.launches(524_280) == 1
    assert step_ops.launches(524_281) == 2
    assert step_ops.launches(3 * 524_280) == 3


# ---------------------------------------------------------------------------
# the dry run on a fake world
# ---------------------------------------------------------------------------

SMOKE = ("gemma-2b", "mamba2-370m", "deepseek-moe-16b", "mingru-lm",
         "zamba2-2.7b")
TINY = {"train": ShapeConfig("tiny_train", 8, 8, "train"),
        "decode": ShapeConfig("tiny_decode", 8, 8, "decode")}


def _real_flops(cfg, shape):
    """FlopCounterMode over the cell's step run for real on the CPU."""
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(gen, cfg, device="cpu")
    b, s = shape.global_batch, shape.seq_len
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           dtype=torch.int32)
    if shape.kind == "train":
        ocfg = dryrun._opt_cfg(cfg)
        step = ts_lib.make_train_step(cfg, ocfg)
        args = (params, opt_lib.init(ocfg, params),
                {"tokens": tokens, "labels": tokens})
    else:
        cache = lm.init_cache(cfg, b, s, device="cpu")

        def step(params, token, cache):
            return lm.decode_step(params, cfg, token, cache)
        args = (params, tokens[:, 0], cache)
    with FlopCounterMode(display=False) as fc:
        step(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", SMOKE)
def test_dryrun_on_a_fake_world(arch, kind):
    cfg, shape = _cut(pt_archs.smoke(arch)), TINY[kind]
    rec = dryrun.run_cell(arch, shape.name, "debug", verbose=False,
                          cfg_override=cfg, device="cpu", shape=shape,
                          mesh=make_debug_mesh(2, 2, pod=2))
    assert rec["ok"] and rec["n_devices"] == 8 and rec["rows_per_rank"] == 2
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    assert 0 < rec["mem"]["argument_bytes"] < rec["hbm_per_device"]
    assert rec["fits"] and rec["kernels"] == {}
    assert set(rec["roofline"]) == {"t_compute", "t_memory",
                                    "t_collective", "dominant"}
    coll = rec["collectives"]
    if kind == "train":
        # the grads' and metrics' means over the data group, the norm
        assert coll["all-reduce"]["count"] >= 2
    elif arch == "mingru-lm":
        # serving TP: one all-reduce a mixer and one an MLP, a layer
        assert coll["all-reduce"]["count"] == 2 * cfg.n_layers
        assert any("rnn/wz/kernel" in s for s in rec["split"])
    else:
        assert coll == {}
    if arch == "deepseek-moe-16b" and kind == "train":
        assert coll["all-reduce"]["count"] > 2
        assert any("gate_w" in s for s in rec["split"])

    one = dryrun.run_cell(arch, shape.name, "one", verbose=False,
                          cfg_override=cfg, device="cpu", shape=shape,
                          mesh=make_debug_mesh(1, 1))
    assert one["collectives"] == {}
    assert one["flops_per_dev"] == _real_flops(cfg, shape)


def test_roofline_constants_are_the_h100_data_sheet():
    assert hlo_analysis.PEAK_FLOPS == 989e12
    assert hlo_analysis.HBM_BW == 3.35e12
    terms = hlo_analysis.roofline_terms(989e12, 0.0, 0.0)
    assert terms["t_compute"] == 1.0 and terms["dominant"] == "compute"
    stats = hlo_analysis.collective_stats([("all-reduce", 8),
                                           ("all-reduce", 4)])
    assert stats["all-reduce"] == {"count": 2, "bytes": 12}
    assert hlo_analysis.model_flops(10, 3, "train") == 180.0


def test_long_context_is_skipped_on_pure_attention():
    rec = dryrun.run_cell("gemma-2b", "long_500k", "single", verbose=False)
    assert rec["ok"] and rec["skipped"]
