"""Same-process A/B of two builds of the whole-block decode kernel.

    PYTHONPATH=src python3 -m repro_torch.kernels.block_step.ab OLD.cu \\
        [--new NEW.cu] [--rounds 10] [--dims DX DH DM]

Builds OLD and NEW (by default this package's ``csrc/block_step.cu``)
with ``kernels.build``, binds full-width mingru-lm / minlstm-lm block
weights (Dx 768, Dh 1536, Dm 3072 unless ``--dims`` says otherwise,
conv K 4, MLP on; fp32 and bf16; 4 seeded sets rotating, together more
than the L2 holds) through this
package's ``BlockOperands``, and times both builds on the same inputs
(B 8: the step, and a C 8 chunk with mixed valid lengths), alternating
which build runs first round by round: eager launches, and a CUDA graph
of them.  One process, so both builds read the same weight addresses,
which separate ``chip_smoke.py`` runs do not.  OLD must export
``repro_block_launch`` with this package's arguments (a build that takes
25 pointers reads the first 25) and must build where it lies.  Prints
the card, then per case each build's median and range (ms) and whether
the two builds' outputs agree bit for bit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import statistics
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_step import ops
from repro_torch.kernels.timing import eager_ms, graph_ms
from repro_torch.models import lm

DX, DH, DM, K, B, C = 768, 1536, 3072, 4, 8, 8
GATES = {"mingru": ("wz", "wh"), "minlstm": ("wf", "wi", "wh")}


def _params(gen, cell, dtype, dev, dims):
    dx, dh, dm = dims

    def w(shape):
        return (torch.randn(shape, generator=gen) / shape[0] ** 0.5).to(dtype)

    def v(n):
        return (0.1 * torch.randn(n, generator=gen)).to(dtype)

    p = {"norm_rnn": {"scale": 1.0 + v(dx)},
         "rnn": {g: {"kernel": w((dx, dh)), "bias": v(dh)}
                 for g in GATES[cell]},
         "down": {"kernel": w((dh, dx))},
         "conv": {"kernel": w((K, dx)), "bias": v(dx)},
         "norm_mlp": {"scale": 1.0 + v(dx)},
         "mlp_in": {"kernel": w((dx, dm)), "bias": v(dm)},
         "mlp_out": {"kernel": w((dm, dx)), "bias": v(dx)}}
    return lm.tree_to(p, dev)


def _check(rc):
    if rc != 0:
        raise RuntimeError(f"block kernel launch returned CUDA error {rc}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("--new", type=Path, default=ops.SOURCE)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--dims", type=int, nargs=3, default=[DX, DH, DM],
                    metavar=("DX", "DH", "DM"))
    a = ap.parse_args(argv)
    dx, dh, _ = a.dims
    if not torch.cuda.is_available():
        raise SystemExit("ab.py needs a GPU")
    libs = {}
    for name, src in (("old", a.old), ("new", a.new)):
        lib = ctypes.CDLL(str(build.build(src.resolve())))
        lib.repro_block_launch.restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    print(f"{torch.cuda.get_device_name(0)}; Dx {dx}, Dh {dh}, Dm "
          f"{a.dims[2]}")
    gen = torch.Generator().manual_seed(0)
    valid = torch.tensor([8, 1, 3, 8, 5, 2, 8, 7], dtype=torch.int32,
                         device=dev)
    for cell in ("mingru", "minlstm"):
        for dtype in (torch.float32, torch.bfloat16):
            bound = [ops.BlockOperands(_params(gen, cell, dtype, dev,
                                               a.dims),
                                       cell=cell, compute_dtype=dtype,
                                       use_conv=True, use_mlp=True)
                     for _ in range(4)]
            x = torch.randn((B, C, dx), generator=gen).to(dtype).to(dev)
            st = {"h": (0.5 * torch.randn((B, dh), generator=gen))
                  .to(dtype).to(dev),
                  "conv": torch.randn((B, K - 1, dx), generator=gen)
                  .to(dtype).to(dev)}
            for form, xx, vv, iters in (
                    ("step", x[:, :1].contiguous(), None, 300),
                    ("chunk", x, valid, 60)):
                prepared = [ops.prepare_launch(b, xx, st, vv, mode="log")
                            for b in bound]

                def captured(lib, sets=itertools.cycle(bound), xx=xx,
                             vv=vv):
                    # prepared under the capture: it binds that stream
                    launch, _ = ops.prepare_launch(next(sets), xx, st, vv,
                                                   mode="log")
                    _check(lib.repro_block_launch(*launch.args))

                eager = {n: [] for n in libs}
                graph = {n: [] for n in libs}
                outs = {}
                for r in range(a.rounds):
                    for name in (("old", "new") if r % 2 == 0
                                 else ("new", "old")):
                        lib = libs[name]
                        for launch, _ in prepared:
                            _check(lib.repro_block_launch(*launch.args))
                        calls = [lambda args=launch.args, lib=lib:
                                 lib.repro_block_launch(*args)
                                 for launch, _ in prepared]
                        eager[name].append(eager_ms(calls, iters))
                        if r == 0:
                            outs[name] = [t.clone() for t in prepared[0][1]
                                          if t is not None]
                        graph[name].append(graph_ms(
                            lambda lib=lib: captured(lib)))
                same = all(torch.equal(o, n)
                           for o, n in zip(outs["old"], outs["new"]))
                tag = f"{cell}/{str(dtype).split('.')[-1]} {form}"
                print(f"{tag:<22} " + "  ".join(
                    f"{n}: eager {statistics.median(eager[n]):.5f} "
                    f"[{min(eager[n]):.5f}-{max(eager[n]):.5f}] graph "
                    f"{statistics.median(graph[n]):.5f} "
                    f"[{min(graph[n]):.5f}-{max(graph[n]):.5f}]"
                    for n in libs) + f"  bits equal: {same}")
            del bound, prepared
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
