"""Same-process A/B of two builds of the fused minGRU / minLSTM kernels.

    PYTHONPATH=src python3 -m repro_torch.kernels.fused_ab OLD_KERNELS \\
        [--new NEW_KERNELS] [--rounds 10]

OLD_KERNELS and NEW_KERNELS (by default this package's directory) are
``kernels`` directories of two checkouts: each holds
``fused_mingru/csrc/fused_mingru.cu`` and
``fused_minlstm/csrc/fused_minlstm.cu`` beside the ``csrc`` headers they
include (e.g. a ``git archive`` of another revision unpacked under
``build/``).  Both are built with ``kernels.build`` and called through
their C entry points on the same inputs: minGRU and minLSTM (normalize
on), log mode, fp32 (the CUDA-core body) and bf16 (the tensor-core
body), at the training shape (B 8, T 256, Dx 768, Dh 1536) and a ragged
one (B 3, T 70, Dx 40, Dh 72).  Each case rotates over 4 seeded input
sets and alternates which build runs first, round by round: eager
launches and a CUDA graph of 20.  Prints the card and its power limit,
then per case the body each build took, each build's median and range
(ms) and whether the two builds' outputs agree bit for bit.  Needs a
GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build, fused_cell
from repro_torch.kernels.timing import eager_ms, graph_ms, rotating

HERE = Path(__file__).resolve().parent
N_SETS = 4
SHAPES = {"train": (8, 256, 768, 1536), "ragged": (3, 70, 40, 72)}
GATES = {"mingru": 2, "minlstm": 3}


def _fn(kernels: Path, cell: str):
    src = kernels / f"fused_{cell}" / "csrc" / f"fused_{cell}.cu"
    lib = ctypes.CDLL(str(build.build(src.resolve())))
    name = f"repro_fused_{cell}_launch"
    fused_cell.declare(lib, name)
    return getattr(lib, name)


def _inputs(gen, cell, dtype, shape, dev):
    bsz, t, dx, dh = shape
    x = torch.randn((bsz, t, dx), generator=gen).to(dtype).to(dev)
    ws = [(torch.randn((dx, dh), generator=gen) / dx ** 0.5).to(dtype)
          .to(dev) for _ in range(GATES[cell])]
    bs = [(0.1 * torch.randn((dh,), generator=gen)).to(dtype).to(dev)
          for _ in range(GATES[cell])]
    h0 = (0.5 * torch.randn((bsz, dh), generator=gen)).to(dev)
    return x, ws, bs, h0


def _bind(fn, cell, ins):
    """A launch of ``fn`` on bound operands into its own output, on the
    stream current when it runs (under a graph's capture, the capturing
    one), and that output."""
    code, shape, h0, out, ptrs = fused_cell._operands(
        cell, *ins, mode="log")
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    body = ctypes.c_int(-1)

    def run(_keep=(h0, out)):
        s = torch.cuda.current_stream().cuda_stream
        rc = fn(code, 1, int(cell == "minlstm"), *shape, arr,
                ctypes.c_void_p(s), ctypes.byref(body))
        if rc != 0:
            raise RuntimeError(f"fused_{cell} launch: CUDA error {rc}")
    run.body = body
    return run, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("--new", type=Path, default=HERE)
    ap.add_argument("--rounds", type=int, default=10)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fused_ab.py needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; old {a.old}; new {a.new}; {N_SETS} input sets "
          f"rotating; eager: 100 launches; graph: 20 replayed 5 times; "
          f"{a.rounds} rounds, the order alternating; median [min-max] ms")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for cell in GATES:
        fns = {"old": _fn(a.old, cell), "new": _fn(a.new, cell)}
        for shape_name, shape in SHAPES.items():
            for dtype in (torch.float32, torch.bfloat16):
                sets = [_inputs(gen, cell, dtype, shape, dev)
                        for _ in range(N_SETS)]
                bound = {n: [_bind(fn, cell, s_) for s_ in sets]
                         for n, fn in fns.items()}
                eager = {n: [] for n in fns}
                graph = {n: [] for n in fns}
                for r in range(a.rounds):
                    for n in (("old", "new") if r % 2 == 0
                              else ("new", "old")):
                        runs = [run for run, _ in bound[n]]
                        eager[n].append(eager_ms(runs, 100))
                        graph[n].append(graph_ms(rotating(runs)))
                torch.cuda.synchronize()
                same = all(torch.equal(o, n_) for (_, o), (_, n_)
                           in zip(bound["old"], bound["new"]))
                bodies = {n: fused_cell.BODIES[bound[n][0][0].body.value]
                          for n in fns}
                tag = (f"{cell}/{str(dtype).split('.')[-1]} {shape_name} "
                       f"{'x'.join(map(str, shape))}")
                print(f"{tag:<36} " + "  ".join(
                    f"{n} ({bodies[n]}): eager "
                    f"{statistics.median(eager[n]):.5f} "
                    f"[{min(eager[n]):.5f}-{max(eager[n]):.5f}] graph "
                    f"{statistics.median(graph[n]):.5f} "
                    f"[{min(graph[n]):.5f}-{max(graph[n]):.5f}]"
                    for n in fns) + f"  bits equal: {same}", flush=True)
                del sets, bound
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
