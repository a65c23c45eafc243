"""Same-process A/B of two builds of the cell decode kernels.

    PYTHONPATH=src python3 -m repro_torch.kernels.decode_step.ab OLD.cu \\
        [--new NEW.cu] [--shapes NAME ...] [--rounds 6]

Builds OLD and NEW (by default this package's ``csrc/decode_step.cu``)
with ``kernels.build``, binds seeded weights through
this package's ``CellOperands`` (sets rotating, together more than the
L2 holds where 16 of them do) and calls both builds' C entry points with
the same arguments: minGRU and minLSTM (normalize on), fp32 and bf16,
the step at B rows and, where the shape has one, a C 8 chunk with mixed
valid lengths.  Shapes (B, Dx, Dh): "mingru-lm" (8, 768, 1536, chunk),
"gemma-2b-mingru" (8, 2048, 2048; minGRU), "ragged" (3, 200, 72,
chunk), "deepseek-v3" (8, 7168, 7168; minGRU), "wide-bf16" (8, 16384,
64; bf16).  Rounds alternate which build runs first: eager launches and a
CUDA graph of 20.  Prints the card and its power limit, then per case
each build's median and range (ms) and whether the two builds' outputs
agree bit for bit; a case a build refuses prints its CUDA error.  OLD
must export the cell entry points with this package's arguments and
must build where it lies (e.g. a ``git archive`` of another revision
unpacked under ``build/``).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_step import ops
from repro_torch.kernels.timing import eager_ms, graph_ms, rotating

SHAPES = {"mingru-lm": (8, 768, 1536, True, None, None),
          "gemma-2b-mingru": (8, 2048, 2048, False, "mingru", None),
          "ragged": (3, 200, 72, True, None, None),
          "deepseek-v3": (8, 7168, 7168, False, "mingru", None),
          "wide-bf16": (8, 16384, 64, False, None, torch.bfloat16)}
DEFAULT_SHAPES = ("mingru-lm", "gemma-2b-mingru", "ragged")
C = 8
VALID = [8, 1, 3, 8, 5, 2, 8, 7]


def _load(src: Path):
    lib = ctypes.CDLL(str(build.build(src.resolve())))
    for name in ("repro_cell_step_launch", "repro_cell_chunk_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p,
                                            ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


def _operands(gen, cell, dtype, dx, dh, dev):
    ws = [(torch.randn((dx, dh), generator=gen) / dx ** 0.5).to(dtype)
          .to(dev) for _ in ops.GATES[cell]]
    bs = [(0.1 * torch.randn((dh,), generator=gen)).to(dtype).to(dev)
          for _ in ops.GATES[cell]]
    return ops.CellOperands(cell, ws, bs)


def _call(lib, launch):
    return getattr(lib, launch.entry)(*launch.args)


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _case(libs, sets, x, h, valid, rounds, iters):
    """Both builds on one form: outputs (set 0) bit for bit, eager and
    graph ms per round, alternating which build goes first."""
    prepared = [ops.prepare_launch(s_, x, h, valid, mode="log")
                for s_ in sets]
    outs = {}
    for name, lib in libs.items():
        launch, out = prepared[0]
        rc = _call(lib, launch)
        if rc != 0:
            return f"{name} refuses: CUDA error {rc}"
        torch.cuda.synchronize()
        outs[name] = out.clone()
    same = torch.equal(outs["old"], outs["new"])
    eager = {n: [] for n in libs}
    graph = {n: [] for n in libs}
    for r in range(rounds):
        for name in (("old", "new") if r % 2 == 0 else ("new", "old")):
            lib = libs[name]
            calls = [lambda lib=lib, lc=lc: _check(_call(lib, lc), name)
                     for lc, _ in prepared]
            eager[name].append(eager_ms(calls, iters))

            def captured(lib=lib, s_=sets[0]):
                # bound under the capture, on its stream
                lc, _ = ops.prepare_launch(s_, x, h, valid, mode="log")
                _check(_call(lib, lc), name)
            graph[name].append(graph_ms(rotating(
                [lambda s_=s_, lib=lib: captured(lib, s_) for s_ in sets])))
    return "  ".join(
        f"{n}: eager {statistics.median(eager[n]):.5f} "
        f"[{min(eager[n]):.5f}-{max(eager[n]):.5f}] graph "
        f"{statistics.median(graph[n]):.5f} "
        f"[{min(graph[n]):.5f}-{max(graph[n]):.5f}]" for n in libs) \
        + f"  bits equal: {same}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("--new", type=Path, default=ops.SOURCE)
    ap.add_argument("--shapes", nargs="+", default=list(DEFAULT_SHAPES),
                    choices=list(SHAPES))
    ap.add_argument("--rounds", type=int, default=6)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab.py needs a GPU")
    libs = {"old": _load(a.old), "new": _load(a.new)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; old {a.old}; new {a.new}")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for shape in a.shapes:
        bsz, dx, dh, chunked, only_cell, only_dtype = SHAPES[shape]
        for cell in ("mingru", "minlstm"):
            if only_cell not in (None, cell):
                continue
            for dtype in (torch.float32, torch.bfloat16):
                if only_dtype not in (None, dtype):
                    continue
                e = torch.tensor([], dtype=dtype).element_size()
                n_sets = min(16, math.ceil(
                    60e6 / (len(ops.GATES[cell]) * dx * dh * e)))
                sets = [_operands(gen, cell, dtype, dx, dh, dev)
                        for _ in range(n_sets)]
                x = torch.randn((bsz, C, dx), generator=gen).to(dtype) \
                    .to(dev)
                h = (0.5 * torch.randn((bsz, dh), generator=gen)).to(dtype) \
                    .to(dev)
                valid = torch.tensor(VALID[:bsz], dtype=torch.int32,
                                     device=dev)
                forms = [("step", x[:, :1].contiguous(), None, 200)]
                if chunked:
                    forms.append(("chunk", x, valid, 100))
                for form, xx, vv, iters in forms:
                    tag = (f"{shape} {cell}/{str(dtype).split('.')[-1]} "
                           f"{form} ({sets[0].body})")
                    print(f"{tag:<44} "
                          + _case(libs, sets, xx, h, vv, a.rounds, iters),
                          flush=True)
                del sets
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
