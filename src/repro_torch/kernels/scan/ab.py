"""Same-process A/B of two builds of the scan kernels.

    PYTHONPATH=src python3 -m repro_torch.kernels.scan.ab OLD.cu \\
        [--new NEW.cu] [--rounds 10]

Builds OLD and NEW (by default this package's ``csrc/scan.cu``) with
``kernels.build`` and times both on the same inputs at the training
shape (B 8, T 256, D 1536; ``ref.inputs``): the linear scan
forward and reversed, fp32 and bf16, and the log-space scan from
h0 = 0 (log_h0 = -inf) and from a given h0, fp32, and from h0 = 0 in
bf16.  Each case rotates over 4 seeded input sets, together more than
the 50 MB L2 holds, and alternates which build runs first round by
round: eager launches (the C entry point called directly, arguments
bound once), and a CUDA graph of 20 of them.  OLD must export
``repro_linear_scan`` / ``repro_log_scan`` with this package's
arguments and must build where it lies (e.g. ``git show
<rev>:src/repro_torch/kernels/scan/csrc/scan.cu > build/old_scan.cu``).
Prints the card and its power limit, then per case each build's median
and range (ms), and whether the two builds' outputs agree bit for bit
(else their largest difference).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels import launch as kl
from repro_torch.kernels.scan import ops, ref
from repro_torch.kernels.timing import eager_ms, graph_ms, rotating

N_SETS = 4
SHAPE = (8, 256, 1536)


def _load(src: Path):
    lib = ctypes.CDLL(str(build.build(src.resolve())))
    ptr = ctypes.c_void_p
    lib.repro_linear_scan.argtypes = [ctypes.c_int] * 5 + [ptr] * 5
    lib.repro_linear_scan.restype = ctypes.c_int
    lib.repro_log_scan.argtypes = [ctypes.c_int] * 4 + [ptr] * 5
    lib.repro_log_scan.restype = ctypes.c_int
    return lib


def _call(lib, kind, reverse, ins, out):
    """A launch of ``lib``'s kernel on bound arguments, the current
    stream included: the host cost of an eager call is the ctypes call
    alone."""
    x, y, c0 = ins
    bsz, t, d = x.shape
    code = kl.DTYPES[x.dtype]
    if kind == "linear":
        fn = lib.repro_linear_scan
        args = (code, int(reverse), bsz, t, d)
    else:
        fn = lib.repro_log_scan
        args = (code, bsz, t, d)
    args += (x.data_ptr(), y.data_ptr(), c0.data_ptr(), out.data_ptr(),
             kl.stream(x.device))

    def run():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{kind} scan launch returned CUDA error {rc}")
    return run


def _call_late(lib, kind, reverse, ins, out):
    """``_call`` bound when it runs: under a CUDA graph's capture the
    launch then takes the capturing stream."""
    return lambda: _call(lib, kind, reverse, ins, out)()


CASES = (("linear", torch.float32, False, True),
         ("linear", torch.float32, True, True),
         ("linear", torch.bfloat16, False, True),
         ("linear", torch.bfloat16, True, True),
         ("log", torch.float32, False, False),
         ("log", torch.float32, False, True),
         ("log", torch.bfloat16, False, False))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("--new", type=Path, default=ops.SOURCE)
    ap.add_argument("--rounds", type=int, default=10)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab.py needs a GPU")
    libs = {"old": _load(a.old), "new": _load(a.new)}
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.returncode == 0
          else torch.cuda.get_device_name(0))
    shape = SHAPE
    print(f"B {shape[0]} T {shape[1]} D {shape[2]}; {N_SETS} input sets "
          f"rotating; eager: 200 launches; graph: 20 launches replayed 5 "
          f"times; {a.rounds} rounds, the order alternating; median "
          f"[min-max] ms per launch")
    gen = torch.Generator().manual_seed(0)
    for kind, dtype, reverse, h0_given in CASES:
        sets = [ref.inputs(gen, kind, dtype, shape, h0_given, dev)
                for _ in range(N_SETS)]
        out_dtype = dtype if kind == "linear" else torch.float32
        outs = {n: [torch.empty(shape, dtype=out_dtype, device=dev)
                    for _ in sets] for n in libs}

        calls = {n: [_call(libs[n], kind, reverse, s, o)
                     for s, o in zip(sets, outs[n])] for n in libs}
        late = {n: [_call_late(libs[n], kind, reverse, s, o)
                    for s, o in zip(sets, outs[n])] for n in libs}
        eager = {n: [] for n in libs}
        graph = {n: [] for n in libs}
        for r in range(a.rounds):
            for n in (("old", "new") if r % 2 == 0 else ("new", "old")):
                eager[n].append(eager_ms(calls[n], 200))
                graph[n].append(graph_ms(rotating(late[n])))
        torch.cuda.synchronize()
        same = all(torch.equal(o, n_)
                   for o, n_ in zip(outs["old"], outs["new"]))
        diff = max(float((o.float() - n_.float()).abs().max())
                   for o, n_ in zip(outs["old"], outs["new"]))
        tag = (f"{kind}/{str(dtype).split('.')[-1]}/"
               + (("reverse" if reverse else "forward") if kind == "linear"
                  else ("h0=given" if h0_given else "h0=0")))
        med = {n: (statistics.median(eager[n]), statistics.median(graph[n]))
               for n in libs}
        print(f"{tag:<24} " + "  ".join(
            f"{n}: eager {med[n][0]:.5f} "
            f"[{min(eager[n]):.5f}-{max(eager[n]):.5f}] graph "
            f"{med[n][1]:.5f} [{min(graph[n]):.5f}-{max(graph[n]):.5f}]"
            for n in libs)
            + f"  new/old eager {med['new'][0] / med['old'][0]:.3f} graph "
            f"{med['new'][1] / med['old'][1]:.3f}"
            + ("  bits equal: True" if same
               else f"  bits equal: False (max abs diff {diff:.3g})"))
        del sets, outs, calls, late
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
