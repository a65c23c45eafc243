"""GPU smoke run of the PyTorch port: builds the CUDA kernels from source,
holds each against its plain PyTorch version at full model width, serves
full-width mingru-lm (and a short minlstm-lm run) through the port's
ServingEngine on the block-fused and on the cell-fused tier, serves and
prefills full-width gemma-2b-mingru, prefills the minRNN LMs in parallel,
serves with speculative decoding on both tiers, trains full-width
mingru-lm / minlstm-lm through the port's train step, then serves under
injected faults, kills and restores the engine (in this process and a
serving process sent SIGKILL) and serves under the card's tune plans,
and checks that every layer of every device round, prefill and training
step went through the kernels.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failed check exits non-zero before the result line):
  1. the card's name and power limit; the five sources built in parallel
     (one nvcc each), with each source's ptxas report;
  2. block kernels at mingru-lm widths (Dx 768, Dh 1536, Dm 3072, K 4),
     B = 8, C = 8, both cells, fp32 and bf16: kernel vs plain version,
     chunk == C steps bit for bit, the same at the verify width C 5 with
     mixed valid (per-position states too; frozen rows re-emit their
     last state), a row independent of B, the launcher's
     plan (the body: bf16 "split", each phase's K split, units and the
     most weight bytes one block holds, within 1.25x of the phase's
     share per SM; fp32 "streamed"; the grid co-resident), kernel / plain
     times and the bound, the kernel also as a CUDA graph (device ms),
     and block 0's per-phase trace; then the cell-only decode kernels at
     mingru-lm /
     minlstm-lm widths (B 8, Dx 768, Dh 1536; step and chunk C 8 with
     mixed valid, and C 5), gemma-2b-mingru's (B 8, 2048 x 2048, step)
     and a ragged case (B 3, Dx 200, Dh 72), fp32 and bf16: kernel vs
     plain version, a chunk == C step launches bit for bit, a row
     independent of B, the
     body every launch took (bf16: the tensor-core body, fp32: the
     CUDA-core body) and the occupancy query's blocks per SM, clusters and
     waves (one wave at every full width), minLSTM also without
     normalize, kernel / plain / one torch.matmul of the projections (the
     yardstick) and the bound, kernel and yardstick timed both as eager
     calls and as a CUDA graph;
  3. training kernels at the training shapes (B 8, T 256, Dx 768,
     Dh 1536; T 250 for a ragged edge; h0 given and not): the fused
     minGRU / minLSTM kernels and the linear / log-space scans, forward
     and each autograd Function's gradients against the plain versions;
     the fused kernels also at the prefill's shapes (bf16, B 8 x T 1024
     right-padded, and T 512 resumed from a bf16 h0) against the plain
     versions;
     for the fused kernels the body each launch takes (bf16: the
     tensor-core body) and the occupancy query's blocks per SM, grid
     blocks and waves (bf16: one wave), two launches equal bit for bit;
     kernel / plain times, the bound, and the unfused yardstick (one bf16
     torch.matmul of the projections + the gates as torch ops + the
     port's linear scan, held to the bf16 tolerance), the kernel and the
     yardstick timed both as eager calls and as a CUDA graph; for the
     scans (forward and reversed linear, log from h0 = 0 and given, fp32
     and bf16) each kernel's plan and the occupancy query's blocks per SM
     and waves, two launches and a row launched alone bit for bit, both
     scans bit for bit with their segmented renderings, eager and
     CUDA-graph times rotating over input
     sets larger than the L2, the Heinsen composition of torch.cumsum /
     torch.logcumsumexp as a yardstick line, and the same checks at
     B 3, T 1100 (five T-tiles), D 70;
  4. serving: full-width mingru-lm (bf16, seeded init), 8 slots, 8 byte
     prompts, 32 new tokens, K = 4, C in {1, 8}: greedy streams equal
     across C and to ``generate_one``, launches == layers x rounds;
     then a short full-width minlstm-lm run; then, outside the counted
     main path, decoded tok/s over 5 windows per C (min / median / max)
     and the cost of sampled requests.  The cell-fused tier
     (fuse_block "off") serves the same traffic, C in {1, 8}, and
     minlstm-lm at C 8: streams equal across C and to ``generate_one``,
     one cell launch per layer per round, step / chunk split as the
     rounds were, every minGRU and minLSTM launch on the tensor-core body;
     the streams and first-round logits set beside the block tier's; a
     device profile of one window per model and the rates.
     gemma-2b-mingru at full width (bf16, drawn on the card): 8 slots, 8
     prompts of 8 seeded token ids, 32 new tokens, K 4, C 1: streams
     equal ``generate_one``, 18 mingru_step_kernel launches per round,
     all on the tensor-core body,
     tok/s over 5 windows, peak device memory, a device profile, and one
     short sampled window; then its prefill, B 8 x T 512 (18
     fused_mingru_kernel launches at Dx 2048 / Dh 2048 on the tensor-core
     body, the occupancy query, the kernel against its plain version at
     that width, peak memory, 16 decode steps after it, the logits against
     the step path's, ms and prompt tokens/s);
  4b. prefill: full-width mingru-lm and minlstm-lm, one ``lm.prefill`` of
     B 8 prompts right-padded to 1024 (lengths 1 to 1024), and mingru-lm
     under scan_strategy "pallas" fresh and resumed: one fused-cell launch
     per layer per prefill, all on the tensor-core body (24 log scans for
     "pallas"); outside the count, each padded row against its own
     prefill, a prefill resumed at 512 and the sequential path
     (``decode_chunk``) against one pass, to the bf16 limit, and the two
     routes' ms at B 8 x T 1024; fp32 prefill
     + 16 ``decode_step`` streams equal ``generate_one``; prefill ms and
     prompt tokens/s at T 256 / 1024 and the Fig. 3 shape (prefill + 16
     decode rounds).  Speculative serving: full-width mingru-lm, n-gram
     drafts S 4, 8 prompts repeating one seeded 16-byte phrase, 32 new
     tokens, K 4, C in {1, 8}, on the block and the cell tier: one verify
     chunk launch per layer per round (cell tier on the tensor-core
     body); outside the count, streams equal the non-speculative
     engine's, the oracle draft accepts every draft (launches by formula),
     the fixed source rolls back, a seeded sampled window and minlstm-lm
     unchanged, gemma-2b-mingru refuses; speculative against plain tok/s,
     host round-trips per token and accepted drafts per round in turns,
     and a device profile of one verify window per tier;
  5. training: full-width mingru-lm (bf16, remat "full") 10 AdamW steps
     of B 8 x T 256 on the corpus, minlstm-lm 3 steps, mingru-lm under
     scan_strategy "pallas" 3 steps; launches == the stated formulas,
     every fused-cell launch on the tensor-core body;
     loss finite and falling; outside the count, the first 3 losses
     against the same run on the plain versions, a checkpoint restore +
     resumed step 6, and ms per step over 5 repeats;
  6. the robustness layer, full width, bf16, weights seeded on the card.
     Faults on mingru-lm (block tier and cell tier) and minlstm-lm
     (block tier), K 4, C 8: an injector armed at rate 0 gives the plain
     run's streams and round counters, dropped uploads (rate 0.3) its
     streams, NaN poured into two slots' state is quarantined and
     retried and every stream equals the plain run's, the chaos trace
     (NaN, drops, stragglers, deadlines, a bounded queue) ends with
     every request terminal and the identities holding; one decode
     kernel launch per layer per round.  Crash recovery on mingru-lm
     (block tier, again with n-gram drafts, again with bit-rot in the
     newest snapshot, and the cell tier; 24 requests, greedy and
     seeded-sampled): killed mid-trace, restored, streams and round clock
     equal the uninterrupted run's; a serving process
     (``repro_torch.launch.serve --snapshot-dir``) sent SIGKILL after 12
     step records, restored here and matched against an uninterrupted
     run; outside the count, decoded tok/s with and without the journal
     in turns, the snapshot's bytes and ms.  Tune plans: the autotuner's
     first 2 points into a scratch directory; ``"auto"``
     resolves the committed plans of this card for both LMs (never the
     JAX package's CPU plans); a ``tune="auto"`` engine streams as K 1 /
     C 1 on the plan's tier; the two in turns;
  7. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script "
          "needs an NVIDIA GPU", file=sys.stderr)
    sys.exit(1)

from repro_torch.configs import archs  # noqa: E402
from repro_torch.data import lm_corpus  # noqa: E402
from repro_torch.core import nn as core_nn  # noqa: E402
from repro_torch.core.min_lstm import normalized_gates  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.block_step import ops, ref  # noqa: E402
from repro_torch.kernels.decode_step import ops as step_ops  # noqa: E402
from repro_torch.kernels.decode_step import ref as step_ref  # noqa: E402
from repro_torch.kernels.fused_mingru import ops as gru_ops  # noqa: E402
from repro_torch.kernels.fused_mingru import ref as gru_ref  # noqa: E402
from repro_torch.kernels.fused_minlstm import ops as lstm_ops  # noqa: E402
from repro_torch.kernels.fused_minlstm import ref as lstm_ref  # noqa: E402
from repro_torch.kernels.scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.scan import ref as scan_ref  # noqa: E402
from repro_torch.kernels.timing import (  # noqa: E402
    eager_ms, graph_ms, rotating)
from repro_torch.models import lm  # noqa: E402
from repro_torch.training import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training import train_step as ts_lib  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from repro_torch.serving import autotune, recovery, tuning  # noqa: E402
from repro_torch.serving import draft as draft_lib  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    TERMINAL_STATUSES, ServingEngine, generate_one, replay_trace)
from repro_torch.serving.faults import FaultInjector  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12,  # fp32 outside the tensor cores
              torch.bfloat16: 989e12}
# |kernel - plain| <= ATOL + RTOL * |plain|.  fp32: the same arithmetic
# summed in another order over up to 3072 terms.  bf16: both round at the
# same cast points, but a sum in another order can land on the
# neighbouring bf16 value (2^-8 relative) and carry through the next cast.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (6e-2, 2e-2)}
DX, DH, DM, K, B, C = 768, 1536, 3072, 4, 8, 8
# the speculative traffic's S drafts a round; a verify chunk at C 1 is
# S + 1 wide
SPEC_S = 4
W_VERIFY = SPEC_S + 1
GATES = {"mingru": ("wz", "wh"), "minlstm": ("wf", "wi", "wh")}
REPLACES = {"block_step_kernel": "src/repro/kernels/block_step/kernel.py:298",
            "block_chunk_kernel": "src/repro/kernels/block_step/kernel.py:349",
            "linear_scan_kernel": "src/repro/kernels/scan/kernel.py:94",
            "log_scan_kernel": "src/repro/kernels/scan/kernel.py:153",
            "fused_mingru_kernel":
                "src/repro/kernels/fused_mingru/kernel.py:60",
            "fused_minlstm_kernel":
                "src/repro/kernels/fused_minlstm/kernel.py:64",
            "mingru_step_kernel": "src/repro/kernels/decode_step/kernel.py:75",
            "mingru_chunk_kernel":
                "src/repro/kernels/decode_step/kernel.py:150",
            "minlstm_step_kernel":
                "src/repro/kernels/decode_step/kernel.py:214",
            "minlstm_chunk_kernel":
                "src/repro/kernels/decode_step/kernel.py:288"}
SOURCES = {"block_step_kernel": ops.SOURCE,
           "block_chunk_kernel": ops.SOURCE,
           "linear_scan_kernel": scan_ops.SOURCE,
           "log_scan_kernel": scan_ops.SOURCE,
           "fused_mingru_kernel": gru_ops.SOURCE,
           "fused_minlstm_kernel": lstm_ops.SOURCE,
           "mingru_step_kernel": step_ops.SOURCE,
           "mingru_chunk_kernel": step_ops.SOURCE,
           "minlstm_step_kernel": step_ops.SOURCE,
           "minlstm_chunk_kernel": step_ops.SOURCE}
# one torch.matmul of x against the concatenated projections, per kernel
# (a yardstick only: no single PyTorch call computes projections, gates
# and update together, and the port never calls it)
LIBRARY_MS = {}
# the device time per launch (a CUDA graph of launches) of the fused and
# the cell kernels, reported beside ``ms``, which times eager launches as
# every kernel's does; and the cell kernels' library call's
DEVICE_MS = {}
LIBRARY_DEVICE_MS = {}
# input sets a timed scan rotates over: 18.9 to 37.7 MB each (inputs and
# output), more than the 50 MB L2 together in every case
SCAN_SETS = 4
TRAIN_KERNELS = ("fused_mingru_kernel", "fused_minlstm_kernel",
                 "linear_scan_kernel", "log_scan_kernel")


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# 1. card and build
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 2. kernels at full width
# ---------------------------------------------------------------------------

def block_params(gen, cell, dtype):
    def w(shape, fan_in):
        return (torch.randn(shape, generator=gen) / fan_in ** 0.5).to(dtype)

    def v(n, s=0.1):
        return (s * torch.randn(n, generator=gen)).to(dtype)

    p = {"norm_rnn": {"scale": (1.0 + v(DX)).to(dtype)},
         "rnn": {g: {"kernel": w((DX, DH), DX), "bias": v(DH)}
                 for g in GATES[cell]},
         "down": {"kernel": w((DH, DX), DH)},
         "conv": {"kernel": w((K, DX), 4), "bias": v(DX)},
         "norm_mlp": {"scale": (1.0 + v(DX)).to(dtype)},
         "mlp_in": {"kernel": w((DX, DM), DX), "bias": v(DM)},
         "mlp_out": {"kernel": w((DM, DX), DM), "bias": v(DX)}}
    return lm.tree_to(p, DEV)


def n_weight_elems(cell):
    n_g = len(GATES[cell])
    return (n_g * (DX * DH + DH) + DH * DX + DX * DM + DM + DM * DX + DX
            + 2 * DX + K * DX + DX)


def bound_ms(cell, dtype, bsz, chunk):
    """Least time for the work: each input read once, each output written
    once, over the memory rate; multiply-adds over the type's peak."""
    e = torch.tensor([], dtype=dtype).element_size()
    n_g = len(GATES[cell])
    elems_in = n_weight_elems(cell) + bsz * chunk * DX + bsz * DH \
        + bsz * (K - 1) * DX
    elems_out = bsz * chunk * (DX + DH + (K - 1) * DX)
    nbytes = (elems_in + elems_out) * e + (bsz * 4 if chunk > 1 else 0)
    flops = 2 * bsz * chunk * (n_g * DX * DH + DH * DX + 2 * DX * DM)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(got, want, dtype, what):
    got, want = got.detach().float(), want.detach().float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got - want).abs()
    atol, rtol = TOL[dtype]
    bad = err > atol + rtol * want.abs()
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} elements outside atol {atol} rtol "
          f"{rtol} (max abs err {float(err.max()):.3g})")
    return float(err.max())


def host_ms(fns, iters):
    """Host time per call to issue ``iters`` calls, rotating over ``fns``,
    without waiting for the device (the queue does not fill at these
    counts): where it is below the device time, eager launches time the
    device, not the host."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def raw(launch):
    def run():
        rc = launch()
        if rc != 0:
            fail(f"raw kernel launch returned CUDA error {rc}")
    return run


def traced_phases(bound, x, st, valid, reps=20):
    """Mean per-phase time (us) of one launch, from block 0's timer, over
    ``reps`` traced launches rotating over the bound weight sets."""
    trace = torch.zeros(1 + 7 * x.shape[1], dtype=torch.int64, device=DEV)
    fns = [raw(ops.prepare_launch(b, x, st, valid, mode="log",
                                  trace=trace)[0]) for b in bound]
    total = {}
    for i in range(reps):
        fns[i % len(fns)]()
        torch.cuda.synchronize()
        for k_, v in ops.phase_times(trace).items():
            total[k_] = total.get(k_, 0.0) + v / reps
    return total


def check_plan(tag, pl, dtype):
    """The block kernel's plan at full width: the grid co-resident; bf16
    on the split body, every phase split over K, and in every phase the
    most weight bytes one block holds within 1.25x of the phase's bytes
    over the SMs (that ratio is kept in the phase's "share_ratio"); fp32,
    whose slices do not fit, on the streamed body."""
    check(pl["grid"] <= pl["blocks_per_sm"] * pl["sms"],
          f"{tag}: grid {pl['grid']} exceeds {pl['blocks_per_sm']} x "
          f"{pl['sms']} resident blocks")
    want = "split" if dtype == torch.bfloat16 else "streamed"
    check(pl["body"] == want, f"{tag}: body {pl['body']}, expected {want}")
    e = torch.tensor([], dtype=dtype).element_size()
    for ph in pl["phases"]:
        share = ph["K"] * ph["N"] * ph["gates"] * e / pl["sms"]
        ph["share_ratio"] = ph["max_block_bytes"] / share
        if want == "split":
            check(ph["S"] > 1 and ph["share_ratio"] <= 1.25,
                  f"{tag}: phase {ph['name']} unbalanced: {ph}")


def block_graph_ms(bound, x, st, valid):
    """Device ms per launch from a CUDA graph of launches rotating over the
    ``bound`` weight sets (the graph captures the cooperative launch).
    Each call binds its launch to the stream current when it runs, the
    capture's."""
    def run(b):
        raw(ops.prepare_launch(b, x, st, valid, mode="log")[0])()
    return graph_ms(rotating([lambda b=b: run(b) for b in bound]))


def kernel_phase(gen):
    rows, traces, plans, verify = [], [], [], []
    main = {}
    valid = torch.tensor([8, 1, 3, 8, 5, 2, 8, 7], dtype=torch.int32,
                         device=DEV)
    full = torch.full((B,), C, dtype=torch.int32, device=DEV)
    valid_w = valid.clamp(max=W_VERIFY)
    for cell in ("mingru", "minlstm"):
        for dtype in (torch.float32, torch.bfloat16):
            kw = dict(cell=cell, mode="log", use_conv=True, use_mlp=True)
            sets = [block_params(gen, cell, dtype) for _ in range(4)]
            kp = [ops.kernel_params(p, cell, dtype, True, True)
                  for p in sets]
            bound = [ops.BlockOperands(p, cell=cell, compute_dtype=dtype,
                                       use_conv=True, use_mlp=True)
                     for p in sets]
            x = torch.randn((B, C, DX), generator=gen).to(dtype).to(DEV)
            st = {"h": (0.5 * torch.randn((B, DH), generator=gen)
                        ).to(dtype).to(DEV),
                  "conv": torch.randn((B, K - 1, DX), generator=gen
                                      ).to(dtype).to(DEV)}
            xs = [x[:, t].contiguous() for t in range(C)]
            tag = f"{cell}/{str(dtype).split('.')[-1]}"

            # step kernel vs plain, at the serving shape (B, 1 token)
            y, s1 = ops.fused_block_step(sets[0], xs[0], st,
                                         compute_dtype=dtype, **kw)
            y_ref, s1_ref = ref.block_step_ref(kp[0], xs[0], st,
                                               compute_dtype=dtype, **kw)
            e_step = max(max_err(y, y_ref, dtype, f"{tag} step y"),
                         max_err(s1["h"], s1_ref["h"], dtype, f"{tag} step h"),
                         max_err(s1["conv"], s1_ref["conv"], dtype,
                                 f"{tag} step window"))

            # chunk kernel vs plain, mixed valid lengths
            ys, _, pos = ops.fused_block_chunk(
                sets[0], x, st, valid, compute_dtype=dtype,
                return_positions=True, **kw)
            ys_ref, _, pos_ref = ref.block_chunk_ref(
                kp[0], x, st, valid, compute_dtype=dtype, **kw)
            e_chunk = max(max_err(ys, ys_ref, dtype, f"{tag} chunk ys"),
                          max_err(pos["h"], pos_ref["h"], dtype,
                                  f"{tag} chunk hs"),
                          max_err(pos["conv"], pos_ref["conv"], dtype,
                                  f"{tag} chunk windows"))

            # the verify width at C 1 (W = S + 1 = 5), mixed valid lengths
            x5 = x[:, :W_VERIFY].contiguous()
            ys5, _, pos5 = ops.fused_block_chunk(
                sets[0], x5, st, valid_w, compute_dtype=dtype,
                return_positions=True, **kw)
            ys5_ref, _, pos5_ref = ref.block_chunk_ref(
                kp[0], x5, st, valid_w, compute_dtype=dtype, **kw)
            e_chunk = max(e_chunk,
                          max_err(ys5, ys5_ref, dtype, f"{tag} chunk W5 ys"),
                          max_err(pos5["h"], pos5_ref["h"], dtype,
                                  f"{tag} chunk W5 hs"),
                          max_err(pos5["conv"], pos5_ref["conv"], dtype,
                                  f"{tag} chunk W5 windows"))

            # chunk == C step launches, bit for bit; frozen rows too (C 8
            # and the verify width)
            ys_full, _, pos_full = ops.fused_block_chunk(
                sets[0], x, st, full, compute_dtype=dtype,
                return_positions=True, **kw)
            s = st
            for t in range(C):
                y_t, s = ops.fused_block_step(sets[0], xs[t], s,
                                              compute_dtype=dtype, **kw)
                check(torch.equal(y_t, ys_full[:, t])
                      and torch.equal(s["h"], pos_full["h"][:, t])
                      and torch.equal(s["conv"], pos_full["conv"][:, t]),
                      f"{tag}: chunk position {t} != step {t}")
                for b in range(B):
                    if t < int(valid[b]):
                        check(torch.equal(ys[b, t], y_t[b])
                              and torch.equal(pos["h"][b, t], s["h"][b]),
                              f"{tag}: varlen row {b} position {t} != step")
                    if t < int(valid_w[b]):
                        check(torch.equal(ys5[b, t], y_t[b])
                              and torch.equal(pos5["h"][b, t], s["h"][b])
                              and torch.equal(pos5["conv"][b, t],
                                              s["conv"][b]),
                              f"{tag}: W5 row {b} position {t} != step")
                    elif t < W_VERIFY:
                        last = int(valid_w[b]) - 1
                        check(torch.equal(pos5["h"][b, t],
                                          pos5["h"][b, last]),
                              f"{tag}: W5 frozen row {b} position {t}")
            # a row's result does not depend on B
            y3, s3 = ops.fused_block_step(
                sets[0], x[:3, 0].contiguous(),
                {k: v[:3].contiguous() for k, v in st.items()},
                compute_dtype=dtype, **kw)
            check(torch.equal(y3, y[:3]) and torch.equal(s3["h"], s1["h"][:3]),
                  f"{tag}: rows changed with the batch size")

            # the plan the launches run
            pl = ops.plan(bound[0])
            check_plan(tag, pl, dtype)
            plans.append((tag, pl))

            # times: kernel (raw launches), plain version, bound
            step_l = [ops.prepare_launch(b, xs[0][:, None], st, None,
                                         mode="log")[0] for b in bound]
            chunk_l = [ops.prepare_launch(b, x, st, valid, mode="log")[0]
                       for b in bound]
            t_step = eager_ms([raw(f) for f in step_l], 200)
            t_chunk = eager_ms([raw(f) for f in chunk_l], 100)
            d_step = block_graph_ms(bound, xs[0][:, None], st, None)
            d_chunk = block_graph_ms(bound, x, st, valid)
            chunk5_l = [ops.prepare_launch(b, x5, st, valid_w, mode="log")[0]
                        for b in bound]
            verify.append((tag, eager_ms([raw(f) for f in chunk5_l], 100),
                           block_graph_ms(bound, x5, st, valid_w)))
            # the wrapper as the engine calls it: weights bound once
            t_step_wrap = eager_ms([lambda p=p, b=b: ops.fused_block_step(
                p, xs[0], st, compute_dtype=dtype, operands=b, **kw)
                for p, b in zip(sets, bound)], 100)
            t_step_plain = eager_ms([lambda k_=k_: ref.block_step_ref(
                k_, xs[0], st, compute_dtype=dtype, **kw) for k_ in kp], 50)
            t_chunk_plain = eager_ms([lambda k_=k_: ref.block_chunk_ref(
                k_, x, st, valid, compute_dtype=dtype, **kw) for k_ in kp], 20)
            phases = {"step": traced_phases(bound, xs[0][:, None], st, None),
                      "chunk": traced_phases(bound, x, st, valid)}
            b_step = bound_ms(cell, dtype, B, 1)
            b_chunk = bound_ms(cell, dtype, B, C)
            rows.append((tag, step_l[0].grid.value, t_step, d_step,
                         t_step_wrap, t_step_plain, b_step[0], e_step,
                         t_chunk, d_chunk, t_chunk_plain, b_chunk[0],
                         e_chunk))
            traces.append((tag, phases))
            if cell == "mingru" and dtype == torch.bfloat16:
                main = {"block_step_kernel": (e_step, t_step, t_step_plain,
                                              b_step),
                        "block_chunk_kernel": (e_chunk, t_chunk,
                                               t_chunk_plain, b_chunk)}
                DEVICE_MS["block_step_kernel"] = d_step
                DEVICE_MS["block_chunk_kernel"] = d_chunk
            del sets, kp, bound, step_l, chunk_l
            torch.cuda.empty_cache()
    print(f"kernels at Dx {DX} Dh {DH} Dm {DM} K {K}, B {B}, chunk C {C} "
          f"(ms per launch; weights rotate over 4 sets, > L2; ms: eager "
          f"launches, device_ms: a CUDA graph of them; chunk_err also over "
          f"the verify width C {W_VERIFY}, valid {valid_w.tolist()}, whose "
          f"positions equal step launches bit for bit):")
    print("  cell/dtype      grid  step_ms  step_device_ms  step_wrapper_ms  "
          "step_plain_ms  step_bound_ms  step_err  chunk_ms  chunk_device_ms"
          "  chunk_plain_ms  chunk_bound_ms  chunk_err")
    for r in rows:
        print("  {:<15} {:>4}  {:.5f}  {:.5f}  {:.5f}  {:.5f}  {:.5f}  "
              "{:.3g}  {:.5f}  {:.5f}  {:.5f}  {:.5f}  {:.3g}".format(*r))
    print(f"block chunk kernel at the verify width C {W_VERIFY}, valid "
          f"{valid_w.tolist()} (ms per launch, as the chunk above): "
          + "; ".join(f"{tag} {t:.5f}, device {d:.5f}"
                      for tag, t, d in verify))
    print("block kernel plans (any B, C; per phase: S x slice rows, units, "
          "most jobs / bytes of one block, that over the phase's bytes per "
          "SM):")
    for tag, pl in plans:
        print(f"  {tag:<15} grid {pl['grid']} on {pl['sms']} SMs, "
              f"{pl['blocks_per_sm']} block(s)/SM, smem {pl['smem']} B, body "
              f"{pl['body']}, ring {pl['ring_bytes']} B: " + "; ".join(
                  f"{ph['name']} {ph['S']}x{ph['slice_rows']}, {ph['units']} "
                  f"units, {ph['max_block_jobs']} / {ph['max_block_bytes']} B"
                  f" = {ph['share_ratio']:.3f}x" for ph in pl["phases"]))
    print("phase times per launch (us, block 0's %globaltimer; sync_X = "
          "wait at the barrier after phase X):")
    for tag, phases in traces:
        for form, ph in phases.items():
            print(f"  {tag:<15} {form:<5} total {sum(ph.values()):8.2f}  "
                  + "  ".join(f"{k_} {v:7.2f}" for k_, v in ph.items()))
    return main


# cell-only decode kernels: (B, Dx, Dh) and whether the chunk form runs
CELL_SHAPES = {"mingru-lm": (8, 768, 1536, True),
               "gemma-2b-mingru": (8, 2048, 2048, False),
               "ragged": (3, 200, 72, True)}
CELL_VALID = [8, 1, 3, 8, 5, 2, 8, 7]


def cell_operands(gen, cell, dtype, dx, dh):
    ws = [(torch.randn((dx, dh), generator=gen) / dx ** 0.5).to(dtype)
          .to(DEV) for _ in GATES[cell]]
    bs = [(0.1 * torch.randn((dh,), generator=gen)).to(dtype).to(DEV)
          for _ in GATES[cell]]
    return step_ops.CellOperands(cell, ws, bs)


def cell_bound_ms(n_g, dtype, bsz, chunk, dx, dh):
    """Weights, biases, x, h0 read once and the output written once over
    the memory rate (plus valid for a chunk); the projections'
    multiply-adds over the type's peak."""
    e = torch.tensor([], dtype=dtype).element_size()
    nbytes = e * (n_g * (dx * dh + dh) + bsz * chunk * dx + bsz * dh
                  + bsz * chunk * dh) + (4 * bsz if chunk > 1 else 0)
    flops = 2 * bsz * chunk * n_g * dx * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cell_kernel_phase(gen):
    """The four decode_step kernels against their plain versions; returns
    the main numbers: mingru_step_kernel at gemma-2b-mingru's width (every
    decode round of that model), the others at mingru-lm / minlstm-lm's,
    all bf16, B 8.  Also the body each launch took (bf16: the tensor-core
    body; fp32: the CUDA-core body), its occupancy (one wave at the full
    widths), minLSTM without normalize against its plain version, and
    device times of the kernel and the library call as CUDA graphs."""
    rows, occ_lines, main = [], [], {}
    for cell in ("mingru", "minlstm"):
        kw = {} if cell == "mingru" else {"normalize": True}
        step_fn = getattr(step_ops, f"fused_{cell}_step")
        chunk_fn = getattr(step_ops, f"fused_{cell}_chunk")
        step_plain = getattr(step_ref, f"{cell}_step_ref")
        chunk_plain = getattr(step_ref, f"{cell}_chunk_ref")
        n_g = len(GATES[cell])
        for dtype in (torch.float32, torch.bfloat16):
            e = torch.tensor([], dtype=dtype).element_size()
            for shape, (bsz, dx, dh, chunked) in CELL_SHAPES.items():
                if shape == "gemma-2b-mingru" and cell != "mingru":
                    continue
                tag = f"{cell}/{str(dtype).split('.')[-1]}/{shape}"
                # weight sets together larger than the 50 MB L2, so each
                # timed launch streams its weights from HBM
                n_sets = min(16, math.ceil(60e6 / (n_g * dx * dh * e)))
                sets = [cell_operands(gen, cell, dtype, dx, dh)
                        for _ in range(n_sets)]
                body = sets[0].body
                want_body = "tc" if dtype == torch.bfloat16 else "cuda_core"
                check(body == want_body, f"{tag}: bound to the {body} body")
                x = torch.randn((bsz, C, dx), generator=gen).to(dtype).to(DEV)
                h = (0.5 * torch.randn((bsz, dh), generator=gen)).to(dtype) \
                    .to(DEV)
                valid = torch.tensor(CELL_VALID[:bsz], dtype=torch.int32,
                                     device=DEV)
                x0 = x[:, 0].contiguous()
                w_cat = [torch.cat(s_.ws, dim=1) for s_ in sets]
                step_ops.reset_launches()
                got = step_fn(x0, *sets[0].args, h, operands=sets[0], **kw)
                e_step = max_err(got, step_plain(x0, *sets[0].args, h, **kw),
                                 dtype, f"{tag} step")
                # a row's result does not depend on B
                check(torch.equal(step_fn(x0[:1], *sets[0].args, h[:1],
                                          operands=sets[0], **kw), got[:1]),
                      f"{tag}: a row changed with the batch size")
                forms = [("step", 1)] + ([("chunk", C)] if chunked else [])
                for form, c_ in forms:
                    occ = step_ops.occupancy(sets[0], bsz, c_)
                    clusters = (f" in clusters of {occ['cluster']} "
                                f"({occ['clusters_resident']} resident at "
                                f"once)" if occ["cluster"] > 1 else "")
                    occ_lines.append(
                        f"  {tag + '/' + form:<38} body {occ['body']:<9} "
                        f"{occ['blocks_per_sm']} block(s)/SM, "
                        f"{occ['grid_blocks']} blocks{clusters} on "
                        f"{occ['sms']} SMs, {occ['waves']} wave(s)")
                    if body == "tc" and shape != "ragged":
                        check(occ["waves"] == 1, f"{tag} {form}: {occ}")
                step_l = [raw(step_ops.prepare_launch(
                    s_, x0[:, None], h, None, mode="log", **kw)[0])
                    for s_ in sets]
                t_step = eager_ms(step_l, 200)
                t_step_host = host_ms(step_l, 200)
                # launches bound inside the capture, on its stream
                t_step_dev = graph_ms(rotating([
                    lambda s_=s_: raw(step_ops.prepare_launch(
                        s_, x0[:, None], h, None, mode="log", **kw)[0])()
                    for s_ in sets]))
                t_step_plain = eager_ms([lambda s_=s_: step_plain(
                    x0, *s_.args, h, **kw) for s_ in sets], 50)
                lib_step = [lambda w=w: x0 @ w for w in w_cat]
                t_step_lib = eager_ms(lib_step, 200)
                t_step_lib_dev = graph_ms(rotating(lib_step))
                b_step = cell_bound_ms(n_g, dtype, bsz, 1, dx, dh)
                row = [tag, body, t_step, t_step_host, t_step_dev,
                       t_step_plain,
                       t_step_lib, t_step_lib_dev, b_step[0], e_step]
                if chunked:
                    hs = chunk_fn(x, *sets[0].args, h, valid,
                                  operands=sets[0], **kw)
                    e_chunk = max_err(hs, chunk_plain(x, *sets[0].args, h,
                                                      valid, **kw),
                                      dtype, f"{tag} chunk")
                    # the verify width at C 1 (W = S + 1), mixed valid
                    x5 = x[:, :W_VERIFY].contiguous()
                    v5 = valid.clamp(max=W_VERIFY)
                    hs5 = chunk_fn(x5, *sets[0].args, h, v5,
                                   operands=sets[0], **kw)
                    e_chunk = max(e_chunk, max_err(
                        hs5, chunk_plain(x5, *sets[0].args, h, v5, **kw),
                        dtype, f"{tag} chunk W{W_VERIFY}"))
                    # a chunk equals C step launches, bit for bit (C 8 and
                    # the verify width)
                    s_h = h
                    for t in range(C):
                        st = step_fn(x[:, t].contiguous(), *sets[0].args,
                                     s_h, operands=sets[0], **kw)
                        s_h = torch.where((t < valid)[:, None], st, s_h)
                        check(torch.equal(hs[:, t], s_h),
                              f"{tag}: chunk position {t} != step launches")
                        if t < W_VERIFY:
                            check(torch.equal(hs5[:, t], s_h),
                                  f"{tag}: W{W_VERIFY} position {t} != "
                                  f"step launches")
                    t_chunk = eager_ms([raw(step_ops.prepare_launch(
                        s_, x, h, valid, mode="log", **kw)[0])
                        for s_ in sets], 100)
                    t_chunk_dev = graph_ms(rotating([
                        lambda s_=s_: raw(step_ops.prepare_launch(
                            s_, x, h, valid, mode="log", **kw)[0])()
                        for s_ in sets]))
                    t_chunk_plain = eager_ms([lambda s_=s_: chunk_plain(
                        x, *s_.args, h, valid, **kw) for s_ in sets], 20)
                    x2 = x.reshape(-1, dx)
                    lib_chunk = [lambda w=w: x2 @ w for w in w_cat]
                    t_chunk_lib = eager_ms(lib_chunk, 200)
                    t_chunk_lib_dev = graph_ms(rotating(lib_chunk))
                    b_chunk = cell_bound_ms(n_g, dtype, bsz, C, dx, dh)
                    row += [t_chunk, t_chunk_dev, t_chunk_plain, t_chunk_lib,
                            t_chunk_lib_dev, b_chunk[0], e_chunk]
                else:
                    row += [float("nan")] * 7
                if cell == "minlstm":
                    # without normalize: plain sigmoids, the same body
                    nkw = {"normalize": False}
                    max_err(step_fn(x0, *sets[0].args, h, operands=sets[0],
                                    **nkw),
                            step_plain(x0, *sets[0].args, h, **nkw), dtype,
                            f"{tag} step, normalize off")
                    if chunked:
                        hs = chunk_fn(x, *sets[0].args, h, valid,
                                      operands=sets[0], **nkw)
                        max_err(hs, chunk_plain(x, *sets[0].args, h, valid,
                                                **nkw),
                                dtype, f"{tag} chunk, normalize off")
                        s_h = h
                        for t in range(C):
                            st = step_fn(x[:, t].contiguous(), *sets[0].args,
                                         s_h, operands=sets[0], **nkw)
                            s_h = torch.where((t < valid)[:, None], st, s_h)
                            check(torch.equal(hs[:, t], s_h),
                                  f"{tag}: normalize off, chunk position "
                                  f"{t} != step launches")
                # every launch above took the body the weights were bound to
                for form in ("step", "chunk"):
                    name = f"{cell}_{form}_kernel"
                    check(step_ops.LAUNCHES[f"{name}/{body}"]
                          == step_ops.LAUNCHES[name],
                          f"{tag}: launches by body {step_ops.LAUNCHES}")
                rows.append(row)
                if dtype == torch.bfloat16:
                    if shape == ("gemma-2b-mingru" if cell == "mingru"
                                 else "mingru-lm"):
                        main[f"{cell}_step_kernel"] = (
                            e_step, t_step, t_step_plain, b_step)
                        LIBRARY_MS[f"{cell}_step_kernel"] = t_step_lib
                        DEVICE_MS[f"{cell}_step_kernel"] = t_step_dev
                        LIBRARY_DEVICE_MS[f"{cell}_step_kernel"] = \
                            t_step_lib_dev
                    if shape == "mingru-lm":
                        main[f"{cell}_chunk_kernel"] = (
                            e_chunk, t_chunk, t_chunk_plain, b_chunk)
                        LIBRARY_MS[f"{cell}_chunk_kernel"] = t_chunk_lib
                        DEVICE_MS[f"{cell}_chunk_kernel"] = t_chunk_dev
                        LIBRARY_DEVICE_MS[f"{cell}_chunk_kernel"] = \
                            t_chunk_lib_dev
                del sets, w_cat
                torch.cuda.empty_cache()
    step_ops.reset_launches()
    print(f"cell-only decode kernels, chunk C {C} with valid {CELL_VALID} "
          f"(chunk_err also over the verify width C {W_VERIFY}, valid "
          f"clamped to it, bit for bit with step launches too; ms per "
          f"launch; weight sets rotate, > L2 where they fit in 16; ms: "
          f"eager launches, device_ms: the same launches captured in a "
          f"CUDA graph, 20 per graph replayed 5 times; host_ms: the "
          f"host's time to issue one eager launch; library = one "
          f"torch.matmul of x against the concatenated projections, timed "
          f"both ways; every launch on the body named; a row independent "
          f"of B and a chunk equal to C step launches, bit for bit):")
    print("  cell/dtype/shape                 body       step_ms  "
          "step_host_ms  step_device_ms  step_plain_ms  step_library_ms  "
          "step_library_device_ms  step_bound_ms  step_err  chunk_ms  "
          "chunk_device_ms  chunk_plain_ms  chunk_library_ms  "
          "chunk_library_device_ms  chunk_bound_ms  chunk_err")
    for r in rows:
        print("  {:<32} {:<9}  {:.5f}  {:.5f}  {:.5f}  {:.5f}  {:.5f}  {:.5f}  "
              "{:.5f}  {:.3g}  {:.5f}  {:.5f}  {:.5f}  {:.5f}  {:.5f}  "
              "{:.5f}  {:.3g}".format(*r))
    print("cell kernel occupancy (cudaOccupancyMaxActiveBlocksPerMultiprocessor"
          " and, for clusters, cudaOccupancyMaxActiveClusters at the "
          "launch's grid and shared memory):")
    for line in occ_lines:
        print(line)
    return main


# ---------------------------------------------------------------------------
# 3. serving
# ---------------------------------------------------------------------------

PROMPTS = ["To be, o", "Friends,", "Now is t", "What's i", "O Romeo,",
           "All the ", "Tomorrow", "Double, "]


def serve_launches():
    """Launch totals per kernel (the cell kernels' per-body counts are in
    ``cell_body_launches``)."""
    out = dict(ops.LAUNCHES)
    out.update({k: v for k, v in step_ops.LAUNCHES.items() if "/" not in k})
    return out


def cell_body_launches():
    """Cell-kernel launches by body, e.g. "mingru_step_kernel/tc"."""
    return {k: v for k, v in step_ops.LAUNCHES.items() if "/" in k}


def reset_serve_launches():
    ops.reset_launches()
    step_ops.reset_launches()


def tokens_of(p):
    return list(p.encode()) if isinstance(p, str) else list(p)


def serve(cfg, params, chunk, prompts, max_new, k=4, label="serve",
          quiet=False, spec=None, **submit_kw):
    """One closed batch through a fresh engine; returns the streams and
    {"rounds", "launches" (this run's, per kernel), "rate" (decoded
    tok/s), "stats" (the snapshot)}; ``quiet`` prints nothing.  ``spec``:
    the engine's speculative options.  Checks one decode kernel launch
    per layer per device round (speculation: one verify chunk; a model
    draft adds S draft steps and one draft commit chunk)."""
    eng = ServingEngine(cfg, params, max_batch=8, max_len=128, seed=0,
                        decode_block=k, prompt_chunk=chunk, device=DEV,
                        **(spec or {}))
    per_round = 1
    if isinstance(eng.draft, draft_lib.ModelDraft):
        per_round += eng.draft.draft_len + 1
    before = serve_launches()
    rids = [eng.submit(tokens_of(p), max_new=max_new, **submit_kw)
            for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.run_to_completion()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    delta = {n: v - before[n] for n, v in serve_launches().items()}
    launched = sum(delta.values())
    rounds = eng.stats.decode_steps
    check(launched == cfg.n_layers * rounds * per_round,
          f"{cfg.name} C={chunk}: {launched} kernel launches for "
          f"{cfg.n_layers} layers x {rounds} rounds x {per_round}")
    check(eng.stats.completed == len(prompts)
          and eng.stats.shard_identities_ok(),
          f"{cfg.name} C={chunk}: engine stats {eng.stats.snapshot()}")
    snap = eng.stats.snapshot()
    n_tok = snap["decode_tokens"]
    streams = [tuple(outs[r]) for r in rids]
    info = {"rounds": rounds, "launches": delta, "rate": n_tok / dt,
            "stats": snap}
    if quiet:
        return streams, info
    what = "" if eng.draft is None else \
        f" {type(eng.draft).__name__} S={eng.draft.draft_len}"
    print(f"{label} {cfg.name} [{eng.kernel_tier}]{what} K={k} C={chunk}: "
          f"{n_tok} tokens in {dt:.3f}s "
          f"({n_tok / dt:.1f} decoded tok/s, "
          f"{snap['tokens_per_second']:.1f} tok/s incl. prompt), "
          f"{rounds} rounds, {snap['decode_calls']} host round-trips, "
          f"{launched} kernel launches, ttft mean "
          f"{snap['ttft_s_mean'] * 1e3:.2f} ms, itl mean "
          f"{snap['itl_s_mean'] * 1e3:.2f} ms")
    print("  engine stats: " + ", ".join(
        f"{k_}={v:.4g}" if isinstance(v, float) else f"{k_}={v}"
        for k_, v in sorted(snap.items()) if k_ != "shards"))
    return streams, info


def rate_spread(cfg, params, reps=5, chunks=(1, 8), prompts=PROMPTS):
    """Decoded tok/s over ``reps`` windows of the serving traffic per C:
    min / median / max, since one window of 8 requests is short and the
    host clock varies."""
    tier = lm.kernel_tier(cfg)
    for c in chunks:
        rates = sorted(serve(cfg, params, c, prompts, 32, quiet=True)[1]
                       ["rate"] for _ in range(reps))
        print(f"rate {cfg.name} [{tier}] K=4 C={c}, {reps} windows of 8 "
              f"requests x 32 tokens: decoded tok/s min {rates[0]:.1f} "
              f"median {rates[reps // 2]:.1f} max {rates[-1]:.1f}")


def sampled_phase(cfg, params, reps=50):
    """What a sampled request costs: the host's key-chain catch-up and
    Gumbel table for one K = 4 superstep (8 slots, each 4 emissions
    behind), and a seeded sampled run, served twice, against the greedy
    rate."""
    keys = sampling.make_keys(0, 8)
    lag = torch.full((8,), 4, dtype=torch.int32)
    t0 = time.perf_counter()
    for _ in range(reps):
        noise = sampling.gumbel_table(sampling.advance_keys(keys, lag), 4,
                                      cfg.padded_vocab).to(DEV)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    check(bool(torch.isfinite(noise).all()), "non-finite Gumbel table")
    kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    runs = [serve(cfg, params, 1, PROMPTS, 32, quiet=True, **kw)
            for _ in range(2)]
    check(runs[0][0] == runs[1][0], "seeded sampled streams differ between "
          "two runs")
    for s in runs[0][0]:
        check(len(s) == 32 and all(0 <= t < cfg.vocab_size for t in s),
              "malformed sampled stream")
    greedy = serve(cfg, params, 1, PROMPTS, 32, quiet=True)[1]["rate"]
    print(f"sampled {cfg.name} K=4 C=1 (T 0.8, top-k 40, top-p 0.95): host "
          f"key catch-up + Gumbel table {host_ms:.3f} ms per superstep; "
          f"decoded tok/s {runs[0][1]['rate']:.1f} / "
          f"{runs[1][1]['rate']:.1f} sampled against {greedy:.1f} greedy; "
          f"seeded streams repeat")


def host_profile(cfg, params, top=12):
    """Where a serving run spends host time: cProfile over one C=1 run
    (outside the counted main path), top functions by own time."""
    import cProfile
    import io
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    serve(cfg, params, 1, PROMPTS, 32, label="profiled")
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    print("host profile of the profiled run (top by own time):")
    for ln in lines[-(top + 1):]:
        print("  " + ln)


def serve_phase(gen):
    cfg = archs.get("mingru-lm")
    params = lm.init_params(gen, cfg, device=DEV)
    for c in (1, 8):               # first-use allocations off the clock
        serve(cfg, params, c, PROMPTS, 4, label="warm-up")
    host_profile(cfg, params)
    reset_serve_launches()
    streams = {c: serve(cfg, params, c, PROMPTS, 32)[0] for c in (1, 8)}
    lstm_cfg = archs.get("minlstm-lm")
    lstm_params = lm.init_params(gen, lstm_cfg, device=DEV)
    lstm_streams = serve(lstm_cfg, lstm_params, 8, PROMPTS[:4], 8)[0]
    launches = dict(ops.LAUNCHES)
    check(set(step_ops.LAUNCHES.values()) == {0},
          f"the block tier launched cell kernels: {step_ops.LAUNCHES}")
    for name, n in launches.items():
        check(n > 0, f"{name} was launched no time on the main path")
    check(streams[1] == streams[8], "greedy streams differ across C")
    for p, s in zip(PROMPTS, streams[1]):
        ref_s = generate_one(cfg, params, list(p.encode()), max_new=32,
                             max_len=128, device=DEV)
        check(tuple(ref_s) == s, f"stream for {p!r} != generate_one")
    for p, s in zip(PROMPTS[:2], lstm_streams):
        ref_s = generate_one(lstm_cfg, lstm_params, list(p.encode()),
                             max_new=8, max_len=128, device=DEV)
        check(tuple(ref_s) == s, f"minlstm stream for {p!r} != generate_one")
    for s in streams[1]:
        check(len(s) == 32 and all(0 <= t < cfg.vocab_size for t in s),
              "malformed stream")
    print(f"serve: streams identical across C and equal to generate_one; "
          f"launches on the main path {launches}")
    rate_spread(cfg, params)
    sampled_phase(cfg, params)
    return launches, (cfg, params, streams[1])


def serve_profile(cfg, params, prompts, label, spec=None, chunk=1):
    """Where one window's device time goes: ``torch.profiler`` over one
    K 4 window (after the warm-ups), device kernels by group and the
    device-busy share of the window's wall time (the profiler's own host
    cost inflates the wall time, so the share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(cfg, params, chunk, prompts, 8, quiet=True, spec=spec)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    if not events:
        print(f"{label} profile: the profiler saw no device time")
        return
    groups = {"cell kernel": 0.0, "block kernel": 0.0, "cuBLAS": 0.0,
              "elementwise, reductions, copies": 0.0}
    for e in events:
        if any(k_ in e.key for k_ in ("cell_kernel", "cell_tc_kernel",
                                      "cell_tc_joint_kernel",
                                      "cell_tc_lstm_chunk_kernel")):
            groups["cell kernel"] += dev_us(e) / 1e3
        elif "block_kernel" in e.key:
            groups["block kernel"] += dev_us(e) / 1e3
        elif any(k_ in e.key.lower() for k_ in ("gemm", "cutlass", "xmma",
                                                 "nvjet", "cublas", "gemv")):
            groups["cuBLAS"] += dev_us(e) / 1e3
        else:
            groups["elementwise, reductions, copies"] += dev_us(e) / 1e3
    busy = sum(groups.values())
    print(f"{label} profile, one window of {len(prompts)} requests x 8 "
          f"tokens (K 4, C {chunk}): wall {wall_ms:.2f} ms under the "
          f"profiler, "
          f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%); "
          + ", ".join(f"{k_} {v:.2f} ms" for k_, v in groups.items())
          + f"; {sum(e.count for e in events)} device events")
    for e in sorted(events, key=dev_us, reverse=True)[:6]:
        print(f"    {dev_us(e) / 1e3:8.3f} ms  {e.count:5d}  {e.key[:80]}")


def first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def cell_serve_phase(gen, cfg, params, block_streams):
    """mingru-lm on the cell-fused tier (fuse_block "off"), C 1 and 8, then
    minlstm-lm at C 8: one cell launch per layer per round, streams equal
    across C and to ``generate_one`` on the same tier; beside the block
    tier: the streams (reported) and the first round's logits (held to the
    bf16 tolerance)."""
    off = cfg.replace(fuse_block="off")
    check(lm.kernel_tier(off) == "cell-fused", "fuse_block off not cell")
    for c in (1, 8):
        serve(off, params, c, PROMPTS, 4, label="warm-up")
    lstm_off = archs.get("minlstm-lm").replace(fuse_block="off")
    lstm_params = lm.init_params(gen, lstm_off, device=DEV)
    reset_serve_launches()
    streams, infos = {}, {}
    for c in (1, 8):
        streams[c], infos[c] = serve(off, params, c, PROMPTS, 32)
    lstm_streams, lstm_info = serve(lstm_off, lstm_params, 8, PROMPTS[:4], 8)
    launches = {k: v for k, v in step_ops.LAUNCHES.items() if "/" not in k}
    check(set(ops.LAUNCHES.values()) == {0},
          f"the cell tier launched block kernels: {ops.LAUNCHES}")
    # every full-width bf16 launch on the tensor-core body, minGRU and
    # minLSTM alike
    bodies = cell_body_launches()
    want_bodies = {f"{k}/{b}": (launches[k] if b == "tc" else 0)
                   for k in launches for b in ("tc", "cuda_core")}
    check(bodies == want_bodies,
          f"cell tier launches by body {bodies} != {want_bodies}")
    layers = cfg.n_layers
    d1, d8 = infos[1]["launches"], infos[8]["launches"]
    check(d1["mingru_step_kernel"] == layers * infos[1]["rounds"]
          and d1["mingru_chunk_kernel"] == 0,
          f"C=1 cell launches {d1} for {infos[1]['rounds']} rounds")
    check(d8["mingru_chunk_kernel"] > 0 and d8["mingru_step_kernel"]
          + d8["mingru_chunk_kernel"] == layers * infos[8]["rounds"],
          f"C=8 cell launches {d8} for {infos[8]['rounds']} rounds")
    dl = lstm_info["launches"]
    check(dl["minlstm_chunk_kernel"] > 0 and dl["minlstm_step_kernel"]
          + dl["minlstm_chunk_kernel"] == layers * lstm_info["rounds"],
          f"minlstm C=8 cell launches {dl}")
    for name, n in launches.items():
        check(n > 0, f"{name} was launched no time on the cell tier")
    check(streams[1] == streams[8], "cell tier: greedy streams differ "
          "across C")
    for p, s_ in zip(PROMPTS, streams[1]):
        ref_s = generate_one(off, params, list(p.encode()), max_new=32,
                             max_len=128, device=DEV)
        check(tuple(ref_s) == s_, f"cell tier: stream for {p!r} != "
              f"generate_one")
    for p, s_ in zip(PROMPTS[:2], lstm_streams):
        ref_s = generate_one(lstm_off, lstm_params, list(p.encode()),
                             max_new=8, max_len=128, device=DEV)
        check(tuple(ref_s) == s_, f"cell tier: minlstm stream for {p!r} != "
              f"generate_one")
    print(f"serve cell tier: streams identical across C and equal to "
          f"generate_one; launches {launches}, by body {bodies} "
          f"(C 1: {d1['mingru_step_kernel']}"
          f" step for {infos[1]['rounds']} rounds; C 8: "
          f"{d8['mingru_step_kernel']} step + {d8['mingru_chunk_kernel']} "
          f"chunk for {infos[8]['rounds']} rounds)")
    # beside the block tier
    div = [first_divergence(a, b) for a, b in zip(streams[1], block_streams)]
    same = sum(d is None for d in div)
    print(f"cell tier vs block tier, greedy streams: {same} of "
          f"{len(div)} identical; first diverging positions "
          f"{[d for d in div]}")
    tok = torch.tensor([p.encode()[0] for p in PROMPTS], dtype=torch.int32,
                       device=DEV)
    lb, _ = lm.decode_step(params, cfg, tok, lm.init_cache(cfg, 8, 16, DEV))
    lc, _ = lm.decode_step(params, off, tok, lm.init_cache(off, 8, 16, DEV))
    e_log = max_err(lc, lb, torch.bfloat16,
                    "first-round logits, cell tier vs block tier")
    print(f"first-round logits, cell tier vs block tier: max abs err "
          f"{e_log:.3g} (bf16 limit atol {TOL[torch.bfloat16][0]} rtol "
          f"{TOL[torch.bfloat16][1]})")
    rate_spread(off, params)
    serve_profile(off, params, PROMPTS, "cell tier mingru-lm")
    serve_profile(lstm_off, lstm_params, PROMPTS, "cell tier minlstm-lm")
    return launches


def gemma_phase():
    """gemma-2b-mingru at full width: 18 layers, d_model 2048, GeGLU d_ff
    16384, vocab 256,000, bf16, weights drawn on the card from a seed.
    Every decode round runs mingru_step_kernel once per layer."""
    cfg = archs.get("gemma-2b-mingru")
    check(cfg.n_layers == 18 and cfg.d_model == 2048
          and cfg.cdtype == torch.bfloat16 and cfg.vocab_size == 256000,
          f"unexpected gemma-2b-mingru config {cfg}")
    check(lm.kernel_tier(cfg) == "cell-fused", "gemma-2b-mingru not cell")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=DEV).manual_seed(0), cfg,
                            device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(a.numel() for a in leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    pgen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (8, 8),
                            generator=pgen).tolist()
    print(f"gemma-2b-mingru: {n_params} parameters drawn on the card in "
          f"{t_init:.2f}s; peak device memory during the init "
          f"{init_peak / 2**30:.2f} GiB")
    serve(cfg, params, 1, prompts, 4, label="warm-up")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_serve_launches()
    streams, info = serve(cfg, params, 1, prompts, 32)
    launches = serve_launches()
    serve_peak = torch.cuda.max_memory_allocated()
    check(launches["mingru_step_kernel"] == cfg.n_layers * info["rounds"]
          and sum(launches.values()) == launches["mingru_step_kernel"],
          f"gemma launches {launches} for {info['rounds']} rounds")
    check(step_ops.LAUNCHES["mingru_step_kernel/tc"]
          == launches["mingru_step_kernel"],
          f"gemma launches by body {cell_body_launches()}")
    for p, s_ in zip(prompts, streams):
        check(len(s_) == 32 and all(0 <= t < cfg.vocab_size for t in s_),
              "malformed gemma stream")
        ref_s = generate_one(cfg, params, p, max_new=32, max_len=128,
                             device=DEV)
        check(tuple(ref_s) == s_, f"gemma stream for {p} != generate_one")
    print(f"serve gemma-2b-mingru: streams equal generate_one; "
          f"mingru_step_kernel launches {launches['mingru_step_kernel']} == "
          f"{cfg.n_layers} x {info['rounds']} rounds, all on the tensor-core "
          f"body; peak device memory "
          f"while serving {serve_peak / 2**30:.2f} GiB")
    rate_spread(cfg, params, chunks=(1,), prompts=prompts)
    serve_profile(cfg, params, prompts, "gemma-2b-mingru")
    # sampled: the Gumbel table is drawn on the host, vocab 256,000 wide
    keys = sampling.make_keys(0, 8)
    t0 = time.perf_counter()
    table = sampling.gumbel_table(keys, 4, cfg.padded_vocab)
    t_table = time.perf_counter() - t0
    check(bool(torch.isfinite(table).all()), "non-finite Gumbel table")
    t0 = time.perf_counter()
    s_streams, s_info = serve(cfg, params, 1, prompts, 8, quiet=True,
                              temperature=0.8, top_k=40, top_p=0.95)
    t_window = time.perf_counter() - t0
    for s_ in s_streams:
        check(len(s_) == 8 and all(0 <= t < cfg.vocab_size for t in s_),
              "malformed sampled gemma stream")
    print(f"sampled gemma-2b-mingru, one window of 8 requests x 8 tokens "
          f"(K 4, T 0.8, top-k 40, top-p 0.95): {t_window:.2f}s, decoded "
          f"tok/s {s_info['rate']:.1f}; one host Gumbel table (8 slots x 4 "
          f"x {cfg.padded_vocab}) {t_table * 1e3:.1f} ms")
    merge(launches, gemma_prefill(cfg, params))
    del params
    torch.cuda.empty_cache()
    return launches



# ---------------------------------------------------------------------------
# 4b. prefill and speculative serving
# ---------------------------------------------------------------------------

def merge(launches, new):
    for name, n in new.items():
        launches[name] = launches.get(name, 0) + n


# the prefill traffic: 8 prompts right-padded to 1024, across the fused
# kernel's 128-row T chunks (1, one chunk and a bit, ragged, 8 whole)
PREFILL_LENS = (1, 17, 64, 127, 128, 300, 513, 1024)
# two prefill routes against each other (padded / unpadded, resumed /
# single pass, parallel / sequential, the two scan strategies): logits as
# the largest |difference| over the largest |logit|, states elementwise
# at TOL.  bf16: cuBLAS may sum the down / MLP products of another row
# count in another order, and the sequential path rounds h to bf16 after
# every step where the fused scan carries it in fp32: a few bf16 ulps
# through 12 layers.  fp32: the same arithmetic in another order.
PREFILL_REL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}


def padded_prompts(gen, lens, vocab, t=None):
    """Seeded token ids (B, T) right-padded with 0 past ``lens``, on the
    card, and the lengths."""
    t = t or max(lens)
    toks = torch.randint(1, vocab, (len(lens), t), generator=gen,
                         dtype=torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32)
    toks[torch.arange(t)[None] >= lengths[:, None]] = 0
    return toks.to(DEV), lengths.to(DEV)


def synced_ms(fn, reps=5):
    """Host ms of ``fn()`` ending in a synchronise: sorted over ``reps``."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)


def prefill_checks(cfg, params, toks, lens, logits, cache, gen):
    """Outside the count: each padded row against its own unpadded
    prefill; the full-length batch resumed at 512 against one pass and
    against the sequential path (``decode_chunk``, 128 tokens a call)."""
    dt = cfg.cdtype
    worst = {"row": 0.0, "resume": 0.0, "sequential": 0.0}
    for b, n in enumerate(PREFILL_LENS):
        l1, c1 = lm.prefill(params, cfg, toks[b:b + 1, :n], 2048)
        check(int(cache["pos"][b]) == n, f"pos of row {b}")
        worst["row"] = max(worst["row"], rel_err(
            logits[b], l1[0], f"{cfg.name} padded row {b} logits",
            PREFILL_REL[dt]))
        for k_ in ("h", "conv"):
            max_err(cache[k_][:, b], c1[k_][:, 0], dt,
                    f"{cfg.name} padded row {b} {k_}")
    full = torch.randint(1, cfg.vocab_size, (8, 1024), generator=gen,
                         dtype=torch.int32).to(DEV)
    l_one, c_one = lm.prefill(params, cfg, full, 2048)
    l_res, c_res = lm.prefill(params, cfg, full[:, :512], 2048)
    l_res, c_res = lm.prefill(params, cfg, full[:, 512:], 2048, cache=c_res)
    worst["resume"] = rel_err(l_res, l_one, f"{cfg.name} resumed at 512",
                              PREFILL_REL[dt])
    for k_ in ("h", "conv"):
        max_err(c_res[k_], c_one[k_], dt, f"{cfg.name} resumed {k_}")
    layers = lm.bind_layers(params, cfg)
    valid = torch.full((8,), 128, dtype=torch.int32, device=DEV)

    def sequential():
        c_seq = lm.init_cache(cfg, 8, 2048, DEV)
        for off in range(0, 1024, 128):
            l_seq, c_seq = lm.decode_chunk(params, cfg,
                                           full[:, off:off + 128], valid,
                                           c_seq, layers=layers)
        return l_seq, c_seq

    l_seq, c_seq = sequential()
    worst["sequential"] = rel_err(l_one, l_seq, f"{cfg.name} parallel vs "
                                  f"sequential", PREFILL_REL[dt])
    e_h = max_err(c_one["h"], c_seq["h"], dt, f"{cfg.name} parallel vs "
                  f"sequential h")
    # both routes timed on the same B 8 x T 1024 prompts (synchronised)
    ms = {"parallel": synced_ms(lambda: lm.prefill(params, cfg, full, 2048),
                                reps=3)[1],
          "sequential": synced_ms(sequential, reps=3)[1]}
    return worst, e_h, ms


def prefill_phase(gen):
    """mingru-lm and minlstm-lm at full width: one padded prefill each
    (B 8, lengths PREFILL_LENS), then mingru-lm under scan_strategy
    "pallas" fresh and resumed: the counted main path.  Then, outside the
    count, the prefill checks, fp32 prefill + 16 decode steps against
    ``generate_one`` and the numbers."""
    cfgs = {n: archs.get(n) for n in ("mingru-lm", "minlstm-lm")}
    params = {n: lm.init_params(gen, c, device=DEV) for n, c in cfgs.items()}
    toks, lens = padded_prompts(gen, PREFILL_LENS, 256)
    pallas = cfgs["mingru-lm"].replace(scan_strategy="pallas")
    for n, c in list(cfgs.items()) + [("pallas", pallas)]:   # first use
        lm.prefill(params["mingru-lm" if n == "pallas" else n], c,
                   toks[:, :8], 64)
    torch.cuda.synchronize()

    reset_train_launches()
    out = {}
    for n, c in cfgs.items():
        out[n] = lm.prefill(params[n], c, toks, 2048, lengths=lens)
    lp, cp = lm.prefill(params["mingru-lm"], pallas, toks[:, :512], 2048)
    lp, cp = lm.prefill(params["mingru-lm"], pallas, toks[:, 512:], 2048,
                        cache=cp)
    torch.cuda.synchronize()
    launches = train_launches()
    bodies = body_launches()
    layers = cfgs["mingru-lm"].n_layers
    want = {"fused_mingru_kernel": layers, "fused_minlstm_kernel": layers,
            "log_scan_kernel": 2 * layers, "linear_scan_kernel": 0}
    check(launches == want, f"prefill launches {launches} != {want}")
    check(bodies["fused_mingru_kernel/tc"] == layers
          and bodies["fused_minlstm_kernel/tc"] == layers,
          f"prefill launches by body {bodies}")
    print(f"prefill: launches on the main path {launches} == {want} (one "
          f"fused-cell launch per layer per prefill, by body {bodies}; the "
          f"pallas prefill and its resume one log scan per layer each)")

    for n, c in cfgs.items():
        worst, e_h, ms = prefill_checks(c, params[n], toks, lens, *out[n],
                                        gen)
        print(f"prefill {n} (bf16, B 8, lengths {list(PREFILL_LENS)}): "
              f"logits relative error, padded row vs its own prefill "
              f"{worst['row']:.3g}, resumed at 512 vs one pass "
              f"{worst['resume']:.3g}, parallel vs sequential "
              f"{worst['sequential']:.3g} (limit "
              f"{PREFILL_REL[c.cdtype]}); h parallel vs sequential max abs "
              f"err {e_h:.3g}; padded and resumed h / conv within "
              f"the bf16 tolerance")
        print(f"rate prefill {n} B 8 x T 1024, median of 3: parallel "
              f"(lm.prefill) {ms['parallel']:.3f} ms, sequential "
              f"(decode_chunk C 128, {lm.kernel_tier(c)} tier) "
              f"{ms['sequential']:.3f} ms: "
              f"{ms['sequential'] / ms['parallel']:.1f}x")
    l_auto, _ = lm.prefill(params["mingru-lm"], cfgs["mingru-lm"],
                           toks, 2048)
    e_p = rel_err(lp, l_auto, "pallas vs fused prefill",
                  PREFILL_REL[torch.bfloat16])
    print(f"prefill mingru-lm under scan_strategy pallas, resumed at 512 "
          f"(log scan, h0 given): logits relative error against the fused "
          f"prefill {e_p:.3g}")

    # fp32 at full width (the CUDA-core bodies): prefill + 16 decode steps
    # against generate_one
    cfg32 = cfgs["mingru-lm"].replace(param_dtype="float32",
                                      compute_dtype="float32")
    p32 = tree_map(lambda a: a.float(), params["mingru-lm"])
    layers32 = lm.bind_layers(p32, cfg32)
    for i, p in enumerate(PROMPTS[:3]):
        prompt = tokens_of(p * (i + 1))
        lg, cache = lm.prefill(p32, cfg32, torch.tensor(
            [prompt], dtype=torch.int32, device=DEV), 256)
        par = [int(lg[0, :cfg32.vocab_size].argmax())]
        for _ in range(16):
            lg, cache = lm.decode_step(
                p32, cfg32, torch.tensor(par[-1:], dtype=torch.int32,
                                         device=DEV), cache,
                layers=layers32)
            par.append(int(lg[0, :cfg32.vocab_size].argmax()))
        seq = generate_one(cfg32, p32, prompt, max_new=17, max_len=256,
                           device=DEV)
        check(par == seq, f"fp32 prefill + decode stream for {p!r} != "
              f"generate_one: {par} vs {seq}")
    print("prefill fp32 mingru-lm (CUDA-core bodies): 3 streams of prefill "
          "+ 16 decode_step equal generate_one's")

    # numbers, outside the count
    cfg, prm = cfgs["mingru-lm"], params["mingru-lm"]
    lay = lm.bind_layers(prm, cfg)
    for t in (256, 1024):
        x = torch.randint(1, 256, (8, t), generator=gen,
                          dtype=torch.int32).to(DEV)
        ms = synced_ms(lambda: lm.prefill(prm, cfg, x, 2048))
        print(f"rate prefill mingru-lm B 8 x T {t}: ms min {ms[0]:.3f} "
              f"median {ms[2]:.3f} max {ms[-1]:.3f}; prompt tokens/s "
              f"median {8 * t / ms[2] * 1e3:.0f}")

    def fig3():
        lg, cache = lm.prefill(prm, cfg, x, 2048)
        tok = lg.argmax(-1).to(torch.int32)
        for _ in range(16):
            lg, cache = lm.decode_step(prm, cfg, tok, cache, layers=lay)
            tok = lg.argmax(-1).to(torch.int32)

    ms = synced_ms(fig3)
    print(f"rate Fig. 3 shape, mingru-lm B 8 x T 1024 prefill + 16 "
          f"decode_step rounds: ms min {ms[0]:.3f} median {ms[2]:.3f} max "
          f"{ms[-1]:.3f}")
    return launches


def gemma_prefill(cfg, params):
    """gemma-2b-mingru, B 8 x T 512: one prefill, 18 fused_mingru_kernel
    launches at Dx 2048 / Dh 2048 on the tensor-core body (the counted
    path); then the kernel against its plain version at that width (B 2),
    16 decode steps after the prefill, and the step path's logits."""
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen,
                         dtype=torch.int32).to(DEV)
    lm.prefill(params, cfg, toks[:, :16], 1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_launches()
    logits, cache = lm.prefill(params, cfg, toks, 1024)
    torch.cuda.synchronize()
    launches = train_launches()
    peak = torch.cuda.max_memory_allocated()
    check(launches["fused_mingru_kernel"] == cfg.n_layers
          and sum(launches.values()) == cfg.n_layers,
          f"gemma prefill launches {launches}")
    check(gru_ops.LAUNCHES["fused_mingru_kernel/tc"] == cfg.n_layers,
          f"gemma prefill launches by body {body_launches()}")
    # the kernel at gemma width against its plain version, layer 0's
    # weights, B 2 x T 512
    p0 = params["layers"]["blocks"]["mixer"]["rnn"]
    wz, bz = p0["wz"]["kernel"][0], p0["wz"]["bias"][0]
    wh, bh = p0["wh"]["kernel"][0], p0["wh"]["bias"][0]
    x = torch.randn((2, 512, cfg.d_model), generator=gen).to(
        torch.bfloat16).to(DEV)
    h0 = torch.zeros((2, wz.shape[1]), dtype=torch.bfloat16, device=DEV)
    occ = gru_ops.occupancy(x, wz, bz, wh, bh, h0)
    e_k = max_err(gru_ops.launch(x, wz, bz, wh, bh, h0),
                  gru_ref.fused_mingru_ref(x, wz, bz, wh, bh, h0),
                  torch.bfloat16, "fused_mingru_kernel at gemma width")
    x8 = torch.randn((8, 512, cfg.d_model), generator=gen).to(
        torch.bfloat16).to(DEV)
    h08 = torch.zeros((8, wz.shape[1]), dtype=torch.bfloat16, device=DEV)
    k_ms = eager_ms([lambda: gru_ops.launch(x8, wz, bz, wh, bh, h08)], 20)
    k_bound = 2 * 2 * 8 * 512 * cfg.d_model * wz.shape[1] \
        / PEAK_FLOPS[torch.bfloat16] * 1e3
    # 16 decode steps after the prefill
    layers = lm.bind_layers(params, cfg)
    tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    streams = [tok]
    for _ in range(16):
        lg, cache = lm.decode_step(params, cfg, tok, cache, layers=layers)
        check(bool(torch.isfinite(lg).all()), "gemma decode after prefill")
        tok = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
        streams.append(tok)
    streams = torch.stack(streams, 1)
    check(bool(((streams >= 0) & (streams < cfg.vocab_size)).all()),
          "malformed gemma stream after prefill")
    # the step path over the same prompts
    c_seq = lm.init_cache(cfg, 8, 1024, DEV)
    for t in range(512):
        l_seq, c_seq = lm.decode_step(params, cfg, toks[:, t], c_seq,
                                      layers=layers)
    e_l = rel_err(logits, l_seq, "gemma prefill vs the step path",
                  PREFILL_REL[torch.bfloat16])
    same = int((l_seq[:, :cfg.vocab_size].argmax(-1)
                == streams[:, 0]).sum())
    occ8 = gru_ops.occupancy(x8, wz, bz, wh, bh, h08)
    ms = synced_ms(lambda: lm.prefill(params, cfg, toks, 1024), reps=3)
    print(f"prefill gemma-2b-mingru B 8 x T 512: fused_mingru_kernel "
          f"launches {launches['fused_mingru_kernel']} == {cfg.n_layers} "
          f"layers, all on the tensor-core body; occupancy at B 8 {occ8}, "
          f"at B 2 {occ}; kernel vs plain version at Dx {cfg.d_model} / "
          f"Dh {wz.shape[1]} (B 2 x T 512) max abs err {e_k:.3g}, at B 8 "
          f"x T 512 {k_ms:.4f} ms eager (operation bound {k_bound:.4f} "
          f"ms); logits "
          f"vs the step path relative error {e_l:.3g} (limit "
          f"{PREFILL_REL[torch.bfloat16]}), first tokens equal on {same} "
          f"of 8 rows; 16 decode steps after it well-formed; peak device "
          f"memory of the prefill {peak / 2**30:.2f} GiB; ms min "
          f"{ms[0]:.2f} median {ms[1]:.2f} max {ms[-1]:.2f}, prompt "
          f"tokens/s median {8 * 512 / ms[1] * 1e3:.0f}")
    return launches


def spec_prompts(gen):
    """The speculative traffic: 8 prompts that repeat one seeded 16-byte
    phrase after a byte of their own, so n-grams recur."""
    phrase = torch.randint(32, 127, (16,), generator=gen).tolist()
    return [[65 + i] + phrase * 3 for i in range(8)]


def spec_phase(gen):
    """Speculative serving, full-width mingru-lm, n-gram drafts S 4, both
    tiers, C 1 and 8: the counted main path.  Then, outside the count,
    streams against the non-speculative engine, the oracle and the
    fixed source, a sampled window, minlstm-lm, gemma's refusal, rates
    and a profile."""
    cfg = archs.get("mingru-lm")
    params = lm.init_params(gen, cfg, device=DEV)
    off = cfg.replace(fuse_block="off")
    prompts = spec_prompts(gen)
    ngram = {"speculative": "ngram", "draft_len": SPEC_S}
    tiers = {"block": cfg, "cell": off}
    for c_ in tiers.values():
        for c in (1, 8):
            serve(c_, params, c, prompts, 4, quiet=True, spec=ngram)
    layers = cfg.n_layers

    reset_serve_launches()
    runs = {(t, c): serve(c_, params, c, prompts, 32, label="spec",
                          spec=ngram)
            for t, c_ in tiers.items() for c in (1, 8)}
    launches = serve_launches()
    bodies = cell_body_launches()
    rounds = {t: sum(runs[(t, c)][1]["rounds"] for c in (1, 8))
              for t in tiers}
    want = {"block_step_kernel": 0, "block_chunk_kernel":
            layers * rounds["block"], "mingru_step_kernel": 0,
            "mingru_chunk_kernel": layers * rounds["cell"],
            "minlstm_step_kernel": 0, "minlstm_chunk_kernel": 0}
    check(launches == want, f"speculative launches {launches} != {want}")
    check(bodies["mingru_chunk_kernel/tc"] == want["mingru_chunk_kernel"],
          f"speculative cell launches by body {bodies}")
    print(f"spec: launches on the main path {launches} == {want}: one "
          f"verify chunk (W {W_VERIFY} / 8) per layer per round, "
          f"{rounds} rounds; every cell chunk launch on the tensor-core body")

    # outside the count: every stream as the non-speculative engine's
    for (t, c), (streams, info) in runs.items():
        base = serve(tiers[t], params, c, prompts, 32, quiet=True)[0]
        check(streams == base, f"{t} tier C={c}: speculative streams != "
              f"non-speculative, first diverging positions "
              f"{[first_divergence(a, b) for a, b in zip(streams, base)]}")
        st = info["stats"]
        check(st["decode_tokens"] == st["draft_accepted"]
              + st["non_spec_tokens"], f"spec stats {st}")
        check(st["draft_proposed"] > 0, f"{t} C={c}: no drafts proposed")
    oracle = draft_lib.ModelDraft(cfg, params, draft_len=SPEC_S)
    o_streams, o_info = serve(cfg, params, 1, prompts, 32, label="spec",
                              spec={"speculative": oracle})
    st = o_info["stats"]
    check(o_streams == runs[("block", 1)][0], "oracle streams differ")
    check(st["draft_accepted"] == st["draft_proposed"] > 0,
          f"the oracle draft did not accept every draft: {st}")
    d = o_info["launches"]
    check(d["block_step_kernel"] == layers * SPEC_S * o_info["rounds"]
          and d["block_chunk_kernel"] == 2 * layers * o_info["rounds"],
          f"oracle launches {d} for {o_info['rounds']} rounds")
    f_streams, f_info = serve(cfg, params, 1, prompts, 32, quiet=True,
                              spec={"speculative":
                                    draft_lib.FixedDraft(0, SPEC_S)})
    st = f_info["stats"]
    check(f_streams == runs[("block", 1)][0] and st["draft_accepted"] == 0
          and st["draft_proposed"] > 0,
          f"the fixed source did not roll back cleanly: {st}")
    kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    s_spec = serve(cfg, params, 1, prompts, 32, quiet=True, spec=ngram,
                   **kw)[0]
    s_base = serve(cfg, params, 1, prompts, 32, quiet=True, **kw)[0]
    check(s_spec == s_base, "sampled speculative streams != non-speculative")
    lstm_cfg = archs.get("minlstm-lm")
    lstm_params = lm.init_params(gen, lstm_cfg, device=DEV)
    l_spec = serve(lstm_cfg, lstm_params, 8, prompts[:4], 8, quiet=True,
                   spec=ngram)[0]
    l_base = serve(lstm_cfg, lstm_params, 8, prompts[:4], 8, quiet=True)[0]
    check(l_spec == l_base, "minlstm-lm speculative streams differ")
    try:
        ServingEngine(archs.get("gemma-2b-mingru"), None, device=DEV,
                      speculative="ngram")
        fail("speculation on gemma-2b-mingru did not raise")
    except ValueError:
        pass
    print(f"spec: streams equal the non-speculative engine's on both tiers "
          f"at C 1 and 8; the oracle accepted every draft with streams "
          f"unchanged (launches {d}); the fixed source rolled back every "
          f"draft; a seeded sampled window and minlstm-lm C 8 unchanged; "
          f"gemma-2b-mingru refuses speculation")

    # rates: speculative against non-speculative, in turns, at C 8 (the
    # prompts packed, so decode rounds dominate); 5 windows on the block
    # tier, 3 on the cell tier (a speculative window there takes seconds)
    for t, c_ in tiers.items():
        rows = {"plain": [], "ngram": []}
        for i in range(5 if t == "block" else 3):
            for kind in (("plain", "ngram") if i % 2 == 0
                         else ("ngram", "plain")):
                info = serve(c_, params, 8, prompts, 32, quiet=True,
                             spec=ngram if kind == "ngram" else None)[1]
                rows[kind].append(info)
        for kind, infos in rows.items():
            rates = sorted(i["rate"] for i in infos)
            st = infos[0]["stats"]
            n = len(rates)
            rt = st["decode_calls"] / max(st["decode_tokens"], 1)
            per = st["draft_accepted"] / max(st["non_spec_tokens"], 1)
            print(f"rate spec {cfg.name} [{t}] K=4 C=8 {kind}, {n} windows "
                  f"of 8 requests x 32 tokens: decoded tok/s min "
                  f"{rates[0]:.1f} median {rates[n // 2]:.1f} max "
                  f"{rates[-1]:.1f}; host round-trips per decoded token "
                  f"{rt:.4f}; accepted drafts per emitting slot-round "
                  f"{per:.3f}; {st['decode_steps']} rounds")
    serve_profile(cfg, params, prompts, "spec block tier mingru-lm", ngram,
                  chunk=8)
    serve_profile(off, params, prompts, "spec cell tier mingru-lm", ngram,
                  chunk=8)
    return launches


# ---------------------------------------------------------------------------
# 3. training kernels at the training shapes
# ---------------------------------------------------------------------------

TB, TT = 8, 256                       # training batch and sequence
# gradients: largest |kernel - plain| over the largest |plain|.  fp32:
# the same arithmetic in another order (1e-4).  bf16: the backward reads
# the kernel's rounded h where the plain version's autograd keeps it
# unrounded, and every gradient is rounded to bf16 (2e-2, a few bf16 ulps)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# training losses, kernels vs plain versions: bf16 activations in both;
# a sum in another order moves an fp32 h across a bf16 rounding boundary
# in a few elements per layer, and AdamW's first steps move every weight
# by ~lr whatever its gradient's size, so those bits compound over the
# three steps.  1% of the loss bounds that drift with room; a wrong
# kernel moves the loss by far more.
LOSS_RTOL_PLAIN = 1e-2
# the resumed step: the same kernels on the same restored bits; only the
# order cuBLAS picks for a product could differ
LOSS_RTOL_RESUME = 1e-3


def rel_err(got, want, what, tol):
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
    e = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
    check(e <= tol, f"{what}: relative error {e:.3g} > {tol}")
    return e


def fused_inputs(gen, cell, dtype, t, with_h0):
    n = len(GATES[cell])
    x = torch.randn((TB, t, DX), generator=gen)
    wb = []
    for _ in range(n):
        wb += [torch.randn((DX, DH), generator=gen) / DX ** 0.5,
               0.1 * torch.randn((DH,), generator=gen)]
    h0 = 0.5 * torch.randn((TB, DH), generator=gen) if with_h0 else None
    out = [v.to(dtype).to(DEV) for v in (x, *wb)]
    return out, (None if h0 is None else h0.to(dtype).to(DEV))


def fused_bound_ms(cell, dtype, t):
    """Projection multiply-adds over the type's peak, against the bytes
    of x, weights, biases, h0 in and h out."""
    n = len(GATES[cell])
    e = torch.tensor([], dtype=dtype).element_size()
    flops = 2 * TB * t * DX * DH * n
    nbytes = e * (TB * t * DX + n * (DX * DH + DH) + TB * t * DH) \
        + 4 * TB * DH
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def scan_bound_ms(in_elem, out_elem, d=DH):
    """Two (B, T, D) inputs and h0 read, one output written."""
    nbytes = TB * TT * d * (2 * in_elem + out_elem) + 4 * TB * d
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def unfused(cell, x, wb, h0):
    """The unfused route, a yardstick never on the port's path: one bf16
    torch.matmul of x against the concatenated projections, the gates as
    torch ops in fp32 (log mode; minLSTM normalised), the port's forward
    linear scan."""
    ws, bs = wb[0::2], wb[1::2]
    n, (bsz, t, dx) = len(ws), x.shape
    k = (x.reshape(-1, dx) @ torch.cat(ws, 1)).float() + torch.cat(bs).float()
    k = k.reshape(bsz, t, n, DH)
    if cell == "mingru":
        z = torch.sigmoid(k[:, :, 0])
        a, b = 1.0 - z, z * core_nn.g(k[:, :, 1])
    else:
        a, i = normalized_gates(k[:, :, 0], k[:, :, 1])
        b = i * core_nn.g(k[:, :, 2])
    return scan_ops.linear_scan_kernel(a.contiguous(), b.contiguous(),
                                       h0.float())


def fused_checks(gen):
    """The fused kernels at the training shapes; returns per-kernel main
    numbers (bf16, T 256, as the LM's layers run them)."""
    rows, main, occ_lines = [], {}, []
    for cell in ("mingru", "minlstm"):
        fn, plain, raw_launch, mod = (
            (gru_ops.fused_mingru, gru_ref.fused_mingru_ref, gru_ops.launch,
             gru_ops)
            if cell == "mingru" else
            (lstm_ops.fused_minlstm, lstm_ref.fused_minlstm_ref,
             lstm_ops.launch, lstm_ops))
        name = f"fused_{cell}_kernel"
        for dtype in (torch.float32, torch.bfloat16):
            for t, with_h0 in ((TT, False), (250, True)):
                wb, h0 = fused_inputs(gen, cell, dtype, t, with_h0)
                x, rest = wb[0], wb[1:]
                ins = [v.requires_grad_(True) for v in
                       [x, *rest] + ([h0] if with_h0 else [])]
                out = fn(*ins[:len(wb)], ins[-1] if with_h0 else None)
                want = plain(*ins[:len(wb)], ins[-1] if with_h0 else None)
                tag = f"{cell}/{str(dtype).split('.')[-1]}/T{t}" + \
                    ("/h0" if with_h0 else "")
                err = max_err(out, want, dtype, f"{tag} forward")
                ct = torch.randn(out.shape, generator=gen).to(dtype).to(DEV)
                got_g = torch.autograd.grad(out, ins, ct)
                want_g = torch.autograd.grad(want, ins, ct)
                g_err = max(rel_err(g, w, f"{tag} grad {i}", GRAD_TOL[dtype])
                            for i, (g, w) in enumerate(zip(got_g, want_g)))
                with torch.no_grad():
                    h0z = (ins[-1] if with_h0 else torch.zeros(
                        (TB, DH), dtype=dtype, device=DEV)).detach()
                    args = [v.detach() for v in ins[:len(wb)]]
                    # the occupancy query, and the body the launcher
                    # reports taking on two launches, equal bit for bit
                    occ = mod.occupancy(*args, h0z)
                    before = dict(mod.LAUNCHES)
                    one, two = raw_launch(*args, h0z), raw_launch(*args, h0z)
                    ran = {k.split("/")[1]: mod.LAUNCHES[k] - before[k]
                           for k in mod.LAUNCHES if "/" in k}
                    body = occ["body"]
                    check(ran[body] == 2 and sum(ran.values()) == 2,
                          f"{tag}: the occupancy query names {body}, the "
                          f"launches took {ran}")
                    check(torch.equal(one, two),
                          f"{tag}: two launches differ")
                    if dtype == torch.bfloat16:
                        check(body == "tc", f"{tag}: bf16 took {body}")
                        check(occ["waves"] == 1, f"{tag}: {occ}")
                    occ_lines.append(
                        f"  {tag:<24} body {occ['body']:<9} "
                        f"{occ['blocks_per_sm']} block(s)/SM, "
                        f"{occ['grid_blocks']} blocks on {occ['sms']} SMs, "
                        f"{occ['waves']} wave(s)")
                    t_k = eager_ms([lambda: raw_launch(*args, h0z)], 20)
                    t_kd = graph_ms(lambda: raw_launch(*args, h0z))
                    t_p = eager_ms([lambda: plain(*args, h0z)], 3)
                    if dtype == torch.bfloat16:
                        u = unfused(cell, args[0], args[1:], h0z)
                        u_err = max_err(u, want, dtype,
                                        f"{tag} unfused yardstick")
                        t_u = eager_ms([lambda: unfused(
                            cell, args[0], args[1:], h0z)], 20)
                        t_ud = graph_ms(lambda: unfused(
                            cell, args[0], args[1:], h0z))
                    else:
                        t_u = t_ud = u_err = float("nan")
                b_ms, b_by = fused_bound_ms(cell, dtype, t)
                rows.append((tag, body, t_k, t_kd, t_p, b_ms, t_u, t_ud, err,
                             g_err, u_err))
                if dtype == torch.bfloat16 and t == TT and not with_h0:
                    main[name] = (err, t_k, t_p, (b_ms, b_by))
                    DEVICE_MS[name] = t_kd
                del ins, out, want, got_g, want_g
    print(f"fused cell kernels at B {TB} Dx {DX} Dh {DH} (ms per launch, "
          f"L2-warm on one input set; kernel_ms and unfused_ms: 20 eager "
          f"calls, wrappers included, as every other kernel is timed; "
          f"device_ms: the same calls captured in a CUDA graph, 20 per "
          f"graph replayed 5 times; plain: 3 eager calls; two launches "
          f"equal bit for bit in every row):")
    print("  cell/dtype/T           body       kernel_ms  device_ms  "
          "plain_ms  bound_ms  unfused_ms  unfused_device_ms  fwd_max_err  "
          "grad_rel_err  unfused_max_err")
    for r in rows:
        print("  {:<22} {:<9}  {:.5f}  {:.5f}  {:.5f}  {:.5f}  {:.5f}  "
              "{:.5f}  {:.3g}  {:.3g}  {:.3g}".format(*r))
    print("  unfused: one bf16 torch.matmul of the concatenated projections "
          "+ the gates as torch ops + linear_scan_kernel (a yardstick, "
          "never on the port's path)")
    print("fused cell occupancy (cudaOccupancyMaxActiveBlocksPerMultiprocessor"
          " at the launch's grid):")
    for line in occ_lines:
        print(line)
    return main


def heinsen(la, lb):
    """The log scan from h0 = 0 as PyTorch's own scan primitives compose
    it (Heinsen): cumsum of log_a, logcumsumexp of log_b - that, exp.  A
    yardstick, never on the port's path."""
    a_star = torch.cumsum(la.float(), 1)
    return torch.exp(a_star + torch.logcumsumexp(lb.float() - a_star, 1))


def scan_case(kind, reverse):
    """(kernel wrapper, plain version, segmented rendering) of a scan."""
    if kind == "linear":
        return (lambda x, y, c: scan_ops.linear_scan_kernel(x, y, c,
                                                            reverse),
                lambda x, y, c: scan_ref.linear_scan_ref(x, y, c, reverse),
                lambda x, y, c: scan_ref.linear_scan_segmented(x, y, c,
                                                               reverse))
    return (scan_ops.log_scan_kernel, scan_ref.log_scan_ref,
            scan_ref.log_scan_segmented)


def scan_edge_checks(gen):
    """Multi-tile ragged T and ragged D, both kinds, directions and
    dtypes: the kernel against the plain version, and bit for bit with
    the segmented rendering, with a second launch and with a row
    alone."""
    shape = (3, 1100, 70)
    for dtype in (torch.float32, torch.bfloat16):
        for kind, variant in (("linear", False), ("linear", True),
                              ("log", False), ("log", True)):
            rev = kind == "linear" and variant
            ins = scan_ref.inputs(gen, kind, dtype, shape,
                                 kind == "linear" or variant, DEV)
            fn, plain, seg = scan_case(kind, rev)
            tag = f"{kind}/{str(dtype).split('.')[-1]}/T1100/D70" + (
                "/reverse" if rev else "") + ("/h0" if kind == "log" and
                                              variant else "")
            got = fn(*ins)
            max_err(got, plain(*ins), dtype if kind == "linear"
                    else torch.float32, tag)
            check(torch.equal(got, fn(*ins)), f"{tag}: two launches differ")
            check(torch.equal(got[1:2], fn(*(v[1:2].contiguous()
                                              for v in ins))),
                  f"{tag}: row 1 alone differs from row 1 of B 3")
            check(torch.equal(got, seg(*ins)),
                  f"{tag}: differs from the segmented rendering")
    print("scan edge cases (B 3, T 1100: 5 T-tiles, the last ragged; D 70: "
          "a ragged column tile; both kinds, directions, dtypes): within "
          "tolerance of the plain versions, two launches and a row alone "
          "bit for bit, bit for bit with the segmented renderings")


def scan_checks(gen):
    """The scans at the training shape: plan and occupancy, the kernel
    against the plain version and the segmented rendering, repeat
    launches and a row alone bit for bit, eager and CUDA-graph times
    rotating over SCAN_SETS input sets (together more than the L2)."""
    rows, main, occ_lines, yard = [], {}, [], []
    shape = (TB, TT, DH)
    for kind in ("linear", "log"):
        for dtype in (torch.float32, torch.bfloat16):
            occ = scan_ops.occupancy(kind, dtype, *shape)
            occ_lines.append(
                f"  {kind}/{str(dtype).split('.')[-1]:<9} S {occ['seg']}, W "
                f"{occ['warps']} ({occ['threads']} threads), {occ['cols']} "
                f"columns a block, {occ['tiles']} T-tile(s), grid "
                f"{occ['grid']} = {occ['blocks']} blocks, "
                f"{occ['blocks_per_sm']} block(s)/SM on {occ['sms']} SMs, "
                f"{occ['waves']} wave(s)")
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split('.')[-1]
        for kind, variant in (("linear", False), ("linear", True),
                              ("log", False), ("log", True)):
            rev = kind == "linear" and variant
            h0_given = kind == "linear" or variant
            sets = [scan_ref.inputs(gen, kind, dtype, shape, h0_given, DEV)
                    for _ in range(SCAN_SETS)]
            fn, plain, seg = scan_case(kind, rev)
            ins = sets[0]
            form = (("reverse" if rev else "forward") if kind == "linear"
                    else "h0=" + ("given" if variant else "0"))
            what = f"{kind}/{tag}/{form}"
            got = fn(*ins)
            err = max_err(got, plain(*ins), dtype if kind == "linear"
                          else torch.float32, what)
            check(torch.equal(got, fn(*ins)), f"{what}: two launches differ")
            check(torch.equal(got[3:4], fn(*(v[3:4].contiguous()
                                              for v in ins))),
                  f"{what}: row 3 alone differs from row 3 of B {TB}")
            check(torch.equal(got, seg(*ins)),
                  f"{what}: differs from the segmented rendering")
            calls = [lambda s=s: fn(*s) for s in sets]
            t_k = eager_ms(calls, 200)
            t_kd = graph_ms(rotating(calls))
            t_p = eager_ms([lambda: plain(*ins)], 3)
            e = ins[0].element_size()
            b_ms, b_by = scan_bound_ms(e, e if kind == "linear" else 4)
            rows.append((what, t_k, t_kd, t_p, b_ms, b_ms / t_kd, err))
            name = f"{kind}_scan_kernel"
            if dtype == torch.float32 and (rev or (kind == "log"
                                                   and not variant)):
                # the main path's use: the backward of every layer, and
                # the pallas strategy's forward from h0 = 0
                main[name] = (err, t_k, t_p, (b_ms, b_by))
                DEVICE_MS[name] = t_kd
            if kind == "log" and not variant and dtype == torch.float32:
                h_err = float((heinsen(*ins[:2]) - plain(*ins)).abs().max())
                hcalls = [lambda s=s: heinsen(*s[:2]) for s in sets]
                yard.append((eager_ms(hcalls, 50), graph_ms(rotating(hcalls)),
                             h_err))
            del sets, calls
    print(f"scan kernels at B {TB} T {TT} D {DH} (ms per launch; kernel_ms: "
          f"200 eager wrapper calls rotating over {SCAN_SETS} input sets, "
          f"together more than the 50 MB L2, as every kernel is timed; "
          f"device_ms: the same calls, 20 in a CUDA graph replayed 5 times;"
          f" plain: 3 eager calls; share: bound over device_ms; two "
          f"launches, row 3 alone and the segmented rendering bit for bit "
          f"in every row):")
    print("  scan/dtype/form          kernel_ms  device_ms  plain_ms  "
          "bound_ms  share  max_err")
    for r in rows:
        print("  {:<24} {:.5f}  {:.5f}  {:.5f}  {:.5f}  {:.3f}  {:.3g}"
              .format(*r))
    for t_h, t_hd, h_err in yard:
        print(f"  yardstick, log/float32/h0=0 as torch.cumsum + "
              f"torch.logcumsumexp + torch.exp (Heinsen; never on the "
              f"port's path): {t_h:.5f} ms eager, {t_hd:.5f} ms device, "
              f"max abs err {h_err:.3g} against the plain version")
    print("scan plan and occupancy (ops.occupancy: the C launcher's "
          "constants and cudaOccupancyMaxActiveBlocksPerMultiprocessor):")
    for line in occ_lines:
        print(line)
    # the Functions' gradients (reversed linear scan inside), fp32
    a = (0.05 + 0.9 * torch.rand(shape, generator=gen)).to(DEV)
    b = torch.randn(shape, generator=gen).to(DEV)
    h0 = torch.randn((TB, DH), generator=gen).to(DEV)
    ins = [v.requires_grad_(True) for v in (a, b, h0)]
    ct = torch.randn(shape, generator=gen).to(DEV)
    got = torch.autograd.grad(scan_ops.linear_scan(*ins), ins, ct)
    want = torch.autograd.grad(scan_ref.linear_scan_ref(*ins), ins, ct)
    g1 = max(rel_err(g, w, f"linear_scan grad {i}", GRAD_TOL[torch.float32])
             for i, (g, w) in enumerate(zip(got, want)))
    ins = [v.requires_grad_(True) for v in
           (torch.log(a.detach()), torch.randn(shape, generator=gen).to(DEV),
            torch.randn((TB, DH), generator=gen).to(DEV))]
    got = torch.autograd.grad(scan_ops.log_space_scan(*ins), ins, ct)
    want = torch.autograd.grad(scan_ref.log_scan_ref(*ins), ins, ct)
    g2 = max(rel_err(g, w, f"log_space_scan grad {i}",
                     GRAD_TOL[torch.float32])
             for i, (g, w) in enumerate(zip(got, want)))
    print(f"scan Function grads vs plain autograd (fp32, relative): "
          f"linear_scan {g1:.3g}, log_space_scan {g2:.3g}")
    scan_edge_checks(gen)
    return main


def fused_prefill_checks():
    """Both fused kernels at the prefill's shapes against their plain
    versions, bf16, mingru-lm / minlstm-lm widths: B 8 x T 1024 with rows
    right-padded past PREFILL_LENS (one pad vector repeated, as a pad
    token's embedding would be), and the prefill resumed at 512 from the
    first half's last h in bf16.  Outside the counted main path."""
    gen = torch.Generator().manual_seed(3)
    dtype, t = torch.bfloat16, 1024
    lens = torch.tensor(PREFILL_LENS, dtype=torch.int32)
    pad = torch.arange(t)[None] >= lens[:, None]
    out = []
    for cell, fn, plain, mod in (
            ("mingru", gru_ops.fused_mingru, gru_ref.fused_mingru_ref,
             gru_ops),
            ("minlstm", lstm_ops.fused_minlstm, lstm_ref.fused_minlstm_ref,
             lstm_ops)):
        wb, _ = fused_inputs(gen, cell, dtype, 1, False)
        x = torch.randn((TB, t, DX), generator=gen)
        x[pad] = torch.randn((DX,), generator=gen)
        x = x.to(dtype).to(DEV)
        before = dict(mod.LAUNCHES)
        with torch.no_grad():
            y = fn(x, *wb[1:], None)
            e_pad = max_err(y, plain(x, *wb[1:], None), dtype,
                            f"fused_{cell} B 8 x T 1024 padded")
            h0 = y[:, 511]
            y2 = fn(x[:, 512:].contiguous(), *wb[1:], h0)
            e_res = max_err(y2, plain(x[:, 512:].contiguous(), *wb[1:], h0),
                            dtype, f"fused_{cell} resumed at 512, bf16 h0")
            e_one = max_err(y2, y[:, 512:], dtype,
                            f"fused_{cell} resumed vs one pass")
        name = f"fused_{cell}_kernel"
        ran = {k: mod.LAUNCHES[k] - before[k] for k in mod.LAUNCHES}
        check(ran[name] == 2 and ran[f"{name}/tc"] == 2,
              f"fused_{cell} prefill shapes: launches {ran}")
        out.append(f"{cell} padded {e_pad:.3g}, resumed {e_res:.3g} "
                   f"(resumed vs one pass {e_one:.3g})")
    print(f"fused cell kernels at the prefill's shapes (bf16, B 8 x T 1024 "
          f"right-padded past {list(PREFILL_LENS)}; T 512 resumed from a "
          f"bf16 h0), max abs err against the plain versions, every launch "
          f"on the tensor-core body: " + "; ".join(out))


def train_kernel_phase(gen):
    main = fused_checks(gen)
    fused_prefill_checks()
    main.update(scan_checks(gen))
    torch.cuda.empty_cache()
    return main


# ---------------------------------------------------------------------------
# 5. training
# ---------------------------------------------------------------------------

def train_launches():
    """Launch totals per kernel (the per-body counts are in
    ``body_launches``)."""
    out = dict(gru_ops.LAUNCHES)
    out.update(lstm_ops.LAUNCHES)
    out.update(scan_ops.LAUNCHES)
    return {k: v for k, v in out.items() if "/" not in k}


def body_launches():
    """Fused-cell launches by body, e.g. "fused_mingru_kernel/tc"."""
    out = {k: v for k, v in gru_ops.LAUNCHES.items() if "/" in k}
    out.update({k: v for k, v in lstm_ops.LAUNCHES.items() if "/" in k})
    return out


def reset_train_launches():
    for mod in (gru_ops, lstm_ops, scan_ops):
        mod.reset_launches()


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def train_run(cfg, params, batches, ocfg, n, ckpt=None):
    """``n`` train steps from ``params`` (updated in place); returns the
    per-step losses (synchronised floats) and the final state."""
    step = ts_lib.make_train_step(cfg, ocfg)
    state = opt_lib.init(ocfg, params)
    losses = []
    for i in range(n):
        params, state, m = step(params, state, batches(i))
        losses.append(float(m["loss"]))
        if ckpt is not None:
            ckpt.maybe_save(i + 1, params, state)
    return losses, params, state


class plain_kernels:
    """Within the block, the model's kernel calls go to the plain versions
    (autograd through them): the reference run for the loss check."""

    @staticmethod
    def gru(x, wz, bz, wh, bh, h0=None, *, mode):
        return gru_ref.fused_mingru_ref(x, wz, bz, wh, bh, h0, mode=mode)

    @staticmethod
    def lstm(x, wf, bf, wi, bi, wh, bh, h0=None, *, mode, normalize):
        return lstm_ref.fused_minlstm_ref(x, wf, bf, wi, bi, wh, bh, h0,
                                          mode=mode, normalize=normalize)

    def __enter__(self):
        self.saved = (gru_ops.fused_mingru, lstm_ops.fused_minlstm,
                      scan_ops.log_space_scan)
        gru_ops.fused_mingru = self.gru          # the LM's layers have
        lstm_ops.fused_minlstm = self.lstm       # biases: no None here
        scan_ops.log_space_scan = scan_ref.log_scan_ref
        return self

    def __exit__(self, *exc):
        (gru_ops.fused_mingru, lstm_ops.fused_minlstm,
         scan_ops.log_space_scan) = self.saved
        return False


def train_profile(cfg, params, batches, ocfg, top=20):
    """Where one training step's device time goes: ``torch.profiler``
    over one step (after a warm one), kernels by self device time, and
    the device-busy share of the step's wall time (the profiler's own
    host cost inflates the wall time, so the share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    step = ts_lib.make_train_step(cfg, ocfg)
    state = opt_lib.init(ocfg, params)
    params, state, _ = step(params, state, batches(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, batches(1))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies): a CPU op's row carries
    # the time of the kernels it launched, which would count them twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    if not events:
        print("train profile: the profiler saw no device time")
        return
    ours = ("fused_cell_kernel", "fused_cell_tc_kernel", "linear_scan_kernel",
            "log_scan_kernel")
    groups = {"this repo's kernels": 0.0, "cuBLAS matmuls": 0.0,
              "elementwise, reductions, copies": 0.0}
    for e in events:
        if any(k in e.key for k in ours):
            groups["this repo's kernels"] += dev_us(e) / 1e3
        elif any(k in e.key.lower() for k in ("gemm", "cutlass", "xmma",
                                                "nvjet", "cublas")):
            groups["cuBLAS matmuls"] += dev_us(e) / 1e3
        else:
            groups["elementwise, reductions, copies"] += dev_us(e) / 1e3
    print(f"train profile, one mingru-lm step (B {TB} x T {TT}): wall "
          f"{wall_ms:.2f} ms under the profiler, device busy "
          f"{total_ms:.2f} ms ({100 * total_ms / wall_ms:.1f}% of the "
          f"wall); " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                 groups.items()))
    fused = [e for e in events if "fused_cell" in e.key]
    print(f"  fused-cell kernels in the step: "
          f"{sum(dev_us(e) for e in fused) / 1e3:.3f} ms device time, "
          f"{sum(e.count for e in fused)} launches")
    n_kernels = sum(e.count for e in events)
    print(f"  {n_kernels} device events in the step; top {top} by self "
          f"device time (ms, calls):")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        print(f"    {dev_us(e) / 1e3:8.3f}  {e.count:5d}  {e.key[:90]}")


def train_phase(gen):
    cfg = archs.get("mingru-lm")
    check(cfg.remat == "full" and cfg.cdtype == torch.bfloat16,
          f"unexpected training config {cfg}")
    train_data, _ = lm_corpus.build_corpus()

    def batches(i):
        return lm_corpus.lm_batch(train_data, 0, i, TB, TT)

    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    p0 = lm.MinRNNLM(cfg, lm.init_params(gen, cfg, device=DEV)).params()
    p_init = clone(p0)
    lstm_cfg = archs.get("minlstm-lm")
    lstm_p = lm.init_params(gen, lstm_cfg, device=DEV)
    pallas_cfg = cfg.replace(scan_strategy="pallas")
    # first-use allocations and library loads off the clock and the count
    train_run(cfg, clone(p_init), batches, ocfg, 1)
    ckdir = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    ckpt = ckpt_lib.CheckpointManager(ckdir, keep=2, save_interval=5,
                                      device=DEV)

    reset_train_launches()
    counted = {}
    t0 = time.perf_counter()
    losses, _, _ = train_run(cfg, p0, batches, ocfg, 10, ckpt=ckpt)
    counted["mingru"] = train_launches()
    lstm_losses, _, _ = train_run(lstm_cfg, lstm_p, batches, ocfg, 3)
    pallas_losses, _, _ = train_run(pallas_cfg, clone(p_init), batches,
                                    ocfg, 3)
    torch.cuda.synchronize()
    t_counted = time.perf_counter() - t0
    launches = train_launches()
    layers = cfg.n_layers
    want = {"fused_mingru_kernel": 2 * layers * 10,
            "fused_minlstm_kernel": 2 * layers * 3,
            "log_scan_kernel": 2 * layers * 3,
            "linear_scan_kernel": layers * (10 + 3 + 3)}
    check(launches == want, f"training launches {launches} != {want}")
    check(counted["mingru"]["fused_mingru_kernel"] == 2 * layers * 10,
          f"auto mingru run launched {counted['mingru']}")
    # every full-width bf16 training launch took the tensor-core body
    bodies = body_launches()
    want_bodies = {"fused_mingru_kernel/tc": 2 * layers * 10,
                   "fused_mingru_kernel/cuda_core": 0,
                   "fused_minlstm_kernel/tc": 2 * layers * 3,
                   "fused_minlstm_kernel/cuda_core": 0}
    check(bodies == want_bodies,
          f"training launches by body {bodies} != {want_bodies}")
    for name, ls in (("mingru-lm", losses), ("minlstm-lm", lstm_losses),
                     ("mingru-lm pallas", pallas_losses)):
        check(all(math.isfinite(v) for v in ls), f"{name}: loss {ls}")
        check(ls[-1] < ls[0], f"{name}: loss did not fall: {ls}")
    print(f"train mingru-lm (bf16, remat full, B {TB} T {TT}) losses "
          + " ".join(f"{v:.4f}" for v in losses))
    print(f"train minlstm-lm losses " + " ".join(f"{v:.4f}"
                                                for v in lstm_losses))
    print(f"train mingru-lm pallas losses " + " ".join(
        f"{v:.4f}" for v in pallas_losses))
    print(f"train: counted runs (16 steps) took {t_counted:.2f}s; launches "
          f"{launches} == {want}; by body {bodies}")

    # outside the count: the same run on the plain versions
    with plain_kernels():
        before = train_launches()
        plain_losses, _, _ = train_run(cfg, clone(p_init), batches, ocfg, 3)
        check(train_launches() == before, "the plain run launched kernels")
    d_plain = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    check(max(d_plain) <= LOSS_RTOL_PLAIN,
          f"kernel vs plain losses {losses[:3]} vs {plain_losses} "
          f"(relative {d_plain})")
    print(f"train: first 3 losses vs the plain versions' run "
          f"{plain_losses}: relative differences "
          + " ".join(f"{v:.3g}" for v in d_plain)
          + f" (limit {LOSS_RTOL_PLAIN})")

    # restore the step-5 checkpoint and take step 6 again
    r_step, rp, rstate = ckpt_lib.restore(
        os.path.join(ckdir, "step_00000005"), device=DEV)
    check(r_step == 5 and int(rstate.step) == 5,
          f"checkpoint restore gave step {r_step} / {int(rstate.step)}")
    _, _, m6 = ts_lib.make_train_step(cfg, ocfg)(rp, rstate, batches(5))
    d_res = abs(float(m6["loss"]) - losses[5]) / abs(losses[5])
    check(d_res <= LOSS_RTOL_RESUME,
          f"resumed step 6 loss {float(m6['loss'])} vs {losses[5]}")
    print(f"train: restored step 5, step 6 loss {float(m6['loss']):.6f} vs "
          f"{losses[5]:.6f} uninterrupted (relative {d_res:.3g}, limit "
          f"{LOSS_RTOL_RESUME})")

    train_profile(cfg, clone(p_init), batches, ocfg)

    # rates: ms per step over 5 repeats of 2 steps, outside the count
    step = ts_lib.make_train_step(cfg, ocfg)
    params, state = clone(p_init), opt_lib.init(ocfg, clone(p_init))
    times = []
    for r in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(2):
            params, state, _ = step(params, state, batches(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) / 2 * 1e3)
    times.sort()
    tok = TB * TT
    print(f"rate mingru-lm training, B {TB} x T {TT}, 5 repeats of 2 steps: "
          f"ms per step min {times[0]:.2f} median {times[2]:.2f} max "
          f"{times[-1]:.2f}; tokens/s median {tok / times[2] * 1e3:.1f}")
    return launches


# ---------------------------------------------------------------------------
# 4c. the robustness layer: faults, crash recovery, tune plans
# ---------------------------------------------------------------------------

# journals, snapshots and plans of this run (under build/, which git
# ignores; removed at the end)
SCRATCH = os.path.join(HERE, "build", "chip_smoke")
# what two runs must agree on, exactly: the round clock, not the wall
ROUND_COUNTERS = ("completed", "cancelled", "timed_out", "failed", "shed",
                  "rejected", "quarantined", "retried", "slot_steps",
                  "prefill_rounds", "prefill_tokens", "decode_tokens",
                  "decode_steps", "decode_calls", "wasted_slot_steps",
                  "nonfinite_decode_rounds")
RATE_WINDOWS = 5


def scratch_dir(name):
    path = os.path.join(SCRATCH, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def round_counters(eng):
    return {c: getattr(eng.stats, c) for c in ROUND_COUNTERS}


def identities_ok(eng):
    """The slot-step identity and the terminal accounting of a drained
    engine, every request terminal."""
    s = eng.stats
    tokens = s.non_spec_tokens if eng.draft is not None else s.decode_tokens
    return (s.slot_steps == s.prefill_rounds + tokens - len(s.ttft_rounds)
            + s.wasted_slot_steps + s.nonfinite_decode_rounds
            and s.submitted == s.completed + s.cancelled + s.timed_out
            + s.failed + s.shed + s.rejected
            and all(r.status in TERMINAL_STATUSES
                    for r in eng.requests.values())
            and s.shard_identities_ok())


class Rounds:
    """Device rounds x layers of every engine a counted phase runs: the
    launches that phase must show (one decode kernel per layer per
    round)."""

    def __init__(self):
        self.want = 0

    def add(self, eng):
        self.want += eng.cfg.n_layers * eng.stats.decode_steps
        return eng


def closed_batch(cfg, params, max_new=32, chunk=8, rounds=None, **kw):
    """PROMPTS through a fresh engine at K 4; (streams, engine)."""
    eng = ServingEngine(cfg, params, max_batch=8, max_len=128, seed=0,
                        decode_block=4, prompt_chunk=chunk, device=DEV, **kw)
    rids = [eng.submit(tokens_of(p), max_new=max_new) for p in PROMPTS]
    outs = eng.run_to_completion()
    if rounds is not None:
        rounds.add(eng)
    return [tuple(outs[r]) for r in rids], eng


def chaos_run(cfg, params, rounds):
    """``tests/test_faults.py``'s chaos trace at full width: NaN, dropped
    uploads and stragglers at once, deadlines on a quarter of the
    requests, a bounded queue; every request must end terminal."""
    rng = np.random.default_rng(7)
    inj = FaultInjector(seed=5, nan_rate=0.01, drop_rate=0.1,
                        straggler_rate=0.1, straggler_s=0.001)
    eng = ServingEngine(cfg, params, max_batch=4, max_len=128,
                        decode_block=4, prompt_chunk=8, device=DEV,
                        faults=inj, max_retries=2, retry_backoff=2,
                        max_queue=8)
    for i in range(24):
        prompt = [int(t) for t in
                  rng.integers(1, 250, size=int(rng.integers(2, 9)))]
        kw = {}
        if i % 4 == 0:
            kw["deadline"] = 2 * (len(prompt) + 12)
        eng.submit(prompt, max_new=int(rng.integers(4, 13)),
                   priority=int(rng.integers(0, 3)), **kw)
        if i % 3 == 2:
            eng.step()
    eng.run_to_completion(max_steps=2000)
    rounds.add(eng)
    return eng, inj


def robustness_checks(tag, cfg, params, rounds):
    """Faults on one model and tier, C 8, K 4: (1) an injector armed at
    rate 0 gives the plain run's streams and round counters; (2)
    dropped uploads (rate 0.3) the same streams; (3) NaN into two slots'
    state at round 4: both requests quarantined, retried, completed, and
    every stream -- theirs too -- the plain run's; (4) the chaos trace."""
    base, eng0 = closed_batch(cfg, params, rounds=rounds)
    armed, eng1 = closed_batch(cfg, params, rounds=rounds,
                               faults=FaultInjector(seed=0))
    check(armed == base and round_counters(eng1) == round_counters(eng0),
          f"{tag}: an injector at rate 0 changed the run: "
          f"{round_counters(eng1)} != {round_counters(eng0)}")
    drop_inj = FaultInjector(seed=3, drop_rate=0.3)
    drop, eng2 = closed_batch(cfg, params, rounds=rounds, faults=drop_inj)
    check(drop_inj.counts()["drop_upload"] > 0, f"{tag}: no upload dropped")
    check(drop == base and identities_ok(eng2),
          f"{tag}: dropped uploads changed the streams")
    nan_inj = FaultInjector(nan_at=((4, 2), (4, 5)))
    nan, eng3 = closed_batch(cfg, params, rounds=rounds, faults=nan_inj,
                             max_retries=2, retry_backoff=2)
    hit = sorted(r.rid for r in eng3.requests.values() if r.retries)
    check(nan_inj.counts()["corrupt_state"] == 2 and len(hit) == 2
          and eng3.stats.quarantined == 2 and eng3.stats.retried == 2
          and eng3.stats.completed == len(PROMPTS) and identities_ok(eng3),
          f"{tag}: NaN quarantine: events {nan_inj.events}, stats "
          f"{round_counters(eng3)}")
    bad = [i for i, (a, b) in enumerate(zip(nan, base)) if a != b]
    check(not bad, f"{tag}: streams {bad} differ after the NaN "
          f"quarantine (hit requests {hit}); first diverging positions "
          f"{[first_divergence(nan[i], base[i]) for i in bad]}")
    chaos, inj = chaos_run(cfg, params, rounds)
    counts = inj.counts()
    check(len(chaos.finished) == 24 and identities_ok(chaos)
          and chaos.stats.completed > 0
          and sum(v > 0 for v in counts.values()) >= 2,
          f"{tag}: chaos trace: {counts}, {round_counters(chaos)}")
    st = chaos.stats
    print(f"faults {tag} K=4 C=8: rate-0 injector and faults=None equal "
          f"(streams, {len(ROUND_COUNTERS)} round counters); "
          f"{drop_inj.counts()['drop_upload']} dropped uploads, streams "
          f"equal; NaN at round 4 into slots 2 and 5 hit requests {hit}: "
          f"quarantined {eng3.stats.quarantined}, retried "
          f"{eng3.stats.retried}, {eng3.stats.nonfinite_decode_rounds} "
          f"non-finite rounds, all 8 streams equal the plain run's; chaos "
          f"trace (24 requests, 4 slots): injected {counts}, completed "
          f"{st.completed}, timed out {st.timed_out}, failed {st.failed}, "
          f"shed {st.shed}, rejected {st.rejected}, quarantined "
          f"{st.quarantined}; identities hold")


def robustness_phase(gen):
    """Faults at full width on mingru-lm (block tier and cell tier) and
    minlstm-lm (block tier): the counted main path of this phase."""
    cfg = archs.get("mingru-lm")
    params = lm.init_params(gen, cfg, device=DEV)
    lstm_cfg = archs.get("minlstm-lm")
    lstm_params = lm.init_params(gen, lstm_cfg, device=DEV)
    cases = [("mingru-lm block tier", cfg, params),
             ("mingru-lm cell tier", cfg.replace(fuse_block="off"), params),
             ("minlstm-lm block tier", lstm_cfg, lstm_params)]
    for _, c_, p_ in cases:                  # first-use allocations
        closed_batch(c_, p_, max_new=4)
    reset_serve_launches()
    rounds = Rounds()
    for tag, c_, p_ in cases:
        robustness_checks(tag, c_, p_, rounds)
    launches = serve_launches()
    check(sum(launches.values()) == rounds.want,
          f"robustness launches {launches}: {sum(launches.values())} != "
          f"layers x rounds = {rounds.want}")
    for name in ("block_step_kernel", "block_chunk_kernel",
                 "mingru_step_kernel", "mingru_chunk_kernel"):
        check(launches[name] > 0, f"{name} not launched under faults")
    check(cell_body_launches()["mingru_step_kernel/tc"]
          == launches["mingru_step_kernel"], "cell launches off the "
          "tensor-core body under faults")
    print(f"faults: launches on the main path {launches} == layers x "
          f"rounds ({rounds.want})")
    del lstm_params
    return launches, (cfg, params)


def trace_submitter(eng):
    """The recovery traffic: seeded prompts, greedy and seeded-sampled in
    turns."""
    def fn(i, r):
        eng.submit(autotune.trace_prompt(i, r["prompt_len"]),
                   max_new=r["max_new"],
                   temperature=0.0 if i % 2 == 0 else 0.8,
                   top_k=0 if i % 2 == 0 else 40)
    return fn


def finished_streams(eng):
    return {rid: tuple(r.out) for rid, r in sorted(eng.finished.items())}


def kill_restore(tag, cfg, params, rounds, corrupt=False, **kw):
    """A journaled engine over the 24-request trace (K 4, C 8) abandoned
    at half the uninterrupted run's rounds, restored from its directory
    and finished: streams and round clock equal the uninterrupted run's.
    ``corrupt``: bit-rot in the newest snapshot, which restore must fall
    back past."""
    trace = autotune.make_trace(24, 8)
    knobs = dict(max_batch=8, max_len=160, seed=0, decode_block=4,
                 prompt_chunk=8, device=DEV, **kw)
    ref = ServingEngine(cfg, params, **knobs)
    replay_trace(ref, trace, trace_submitter(ref))
    rounds.add(ref)
    total = ref.stats.decode_steps
    d = scratch_dir(tag.replace(" ", "_"))
    eng = ServingEngine(cfg, params, recover_dir=d, snapshot_every=8,
                        **knobs)
    # mid-way, one superstep past a snapshot: the journal has a tail
    kill = total // 2 // 8 * 8 + 4
    replay_trace(eng, trace, trace_submitter(eng),
                 stop=lambda e: e.stats.decode_steps >= kill)
    check(len(eng.finished) < len(trace), f"{tag}: nothing left to kill")
    rounds.add(eng)
    eng.journal.close()
    del eng
    skipped = []
    if corrupt:
        newest = recovery.list_snapshots(d)[-1]
        with open(os.path.join(recovery.snapshot_path(d, newest),
                               "arrays.npz"), "ab") as f:
            f.write(b"bitrot")
        skipped = [newest]
    torch.cuda.synchronize()
    rec = ServingEngine.restore(d, cfg, params, device=DEV)
    rep = rec.recovery_report
    before = rec.stats.decode_steps
    check(rep["corrupt_snapshots_skipped"] == skipped
          and rep["snapshot_round"] is not None,
          f"{tag}: recovery report {rep}")
    replay_trace(rec, trace, trace_submitter(rec), start=len(rec.requests))
    rounds.want += cfg.n_layers * (rec.stats.decode_steps - before
                                   + rep["replayed_rounds"])
    check(finished_streams(rec) == finished_streams(ref)
          and rec.stats.decode_steps == total
          and rec.stats.completed == len(trace),
          f"{tag}: restored run differs from the uninterrupted one")
    print(f"recovery {tag}: killed at round {kill} of {total}, "
          f"restored from the snapshot of round {rep['snapshot_round']}"
          + (f" (fell past the corrupt one of round {skipped[0]})"
             if skipped else "")
          + f", {rep['replayed_records']} journal records "
          f"({rep['replayed_rounds']} rounds) replayed; load "
          f"{rep['load_s'] * 1e3:.2f} ms, replay "
          f"{rep['replay_s'] * 1e3:.2f} ms; 24 streams (12 greedy, 12 "
          f"seeded-sampled) and {total} rounds equal the uninterrupted "
          f"run's")
    return rep


def sigkill_case(cfg, params):
    """A real kill: ``python -m repro_torch.launch.serve --snapshot-dir``
    serving 8 prompts x 256 new tokens at K 1 is sent SIGKILL once its
    journal holds 12 step records; this process restores from the
    directory with the same seeded weights, finishes, and matches an
    uninterrupted run of the same prompts and knobs."""
    import signal
    d = scratch_dir("sigkill")
    log_path = os.path.join(SCRATCH, "sigkill_child.log")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           cfg.name, "--device", "cuda", "--max-batch", "8", "--max-len",
           "512", "--max-new", "256", "--decode-block", "1",
           "--prompt-chunk", "1", "--seed", "0", "--snapshot-dir", d,
           "--snapshot-every", "8", "--prompts", *PROMPTS]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    jpath = os.path.join(d, recovery.JOURNAL_NAME)
    steps = 0
    with open(log_path, "w") as log:
        child = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=log,
                                 stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            while steps < 12:
                if child.poll() is not None:
                    break
                check(time.perf_counter() - t0 < 300,
                      "the serving child wrote no 12 step records in 300 s")
                if os.path.exists(jpath):
                    steps = sum(r["kind"] == "step" for r in
                                recovery.read_journal(jpath)[1])
                time.sleep(0.02)
            if child.poll() is None:
                child.send_signal(signal.SIGKILL)
        finally:
            if child.poll() is None:
                child.kill()
            child.wait()
    with open(log_path) as f:
        tail = f.read()[-3000:]
    check(child.returncode == -signal.SIGKILL,
          f"the serving child exited on its own (rc {child.returncode}) "
          f"after {steps} step records: {tail}")
    _, recs, dropped, _ = recovery.read_journal(jpath)
    t0 = time.perf_counter()
    rec = ServingEngine.restore(d, cfg, params, device=DEV)
    t_restore = time.perf_counter() - t0
    rep = rec.recovery_report
    outs = rec.run_to_completion()
    ref = ServingEngine(cfg, params, max_batch=8, max_len=512, seed=0,
                        decode_block=1, prompt_chunk=1, device=DEV)
    rids = [ref.submit(tokens_of(p), max_new=256) for p in PROMPTS]
    want = ref.run_to_completion()
    check([outs[r] for r in rids] == [want[r] for r in rids]
          and rec.stats.decode_steps == ref.stats.decode_steps
          and rec.stats.completed == len(PROMPTS),
          "SIGKILL: the restored run differs from the uninterrupted one")
    print(f"recovery SIGKILL: the serving child killed after "
          f"{sum(r['kind'] == 'step' for r in recs)} step records "
          f"({dropped} torn line(s) dropped); restored in "
          f"{t_restore * 1e3:.1f} ms from the snapshot of round "
          f"{rep['snapshot_round']} + {rep['replayed_rounds']} replayed "
          f"rounds; 8 streams x 256 tokens and {ref.stats.decode_steps} "
          f"rounds equal an uninterrupted run's")
    return ref.stats.decode_steps + rec.stats.decode_steps \
        - (rep["snapshot_round"] or 0)


def durability_cost(cfg, params):
    """Outside the count: decoded tok/s of the closed batch (C 8, K 4)
    plain, journaled with a snapshot every 8 rounds, and journaled
    without snapshots, in turns; one fsync'd journal record's ms; the
    snapshot's bytes and ms, and the share of it that copies the slot
    state to the host."""
    kinds = {"plain": None, "journaled": 8, "journal only": 10 ** 9}
    rates = {k: [] for k in kinds}
    for i in range(RATE_WINDOWS):
        order = list(kinds) if i % 2 == 0 else list(kinds)[::-1]
        for kind in order:
            extra = {} if kinds[kind] is None else {
                "recover_dir": scratch_dir("rate"),
                "snapshot_every": kinds[kind]}
            rates[kind].append(serve(cfg, params, 8, PROMPTS, 32,
                                     quiet=True, spec=extra)[1]["rate"])
    for kind, r in rates.items():
        r.sort()
        print(f"rate recovery {cfg.name} [block-fused] K=4 C=8 {kind}, "
              f"{RATE_WINDOWS} windows of 8 requests x 32 tokens: decoded "
              f"tok/s min {r[0]:.1f} median {r[len(r) // 2]:.1f} max "
              f"{r[-1]:.1f}")
    d = scratch_dir("snap_cost")
    journal = recovery.Journal.create(os.path.join(d, "bench.jsonl"), {})
    rec_ms = []
    for r in range(50):
        t0 = time.perf_counter()
        journal.record_step({"round": 4 * r, "k": 4,
                             "emits": [[j, 65 + j] for j in range(32)],
                             "digest": {"round": 4 * r + 4}})
        rec_ms.append((time.perf_counter() - t0) * 1e3)
    journal.close()
    rec_ms.sort()
    eng = ServingEngine(cfg, params, max_batch=8, max_len=128, seed=0,
                        decode_block=4, prompt_chunk=8, device=DEV)
    for p in PROMPTS:
        eng.submit(tokens_of(p), max_new=32)
    for _ in range(3):
        eng.step()
    total, to_host = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = recovery.save_snapshot(eng, d, keep=1)
        t1 = time.perf_counter()
        arrays, _ = recovery.snapshot_engine(eng)
        ckpt_lib.pack_arrays(arrays)
        total.append((t1 - t0) * 1e3)
        to_host.append((time.perf_counter() - t1) * 1e3)
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    total.sort()
    to_host.sort()
    print(f"journal record (one step of 32 emissions, fsync'd): ms min "
          f"{rec_ms[0]:.3f} median {rec_ms[25]:.3f} max {rec_ms[-1]:.3f} "
          f"over 50")
    print(f"snapshot {cfg.name} (8 slots, max_len 128, {cfg.n_layers} "
          f"layers, {len(arrays)} arrays): {size} bytes, ms min "
          f"{total[0]:.2f} median {total[2]:.2f} max {total[-1]:.2f} over "
          f"5 writes; of which the state to the host (one copy an array) "
          f"median {to_host[2]:.2f} ms")


def recovery_phase(cfg, params):
    """Kill and restore at full width: mingru-lm on the block tier, with
    n-gram speculation, with a corrupted newest snapshot, on the cell
    tier; then a real SIGKILL of a serving process (the counted main
    path of this phase), and the durability cost."""
    off = cfg.replace(fuse_block="off")
    spec = {"speculative": "ngram", "draft_len": SPEC_S}
    reset_serve_launches()
    rounds = Rounds()
    kill_restore("block tier", cfg, params, rounds)
    kill_restore("block tier, corrupt newest snapshot", cfg, params, rounds,
                 corrupt=True)
    kill_restore("block tier, ngram S 4", cfg, params, rounds, **spec)
    kill_restore("cell tier", off, params, rounds)
    launches = serve_launches()
    check(sum(launches.values()) == rounds.want,
          f"recovery launches {launches}: {sum(launches.values())} != "
          f"layers x rounds = {rounds.want}")
    for name in ("block_step_kernel", "block_chunk_kernel",
                 "mingru_step_kernel", "mingru_chunk_kernel"):
        check(launches[name] > 0, f"{name} not launched under recovery")
    print(f"recovery: launches on the main path {launches} == layers x "
          f"rounds ({rounds.want})")
    gen = torch.Generator(device=DEV).manual_seed(0)   # the launcher's
    sig_params = lm.init_params(gen, cfg, device=DEV)
    reset_serve_launches()
    sig_rounds = sigkill_case(cfg, sig_params)
    sig = serve_launches()
    check(sig["block_step_kernel"] == cfg.n_layers * sig_rounds
          and sum(sig.values()) == sig["block_step_kernel"],
          f"SIGKILL case launches {sig} != {cfg.n_layers} x {sig_rounds}")
    merge(launches, sig)
    del sig_params
    durability_cost(cfg, params)
    return launches


def window_rate(cfg, params, **kw):
    eng = ServingEngine(cfg, params, max_batch=8, max_len=128, seed=0,
                        device=DEV, **kw)
    rids = [eng.submit(tokens_of(p), max_new=32) for p in PROMPTS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.run_to_completion()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return [tuple(outs[r]) for r in rids], eng.stats.decode_tokens / dt, eng


def tuning_phase(gen):
    """The autotuner's first 2 points at full width into a scratch
    directory; ``"auto"`` resolves the committed plans for this card (and
    never the JAX package's CPU-modelled plans); an engine with
    ``tune="auto"`` streams as the untuned engine on the plan's tier, at
    K 1 / C 1; the two in turns."""
    d = scratch_dir("tune")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    env.pop("REPRO_TUNE_DIR", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serving.autotune", "--arch",
         "mingru-lm", "--points", "2", "--out-dir", d], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"autotune --points 2 failed: "
          f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    for ln in proc.stdout.strip().splitlines():
        print(f"  {ln}")
    cfg = archs.get("mingru-lm")
    name = tuning.tune_filename(cfg, DEV)
    fresh = tuning.load_plan(os.path.join(d, name))
    check(fresh["points_scored"] == 2 and fresh["card"] == card_line()
          and fresh["config"]["device"] == tuning.device_name(DEV),
          f"autotune --points 2 wrote {fresh}")
    print(f"tune: autotune --points 2 for mingru-lm in "
          f"{time.perf_counter() - t0:.1f}s wrote {name}")
    check(os.path.exists(os.path.join(HERE, "TUNE_mingru-lm_L3_d64.json"))
          and tuning.resolve_plan(archs.smoke("mingru-lm"), "auto", DEV)
          is None, "a plan of another device resolved on the card")
    launches = {}
    for arch in ("mingru-lm", "minlstm-lm"):
        a_cfg = archs.get(arch)
        plan = tuning.resolve_plan(a_cfg, "auto", DEV)
        want = os.path.join(HERE, tuning.tune_filename(a_cfg, DEV))
        check(plan is not None
              and os.path.realpath(plan["source"]) == os.path.realpath(want)
              and plan["streams_identical_within_tier"],
              f"{arch}: 'auto' resolved {plan and plan.get('source')}, "
              f"not {want}")
        a_params = lm.init_params(gen, a_cfg, device=DEV)
        tier = plan["fuse_block"]
        knobs = dict(decode_block=1, prompt_chunk=1, fuse_block=tier)
        window_rate(a_cfg, a_params, tune="auto")          # warm-up
        window_rate(a_cfg, a_params, **knobs)
        reset_serve_launches()
        tuned, _, eng = window_rate(a_cfg, a_params, tune="auto")
        got = serve_launches()
        check(sum(got.values()) == a_cfg.n_layers * eng.stats.decode_steps
              and (eng.decode_block, eng.prompt_chunk, eng.cfg.fuse_block)
              == (plan["decode_block"], plan["prompt_chunk"], tier),
              f"{arch}: tune='auto' engine {got}, K {eng.decode_block} C "
              f"{eng.prompt_chunk} tier {eng.cfg.fuse_block}")
        merge(launches, got)
        untuned = window_rate(a_cfg, a_params, **knobs)[0]
        check(tuned == untuned, f"{arch}: tune='auto' streams differ from "
              f"K 1 / C 1 on the {tier} tier")
        rates = {"auto": [], "K1C1": []}
        for i in range(RATE_WINDOWS):
            for kind in (("auto", "K1C1") if i % 2 == 0
                         else ("K1C1", "auto")):
                kw = {"tune": "auto"} if kind == "auto" else knobs
                rates[kind].append(window_rate(a_cfg, a_params, **kw)[1])
        print(f"tune {arch}: plan {os.path.basename(plan['source'])} "
              f"(fuse_block={tier}, K={plan['decode_block']}, "
              f"C={plan['prompt_chunk']}, swept "
              f"{plan['score_decode_tokens_per_s']:.1f} decoded tok/s); "
              f"streams equal K 1 / C 1 on that tier")
        for kind, r in rates.items():
            r.sort()
            print(f"rate tune {arch} {kind}, {RATE_WINDOWS} windows of 8 "
                  f"requests x 32 tokens: decoded tok/s min {r[0]:.1f} "
                  f"median {r[len(r) // 2]:.1f} max {r[-1]:.1f}")
        del a_params
    return launches


def main():
    t_start = time.perf_counter()
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sources = sorted(set(SOURCES.values()))
    t0 = time.perf_counter()
    build.build_all(sources)
    print(f"built {', '.join(s_.name for s_ in sources)} in parallel in "
          f"{time.perf_counter() - t0:.1f}s")
    for src in sources:
        print(f"ptxas report of {src.name}:")
        print(build.ptxas_log(src).strip())

    gen = torch.Generator().manual_seed(0)
    main_k = kernel_phase(gen)
    main_k.update(cell_kernel_phase(gen))
    main_k.update(train_kernel_phase(gen))
    launches, (cfg, params, block_streams) = serve_phase(gen)
    launches.update(cell_serve_phase(gen, cfg, params, block_streams))
    del params
    torch.cuda.empty_cache()
    merge(launches, gemma_phase())
    merge(launches, prefill_phase(gen))
    merge(launches, spec_phase(gen))
    torch.cuda.empty_cache()
    merge(launches, train_phase(gen))
    torch.cuda.empty_cache()
    rgen = torch.Generator().manual_seed(21)
    robust, (cfg, params) = robustness_phase(rgen)
    merge(launches, robust)
    merge(launches, recovery_phase(cfg, params))
    del params
    merge(launches, tuning_phase(rgen))
    shutil.rmtree(SCRATCH, ignore_errors=True)

    entries = []
    for name in REPLACES:
        err, t_k, t_p, (b_ms, b_by) = main_k[name]
        check(launches[name] > 0, f"{name} was launched no time on the "
              f"main path")
        entries.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(SOURCES[name], HERE),
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": t_k, "kernel_ms": t_k,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": LIBRARY_MS.get(name)})
        if name in DEVICE_MS:
            entries[-1]["device_ms"] = DEVICE_MS[name]
        if name in LIBRARY_DEVICE_MS:
            entries[-1]["library_device_ms"] = LIBRARY_DEVICE_MS[name]
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
