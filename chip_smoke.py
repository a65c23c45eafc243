"""GPU smoke run of the PyTorch port: builds the CUDA kernels from source,
holds each against its plain PyTorch version at full model width, serves
full-width mingru-lm (and a short minlstm-lm run) through the port's
ServingEngine on the block-fused and on the cell-fused tier, serves,
prefills and trains full-width gemma-2b-mingru, gemma-2b (native GQA
with RoPE and a KV cache), mamba2-370m (the SSD trunk), zamba2-2.7b (the
hybrid), deepseek-moe-16b (MoE; trained at 4 layers), starcoder2-15b
(LayerNorm, biases), pixtral-12b (a patch prefix), deepseek-67b and
deepseek-v3-671b (MLA with 256 routed experts; all at cut depths),
encodes, decodes and trains whisper-base (the encoder-decoder),
compares remat "dots" with "full" and "none", trains the
paper's task heads, holds the GRU / LSTM baselines against the CPU and
times them against minGRU / minLSTM, prefills the minRNN LMs in parallel,
serves with speculative decoding on both tiers, trains full-width
mingru-lm / minlstm-lm through the port's train step, then serves under
injected faults, kills and restores the engine (in this process and a
serving process sent SIGKILL), serves under the card's tune plans and
on data x model worlds of ranks sharing the card, trains on such worlds
(the compressed data-parallel step, MoE expert parallelism, the
sequence-parallel scan, a checkpoint restored onto a mesh), and checks
that every layer of every device round, prefill and training step went
through the kernels.

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
     the step path's, ms and prompt tokens/s); then 3 AdamW training
     steps, B 8 x T 512 on one repeated corpus batch (108
     fused_mingru_kernel launches, all on the tensor-core body, and 54
     reversed linear scans; the loss finite and falling; ms a step,
     tokens/s, peak memory), outside the count the same 3 steps on the
     plain versions (losses within 1%), a profiled step, and the reversed
     linear scan at that shape (D 2048) against its plain version, timed.
     gemma-2b at full width (bf16, drawn on the card; no kernel of the
     repo, every count stays 0): the same serving traffic with a KV cache
     of 1024 (streams equal ``generate_one``, tok/s over 5 windows, peak
     memory, a device profile, a sampled window), its prefill B 8 x T 512
     (ms, prompt tokens/s, peak memory; the logits and a ``decode_step``
     after it against the 512-step sequential route within 5e-2 of the
     largest |logit|), the port's blocked attention against
     ``scaled_dot_product_attention`` at that shape (a yardstick), and 3
     training steps as gemma-2b-mingru's;
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
  5c. mamba2-370m at full width, cut to 12 of its 48 SSD layers for the
     script's time (d 1024, 32 heads of 64, d_state 128, chunk 256, tied
     vocab 50,280; bf16, drawn on the card; no kernel of the repo, every
     count stays 0): 8 slots, 8 prompts of
     8 seeded ids, 32 new tokens, K 4, C 1 (streams equal
     ``generate_one``, a B-8 decode row equal to the B-1 row bit for bit,
     tok/s over 5 windows, peak memory, a device profile with its device
     events a layer a round); its prefill B 8 x T 1024, full and
     right-padded (lengths 1 to 1024): the logits, the ssm state and one
     step after against 1024 ``decode_step`` calls (and in an fp32
     compute dtype against 128), each padded row
     against its own prefill, within 5e-2 of the largest; ms, prompt
     tokens/s, peak memory, a profile; one layer's SSD at that shape,
     the masked form against the compact one and ``ssd_sequential``, ms
     and memory of each; 3 training steps as gemma-2b's.  The task heads
     (fp32): the Chomsky classifier (Table 4's block) on majority and on
     ListOps and the Decision-Transformer model on rl_proxy "medium",
     minGRU and minLSTM, 5 AdamW steps each on one batch: one fused-cell
     launch and one reversed linear scan per layer a step, all on the
     CUDA-core body, the loss finite and falling, outside the count the
     plain versions' losses within 1% and the fused cells at the heads'
     shapes (T 40, 128, 192) against their plain versions.  GRU / LSTM:
     forward and BPTT gradients on the card against the CPU run, then one
     ungated Fig. 1 line (fwd + bwd ms at D 64, B 16, T 1024 and 4096
     against minGRU / minLSTM in parallel);
  5d. zamba2-2.7b at full width, cut to 12 of its 54 SSD layers (2
     groups) for the script's time (d 2560, 80 heads of 64, d_state 64;
     one shared MHA block of 32 heads of 80 with GeGLU d_ff 10240 after
     every 6; vocab 32,000; bf16, drawn on the card; no
     kernel of the repo, every count stays 0): 8 slots, 8 prompts of 8
     seeded ids, 32 new tokens, K 4, C 1, a KV cache of 1024 (streams
     equal ``generate_one``, a B-8 decode row equal to the B-1 row bit
     for bit in the logits and every cache leaf, tok/s over 5 windows,
     peak memory, a device profile with its device events a layer a
     round); its prefill B 8 x T 1024, full and right-padded (ms, prompt
     tokens/s, peak memory, a profile; each padded row against its own
     prefill; against 256 sequential steps, logits and one step after,
     within 5e-2 of the largest, and in an fp32 compute dtype at T 32
     within 1e-4); 3 training steps as gemma-2b's.  deepseek-moe-16b at
     full width (64 experts of 1408, top-6, 2 shared of 2816; vocab
     102,400; drawn on the card; no kernel of the repo), its serving and
     prefill cut to 6 of its 28 layers (1 dense + 5 MoE) for the
     script's time: the same
     serving traffic at capacity factor 16 (streams equal
     ``generate_one``, a B-8 row equal to the B-1 row) and at the
     published 1.25 (the dropped share, tok/s over 5 windows, peak
     memory, a profile, one sampled superstep); its prefill B 8 x T 512
     at 1.25 (ms, prompt tokens/s, the dropped share, peak memory, a
     profile) and, at capacity factor 16, against 64 sequential steps
     held to the prefill's routing (5e-2; how many of the steps' own
     top-6 choices differ printed) and in an fp32 compute dtype at T 32
     (1e-4, no choice apart); then cut to 4 layers (1 dense + 3 MoE) 3
     training steps, the losses and ``moe_aux`` printed;
  5e. the rest of the dense zoo at full width, bf16, drawn on the card,
     no kernel of the repo (every count stays 0), a lap line each.
     starcoder2-15b cut to 16 of 40 layers (d 6144, GQA 48 / 4, LayerNorm,
     biased attention and GELU MLP 24576, vocab 49,152): 8
     prompts of 8 seeded ids, 32 new tokens, K 4, C 1, a KV cache of
     1024 (streams equal ``generate_one``, a B-8 decode row equal to the
     B-1 row bit for bit, tok/s over 3 windows, peak memory, a device
     profile with its events a layer a round); its prefill B 8 x T 512
     (ms, prompt tokens/s, peak memory, a profile; a prefill of 128
     tokens and a step after against 128 sequential steps within 5e-2 of
     the largest |logit|, and of 32 in an fp32 compute dtype within
     1e-4); cut to 4 layers, 3 training steps at B 8 x T 512.
     pixtral-12b cut to 10 of 40 layers (d 5120, GQA 32 / 8; 1024 patch
     embeddings of dim 1024): the same serving traffic as text, its
     prefill B 8 x (1024 patches + 512 tokens) against a prefill of the
     patches and 384 tokens followed by 128 steps (5e-2), and cut to 4
     layers 3 training steps with the patch prefix.  deepseek-67b cut to
     8 of 95 layers (d 8192, GQA 64 / 8, SwiGLU 22016): serving and
     prefill as starcoder2-15b's, the route at 128 steps.  whisper-base
     whole (6 + 6 layers, d 512): encode B 8 x 1500 frames; prefill and
     64 greedy decode steps against teacher-forced ``forward`` (bf16
     5e-2, fp32 1e-4), decoded tok/s, a B-8 decode row equal to the B-1
     row; 3 training steps at B 8 x 1500 frames x 448 tokens;
  5f. deepseek-v3-671b (MLA: 128 heads, q / kv LoRA 1536 / 512, rope dim
     64; 256 experts of 2048, top-8, a shared one; vocab 129,280) at full
     width, bf16, drawn on the card a layer at a time, no kernel of the
     repo (every count stays 0), cut to 3 dense + 2 MoE layers (53.2 GB):
     the serving traffic with a latent cache of 1024 at capacity factor
     32 (streams equal ``generate_one``, a B-8 decode row equal to the B-1
     row bit for bit in the logits, ckv and krope) and at the published
     1.25 (the dropped share, tok/s over 3 windows, peak memory, a
     profile); its prefill B 8 x T 512 at 1.25 (the dropped share, ms,
     prompt tokens/s, peak memory, a profile) and, at 32, against 128
     steps held to the prefill's routing (5e-2); fp32 weights at 1 dense +
     1 MoE layer against 32 steps (1e-4, no top-8 choice apart); 3
     training steps on the 3 dense layers (an empty MoE stack), then one
     loss and its gradients under remat full, dots and none (the same
     loss, gradients within the bf16 limit of full's, peaks ordered);
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
  7. mesh-sharded serving of full-width mingru-lm on worlds of ranks that
     share the card (gloo, every rank on ``cuda:0``, spawned by
     ``serve_mesh.run_world``): DP 2x1 and 4x1 on the block tier at K 4,
     C 1 and 8, and 2x1 on the cell tier, streams equal to the one card's
     bit for bit and one kernel launch per layer per round on every rank;
     a shard crash at round 4 finishing on the survivors with the same
     streams; TP 1x2 and 2x2 on the cell tier at Dh 768, the model ranks'
     planes and first-step logits equal bit for bit, the logits within
     the bf16 tolerance of the one card's, fp32 streams equal to the one
     card's, bf16 streams counted; ``python -m repro_torch.launch.serve
     --mesh 2x2`` on the card; decoded tok/s per mesh against the one
     card, ms per TP all-reduce, each world's start-up (not gated);
  7b. training on worlds of ranks that share the card (gloo, cuda:0):
     the compressed DP step (bf16 grads, one all-reduce over the data
     ranks) of full-width mingru-lm (bf16, remat full, B 8 x T 256, 3
     steps) at 2x1 and 2x2: every rank launches the one card's 24 fused
     minGRU and 12 reversed linear scans a step, replicas bit-equal,
     losses within 1e-2 of the one card's, params within the
     reference's trend tolerance (rtol 0.1, atol 2e-3) of the one card's
     step on the same halves as 2 microbatches (against its whole-batch
     step: printed, not gated); deepseek-moe-16b at full width cut to 1
     dense + 1 MoE layer, expert parallel at 1x2 and 2x2 with ep_2d off
     and on: the MoE layer's y and aux against the one card at capacity
     factor 16 (bf16 limit; fp32 1e-4), its drops at capacity factor 1
     equal to the one card's on each data rank's tokens, "auto" taking
     2D at 2x2 at the published 1.25, one train step's grads within 2e-2
     of the max of the one card's, the global norm, the bytes each rank
     holds; the sequence-parallel scan over 4 ranks at B 8 x T 4096 x D
     1536 fp32 against the one-card linear_scan_kernel (1e-4); the whole
     mingru-lm checkpoint restored onto a 2x2 world, each block its
     slice and every leaf reassembled bit for bit; ms a DP step per
     world against the one card, each world's start-up (not gated);
  8. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from repro_torch.distributed import context as mesh_ctx  # noqa: E402
from repro_torch.distributed import serve_mesh  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.core import scan as scan_lib  # noqa: E402
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
from repro_torch.models import encdec, lm  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.training import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training import train_step as ts_lib  # noqa: E402
from repro_torch.tree import (  # noqa: E402
    at, leaves, leaves_with_path, map_with_path, tree_map)
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
          quiet=False, spec=None, max_len=128, **submit_kw):
    """One closed batch through a fresh engine; returns the streams and
    {"rounds", "launches" (this run's, per kernel), "rate" (decoded
    tok/s), "stats" (the snapshot)}; ``quiet`` prints nothing.  ``spec``:
    the engine's speculative options.  Checks one decode kernel launch
    per layer per device round (speculation: one verify chunk; a model
    draft adds S draft steps and one draft commit chunk), none on the
    unfused tier (native GQA)."""
    eng = ServingEngine(cfg, params, max_batch=8, max_len=max_len, seed=0,
                        decode_block=k, prompt_chunk=chunk, device=DEV,
                        **(spec or {}))
    per_round = 0 if eng.kernel_tier == "unfused" else 1
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


def rate_spread(cfg, params, reps=5, chunks=(1, 8), prompts=PROMPTS,
                max_len=128):
    """Decoded tok/s over ``reps`` windows of the serving traffic per C:
    min / median / max, since one window of 8 requests is short and the
    host clock varies."""
    tier = lm.kernel_tier(cfg)
    for c in chunks:
        rates = sorted(serve(cfg, params, c, prompts, 32, quiet=True,
                             max_len=max_len)[1]["rate"]
                       for _ in range(reps))
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


def serve_profile(cfg, params, prompts, label, spec=None, chunk=1,
                  max_len=128):
    """Where one window's device time goes: ``torch.profiler`` over one
    K 4 window (after the warm-ups), device kernels by group and the
    device-busy share of the window's wall time (the profiler's own host
    cost inflates the wall time, so the share is a lower bound).  Returns
    {"events", "rounds", "busy_ms", "wall_ms"}, or None if the profiler
    saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, info = serve(cfg, params, chunk, prompts, 8, quiet=True,
                        spec=spec, max_len=max_len)
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
    return {"events": sum(e.count for e in events), "rounds": info["rounds"],
            "busy_ms": busy, "wall_ms": wall_ms}


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
    # sampled: the Gumbel table is drawn on the host, vocab 256,000 wide;
    # one superstep (2-token prompts, 2 new tokens: one table)
    keys = sampling.make_keys(0, 8)
    t0 = time.perf_counter()
    table = sampling.gumbel_table(keys, 4, cfg.padded_vocab)
    t_table = time.perf_counter() - t0
    check(bool(torch.isfinite(table).all()), "non-finite Gumbel table")
    t0 = time.perf_counter()
    s_streams, s_info = serve(cfg, params, 1, [p[:2] for p in prompts], 2,
                              quiet=True, temperature=0.8, top_k=40,
                              top_p=0.95)
    t_window = time.perf_counter() - t0
    for s_ in s_streams:
        check(len(s_) == 2 and all(0 <= t < cfg.vocab_size for t in s_),
              "malformed sampled gemma stream")
    print(f"sampled gemma-2b-mingru, one window of 8 requests x 2 tokens "
          f"(K 4, T 0.8, top-k 40, top-p 0.95): {t_window:.2f}s, "
          f"{s_info['rounds']} rounds; one host Gumbel table (8 slots x 4 "
          f"x {cfg.padded_vocab}) {t_table * 1e3:.1f} ms")
    merge(launches, gemma_prefill(cfg, params))
    merge(launches, attn_train(cfg, params, plain_check=True))
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


def train_profile(cfg, params, batches, ocfg, top=20, shape=(TB, TT)):
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
    print(f"train profile, one {cfg.name} step (B {shape[0]} x T "
          f"{shape[1]}): wall "
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
# 5b. the attention trunk at full width: gemma-2b (native GQA, a KV cache),
#     and training gemma-2b-mingru
# ---------------------------------------------------------------------------

# training traffic of the attention trunk: one repeated corpus batch
AB, AT = 8, 512
# gemma-2b's serving and prefill cache length
GEMMA_MAX_LEN = 1024
# the first 3 steps of a warmup over 10 to lr 1e-4: at 2.5 B parameters
# AdamW's sign-like first steps move every weight by ~lr, and a fan-in of
# 16384 sums them coherently (lr 3e-4 without warmup took gemma-2b-mingru's
# loss from 13.8 to 22.1); below lr ~1e-5 bf16 weights would not move
ATTN_OPT = opt_lib.AdamWConfig(lr=1e-4, warmup_steps=10, total_steps=1000)


def timed_steps(cfg, params, batch, ocfg, n, aux=None):
    """``n`` train steps on one batch from ``params`` (updated in place):
    the per-step losses and host ms (each step ends in the loss's read);
    ``aux``, a list, gets each step's MoE router loss."""
    step = ts_lib.make_train_step(cfg, ocfg)
    state = opt_lib.init(ocfg, params)
    losses, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
        if aux is not None:
            aux.append(float(m["moe_aux"]))
    return losses, times


def attn_train(cfg, params, plain_check, extra=None):
    """3 AdamW steps of full-width ``cfg`` (bf16, remat "full") at B 8 x T
    512 on one repeated corpus batch (``extra``: more batch entries, e.g.
    a patch prefix), from ``params`` (updated in place):
    launches against the formula (gemma-2b-mingru: 2 fused-cell launches
    per layer a step, forward and recompute, all on the tensor-core body,
    and one reversed linear scan; native GQA: none), the loss finite and
    falling, ms a step and peak memory.  ``plain_check``: outside the
    count, the same 3 steps on the plain versions of the kernels (losses
    within LOSS_RTOL_PLAIN) and a profiled step."""
    train_data, _ = lm_corpus.build_corpus()
    batch = dict(lm_corpus.lm_batch(train_data, 0, 0, AB, AT),
                 **(extra or {}))
    ocfg = ATTN_OPT
    p_init = clone(params) if plain_check else None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_train_launches()
    reset_serve_launches()
    aux = [] if cfg.moe else None
    losses, times = timed_steps(cfg, params, batch, ocfg, 3, aux=aux)
    peak = torch.cuda.max_memory_allocated()
    launches = train_launches()
    n = cfg.n_layers
    want = {k_: 0 for k_ in launches}
    if lm.kernel_tier(cfg) != "unfused":
        want.update(fused_mingru_kernel=2 * n * 3, linear_scan_kernel=n * 3)
    check(launches == want, f"{cfg.name} training launches {launches} != "
          f"{want}")
    check(gru_ops.LAUNCHES["fused_mingru_kernel/tc"]
          == want["fused_mingru_kernel"],
          f"{cfg.name} training launches by body {body_launches()}")
    check(sum(serve_launches().values()) == 0,
          f"{cfg.name} training launched decode kernels")
    check(all(math.isfinite(v) for v in losses), f"{cfg.name}: {losses}")
    check(losses[-1] < losses[0], f"{cfg.name}: loss did not fall: {losses}")
    tok = AB * AT
    if aux is not None:
        check(all(math.isfinite(v) for v in aux), f"{cfg.name}: moe_aux "
              f"{aux}")
    prefix = "" if not extra else \
        " + a prefix of " + ", ".join(f"{k} {tuple(v.shape)}"
                                      for k, v in extra.items())
    print(f"train {cfg.name} ({cfg.n_layers} layers, bf16, remat full, B "
          f"{AB} x T {AT}{prefix}, one repeated batch, 3 steps): losses "
          + " ".join(f"{v:.4f}" for v in losses)
          + ("" if aux is None else "; moe_aux "
             + " ".join(f"{v:.4f}" for v in aux))
          + f"; launches {launches} == {want}; ms per step "
          + " ".join(f"{v:.2f}" for v in times)
          + f" (steps 2-3: tokens/s {tok / (sum(times[1:]) / 2) * 1e3:.1f});"
          f" peak device memory {peak / 2**30:.2f} GiB")
    if not plain_check:
        return launches
    with plain_kernels():
        before = train_launches()
        plain, _ = timed_steps(cfg, clone(p_init), batch, ocfg, 3)
        check(train_launches() == before, "the plain run launched kernels")
    d_plain = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    check(max(d_plain) <= LOSS_RTOL_PLAIN,
          f"{cfg.name} kernel vs plain losses {losses} vs {plain} "
          f"(relative {d_plain})")
    print(f"train {cfg.name}: losses vs the plain versions' run {plain}: "
          f"relative differences " + " ".join(f"{v:.3g}" for v in d_plain)
          + f" (limit {LOSS_RTOL_PLAIN})")
    train_profile(cfg, p_init, lambda i: batch, ocfg, shape=(AB, AT))
    scan_at_gemma_width()
    return launches


def scan_at_gemma_width():
    """The backward's reversed linear scan at gemma-2b-mingru's training
    shape (fp32, B 8 x T 512 x D 2048, zero h0; a_next and the incoming
    gradient as the backward passes them): against its plain version and
    its segmented rendering, its plan, eager and CUDA-graph times over 4
    input sets (134 MB: more than the L2), the plain version's, the bound."""
    gen = torch.Generator().manual_seed(22)
    d = 2048
    sets = [(torch.rand((AB, AT, d), generator=gen).to(DEV),
             torch.randn((AB, AT, d), generator=gen).to(DEV))
            for _ in range(SCAN_SETS)]
    h0 = torch.zeros((AB, d), device=DEV)
    a, b = sets[0]
    got = scan_ops.launch_linear_scan(a, b, h0, True)
    err = max_err(got, scan_ref.linear_scan_ref(a, b, h0, reverse=True),
                  torch.float32, "reversed linear scan at D 2048")
    check(torch.equal(got, scan_ref.linear_scan_segmented(a, b, h0,
                                                          reverse=True)),
          "reversed linear scan at D 2048 != its segmented rendering")
    occ = scan_ops.occupancy("linear", torch.float32, AB, AT, d)
    fns = [lambda a_=a_, b_=b_: scan_ops.launch_linear_scan(a_, b_, h0, True)
           for a_, b_ in sets]
    k_ms = eager_ms(fns, 40)
    g_ms = graph_ms(rotating(fns))
    p_ms = eager_ms([lambda: scan_ref.linear_scan_ref(a, b, h0,
                                                      reverse=True)], 3)
    b_ms = AB * AT * d * 3 * 4 / HBM_BYTES_PER_S * 1e3
    print(f"linear_scan_kernel reversed at gemma width (fp32, B {AB} x T "
          f"{AT} x D {d}): max abs err {err:.3g}, bit-equal to the "
          f"segmented rendering; plan {occ}; {k_ms:.5f} ms eager, device "
          f"{g_ms:.5f} ms, plain {p_ms:.3f} ms, bound {b_ms:.5f} ms (bytes)")


def gemma2b_phase():
    """gemma-2b at full width (native GQA: 8 query heads on one KV head of
    256, RoPE, a KV cache of 1024 positions; GeGLU d_ff 16384, tied vocab
    256,000; bf16, weights drawn on the card from a seed).  It runs no
    kernel of the repo (the reference computes attention outside Pallas):
    every count stays 0.  Serving: 8 requests x 32 new tokens, K 4, C 1,
    streams equal ``generate_one``, tok/s over 5 windows, a profiled and a
    sampled window; then the prefill, the attention yardstick and 3
    training steps on the same weights."""
    cfg = archs.get("gemma-2b")
    check(cfg.n_layers == 18 and cfg.d_model == 2048 and cfg.n_heads == 8
          and cfg.n_kv_heads == 1 and cfg.head_dim_ == 256
          and cfg.cdtype == torch.bfloat16 and cfg.vocab_size == 256000,
          f"unexpected gemma-2b config {cfg}")
    check(lm.kernel_tier(cfg) == "unfused", "gemma-2b not unfused")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=DEV).manual_seed(0), cfg,
                            device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(a.numel() for a in leaves(params))
    print(f"gemma-2b: {n_params} parameters drawn on the card in "
          f"{t_init:.2f}s; peak device memory during the init "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    prompts = torch.randint(0, cfg.vocab_size, (8, 8), generator=torch.
                            Generator().manual_seed(1)).tolist()
    serve(cfg, params, 1, prompts, 4, label="warm-up",
          max_len=GEMMA_MAX_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_serve_launches()
    reset_train_launches()
    streams, info = serve(cfg, params, 1, prompts, 32, max_len=GEMMA_MAX_LEN)
    serve_peak = torch.cuda.max_memory_allocated()
    check(sum(serve_launches().values()) + sum(train_launches().values())
          == 0, f"gemma-2b serving launched kernels {serve_launches()}")
    for p, s_ in zip(prompts, streams):
        check(len(s_) == 32 and all(0 <= t < cfg.vocab_size for t in s_),
              "malformed gemma-2b stream")
        ref_s = tuple(generate_one(cfg, params, p, max_new=32,
                                   max_len=GEMMA_MAX_LEN, device=DEV))
        check(ref_s == s_, f"gemma-2b stream for {p} != generate_one: first "
              f"divergence at token {first_divergence(ref_s, s_)}")
    print(f"serve gemma-2b: streams equal generate_one; no kernel launch; "
          f"KV cache {GEMMA_MAX_LEN} positions; peak device memory while "
          f"serving {serve_peak / 2**30:.2f} GiB")
    rate_spread(cfg, params, chunks=(1,), prompts=prompts,
                max_len=GEMMA_MAX_LEN)
    serve_profile(cfg, params, prompts, "gemma-2b", max_len=GEMMA_MAX_LEN)
    # sampled: one superstep (2-token prompts, 2 new tokens: one host
    # Gumbel table of 8 slots x 4 x 256,000, ~3.5 s)
    t0 = time.perf_counter()
    s_streams, s_info = serve(cfg, params, 1, [p[:2] for p in prompts], 2,
                              quiet=True, max_len=GEMMA_MAX_LEN,
                              temperature=0.8, top_k=40, top_p=0.95)
    t_window = time.perf_counter() - t0
    for s_ in s_streams:
        check(len(s_) == 2 and all(0 <= t < cfg.vocab_size for t in s_),
              "malformed sampled gemma-2b stream")
    print(f"sampled gemma-2b, one window of 8 requests x 2 tokens (K 4, T "
          f"0.8, top-k 40, top-p 0.95): {t_window:.2f}s, "
          f"{s_info['rounds']} rounds")
    gemma2b_prefill(cfg, params)
    attention_yardstick(cfg)
    launches = attn_train(cfg, params, plain_check=False)
    del params
    torch.cuda.empty_cache()
    return launches


def gemma2b_prefill(cfg, params):
    """gemma-2b, B 8 x T 512 into a KV cache of 1024: ms and prompt
    tokens/s, peak memory; the logits and one ``decode_step`` after it
    against the sequential route (512 ``decode_step`` calls) within
    PREFILL_REL of the largest |logit|; 16 decode steps after it."""
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (AB, AT), generator=gen,
                         dtype=torch.int32).to(DEV)
    lm.prefill(params, cfg, toks[:, :16], GEMMA_MAX_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits, cache = lm.prefill(params, cfg, toks, GEMMA_MAX_LEN)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(tuple(cache["k"].shape) == (cfg.n_layers, AB, GEMMA_MAX_LEN,
                                      cfg.n_kv_heads, cfg.head_dim_)
          and bool((cache["pos"] == AT).all()), "gemma-2b prefill cache")
    c_seq = lm.init_cache(cfg, AB, GEMMA_MAX_LEN, DEV)
    for t in range(AT):
        l_seq, c_seq = lm.decode_step(params, cfg, toks[:, t], c_seq)
    tol = PREFILL_REL[torch.bfloat16]
    e_l = rel_err(logits, l_seq, "gemma-2b prefill vs the step path", tol)
    tok = l_seq[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    l_p1, cache = lm.decode_step(params, cfg, tok, cache)
    l_s1, _ = lm.decode_step(params, cfg, tok, c_seq)
    e_d = rel_err(l_p1, l_s1, "gemma-2b decode after the prefill vs after "
                  "the step path", tol)
    for _ in range(15):
        tok = l_p1[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
        l_p1, cache = lm.decode_step(params, cfg, tok, cache)
        check(bool(torch.isfinite(l_p1).all()), "gemma-2b decode after "
              "prefill")
    ms = synced_ms(lambda: lm.prefill(params, cfg, toks, GEMMA_MAX_LEN),
                   reps=3)
    print(f"prefill gemma-2b B {AB} x T {AT} (KV cache {GEMMA_MAX_LEN}): "
          f"logits vs the step path relative error {e_l:.3g}, one "
          f"decode_step after each {e_d:.3g} (limit {tol}); 16 decode steps "
          f"after it finite; peak device memory of the prefill "
          f"{peak / 2**30:.2f} GiB; ms min {ms[0]:.2f} median {ms[1]:.2f} "
          f"max {ms[-1]:.2f}, prompt tokens/s median "
          f"{AB * AT / ms[1] * 1e3:.0f}")


def attention_yardstick(cfg):
    """The port's blocked attention (causal, bf16, its 1024 tiles) against
    one ``F.scaled_dot_product_attention`` call on the same inputs, at the
    prefill's shape: a yardstick only, the port never calls it."""
    gen = torch.Generator().manual_seed(3)
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = torch.randn((AB, AT, h, d), generator=gen).to(torch.bfloat16).to(DEV)
    k = torch.randn((AB, AT, kv, d), generator=gen).to(torch.bfloat16).to(DEV)
    v = torch.randn((AB, AT, kv, d), generator=gen).to(torch.bfloat16).to(DEV)
    from repro_torch.models import attention as attn

    def port():
        return attn.blocked_attention(q, k, v, causal=True,
                                      q_chunk=cfg.attn_q_chunk,
                                      kv_chunk=cfg.attn_kv_chunk)

    def sdpa():
        rep_ = h // kv
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(rep_, 1),
            v.transpose(1, 2).repeat_interleave(rep_, 1),
            is_causal=True).transpose(1, 2)

    err = max_err(port(), sdpa(), torch.bfloat16,
                  "blocked attention vs scaled_dot_product_attention")
    p_ms, s_ms = eager_ms([port], 20), eager_ms([sdpa], 20)
    flops = 2 * 2 * AB * h * AT * AT * d / 2          # causal QK^T and PV
    nbytes = 2 * (2 * AB * AT * h * d + 2 * AB * AT * kv * d)
    b_ms = max(flops / PEAK_FLOPS[torch.bfloat16],
               nbytes / HBM_BYTES_PER_S) * 1e3
    print(f"attention yardstick at the prefill shape (bf16, B {AB} x T {AT}"
          f", {h} heads on {kv} KV head of {d}, causal): the port's blocked "
          f"attention {p_ms:.4f} ms, scaled_dot_product_attention "
          f"{s_ms:.4f} ms, bound {b_ms:.4f} ms; max abs difference "
          f"{err:.3g}")


# ---------------------------------------------------------------------------
# 5c. the paper's rival and baselines: mamba2-370m (the SSD trunk), the task
#     heads, the sequential GRU / LSTM
# ---------------------------------------------------------------------------

def mamba2_phase():
    """mamba2-370m at full width (d 1024, 32 heads of 64, d_state 128, one
    group, conv 4, chunk 256, tied vocab 50,280; bf16, weights drawn on
    the card from a seed), cut from 48 SSD layers to MAMBA2_LAYERS for the
    script's time (its checks are host-bound, a layer at a time).  It
    runs no kernel of the repo (the reference runs the SSD outside
    Pallas): every count stays 0.
    Serving: 8 requests x 32 new tokens, K 4, C 1, streams equal
    ``generate_one``, a B-8 decode row equal to the B-1 row bit for bit,
    tok/s over 5 windows, a profiled window; then the prefill, one layer's
    SSD in both dual forms against the sequential one, and 3 training
    steps, on the same weights."""
    cfg = archs.get("mamba2-370m")
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    check(cfg.n_layers == 48 and cfg.d_model == 1024 and nh == 32
          and s.head_dim == 64 and s.d_state == 128 and s.n_groups == 1
          and s.chunk == 256 and cfg.cdtype == torch.bfloat16
          and cfg.vocab_size == 50280 and cfg.remat == "full",
          f"unexpected mamba2-370m config {cfg}")
    cfg = cfg.replace(n_layers=MAMBA2_LAYERS)
    print(f"mamba2-370m cut to {cfg.n_layers} of 48 layers (the script's "
          f"time)")
    check(lm.kernel_tier(cfg) == "unfused", "mamba2-370m not unfused")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=DEV).manual_seed(0), cfg,
                            device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(a.numel() for a in leaves(params))
    state_mb = cfg.n_layers * nh * s.head_dim * s.d_state * 4 / 1e6
    print(f"mamba2-370m: {n_params} parameters drawn on the card in "
          f"{t_init:.2f}s; SSM state {state_mb:.1f} MB a slot (fp32, "
          f"derived)")
    prompts = torch.randint(0, cfg.vocab_size, (8, 8), generator=torch.
                            Generator().manual_seed(1)).tolist()
    serve(cfg, params, 1, prompts, 4, label="warm-up")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_serve_launches()
    reset_train_launches()
    streams, info = serve(cfg, params, 1, prompts, 32)
    serve_peak = torch.cuda.max_memory_allocated()
    check(sum(serve_launches().values()) + sum(train_launches().values())
          == 0, f"mamba2-370m serving launched kernels {serve_launches()}")
    for p, s_ in zip(prompts, streams):
        check(len(s_) == 32 and all(0 <= t < cfg.vocab_size for t in s_),
              "malformed mamba2-370m stream")
        ref_s = tuple(generate_one(cfg, params, p, max_new=32, max_len=128,
                                   device=DEV))
        check(ref_s == s_, f"mamba2-370m stream for {p} != generate_one: "
              f"first divergence at token {first_divergence(ref_s, s_)}")
    toks = torch.randint(0, cfg.vocab_size, (8, 6), generator=torch.
                         Generator().manual_seed(7), dtype=torch.int32).to(DEV)
    c8, c1 = lm.init_cache(cfg, 8, 64, DEV), lm.init_cache(cfg, 1, 64, DEV)
    for t in range(toks.shape[1]):
        l8, c8 = lm.decode_step(params, cfg, toks[:, t], c8)
        l1, c1 = lm.decode_step(params, cfg, toks[3:4, t], c1)
        check(torch.equal(l8[3:4], l1), f"mamba2-370m: a B-8 decode row's "
              f"logits != the B-1 row's at step {t}")
    for k_ in ("conv", "ssm"):
        check(torch.equal(c8[k_][:, 3:4], c1[k_]),
              f"mamba2-370m: a B-8 decode row's {k_} != the B-1 row's")
    print(f"serve mamba2-370m: streams equal generate_one; a B-8 decode row "
          f"equals the B-1 row bit for bit (logits, conv and ssm state, 6 "
          f"steps); no kernel launch; peak device memory while serving "
          f"{serve_peak / 2**30:.2f} GiB ({info['rounds']} rounds)")
    rate_spread(cfg, params, chunks=(1,), prompts=prompts)
    prof = serve_profile(cfg, params, prompts, "mamba2-370m")
    if prof is not None:
        print(f"mamba2-370m profile: {prof['events']} device events in "
              f"{prof['rounds']} rounds: "
              f"{prof['events'] / (cfg.n_layers * prof['rounds']):.1f} a "
              f"layer a round")
    mamba2_prefill(cfg, params)
    ssd_forms_at_full_shape(cfg, params)
    launches = attn_train(cfg, params, plain_check=False)
    del params
    torch.cuda.empty_cache()
    return launches


def device_groups(fn, label):
    """``torch.profiler`` over one call of ``fn`` (after a warm one):
    device time by group (cuBLAS, elementwise / reductions / copies) and
    the device-busy share of the wall time (a lower bound: the profiler's
    own host cost inflates the wall)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    groups = {"cuBLAS": 0.0, "elementwise, reductions, copies": 0.0}
    for e in events:
        key = "cuBLAS" if any(k_ in e.key.lower() for k_ in (
            "gemm", "cutlass", "xmma", "nvjet", "cublas", "gemv")) \
            else "elementwise, reductions, copies"
        groups[key] += dev_us(e) / 1e3
    busy = sum(groups.values())
    print(f"{label} profile: wall {wall_ms:.2f} ms under the profiler, "
          f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%); "
          + ", ".join(f"{k_} {v:.2f} ms" for k_, v in groups.items())
          + f"; {sum(e.count for e in events)} device events; top:")
    for e in sorted(events, key=dev_us, reverse=True)[:6]:
        print(f"    {dev_us(e) / 1e3:8.3f} ms  {e.count:5d}  {e.key[:80]}")


def mamba2_prefill(cfg, params):
    """mamba2-370m, B 8 x T 1024, full and right-padded (PREFILL_LENS):
    the last logits against the sequential route (1024 ``decode_step``
    calls) and one step after each, within PREFILL_REL of the largest
    (the ssm state's difference printed: the same bf16 rounding drift
    the logits carry); the two routes in an fp32 compute dtype at T
    ROUTE_T, logits and state within PREFILL_REL[fp32] (they compute one
    function); each padded row against its own unpadded prefill; ms,
    prompt tokens/s, peak memory and a profile."""
    gen = torch.Generator().manual_seed(2)
    t = PREFILL_LENS[-1]
    full = torch.randint(1, cfg.vocab_size, (B, t), generator=gen,
                         dtype=torch.int32).to(DEV)
    toks, lens = padded_prompts(gen, PREFILL_LENS, cfg.vocab_size)
    tol = PREFILL_REL[torch.bfloat16]
    lm.prefill(params, cfg, full[:, :16], 2048)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logits, cache = lm.prefill(params, cfg, full, 2048)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    s = cfg.ssm
    check(tuple(cache["ssm"].shape) == (cfg.n_layers, B, s.n_heads(
        cfg.d_model), s.head_dim, s.d_state)
          and cache["ssm"].dtype == torch.float32
          and cache["conv"].dtype == torch.bfloat16
          and bool((cache["pos"] == t).all()), "mamba2-370m prefill cache")
    c_seq = lm.init_cache(cfg, B, 2048, DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(t):
        l_seq, c_seq = lm.decode_step(params, cfg, full[:, i], c_seq)
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    v = cfg.vocab_size          # the pad columns are -1e30 in every route
    e_l = rel_err(logits[:, :v], l_seq[:, :v], "mamba2-370m prefill vs the "
                  "step path", tol)
    e_s = float((cache["ssm"] - c_seq["ssm"]).abs().max()
                / c_seq["ssm"].abs().max())
    tok = l_seq[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    l_p1, _ = lm.decode_step(params, cfg, tok, cache)
    l_s1, _ = lm.decode_step(params, cfg, tok, c_seq)
    e_d = rel_err(l_p1[:, :v], l_s1[:, :v], "mamba2-370m decode after the "
                  "prefill vs after the step path", tol)
    lp, cp = lm.prefill(params, cfg, toks, 2048, lengths=lens)
    worst, worst_s = 0.0, 0.0
    for b, n in enumerate(PREFILL_LENS):
        l1, c1 = lm.prefill(params, cfg, toks[b:b + 1, :n], 2048)
        check(int(cp["pos"][b]) == n, f"mamba2-370m pos of row {b}")
        worst = max(worst, rel_err(lp[b, :v], l1[0, :v], f"mamba2-370m "
                                   f"padded row {b} logits", tol))
        check(bool(torch.isfinite(cp["ssm"][:, b]).all()),
              f"mamba2-370m padded row {b} ssm state")
        worst_s = max(worst_s, float((cp["ssm"][:, b] - c1["ssm"][:, 0])
                                     .abs().max() / c1["ssm"].abs().max()))
    ms = synced_ms(lambda: lm.prefill(params, cfg, full, 2048), reps=3)
    ms_pad = synced_ms(lambda: lm.prefill(params, cfg, toks, 2048,
                                          lengths=lens), reps=3)
    f32 = cfg.replace(compute_dtype="float32")
    l32, c32 = lm.prefill(params, f32, full[:, :ROUTE_T], 2048)
    c_s32 = lm.init_cache(f32, B, 2048, DEV)
    for i in range(ROUTE_T):
        l_s32, c_s32 = lm.decode_step(params, f32, full[:, i], c_s32)
    tol32 = PREFILL_REL[torch.float32]
    e_l32 = rel_err(l32[:, :v], l_s32[:, :v], "mamba2-370m fp32 prefill vs "
                    "the step path", tol32)
    e_s32 = rel_err(c32["ssm"], c_s32["ssm"], "mamba2-370m fp32 prefill ssm "
                    "state vs the step path's", tol32)
    print(f"prefill mamba2-370m B {B} x T {t}: logits vs the step path "
          f"relative error {e_l:.3g}, one decode_step after each {e_d:.3g} "
          f"(limit {tol}); the ssm state {e_s:.3g} (printed); in an fp32 "
          f"compute dtype at T {ROUTE_T} logits {e_l32:.3g}, ssm state "
          f"{e_s32:.3g} (limit {tol32}); padded rows (lengths {PREFILL_LENS}) vs "
          f"their own prefill, worst {worst:.3g} (limit {tol}), ssm state "
          f"{worst_s:.3g} (printed); peak device "
          f"memory of the prefill {peak / 2**30:.2f} GiB; ms min "
          f"{ms[0]:.2f} median {ms[1]:.2f} max {ms[-1]:.2f}, prompt "
          f"tokens/s median {B * t / ms[1] * 1e3:.0f}; padded median "
          f"{ms_pad[1]:.2f} ms; the sequential route (1024 decode_step "
          f"calls) {seq_ms:.1f} ms")
    device_groups(lambda: lm.prefill(params, cfg, full, 2048),
                  f"prefill mamba2-370m B {B} x T {t}")


def ssd_forms_at_full_shape(cfg, params):
    """One layer's SSD at the prefill's shape (B 8 x T 1024, 32 heads of
    64, d_state 128, one group, chunk 256), its inputs from layer 0's
    in-projection and conv on seeded embeddings (x, b, c bf16; dt fp32):
    the masked form (the model's) against ``ssd_sequential`` within
    PREFILL_REL of the largest |y| (and the final state); the compact form
    on the same inputs in fp32 against the sequential one in fp32 within
    SSD_FP32_REL; in bf16 the compact form's error is printed, not held
    (it rounds the cumulative log decay to bf16, as the reference's
    does); each form's ms and peak memory in bf16."""
    from repro_torch.models import ssd
    gen = torch.Generator().manual_seed(4)
    p0 = tree_map(lambda a: a[0], params["layers"]["blocks"])
    toks = torch.randint(0, cfg.vocab_size, (B, 1024), generator=gen,
                         dtype=torch.int32).to(DEV)
    with torch.no_grad():
        u = core_nn.rmsnorm_apply(p0["norm"], lm._embed(params, cfg, toks))
        ins = ssd.ssd_inputs(p0["mixer"], cfg, u)
        args = (ins["x"], ins["dt"], p0["mixer"]["a_log"], ins["b"],
                ins["c"], p0["mixer"]["d_skip"])
        seq = ssd.ssd_sequential(*args)
        args32 = tuple(a.float() for a in args)
        y32 = ssd.ssd_chunked(*args32, chunk=cfg.ssm.chunk, form="compact")
        seq32 = ssd.ssd_sequential(*args32)
        out, times, peaks = {}, {}, {}
        for form in ("masked", "compact"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out[form] = ssd.ssd_chunked(*args, chunk=cfg.ssm.chunk,
                                        return_state=True, form=form)
            torch.cuda.synchronize()
            peaks[form] = torch.cuda.max_memory_allocated() - base
            times[form] = synced_ms(lambda f=form: ssd.ssd_chunked(
                *args, chunk=cfg.ssm.chunk, form=f), reps=3)[1]
        state = torch.zeros_like(out["masked"][1])
        for i in range(args[0].shape[1]):
            _, state = ssd.ssd_step(args[0][:, i], args[1][:, i], args[2],
                                    args[3][:, i], args[4][:, i], args[5],
                                    state)
    tol = PREFILL_REL[torch.bfloat16]
    e_q = rel_err(out["masked"][0], seq, "SSD masked vs ssd_sequential at "
                  "the prefill shape", tol)
    e_st = rel_err(out["masked"][1], state, "SSD masked final state vs the "
                   "sequential roll-out", tol)
    e_32 = rel_err(y32, seq32, "SSD compact vs ssd_sequential at the prefill "
                   "shape in fp32", SSD_FP32_REL)
    d_c = out["compact"][0].float() - seq.float()
    e_c = float(d_c.abs().max() / seq.float().abs().max())
    print(f"SSD dual forms, one layer at B {B} x T 1024 (32 heads of 64, "
          f"d_state 128, chunk 256; x, b, c bf16, dt fp32): masked vs "
          f"sequential {e_q:.3g}, final state {e_st:.3g} (limit {tol}); "
          f"compact vs sequential in fp32 {e_32:.3g} (limit "
          f"{SSD_FP32_REL}); compact in bf16 vs sequential {e_c:.3g} (not "
          f"held: the bf16 cumulative log decay); "
          f"masked {times['masked']:.3f} ms, {peaks['masked'] / 2**30:.2f} "
          f"GiB above its inputs; compact {times['compact']:.3f} ms, "
          f"{peaks['compact'] / 2**30:.2f} GiB")


# the prompt length at which the two prefill routes of mamba2-370m are held
# in an fp32 compute dtype
ROUTE_T = 128
# the compact SSD form against the sequential one in fp32 at the prefill
# shape: the same sums in another order over up to 1024 steps
SSD_FP32_REL = 1e-3


# the task heads at the settings of the repo's own scripts: the classifier
# of benchmarks/table4_chomsky.py (d 64, 2 layers, expansion 2, conv on,
# MLP off; batch 64; AdamW lr 3e-4, warmup 20, weight decay 0.01) on
# majority (T 40) and on ListOps (T 128), and the Decision-Transformer
# model of benchmarks/table3_rl_proxy.py (d 64, 3 layers, MLP x2, no
# conv; 192 episodes of "medium", batch 64, lr 1e-3, warmup 20, weight
# decay 1e-4; T 3 x 64), each cell for minGRU and minLSTM: HEAD_STEPS
# steps on one repeated batch, fp32
HEAD_STEPS = 5


def head_cells():
    """(label, block config, init, loss, batch on the card, layers,
    AdamW config) for every head cell."""
    from repro_torch.core import blocks
    from repro_torch.data import rl_proxy, synthetic
    from repro_torch.models import heads
    out = []
    ocls = opt_lib.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=250,
                               weight_decay=0.01)
    odt = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=150,
                              weight_decay=1e-4)
    rl = rl_proxy.build_dataset("medium", n_episodes=192, seed=0)
    for cell in ("mingru", "minlstm"):
        bc = blocks.MinRNNBlockConfig(d_model=64, cell=cell, expansion=2.0,
                                      use_conv=True, use_mlp=False)
        for task in ("majority", "listops"):
            b = getattr(synthetic, task)(0, 0, 64)
            batch = {"tokens": torch.from_numpy(b["tokens"]).to(DEV),
                     "label": torch.from_numpy(b["label"]).to(DEV)}

            def init(gen, bc=bc, nc=b["n_classes"]):
                return heads.classifier_init(gen, vocab=16, n_classes=nc,
                                             d_model=64, n_layers=2,
                                             block_cfg=bc, device=DEV)

            def loss(p, bt, bc=bc):
                return heads.classifier_loss(p, bc, bt)
            out.append((f"classifier/{task}/{cell}", init, loss, batch, 2,
                        ocls))
        dbc = blocks.MinRNNBlockConfig(d_model=64, cell=cell, expansion=2.0,
                                       use_conv=False, use_mlp=True,
                                       mlp_factor=2.0)
        batch = {k: torch.from_numpy(v).to(DEV)
                 for k, v in rl_proxy.rl_batch(rl, 0, 0, 64).items()}

        def dinit(gen, bc=dbc):
            return heads.dt_init(gen, state_dim=rl_proxy.STATE_DIM,
                                 act_dim=rl_proxy.ACT_DIM, d_model=64,
                                 n_layers=3, block_cfg=bc, device=DEV)

        def dloss(p, bt, bc=dbc):
            return heads.dt_loss(p, bc, bt)
        out.append((f"dt/rl_proxy-medium/{cell}", dinit, dloss, batch, 3,
                    odt))
    return out


def head_train(loss, params, batch, ocfg, n):
    """``n`` AdamW steps on one batch from ``params`` (updated in place):
    losses (synchronised floats) and host ms a step."""
    state = opt_lib.init(ocfg, params)
    losses, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (lv, _), grads = ts_lib.value_and_grad(loss, params, batch)
        params, state, _ = opt_lib.apply(ocfg, state, params, grads)
        losses.append(float(lv))
        times.append((time.perf_counter() - t0) * 1e3)
    return losses, times


def head_kernel_checks():
    """The fused cells at the heads' shapes (B 64; T 40, 128, 192; Dx 64,
    Dh 128; fp32, zero h0) against their plain versions, forward and
    gradients, and the reversed linear scan their backward runs; kernel
    and plain ms.  Outside the count."""
    gen = torch.Generator().manual_seed(23)
    rows = []
    for cell, fn, plain in (
            ("mingru", lambda *a: gru_ops.fused_mingru(*a, mode="log"),
             lambda *a: gru_ref.fused_mingru_ref(*a, mode="log")),
            ("minlstm", lambda *a: lstm_ops.fused_minlstm(
                *a, mode="log", normalize=True),
             lambda *a: lstm_ref.fused_minlstm_ref(*a, mode="log",
                                                   normalize=True))):
        for t in (40, 128, 192):
            n = len(GATES[cell])
            ins = [torch.randn((64, t, 64), generator=gen)]
            for _ in range(n):
                ins += [torch.randn((64, 128), generator=gen) / 8.0,
                        0.1 * torch.randn((128,), generator=gen)]
            ins = [v.to(DEV).requires_grad_(True) for v in ins]
            out, want = fn(*ins), plain(*ins)
            e = max_err(out, want, torch.float32,
                        f"{cell} fused kernel at the heads' T {t}")
            ct = torch.randn(out.shape, generator=gen).to(DEV)
            for g, w in zip(torch.autograd.grad(out, ins, ct),
                            torch.autograd.grad(want, ins, ct)):
                rel_err(g, w, f"{cell} fused kernel's gradient at T {t}",
                        GRAD_TOL[torch.float32])
            det = [v.detach() for v in ins]
            with torch.no_grad():
                k_ms = eager_ms([lambda: fn(*det)], 20)
                p_ms = eager_ms([lambda: plain(*det)], 5)
            rows.append(f"{cell} T {t}: err {e:.3g}, {k_ms:.4f} ms "
                        f"(plain {p_ms:.4f})")
    print("fused cells at the heads' shapes (B 64, Dx 64, Dh 128, fp32, "
          "the CUDA-core body), forward and gradients against the plain "
          "versions: " + "; ".join(rows))


def heads_phase():
    """Every head cell trains HEAD_STEPS AdamW steps on one repeated batch
    on the card: the counted main path.  Launches against the formula
    (per step, one fused-cell launch a layer of the cell's kernel, the
    forward, and one reversed linear scan a layer, the backward; no remat,
    no log scan; every launch on the CUDA-core body, fp32), the loss
    finite and falling; outside the count, the same steps on the plain
    versions (losses within LOSS_RTOL_PLAIN) and the kernels at the heads'
    shapes."""
    cells = head_cells()
    inits = {}
    for label, init, _, _, _, _ in cells:
        inits[label] = init(torch.Generator(device=DEV).manual_seed(0))
    # first-use allocations off the count
    for label, _, loss, batch, _, ocfg in cells:
        head_train(loss, clone(inits[label]), batch, ocfg, 1)
    reset_train_launches()
    reset_serve_launches()
    results, want = {}, {k_: 0 for k_ in train_launches()}
    for label, _, loss, batch, layers, ocfg in cells:
        results[label] = head_train(loss, clone(inits[label]), batch, ocfg,
                                    HEAD_STEPS)
        cell = label.rsplit("/", 1)[1]
        want[f"fused_{cell}_kernel"] += layers * HEAD_STEPS
        want["linear_scan_kernel"] += layers * HEAD_STEPS
    launches = train_launches()
    check(launches == want, f"head training launches {launches} != {want}")
    bodies = body_launches()
    want_bodies = {f"{k_}/{b_}": (want[k_] if b_ == "cuda_core" else 0)
                   for k_ in ("fused_mingru_kernel", "fused_minlstm_kernel")
                   for b_ in ("tc", "cuda_core")}
    check(bodies == want_bodies, f"head launches by body {bodies} != "
          f"{want_bodies}")
    check(sum(serve_launches().values()) == 0, "head training launched "
          "decode kernels")
    for label, _, loss, batch, _, ocfg in cells:
        ls, times = results[label]
        check(all(math.isfinite(v) for v in ls), f"{label}: loss {ls}")
        check(ls[-1] < ls[0], f"{label}: loss did not fall: {ls}")
        with plain_kernels():
            before = train_launches()
            plain, p_times = head_train(loss, clone(inits[label]), batch,
                                        ocfg, HEAD_STEPS)
            check(train_launches() == before, "the plain run launched "
                  "kernels")
        d = [abs(a - b_) / abs(b_) for a, b_ in zip(ls, plain)]
        check(max(d) <= LOSS_RTOL_PLAIN, f"{label}: kernel vs plain losses "
              f"{ls} vs {plain} (relative {d})")
        print(f"train head {label} (fp32, B 64, {HEAD_STEPS} steps on one "
              f"batch): losses " + " ".join(f"{v:.5f}" for v in ls)
              + f"; vs the plain versions' run, relative at most "
              f"{max(d):.3g} (limit {LOSS_RTOL_PLAIN}); ms a step median "
              f"{sorted(times)[len(times) // 2]:.2f} (plain "
              f"{sorted(p_times)[len(p_times) // 2]:.2f})")
    print(f"train heads: launches {launches} == {want}; by body {bodies}")
    head_kernel_checks()
    return launches


def rnn_baselines_phase():
    """The sequential GRU / LSTM (``core/gru.py``, ``core/lstm.py``; PyTorch
    ops, no kernel of the repo): forward and BPTT gradients of a mean
    square on the card against the CPU run (fp32, D 64, B 16, T 64: TOL
    and GRAD_TOL); then Fig. 1's line, not gated: fwd + bwd ms at D 64,
    B 16, T 1024 and 4096, GRU / LSTM by BPTT against minGRU / minLSTM in
    parallel (the fused kernels, log mode, fp32; min of 5 calls; GRU /
    LSTM one call each, about a second)."""
    from repro_torch.core import gru, lstm, min_gru, min_lstm
    gen = torch.Generator().manual_seed(31)

    def fwd_bwd(fn, p, x):
        p = tree_map(lambda a: a.detach().clone().requires_grad_(True), p)
        x = x.detach().clone().requires_grad_(True)
        h = fn(p, x)
        return h, torch.autograd.grad(torch.mean(h ** 2), leaves(p) + [x])

    errs = []
    for name, mod in (("GRU", gru), ("LSTM", lstm)):
        p = mod.init(gen, 64, 64)
        x = torch.randn((16, 64, 64), generator=gen)
        h_c, g_c = fwd_bwd(mod.forward, p, x)
        h_d, g_d = fwd_bwd(mod.forward, tree_map(lambda a: a.to(DEV), p),
                           x.to(DEV))
        e = max_err(h_d, h_c.to(DEV), torch.float32, f"{name} on the card "
                    f"vs the CPU")
        e_g = max(rel_err(gd, gc.to(DEV), f"{name} BPTT gradient on the card "
                          f"vs the CPU", GRAD_TOL[torch.float32])
                  for gd, gc in zip(g_d, g_c))
        errs.append(f"{name} h {e:.3g}, gradients {e_g:.3g}")
    print(f"GRU / LSTM (fp32, D 64, B 16, T 64) on the card vs the CPU run: "
          + "; ".join(errs) + f" (limits {TOL[torch.float32]}, "
          f"{GRAD_TOL[torch.float32]})")
    models = {"GRU": (gru, gru.forward), "LSTM": (lstm, lstm.forward),
              "minGRU": (min_gru, lambda p, x: min_gru.parallel(
                  p, x, mode="log", scan_strategy="auto")),
              "minLSTM": (min_lstm, lambda p, x: min_lstm.parallel(
                  p, x, mode="log", scan_strategy="auto"))}
    for t in (1024, 4096):
        x = torch.randn((16, t, 64), generator=gen).to(DEV)
        ms = {}
        for name, (mod, fn) in models.items():
            p = tree_map(lambda a: a.to(DEV), mod.init(gen, 64, 64))
            if name in ("GRU", "LSTM"):     # warm from the check above
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fwd_bwd(fn, p, x)
                torch.cuda.synchronize()
                ms[name] = (time.perf_counter() - t0) * 1e3
            else:
                ms[name] = synced_ms(lambda: fwd_bwd(fn, p, x), reps=5)[0]
        print(f"fig1 (fwd + bwd of mean(h^2), fp32, D 64, B 16, T {t}; not "
              f"gated): " + ", ".join(f"{k_} {v:.3f} ms"
                                       for k_, v in ms.items())
              + f"; GRU / minGRU {ms['GRU'] / ms['minGRU']:.1f}x, LSTM / "
              f"minLSTM {ms['LSTM'] / ms['minLSTM']:.1f}x")


# ---------------------------------------------------------------------------
# 5d. the hybrid and mixture-of-experts trunks: zamba2-2.7b, deepseek-moe-16b
# ---------------------------------------------------------------------------

# the prompt lengths at which the prefill is held against the sequential
# route (that many ``decode_step`` calls of 8 rows, ~0.1 s each at these
# widths): the hybrid's and the MoE trunk's in bf16, and both in an fp32
# compute dtype
HYBRID_ROUTE_T = 256
MOE_ROUTE_T = 64
FP32_ROUTE_T = 32
# depths of the earlier big models in this script, cut at full width so
# the whole run stays inside its time (their checks are host-bound, a
# layer at a time): mamba2-370m 48 -> 12 layers, zamba2-2.7b 54 -> 12
# (2 groups), deepseek-moe-16b's serving and prefill 28 -> 6 (1 dense +
# 5 MoE)
MAMBA2_LAYERS = 12
ZAMBA2_LAYERS = 12
DEEPSEEK_MOE_LAYERS = 6
# deepseek-moe-16b's capacity factor for the checks that need no drops:
# the reference's smoke configs' (at 8 tokens 12 rows an expert, at 1 one)
NO_DROP_CF = 16.0


def fresh_card():
    """Free what earlier phases left and restart the peak counter; the
    objects that survive are moved out of the collector's sight (the big
    models' host-bound decode steps allocate many short-lived objects,
    and each full collection would walk what earlier phases left)."""
    import gc
    gc.collect()
    gc.freeze()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def draw_params(cfg, label):
    """Seeded weights drawn on the card; prints the count, the draw's
    seconds and its peak memory."""
    fresh_card()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=DEV).manual_seed(0), cfg,
                            device=DEV)
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in leaves(params))
    n_bytes = sum(a.numel() * a.element_size() for a in leaves(params))
    print(f"{label}: {n_params} parameters ({n_bytes / 1e9:.2f} GB in "
          f"{cfg.param_dtype}) drawn on the card in "
          f"{time.perf_counter() - t0:.2f}s; "
          f"peak device memory during the init "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return params


def row_alone(cfg, params, label):
    """A row decoded in a batch of 8 against the row decoded alone, 6
    steps: the logits and every cache leaf, bit for bit."""
    toks = torch.randint(0, cfg.vocab_size, (8, 6), generator=torch.
                         Generator().manual_seed(7), dtype=torch.int32).to(DEV)
    c8, c1 = lm.init_cache(cfg, 8, 64, DEV), lm.init_cache(cfg, 1, 64, DEV)
    for t in range(toks.shape[1]):
        l8, c8 = lm.decode_step(params, cfg, toks[:, t], c8)
        l1, c1 = lm.decode_step(params, cfg, toks[3:4, t], c1)
        check(torch.equal(l8[3:4], l1), f"{label}: a B-8 decode row's "
              f"logits != the B-1 row's at step {t}")
    keys = sorted(k for k in c8 if k != "pos")
    for k in keys:
        check(torch.equal(c8[k][:, 3:4], c1[k]),
              f"{label}: a B-8 decode row's {k} != the B-1 row's")
    return keys


def served_against_generate_one(cfg, params, prompts, label):
    """A warm-up, then the counted serving run of ``prompts`` (8 slots, 32
    new tokens, K 4, C 1, a KV cache of GEMMA_MAX_LEN): no kernel of the
    repo launched, the streams equal to ``generate_one``'s, a B-8 decode
    row equal to the B-1 row.  Prints the line; returns the serving
    info."""
    serve(cfg, params, 1, prompts, 4, label="warm-up",
          max_len=GEMMA_MAX_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_serve_launches()
    reset_train_launches()
    streams, info = serve(cfg, params, 1, prompts, 32, max_len=GEMMA_MAX_LEN,
                          label=f"serve [{label}]")
    peak = torch.cuda.max_memory_allocated()
    check(sum(serve_launches().values()) + sum(train_launches().values())
          == 0, f"{label} serving launched kernels {serve_launches()}")
    for p, s_ in zip(prompts, streams):
        check(len(s_) == 32 and all(0 <= t < cfg.vocab_size for t in s_),
              f"malformed {label} stream")
        ref_s = tuple(generate_one(cfg, params, p, max_new=32,
                                   max_len=GEMMA_MAX_LEN, device=DEV))
        check(ref_s == s_, f"{label} stream for {p} != generate_one: first "
              f"divergence at token {first_divergence(ref_s, s_)}")
    keys = row_alone(cfg, params, label)
    print(f"serve {label}: streams equal generate_one; a B-8 decode row "
          f"equals the B-1 row bit for bit (logits, {', '.join(keys)}; 6 "
          f"steps); no kernel launch; KV cache {GEMMA_MAX_LEN} positions; "
          f"peak device memory while serving {peak / 2**30:.2f} GiB "
          f"({info['rounds']} rounds)")
    return dict(info, streams=streams)


def route_check(cfg, params, toks, max_len, label, tol):
    """``lm.prefill`` of ``toks`` against ``toks.shape[1]`` sequential
    ``decode_step`` calls: the last logits and one step after each, within
    ``tol`` of the largest |logit|.  Returns the two errors and the
    sequential route's ms."""
    v = cfg.vocab_size
    logits, cache = lm.prefill(params, cfg, toks, max_len)
    c_seq = lm.init_cache(cfg, toks.shape[0], max_len, DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(toks.shape[1]):
        l_seq, c_seq = lm.decode_step(params, cfg, toks[:, i], c_seq)
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    e_l = rel_err(logits[:, :v], l_seq[:, :v], f"{label} prefill vs the "
                  f"step path", tol)
    tok = l_seq[:, :v].argmax(-1).to(torch.int32)
    l_p1, _ = lm.decode_step(params, cfg, tok, cache)
    l_s1, _ = lm.decode_step(params, cfg, tok, c_seq)
    e_d = rel_err(l_p1[:, :v], l_s1[:, :v], f"{label} decode after the "
                  f"prefill vs after the step path", tol)
    return e_l, e_d, seq_ms


def profile_events(cfg, params, prompts, label):
    prof = serve_profile(cfg, params, prompts, label, max_len=GEMMA_MAX_LEN)
    if prof is not None:
        print(f"{label} profile: {prof['events']} device events in "
              f"{prof['rounds']} rounds: "
              f"{prof['events'] / (cfg.n_layers * prof['rounds']):.1f} a "
              f"layer a round ({cfg.n_layers} layers)")


def zamba2_phase():
    """zamba2-2.7b at full width (d 2560, 80 heads of 64, d_state 64, chunk
    256; one shared attention block, MHA 32 heads of 80 and a GeGLU MLP of
    10240, after every 6 SSD layers; untied vocab 32,000; bf16, weights
    drawn on the card), cut from 54 SSD layers to ZAMBA2_LAYERS (2
    groups) for the script's time.  It runs no kernel of the
    repo: every count stays 0.  Serving: 8 requests x 32 new tokens, K 4,
    C 1, a KV cache of 1024 (streams equal ``generate_one``, a B-8 decode
    row equal to the B-1 row, tok/s over 5 windows, a profile); then the
    prefill and 3 training steps on the same weights."""
    cfg = archs.get("zamba2-2.7b")
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    check(cfg.n_layers == 54 and cfg.hybrid_attn_every == 6
          and cfg.d_model == 2560 and nh == 80 and s.head_dim == 64
          and s.d_state == 64 and cfg.n_heads == 32 and cfg.head_dim_ == 80
          and cfg.d_ff == 10240 and cfg.vocab_size == 32000
          and cfg.cdtype == torch.bfloat16 and cfg.remat == "full",
          f"unexpected zamba2-2.7b config {cfg}")
    cfg = cfg.replace(n_layers=ZAMBA2_LAYERS)
    print(f"zamba2-2.7b cut to {cfg.n_layers} of 54 layers, "
          f"{cfg.n_layers // cfg.hybrid_attn_every} groups (the script's "
          f"time)")
    check(lm.kernel_tier(cfg) == "unfused", "zamba2-2.7b not unfused")
    params = draw_params(cfg, "zamba2-2.7b")
    n_groups = cfg.n_layers // cfg.hybrid_attn_every
    state_mb = cfg.n_layers * nh * s.head_dim * s.d_state * 4 / 1e6
    kv_mb = n_groups * GEMMA_MAX_LEN * cfg.n_kv_heads * cfg.head_dim_ * 4 \
        / 1e6
    print(f"zamba2-2.7b: SSM state {state_mb:.1f} MB (fp32) and KV cache "
          f"{kv_mb:.1f} MB (bf16, {n_groups} applications x "
          f"{GEMMA_MAX_LEN} positions) a slot (derived)")
    prompts = torch.randint(0, cfg.vocab_size, (8, 8), generator=torch.
                            Generator().manual_seed(1)).tolist()
    served_against_generate_one(cfg, params, prompts, "zamba2-2.7b")
    rate_spread(cfg, params, chunks=(1,), prompts=prompts,
                max_len=GEMMA_MAX_LEN)
    profile_events(cfg, params, prompts, "zamba2-2.7b")
    zamba2_prefill(cfg, params)
    launches = attn_train(cfg, params, plain_check=False)
    del params
    fresh_card()
    return launches


def zamba2_prefill(cfg, params):
    """zamba2-2.7b, B 8 x T 1024, full and right-padded (PREFILL_LENS),
    into a cache of 2048: ms, prompt tokens/s, peak memory, a profile;
    each padded row against its own prefill; the prefill against the
    sequential route at T HYBRID_ROUTE_T (bf16) and FP32_ROUTE_T (an fp32
    compute dtype), within PREFILL_REL of the largest |logit|."""
    gen = torch.Generator().manual_seed(2)
    t, max_len = PREFILL_LENS[-1], 2048
    full = torch.randint(1, cfg.vocab_size, (B, t), generator=gen,
                         dtype=torch.int32).to(DEV)
    toks, lens = padded_prompts(gen, PREFILL_LENS, cfg.vocab_size)
    tol, v = PREFILL_REL[torch.bfloat16], cfg.vocab_size
    lm.prefill(params, cfg, full[:, :16], max_len)
    fresh_card()
    logits, cache = lm.prefill(params, cfg, full, max_len)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    s = cfg.ssm
    n_groups = cfg.n_layers // cfg.hybrid_attn_every
    check(tuple(cache["ssm"].shape) == (cfg.n_layers, B, s.n_heads(
        cfg.d_model), s.head_dim, s.d_state)
          and cache["ssm"].dtype == torch.float32
          and tuple(cache["k"].shape) == (n_groups, B, max_len,
                                          cfg.n_kv_heads, cfg.head_dim_)
          and bool((cache["pos"] == t).all())
          and bool(torch.isfinite(logits[:, :v]).all()),
          "zamba2-2.7b prefill cache")
    del logits, cache
    ms = synced_ms(lambda: lm.prefill(params, cfg, full, max_len), reps=3)
    ms_pad = synced_ms(lambda: lm.prefill(params, cfg, toks, max_len,
                                          lengths=lens), reps=3)
    lp, cp = lm.prefill(params, cfg, toks, max_len, lengths=lens)
    worst = 0.0
    for b, n in enumerate(PREFILL_LENS):
        l1, _ = lm.prefill(params, cfg, toks[b:b + 1, :n], max_len)
        check(int(cp["pos"][b]) == n, f"zamba2-2.7b pos of row {b}")
        worst = max(worst, rel_err(lp[b, :v], l1[0, :v], f"zamba2-2.7b "
                                   f"padded row {b} logits", tol))
    del lp, cp
    e_l, e_d, seq_ms = route_check(cfg, params, full[:, :HYBRID_ROUTE_T],
                                   max_len, "zamba2-2.7b", tol)
    f32 = cfg.replace(compute_dtype="float32")
    tol32 = PREFILL_REL[torch.float32]
    e_l32, e_d32, _ = route_check(f32, params, full[:, :FP32_ROUTE_T],
                                  max_len, "zamba2-2.7b fp32", tol32)
    print(f"prefill zamba2-2.7b B {B} x T {t}: peak device memory "
          f"{peak / 2**30:.2f} GiB; ms min {ms[0]:.2f} median {ms[1]:.2f} "
          f"max {ms[-1]:.2f}, prompt tokens/s median "
          f"{B * t / ms[1] * 1e3:.0f}; padded median {ms_pad[1]:.2f} ms; "
          f"padded rows (lengths {PREFILL_LENS}) vs their own prefill, "
          f"worst {worst:.3g}; against the step path at T "
          f"{HYBRID_ROUTE_T}: logits {e_l:.3g}, one decode_step after "
          f"{e_d:.3g} (limit {tol}; the {HYBRID_ROUTE_T} steps "
          f"{seq_ms:.1f} ms); in an fp32 compute dtype at T {FP32_ROUTE_T}: "
          f"{e_l32:.3g}, {e_d32:.3g} (limit {tol32})")
    device_groups(lambda: lm.prefill(params, cfg, full, max_len),
                  f"prefill zamba2-2.7b B {B} x T {t}")


def moe_route_check(cfg, params, toks):
    """``lm.prefill`` of ``toks`` against ``toks.shape[1]`` sequential
    ``decode_step`` calls of the MoE trunk, the steps held to the
    prefill's top-k choices (``moe.forced_routing``): in bf16 a rounding
    apart flips near-tied choices, and a flipped token's expert mix
    changes the rest of the route.  Returns ((prefill, steps) last
    logits, how many of the steps' own top-k choices differ from the
    prefill's, all choices, the steps' ms)."""
    v = cfg.vocab_size
    bsz, t = toks.shape
    with moe_lib.routing_log() as pre:
        logits, _ = lm.prefill(params, cfg, toks, GEMMA_MAX_LEN)
    n_moe = len(pre)
    pre = torch.stack([r.reshape(bsz, t, -1) for r in pre])  # (L, B, T, k)
    cache = lm.init_cache(cfg, bsz, GEMMA_MAX_LEN, DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with moe_lib.routing_log() as own, moe_lib.forced_routing(
            lambda i: pre[i % n_moe, :, i // n_moe]):
        for i in range(t):
            l_seq, cache = lm.decode_step(params, cfg, toks[:, i], cache)
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    own = torch.stack(own).reshape(t, n_moe, bsz, -1).permute(1, 2, 0, 3)
    apart = int((pre.sort(-1).values != own.sort(-1).values).any(-1).sum())
    return (logits[:, :v], l_seq[:, :v]), apart, pre[..., 0].numel(), seq_ms


def dropped_share(drops):
    """(dropped, assigned, share) over ``moe.count_drops``' records."""
    if not drops:
        return 0, 0, 0.0
    dropped = int(torch.stack([d for d, _ in drops]).sum())
    assigned = sum(n for _, n in drops)
    return dropped, assigned, dropped / assigned


def deepseek_phase():
    """deepseek-moe-16b at full width (1 dense layer of d_ff 10944, 27 MoE
    layers of 64 experts of 1408, top-6, 2 shared experts of 2816, MHA 16
    heads of 128, untied vocab 102,400; bf16, drawn on the card), its
    serving and prefill cut to DEEPSEEK_MOE_LAYERS (1 dense + 5 MoE) for
    the script's time.  It runs no kernel of the repo: every count stays
    0.  Serving: at capacity factor NO_DROP_CF streams equal ``generate_one``
    and a B-8 decode row the B-1 row; at the published 1.25 the dropped
    share, tok/s over 5 windows, a profile and one sampled superstep.
    Prefill B 8 x T 512 at 1.25 and the route check at NO_DROP_CF.  Then
    training cut to 4 layers (1 dense + 3 MoE; 16.38 B parameters take
    ~196 GB with AdamW's fp32 moments), 3 steps."""
    cfg = archs.get("deepseek-moe-16b")
    m = cfg.moe
    check(cfg.n_layers == 28 and m.first_dense_layers == 1
          and cfg.d_model == 2048 and cfg.d_ff == 10944
          and m.n_experts == 64 and m.top_k == 6 and m.d_expert == 1408
          and m.n_shared == 2 and m.d_shared == 2816
          and m.capacity_factor == 1.25 and cfg.n_heads == 16
          and cfg.head_dim_ == 128 and cfg.vocab_size == 102400
          and cfg.cdtype == torch.bfloat16,
          f"unexpected deepseek-moe-16b config {cfg}")
    cfg = cfg.replace(n_layers=DEEPSEEK_MOE_LAYERS)
    print(f"deepseek-moe-16b serving and prefill cut to {cfg.n_layers} of 28 "
          f"layers (the script's time)")
    check(lm.kernel_tier(cfg) == "unfused", "deepseek-moe-16b not unfused")
    cfg16 = cfg.replace(moe=dataclasses.replace(m, capacity_factor=NO_DROP_CF))
    params = draw_params(cfg, "deepseek-moe-16b")
    prompts = torch.randint(0, cfg.vocab_size, (8, 8), generator=torch.
                            Generator().manual_seed(1)).tolist()
    at16 = served_against_generate_one(cfg16, params, prompts,
                                       f"deepseek-moe-16b cf {NO_DROP_CF}")
    torch.cuda.reset_peak_memory_stats()
    with moe_lib.count_drops() as drops:
        streams, info = serve(cfg, params, 1, prompts, 32,
                              max_len=GEMMA_MAX_LEN,
                              label="serve [deepseek-moe-16b cf 1.25]")
    peak = torch.cuda.max_memory_allocated()
    dropped, assigned, share = dropped_share(drops)
    n_moe = cfg.n_layers - m.first_dense_layers
    same = sum(a == b for a, b in zip(streams, at16["streams"]))
    print(f"serve deepseek-moe-16b at cf 1.25: {dropped} of {assigned} "
          f"top-6 assignments dropped ({100 * share:.1f}%; "
          f"{dropped / (info['rounds'] * n_moe):.2f} of "
          f"{assigned / (info['rounds'] * n_moe):.0f} a layer a round, "
          f"{info['rounds']} rounds); {same} of 8 streams as at cf "
          f"{NO_DROP_CF}; peak device memory while serving "
          f"{peak / 2**30:.2f} GiB")
    rate_spread(cfg, params, chunks=(1,), prompts=prompts,
                max_len=GEMMA_MAX_LEN)
    profile_events(cfg, params, prompts, "deepseek-moe-16b")
    t0 = time.perf_counter()
    s_streams, s_info = serve(cfg, params, 1, [p[:2] for p in prompts], 2,
                              quiet=True, max_len=GEMMA_MAX_LEN,
                              temperature=0.8, top_k=40, top_p=0.95)
    t_window = time.perf_counter() - t0
    for s_ in s_streams:
        check(len(s_) == 2 and all(0 <= t < cfg.vocab_size for t in s_),
              "malformed sampled deepseek-moe-16b stream")
    print(f"sampled deepseek-moe-16b, one window of 8 requests x 2 tokens "
          f"(K 4, T 0.8, top-k 40, top-p 0.95): {t_window:.2f}s, "
          f"{s_info['rounds']} rounds")
    deepseek_prefill(cfg, cfg16, params)
    del params
    tcfg = cfg.replace(n_layers=4)
    tparams = draw_params(tcfg, "deepseek-moe-16b cut to 4 layers (1 dense "
                          "+ 3 MoE) for training")
    launches = attn_train(tcfg, tparams, plain_check=False)
    del tparams
    fresh_card()
    return launches


def deepseek_prefill(cfg, cfg16, params):
    """deepseek-moe-16b, B 8 x T 512 at the published capacity into a KV
    cache of 1024: ms, prompt tokens/s, the dropped share, peak memory, a
    profile; the prefill against the sequential route held to its
    routing at capacity factor NO_DROP_CF (no drops on either route) at
    T MOE_ROUTE_T (bf16) and FP32_ROUTE_T (an fp32 compute dtype, where
    no choice may differ), within PREFILL_REL of the largest |logit|."""
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (AB, AT), generator=gen,
                         dtype=torch.int32).to(DEV)
    lm.prefill(params, cfg, toks[:, :16], GEMMA_MAX_LEN)
    fresh_card()
    with moe_lib.count_drops() as drops:
        logits, cache = lm.prefill(params, cfg, toks, GEMMA_MAX_LEN)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    dropped, assigned, share = dropped_share(drops)
    check(tuple(cache["k"].shape) == (cfg.n_layers, AB, GEMMA_MAX_LEN,
                                      cfg.n_kv_heads, cfg.head_dim_)
          and bool((cache["pos"] == AT).all()), "deepseek-moe-16b prefill "
          "cache")
    check(bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          "deepseek-moe-16b prefill logits")
    del logits, cache
    ms = synced_ms(lambda: lm.prefill(params, cfg, toks, GEMMA_MAX_LEN),
                   reps=3)
    tol, tol32 = PREFILL_REL[torch.bfloat16], PREFILL_REL[torch.float32]
    held, apart, n_dec, seq_ms = moe_route_check(cfg16, params,
                                                 toks[:, :MOE_ROUTE_T])
    held = rel_err(*held, "deepseek-moe-16b prefill vs the step path on "
                   "the prefill's routing", tol)
    f32 = cfg16.replace(compute_dtype="float32")
    held32, apart32, n_dec32, _ = moe_route_check(f32, params,
                                                  toks[:, :FP32_ROUTE_T])
    check(apart32 == 0, f"deepseek-moe-16b fp32: {apart32} top-6 choices "
          f"of the steps differ from the prefill's")
    held32 = rel_err(*held32, "deepseek-moe-16b fp32 prefill vs the step "
                     "path", tol32)
    print(f"prefill deepseek-moe-16b B {AB} x T {AT} at cf 1.25 (KV cache "
          f"{GEMMA_MAX_LEN}): {dropped} of {assigned} assignments dropped "
          f"({100 * share:.1f}%); peak device memory {peak / 2**30:.2f} "
          f"GiB; ms min {ms[0]:.2f} median {ms[1]:.2f} max {ms[-1]:.2f}, "
          f"prompt tokens/s median {AB * AT / ms[1] * 1e3:.0f}; at cf "
          f"{NO_DROP_CF} against {MOE_ROUTE_T} sequential steps held to the "
          f"prefill's routing (bf16): logits {held:.3g} (limit {tol}), "
          f"{apart} of {n_dec} top-6 choices of the steps' own apart from "
          f"the prefill's (printed; the steps {seq_ms:.1f} ms); in an fp32 "
          f"compute dtype at T {FP32_ROUTE_T}: {held32:.3g} (limit "
          f"{tol32}), {apart32} of {n_dec32} choices apart (limit 0)")
    device_groups(lambda: lm.prefill(params, cfg, toks, GEMMA_MAX_LEN),
                  f"prefill deepseek-moe-16b B {AB} x T {AT}")


# ---------------------------------------------------------------------------
# 5e. the rest of the dense zoo: starcoder2-15b, pixtral-12b, deepseek-67b,
# whisper-base
# ---------------------------------------------------------------------------

# depths at full width, for the script's time: starcoder2-15b at 16 of
# 40 layers, pixtral-12b at 10 of 40 (4.07 B, 8.15 GB) and deepseek-67b
# at 8 of 95 (whole it is 134.85 GB of bf16, more than the card); every
# zoo model trains cut to 4 layers (AdamW's fp32 moments: ~12 bytes a
# parameter on top of the weights)
STARCODER2_LAYERS = 16
PIXTRAL_LAYERS = 10
DEEPSEEK67_LAYERS = 8
ZOO_TRAIN_LAYERS = 4
ZOO_RATE_WINDOWS = 3
# the sequential routes the prefills are held against: starcoder2-15b
# and deepseek-67b 128 steps, pixtral-12b a prefill of the patches and
# the first PIXTRAL_SPLIT tokens, then the other AT - PIXTRAL_SPLIT as
# steps
STARCODER_ROUTE_T = 128
DEEPSEEK67_ROUTE_T = 128
PIXTRAL_SPLIT = 384
# whisper-base: greedy decode steps after the prefill, and the training
# batch's decoder tokens (whisper's 448-token context)
WHISPER_STEPS = 64
WHISPER_TRAIN_T = 448


def zoo_kernel_counts_zero(label):
    check(sum(serve_launches().values()) + sum(train_launches().values())
          == 0, f"{label} launched kernels of the repo: serving "
          f"{serve_launches()}, training {train_launches()}")


def zoo_serving(cfg, params, label):
    """8 prompts of 8 seeded ids, 32 new tokens, K 4, C 1, a KV cache of
    GEMMA_MAX_LEN: streams equal ``generate_one``, a B-8 decode row the
    B-1 row, tok/s over ZOO_RATE_WINDOWS windows, peak memory, and one
    profiled window (device-busy share, device events a layer a
    round)."""
    prompts = torch.randint(0, cfg.vocab_size, (8, 8), generator=torch.
                            Generator().manual_seed(1)).tolist()
    served_against_generate_one(cfg, params, prompts, label)
    rate_spread(cfg, params, reps=ZOO_RATE_WINDOWS, chunks=(1,),
                prompts=prompts, max_len=GEMMA_MAX_LEN)
    profile_events(cfg, params, prompts, label)


def zoo_prefill(cfg, params, label, route_t):
    """B 8 x T 512 into a KV cache of GEMMA_MAX_LEN: ms, prompt tokens/s,
    peak memory, a profile; a prefill of the first ``route_t`` tokens and
    one ``decode_step`` after it against ``route_t`` sequential steps
    (bf16, PREFILL_REL), and of the first FP32_ROUTE_T in an fp32
    compute dtype."""
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (AB, AT), generator=gen,
                         dtype=torch.int32).to(DEV)
    lm.prefill(params, cfg, toks[:, :16], GEMMA_MAX_LEN)
    fresh_card()
    logits, cache = lm.prefill(params, cfg, toks, GEMMA_MAX_LEN)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(tuple(cache["k"].shape) == (cfg.n_layers, AB, GEMMA_MAX_LEN,
                                      cfg.n_kv_heads, cfg.head_dim_)
          and bool((cache["pos"] == AT).all())
          and bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          f"{label} prefill cache and logits")
    del logits, cache
    ms = synced_ms(lambda: lm.prefill(params, cfg, toks, GEMMA_MAX_LEN),
                   reps=3)
    tol, tol32 = PREFILL_REL[torch.bfloat16], PREFILL_REL[torch.float32]
    e_l, e_d, seq_ms = route_check(cfg, params, toks[:, :route_t],
                                   GEMMA_MAX_LEN, label, tol)
    f32 = cfg.replace(compute_dtype="float32")
    e_l32, e_d32, _ = route_check(f32, params, toks[:, :FP32_ROUTE_T],
                                  GEMMA_MAX_LEN, f"{label} fp32", tol32)
    print(f"prefill {label} B {AB} x T {AT} (KV cache {GEMMA_MAX_LEN}): "
          f"peak device memory {peak / 2**30:.2f} GiB; ms min {ms[0]:.2f} "
          f"median {ms[1]:.2f} max {ms[-1]:.2f}, prompt tokens/s median "
          f"{AB * AT / ms[1] * 1e3:.0f}; against the step path at T "
          f"{route_t}: logits {e_l:.3g}, one decode_step after {e_d:.3g} "
          f"(limit {tol}; the {route_t} steps {seq_ms:.1f} ms); in an fp32 "
          f"compute dtype at T {FP32_ROUTE_T}: {e_l32:.3g}, {e_d32:.3g} "
          f"(limit {tol32})")
    device_groups(lambda: lm.prefill(params, cfg, toks, GEMMA_MAX_LEN),
                  f"prefill {label} B {AB} x T {AT}")


def zoo_train(cfg, label, extra=None):
    """``cfg`` cut to ZOO_TRAIN_LAYERS, drawn on the card: 3 AdamW steps
    at B 8 x T 512 (``attn_train``; ``extra``: a patch prefix)."""
    tcfg = cfg.replace(n_layers=ZOO_TRAIN_LAYERS)
    tparams = draw_params(tcfg, f"{label} cut to {ZOO_TRAIN_LAYERS} layers "
                          f"for training")
    launches = attn_train(tcfg, tparams, plain_check=False, extra=extra)
    del tparams
    fresh_card()
    return launches


def starcoder2_phase():
    """starcoder2-15b at full width (d 6144, GQA 48 heads on 4 KV heads
    of 128, RoPE theta 1e5, LayerNorm, biased attention and a plain GELU
    MLP of 24576, untied vocab 49,152; bf16, drawn on the card), cut to
    STARCODER2_LAYERS of its 40 layers.  No kernel of the repo: every
    count stays 0.  Serving (``zoo_serving``), the prefill
    (``zoo_prefill``, the route at STARCODER_ROUTE_T steps), then 3
    training steps at ZOO_TRAIN_LAYERS layers (2.14 B)."""
    cfg = archs.get("starcoder2-15b")
    check(cfg.n_layers == 40 and cfg.d_model == 6144 and cfg.n_heads == 48
          and cfg.n_kv_heads == 4 and cfg.head_dim_ == 128
          and cfg.d_ff == 24576 and cfg.vocab_size == 49152
          and cfg.norm == "layernorm" and cfg.attn_bias and cfg.mlp_bias
          and not cfg.gated_mlp and not cfg.tie_embeddings
          and cfg.rope_theta == 1e5 and cfg.cdtype == torch.bfloat16,
          f"unexpected starcoder2-15b config {cfg}")
    cfg = cfg.replace(n_layers=STARCODER2_LAYERS)
    check(lm.kernel_tier(cfg) == "unfused", "starcoder2-15b not unfused")
    reset_serve_launches()
    reset_train_launches()
    params = draw_params(cfg, f"starcoder2-15b cut to {cfg.n_layers} of 40 "
                         f"layers")
    zoo_serving(cfg, params, "starcoder2-15b")
    zoo_prefill(cfg, params, "starcoder2-15b", STARCODER_ROUTE_T)
    zoo_kernel_counts_zero("starcoder2-15b")
    del params
    fresh_card()
    launches = zoo_train(cfg, "starcoder2-15b")
    zoo_kernel_counts_zero("starcoder2-15b")
    return launches


def pixtral_prefill(cfg, params, patches):
    """B 8 x (the patch prefix + T 512) into a cache of 2048: ms, prompt
    tokens/s, peak memory, a profile; its last logits against a prefill
    of the patches and the first PIXTRAL_SPLIT tokens followed by AT -
    PIXTRAL_SPLIT ``decode_step`` calls, within PREFILL_REL."""
    n_pre, max_len, v = patches.shape[1], 2048, cfg.vocab_size
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, v, (AB, AT), generator=gen,
                         dtype=torch.int32).to(DEV)
    lm.prefill(params, cfg, toks[:, :16], max_len, patch_embeds=patches)
    fresh_card()
    logits, cache = lm.prefill(params, cfg, toks, max_len,
                               patch_embeds=patches)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(bool((cache["pos"] == n_pre + AT).all())
          and bool(torch.isfinite(logits[:, :v]).all()),
          "pixtral-12b prefill with patches: cache and logits")
    ms = synced_ms(lambda: lm.prefill(params, cfg, toks, max_len,
                                      patch_embeds=patches), reps=3)
    l_s, c_s = lm.prefill(params, cfg, toks[:, :PIXTRAL_SPLIT], max_len,
                          patch_embeds=patches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(PIXTRAL_SPLIT, AT):
        l_s, c_s = lm.decode_step(params, cfg, toks[:, i], c_s)
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    tol = PREFILL_REL[torch.bfloat16]
    e = rel_err(logits[:, :v], l_s[:, :v], "pixtral-12b prefill with "
                "patches vs a shorter prefill and steps", tol)
    check(bool((c_s["pos"] == cache["pos"]).all()), "pixtral-12b pos")
    del logits, cache, l_s, c_s
    n = AB * (n_pre + AT)
    print(f"prefill pixtral-12b B {AB} x ({n_pre} patches + {AT} tokens) "
          f"(cache {max_len}): peak device memory {peak / 2**30:.2f} GiB; "
          f"ms min {ms[0]:.2f} median {ms[1]:.2f} max {ms[-1]:.2f}, prompt "
          f"tokens/s median {n / ms[1] * 1e3:.0f}; last logits against the "
          f"patches + {PIXTRAL_SPLIT} tokens prefilled, then "
          f"{AT - PIXTRAL_SPLIT} decode steps ({seq_ms:.1f} ms): {e:.3g} "
          f"(limit {tol})")
    device_groups(lambda: lm.prefill(params, cfg, toks, max_len,
                                     patch_embeds=patches),
                  f"prefill pixtral-12b B {AB} x ({n_pre} + {AT})")


def pixtral_phase():
    """pixtral-12b at full width (a mistral-nemo trunk: d 5120, GQA 32
    heads on 8 KV heads of 128, RoPE theta 1e6, SwiGLU 14336, untied vocab
    131,072; the stub patch frontend: 1024 patch embeddings of dim 1024,
    ``patch_proj``), cut to PIXTRAL_LAYERS layers; bf16, drawn on the
    card; no kernel of the repo.  Serving text (``zoo_serving``), the
    prefill with the patch prefix (``pixtral_prefill``), then 3 training
    steps at ZOO_TRAIN_LAYERS layers (2.44 B) with the patch prefix."""
    cfg = archs.get("pixtral-12b")
    check(cfg.n_layers == 40 and cfg.d_model == 5120 and cfg.n_heads == 32
          and cfg.n_kv_heads == 8 and cfg.head_dim_ == 128
          and cfg.d_ff == 14336 and cfg.vocab_size == 131072
          and cfg.frontend == "patches" and cfg.n_frontend_tokens == 1024
          and cfg.frontend_dim == 1024 and cfg.rope_theta == 1e6
          and cfg.cdtype == torch.bfloat16,
          f"unexpected pixtral-12b config {cfg}")
    cfg = cfg.replace(n_layers=PIXTRAL_LAYERS)
    check(lm.kernel_tier(cfg) == "unfused", "pixtral-12b not unfused")
    reset_serve_launches()
    reset_train_launches()
    patches = torch.randn((AB, cfg.n_frontend_tokens, cfg.frontend_dim),
                          generator=torch.Generator().manual_seed(4)
                          ).to(torch.bfloat16).to(DEV)
    params = draw_params(cfg, f"pixtral-12b cut to {cfg.n_layers} of 40 "
                         f"layers")
    zoo_serving(cfg, params, "pixtral-12b")
    pixtral_prefill(cfg, params, patches)
    zoo_kernel_counts_zero("pixtral-12b")
    del params
    fresh_card()
    launches = zoo_train(cfg, "pixtral-12b", extra={"patch_embeds": patches})
    zoo_kernel_counts_zero("pixtral-12b")
    return launches


def deepseek67_phase():
    """deepseek-67b at full width (d 8192, GQA 64 heads on 8 KV heads of
    128, SwiGLU 22016, RMSNorm, untied vocab 102,400), cut to
    DEEPSEEK67_LAYERS layers; bf16, drawn on the card; no kernel of the
    repo.  Serving (``zoo_serving``) and the prefill (``zoo_prefill``,
    the route at DEEPSEEK67_ROUTE_T steps); no training on the card: it
    runs the code of starcoder2-15b's and pixtral-12b's training, and
    the CPU tests hold its loss and gradients."""
    cfg = archs.get("deepseek-67b")
    check(cfg.n_layers == 95 and cfg.d_model == 8192 and cfg.n_heads == 64
          and cfg.n_kv_heads == 8 and cfg.head_dim_ == 128
          and cfg.d_ff == 22016 and cfg.vocab_size == 102400
          and cfg.norm == "rmsnorm" and cfg.gated_mlp
          and cfg.cdtype == torch.bfloat16,
          f"unexpected deepseek-67b config {cfg}")
    cfg = cfg.replace(n_layers=DEEPSEEK67_LAYERS)
    check(lm.kernel_tier(cfg) == "unfused", "deepseek-67b not unfused")
    reset_serve_launches()
    reset_train_launches()
    params = draw_params(cfg, f"deepseek-67b cut to {cfg.n_layers} of 95 "
                         f"layers")
    zoo_serving(cfg, params, "deepseek-67b")
    zoo_prefill(cfg, params, "deepseek-67b", DEEPSEEK67_ROUTE_T)
    zoo_kernel_counts_zero("deepseek-67b")
    del params
    fresh_card()
    return {}


def whisper_decode(cfg, params, frames, n_steps):
    """``encdec.prefill`` of ``frames``, then ``n_steps`` greedy
    ``decode_step`` calls from seeded start tokens.  Returns the fed
    tokens (B, n), the step logits (B, n, V) and the steps' seconds."""
    bsz = frames.shape[0]
    cache = encdec.prefill(params, cfg, frames, encdec.init_cache(
        cfg, bsz, n_steps, DEV))
    tok = torch.randint(0, cfg.vocab_size, (bsz,), generator=torch.
                        Generator().manual_seed(5), dtype=torch.int32).to(DEV)
    fed, logits = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        fed.append(tok)
        out, cache = encdec.decode_step(params, cfg, tok, cache)
        logits.append(out)
        tok = out[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    return torch.stack(fed, 1), torch.stack(logits, 1), \
        time.perf_counter() - t0


def whisper_phase():
    """whisper-base whole (6 encoder and 6 decoder layers, d 512, 8 heads
    of 64, LayerNorm, biased attention, GELU MLP 2048, learned positions,
    tied vocab 51,865; the stub frame frontend: 1500 frames of dim 512;
    bf16, drawn on the card; no kernel of the repo).  Encode B 8 x 1500
    frames (ms); prefill, then WHISPER_STEPS greedy decode steps against
    teacher-forced ``forward`` on the same tokens (bf16 and an fp32
    compute dtype, PREFILL_REL), decoded tok/s; a decode row in a batch
    of 8 equal to the row alone; 3 training steps at B 8 x 1500 frames x
    WHISPER_TRAIN_T tokens (loss falling, ms a step, peak memory)."""
    cfg = archs.get("whisper-base")
    check(cfg.family == "encdec" and cfg.n_layers == 6
          and cfg.n_encoder_layers == 6 and cfg.d_model == 512
          and cfg.n_heads == 8 and cfg.head_dim_ == 64 and cfg.d_ff == 2048
          and cfg.vocab_size == 51865 and cfg.norm == "layernorm"
          and cfg.n_frontend_tokens == encdec.N_AUDIO_FRAMES
          and cfg.frontend_dim == 512 and cfg.cdtype == torch.bfloat16,
          f"unexpected whisper-base config {cfg}")
    reset_serve_launches()
    reset_train_launches()
    fresh_card()
    t0 = time.perf_counter()
    params = encdec.init_params(torch.Generator(device=DEV).manual_seed(0),
                                cfg, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in leaves(params))
    print(f"whisper-base: {n_params} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.2f}s")
    v, t_enc = cfg.vocab_size, cfg.n_frontend_tokens
    frames = torch.randn((AB, t_enc, cfg.frontend_dim), generator=torch.
                         Generator().manual_seed(3)).to(torch.bfloat16).to(DEV)
    with torch.no_grad():
        enc = encdec.encode(params, cfg, frames)
        check(tuple(enc.shape) == (AB, t_enc, cfg.d_model)
              and bool(torch.isfinite(enc).all()), "whisper-base encode")
        enc_ms = synced_ms(lambda: encdec.encode(params, cfg, frames),
                           reps=3)
    del enc
    tol, tol32 = PREFILL_REL[torch.bfloat16], PREFILL_REL[torch.float32]
    errs = {}
    for c in (cfg, cfg.replace(compute_dtype="float32")):
        fed, step_logits, secs = whisper_decode(c, params, frames,
                                                WHISPER_STEPS)
        with torch.no_grad():
            teacher = encdec.forward(params, c, frames, fed)
        errs[c.compute_dtype] = rel_err(
            step_logits[..., :v], teacher[..., :v], f"whisper-base "
            f"{c.compute_dtype} decode steps vs teacher-forced forward",
            tol if c.cdtype == torch.bfloat16 else tol32)
        if c.cdtype == torch.bfloat16:
            rate = AB * WHISPER_STEPS / secs
            step_ms = secs / WHISPER_STEPS * 1e3
        del step_logits, teacher
    cache = encdec.prefill(params, cfg, frames,
                           encdec.init_cache(cfg, AB, 64, DEV))
    alone = {k: a[3:4].clone() if k == "pos" else a[:, 3:4].clone()
             for k, a in cache.items()}
    toks = torch.randint(0, v, (AB, 6), generator=torch.Generator().
                         manual_seed(7), dtype=torch.int32).to(DEV)
    for t in range(toks.shape[1]):
        l8, cache = encdec.decode_step(params, cfg, toks[:, t], cache)
        l1, alone = encdec.decode_step(params, cfg, toks[3:4, t], alone)
        check(torch.equal(l8[3:4], l1), f"whisper-base: a B-8 decode row's "
              f"logits != the B-1 row's at step {t}")
    for k in ("k", "v"):
        check(torch.equal(cache[k][:, 3:4], alone[k]),
              f"whisper-base: a B-8 decode row's {k} != the B-1 row's")
    del cache, alone
    print(f"whisper-base: encode B {AB} x {t_enc} frames ms min "
          f"{enc_ms[0]:.2f} median {enc_ms[1]:.2f} max {enc_ms[-1]:.2f}; "
          f"prefill + {WHISPER_STEPS} greedy decode steps against "
          f"teacher-forced forward: bf16 {errs['bfloat16']:.3g} (limit "
          f"{tol}), fp32 {errs['float32']:.3g} (limit {tol32}); decoded "
          f"tok/s {rate:.1f} (B {AB}, {step_ms:.2f} ms a step); a B-8 "
          f"decode row equals the B-1 row bit for bit (logits, k, v; 6 "
          f"steps)")
    train_data, _ = lm_corpus.build_corpus()
    batch = dict(lm_corpus.lm_batch(train_data, 0, 0, AB, WHISPER_TRAIN_T),
                 frames=frames)
    fresh_card()
    losses, times = timed_steps(cfg, params, batch, ATTN_OPT, 3)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"whisper-base: {losses}")
    check(losses[-1] < losses[0], f"whisper-base: loss did not fall: "
          f"{losses}")
    print(f"train whisper-base (bf16, remat full, B {AB} x {t_enc} frames x "
          f"{WHISPER_TRAIN_T} tokens, one repeated batch, 3 steps): losses "
          + " ".join(f"{x:.4f}" for x in losses) + "; ms per step "
          + " ".join(f"{x:.2f}" for x in times)
          + f"; peak device memory {peak / 2**30:.2f} GiB")
    zoo_kernel_counts_zero("whisper-base")
    del params
    fresh_card()
    return {}


# ---------------------------------------------------------------------------
# 5f. MLA: deepseek-v3-671b
# ---------------------------------------------------------------------------

# deepseek-v3-671b at full width and a cut depth (671 B parameters are
# ~1.34 TB of bf16): served and prefilled at 3 dense + 2 MoE layers
# (26.62 B, 53.2 GB), its fp32 route at 1 dense + 1 MoE (13.94 B, 55.8
# GB in fp32), trained on the 3 dense layers alone (an empty MoE stack;
# 3.60 B, ~43 GB with the gradients and AdamW's fp32 moments)
DEEPSEEK_V3_LAYERS = 5
# the capacity factor at which no assignment can drop in the stream, row
# and route checks: a B-1 step gets 1 row an expert, a B-8 step 8, a
# prefill of 8 x 128 tokens 1024 (cap = int(cf * N * k / E))
V3_NO_DROP_CF = 32.0
V3_ROUTE_T = 128


def deepseek_v3_phase():
    """deepseek-v3-671b at full width (d 7168; MLA: 128 heads, q LoRA
    1536, kv LoRA 512, rope dim 64, nope and v dims 128; 3 dense layers
    of d_ff 18432, then MoE layers of 256 experts of 2048, top-8, one
    shared expert of 2048; untied vocab 129,280; bf16, drawn on the card
    a layer at a time), cut to DEEPSEEK_V3_LAYERS.  No kernel of the
    repo: every count stays 0.  Serving 8 prompts of 8 seeded ids, 32 new
    tokens, K 4, C 1, a latent cache of 1024: at capacity factor
    V3_NO_DROP_CF streams equal ``generate_one`` and a B-8 decode row the
    B-1 row; at the published 1.25 the dropped share, tok/s over
    ZOO_RATE_WINDOWS windows and a profile.  The prefill
    (``deepseek_v3_prefill``), the fp32 route at 1 + 1 layers, then 3
    training steps on the dense prefix and one more under each remat
    (``remat_peaks``)."""
    cfg = archs.get("deepseek-v3-671b")
    m = cfg.moe
    check(cfg.n_layers == 61 and m.first_dense_layers == 3
          and cfg.attn_kind == "mla" and cfg.d_model == 7168
          and cfg.n_heads == 128 and cfg.mla_q_lora == 1536
          and cfg.mla_kv_lora == 512 and cfg.mla_rope_dim == 64
          and cfg.mla_qk_nope_dim == 128 and cfg.mla_v_dim == 128
          and cfg.d_ff == 18432 and m.n_experts == 256 and m.top_k == 8
          and m.d_expert == 2048 and m.n_shared == 1 and m.d_shared == 2048
          and m.capacity_factor == 1.25 and cfg.vocab_size == 129280
          and not cfg.tie_embeddings and cfg.cdtype == torch.bfloat16
          and cfg.remat == "full",
          f"unexpected deepseek-v3-671b config {cfg}")
    label = "deepseek-v3-671b"
    cfg = cfg.replace(n_layers=DEEPSEEK_V3_LAYERS)
    check(lm.kernel_tier(cfg) == "unfused", f"{label} not unfused")
    cf32 = cfg.replace(moe=dataclasses.replace(m,
                                               capacity_factor=V3_NO_DROP_CF))
    reset_serve_launches()
    reset_train_launches()
    params = draw_params(cfg, f"{label} cut to {cfg.n_layers} of 61 layers "
                         f"({m.first_dense_layers} dense + "
                         f"{cfg.n_layers - m.first_dense_layers} MoE)")
    cache_mb = cfg.n_layers * GEMMA_MAX_LEN * (
        cfg.mla_kv_lora + cfg.mla_rope_dim) * 2 / 1e6
    print(f"{label}: latent cache {cache_mb:.2f} MB a slot (bf16, "
          f"{cfg.n_layers} layers x {GEMMA_MAX_LEN} positions x "
          f"{cfg.mla_kv_lora} + {cfg.mla_rope_dim}; derived)")
    prompts = torch.randint(0, cfg.vocab_size, (8, 8), generator=torch.
                            Generator().manual_seed(1)).tolist()
    at32 = served_against_generate_one(cf32, params, prompts,
                                       f"{label} cf {V3_NO_DROP_CF}")
    torch.cuda.reset_peak_memory_stats()
    with moe_lib.count_drops() as drops:
        streams, info = serve(cfg, params, 1, prompts, 32,
                              max_len=GEMMA_MAX_LEN,
                              label=f"serve [{label} cf 1.25]")
    peak = torch.cuda.max_memory_allocated()
    dropped, assigned, share = dropped_share(drops)
    n_moe = cfg.n_layers - m.first_dense_layers
    same = sum(a == b for a, b in zip(streams, at32["streams"]))
    print(f"serve {label} at cf 1.25: {dropped} of {assigned} top-8 "
          f"assignments dropped ({100 * share:.1f}%; "
          f"{dropped / (info['rounds'] * n_moe):.2f} of "
          f"{assigned / (info['rounds'] * n_moe):.0f} a layer a round, "
          f"{info['rounds']} rounds); {same} of 8 streams as at cf "
          f"{V3_NO_DROP_CF}; peak device memory while serving "
          f"{peak / 2**30:.2f} GiB")
    rate_spread(cfg, params, reps=ZOO_RATE_WINDOWS, chunks=(1,),
                prompts=prompts, max_len=GEMMA_MAX_LEN)
    profile_events(cfg, params, prompts, label)
    deepseek_v3_prefill(cfg, cf32, params)
    zoo_kernel_counts_zero(label)
    del params
    deepseek_v3_fp32_route(cf32)
    tcfg = cfg.replace(n_layers=m.first_dense_layers)
    tparams = draw_params(tcfg, f"{label} cut to its {tcfg.n_layers} dense "
                          f"layers (an empty MoE stack) for training")
    check(leaves(tparams["layers"]["blocks"])[0].shape[0] == 0,
          f"{label}: the training cut's MoE stack is not empty")
    launches = attn_train(tcfg, tparams, plain_check=False)
    remat_peaks(tcfg, tparams, label)
    zoo_kernel_counts_zero(label)
    del tparams
    fresh_card()
    return launches


def deepseek_v3_prefill(cfg, cf32, params):
    """deepseek-v3-671b, B 8 x T 512 at the published capacity into a
    latent cache of GEMMA_MAX_LEN: the dropped share, ms, prompt
    tokens/s, peak memory, a profile; a prefill of the first V3_ROUTE_T
    tokens at capacity factor V3_NO_DROP_CF against that many sequential
    steps held to its routing (bf16, PREFILL_REL)."""
    label = "deepseek-v3-671b"
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (AB, AT), generator=gen,
                         dtype=torch.int32).to(DEV)
    lm.prefill(params, cfg, toks[:, :16], GEMMA_MAX_LEN)
    fresh_card()
    with moe_lib.count_drops() as drops:
        logits, cache = lm.prefill(params, cfg, toks, GEMMA_MAX_LEN)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    dropped, assigned, share = dropped_share(drops)
    check(tuple(cache["ckv"].shape) == (cfg.n_layers, AB, GEMMA_MAX_LEN,
                                        cfg.mla_kv_lora)
          and tuple(cache["krope"].shape) == (cfg.n_layers, AB,
                                              GEMMA_MAX_LEN,
                                              cfg.mla_rope_dim)
          and set(cache) == {"pos", "ckv", "krope"}
          and bool((cache["pos"] == AT).all())
          and bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          f"{label} prefill cache and logits")
    del logits, cache
    ms = synced_ms(lambda: lm.prefill(params, cfg, toks, GEMMA_MAX_LEN),
                   reps=3)
    tol = PREFILL_REL[torch.bfloat16]
    held, apart, n_dec, seq_ms = moe_route_check(cf32, params,
                                                 toks[:, :V3_ROUTE_T])
    held = rel_err(*held, f"{label} prefill vs the step path on the "
                   f"prefill's routing", tol)
    print(f"prefill {label} B {AB} x T {AT} at cf 1.25 (latent cache "
          f"{GEMMA_MAX_LEN}): {dropped} of {assigned} assignments dropped "
          f"({100 * share:.1f}%); peak device memory {peak / 2**30:.2f} "
          f"GiB; ms min {ms[0]:.2f} median {ms[1]:.2f} max {ms[-1]:.2f}, "
          f"prompt tokens/s median {AB * AT / ms[1] * 1e3:.0f}; at cf "
          f"{V3_NO_DROP_CF} against {V3_ROUTE_T} sequential steps held to "
          f"the prefill's routing (bf16): logits {held:.3g} (limit {tol}), "
          f"{apart} of {n_dec} top-8 choices of the steps' own apart from "
          f"the prefill's (printed; the steps {seq_ms:.1f} ms)")
    device_groups(lambda: lm.prefill(params, cfg, toks, GEMMA_MAX_LEN),
                  f"prefill {label} B {AB} x T {AT}")


def deepseek_v3_fp32_route(cf32):
    """The prefill against the step path with fp32 weights and compute at
    1 dense + 1 MoE layer (drawn after the bf16 model is freed), at
    capacity factor V3_NO_DROP_CF and T FP32_ROUTE_T: no top-8 choice of
    the steps apart from the prefill's, logits within PREFILL_REL."""
    label = "deepseek-v3-671b fp32"
    f32 = cf32.replace(n_layers=2, param_dtype="float32",
                       compute_dtype="float32",
                       moe=dataclasses.replace(cf32.moe,
                                               first_dense_layers=1))
    params = draw_params(f32, f"{label} at 1 dense + 1 MoE layer")
    toks = torch.randint(0, f32.vocab_size, (AB, FP32_ROUTE_T),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32).to(DEV)
    fresh_card()
    held, apart, n_dec, seq_ms = moe_route_check(f32, params, toks)
    peak = torch.cuda.max_memory_allocated()
    check(apart == 0, f"{label}: {apart} top-8 choices of the steps differ "
          f"from the prefill's")
    tol = PREFILL_REL[torch.float32]
    held = rel_err(*held, f"{label} prefill vs the step path", tol)
    print(f"prefill {label} (1 dense + 1 MoE layer, fp32 weights) at cf "
          f"{V3_NO_DROP_CF} against {FP32_ROUTE_T} sequential steps: logits "
          f"{held:.3g} (limit {tol}), {apart} of {n_dec} top-8 choices "
          f"apart (limit 0); the steps {seq_ms:.1f} ms; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    del params
    fresh_card()


def remat_peaks(cfg, params, label):
    """One loss and its gradients at B 8 x T 512 under remat "full",
    "dots" and "none", each from a clean peak counter: the same loss, the
    gradients of "dots" and "none" within GRAD_TOL of "full"'s (the
    largest error over the largest value, leaf by leaf; "full"'s kept on
    the host meanwhile), and the peaks ordered full <= dots <= none."""
    train_data, _ = lm_corpus.build_corpus()
    batch = ts_lib.batch_to(lm_corpus.lm_batch(train_data, 0, 1, AB, AT),
                            DEV)
    tol = GRAD_TOL[cfg.cdtype]
    peaks, errs, ms, ref = {}, {}, {}, None
    for remat in ("full", "dots", "none"):
        fresh_card()
        t0 = time.perf_counter()
        (loss, _), grads = ts_lib.value_and_grad(
            ts_lib.make_loss_fn(cfg.replace(remat=remat)), params, batch)
        torch.cuda.synchronize()
        ms[remat] = (time.perf_counter() - t0) * 1e3
        peaks[remat] = torch.cuda.max_memory_allocated()
        flat = leaves(grads)
        if ref is None:
            ref = (float(loss), [g.cpu() for g in flat])
        else:
            check(float(loss) == ref[0], f"{label} remat {remat}: loss "
                  f"{float(loss)} != full's {ref[0]}")
            errs[remat] = max(
                float((g.float() - r.to(DEV).float()).abs().max()
                      / r.float().abs().max().clamp(min=1e-30))
                for g, r in zip(flat, ref[1]) if r.numel())
            check(errs[remat] <= tol, f"{label} remat {remat}: gradients "
                  f"{errs[remat]:.3g} of the largest from full's > {tol}")
        del grads, flat
    check(peaks["full"] <= peaks["dots"] <= peaks["none"],
          f"{label}: remat peaks not ordered full <= dots <= none: {peaks}")
    print(f"remat {label} ({cfg.n_layers} layers, bf16, B {AB} x T {AT}, "
          f"one loss and its gradients): loss {ref[0]:.4f} under all "
          f"three; gradients against full's: dots {errs['dots']:.3g}, none "
          f"{errs['none']:.3g} (limit {tol}); peak device memory full "
          f"{peaks['full'] / 2**30:.2f} <= dots {peaks['dots'] / 2**30:.2f}"
          f" <= none {peaks['none'] / 2**30:.2f} GiB; ms full "
          f"{ms['full']:.1f}, dots {ms['dots']:.1f}, none {ms['none']:.1f}")


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


# ---------------------------------------------------------------------------
# 7. mesh-sharded serving: a world of ranks on the one card
# ---------------------------------------------------------------------------

MESH_SEED = 27
MESH_NEW = 32
MESH_AR_ITERS = 50


def mesh_cfg(tier, fp32=False):
    cfg = archs.get("mingru-lm").replace(fuse_block=tier)
    if fp32:
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    return cfg


def mesh_params(cfg, dev):
    """Every rank and this process draw the same bits from one seed."""
    return lm.init_params(torch.Generator(device=dev).manual_seed(MESH_SEED),
                          cfg, device=dev)


def mesh_serve(cfg, params, mesh, dev, chunk=1, faults=None):
    """PROMPTS x MESH_NEW greedy tokens at K 4 through one engine, on one
    card (``mesh`` None) or as this rank of ``mesh``: its streams, stats,
    launches (this process's) and decoded tok/s."""
    eng = ServingEngine(cfg, params, max_batch=8, max_len=128, seed=0,
                        decode_block=4, prompt_chunk=chunk, device=dev,
                        mesh=mesh, faults=faults)
    before = serve_launches()
    bodies = cell_body_launches()
    rids = [eng.submit(tokens_of(p), max_new=MESH_NEW) for p in PROMPTS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.run_to_completion()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = cell_body_launches()
    return {"streams": [tuple(outs[r]) for r in rids],
            "rounds": eng.stats.decode_steps, "tier": eng.kernel_tier,
            "launches": {k: v - before[k]
                         for k, v in serve_launches().items()},
            "bodies": {k: v - bodies[k] for k, v in after.items()},
            "identities": eng.stats.shard_identities_ok(),
            "completed": eng.stats.completed,
            "dead_shards": sorted(eng.dead_shards),
            "mismatches": eng.tp_plane_mismatches,
            "h_block": tuple(eng.state["cache"]["h"].shape),
            "rate": eng.stats.decode_tokens / dt}


def first_logits(cfg, params, mesh=None):
    """The first decode step's logits for PROMPTS' first bytes, B 8, on
    one card, or this rank's rows of them sharded as this rank of
    ``mesh`` (a RankMesh)."""
    tok = torch.tensor([p.encode()[0] for p in PROMPTS], dtype=torch.int32,
                       device=params["embed"]["table"].device)
    cache = lm.init_cache(cfg, 8, 16, tok.device)
    group = None
    if mesh is not None:
        rows = serve_mesh.shard_rows(mesh.data_index, 8 // mesh.plan.data)
        tok = tok[rows.start:rows.stop]
        params = serve_mesh.shard_params(params, cfg, mesh)
        cache = serve_mesh.cut_slot_state(cfg, {"cache": cache},
                                          mesh)["cache"]
        group = mesh.model_group
    with mesh_ctx.serving_tp(group):
        logits, _ = lm.decode_step(params, cfg, tok, cache)
    return logits.float().cpu()


def allreduce_ms(mesh, dev):
    """ms of one all-reduce of a (8, 768) bf16 partial over the model
    group, the size each TP sub-block reduces a round at C 1."""
    import torch.distributed as dist
    x = torch.ones((8, 768), dtype=torch.bfloat16, device=dev)
    for _ in range(5):
        dist.all_reduce(x, group=mesh.model_group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_AR_ITERS):
        dist.all_reduce(x, group=mesh.model_group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / MESH_AR_ITERS * 1e3


def mesh_rank(mesh_spec, t_spawn):
    """One rank of a serving world on the card: the scenarios of its
    shape, its own launch counts, and when it was ready."""
    dev = serve_mesh.rank_device("cuda")
    plan = serve_mesh.MeshPlan.parse(mesh_spec)
    out = {"rank": int(os.environ["RANK"]), "device": str(dev)}
    block = mesh_cfg("auto")
    params = mesh_params(block, dev)
    mesh_serve(block, params, mesh_spec, dev, chunk=8)    # first use
    torch.cuda.synchronize()
    out["ready_s"] = time.time() - t_spawn
    if plan.model == 1:
        for c in (1, 8):
            out[f"block C{c}"] = mesh_serve(block, params, mesh_spec, dev,
                                            chunk=c)
        out["failover"] = mesh_serve(
            block, params, mesh_spec, dev,
            faults=FaultInjector(shard_crash_at=((4, 1),)))
        if plan.data == 2:
            out["cell C1"] = mesh_serve(mesh_cfg("off"), params, mesh_spec,
                                        dev)
        return out
    rank_mesh = plan.build()
    out["bf16"] = mesh_serve(block, params, mesh_spec, dev)
    out["logits"] = first_logits(block, params, rank_mesh)
    out["allreduce_ms"] = allreduce_ms(rank_mesh, dev)
    del params
    fp32 = mesh_cfg("off", fp32=True)
    params = mesh_params(fp32, dev)
    out["fp32"] = mesh_serve(fp32, params, mesh_spec, dev)
    return out


def mesh_cli(mesh_spec):
    """Start ``python -m repro_torch.launch.serve --mesh`` (full-width
    mingru-lm on the card); returns the process."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "mingru-lm", "--device", "cuda", "--mesh", mesh_spec,
           "--max-new", "8", "--decode-block", "4"]
    return subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def mesh_phase():
    """Full-width mingru-lm served on data x model worlds of ranks that
    share the card (gloo): DP 2x1 / 4x1 on the block tier at C 1 and 8
    and 2x1 on the cell tier, streams bit-equal to the one-card engine's,
    one kernel launch per layer per round on every rank, a shard crash
    failing over with the same streams; TP 1x2 / 2x2 on the cell tier,
    model ranks' planes equal bit for bit, first-step logits within the
    bf16 tolerance, fp32 streams equal to the one card's; the launcher at
    --mesh 2x2.  Returns the launches of every rank's counted runs."""
    t_phase = time.perf_counter()
    cli = mesh_cli("2x2")
    # the one card's streams while the launcher runs; its rates after
    block, fp32 = mesh_cfg("auto"), mesh_cfg("off", fp32=True)
    params = {"bf16": mesh_params(block, DEV), "fp32": mesh_params(fp32, DEV)}
    runs = (("block C1", block, "bf16", 1), ("block C8", block, "bf16", 8),
            ("cell C1", mesh_cfg("off"), "bf16", 1), ("fp32", fp32, "fp32", 1))
    single = {name: mesh_serve(cfg, params[p], None, DEV, chunk=c)
              for name, cfg, p, c in runs}
    ref_logits = first_logits(block, params["bf16"])
    try:
        cli_out, _ = cli.communicate(timeout=300)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    line = [ln for ln in cli_out.splitlines() if ln.startswith("mesh 2x2")]
    check(cli.returncode == 0 and line
          and "identity per shard + global: True" in line[0]
          and "plane mismatches: 0" in line[0],
          f"launch.serve --mesh 2x2 (rc {cli.returncode}): "
          f"{cli_out[-3000:]}")
    print(f"launch.serve --mesh 2x2: {line[0]}")
    for name, cfg, p, c in runs:
        single[name]["rate"] = mesh_serve(cfg, params[p], None, DEV,
                                          chunk=c)["rate"]
        print(f"mesh one card [{single[name]['tier']}] {name}: "
              f"{single[name]['rate']:.1f} decoded tok/s")
    del params
    torch.cuda.empty_cache()

    layers = block.n_layers
    launches = {}
    for spec in ("2x1", "4x1", "1x2", "2x2"):
        plan = serve_mesh.MeshPlan.parse(spec)
        t0 = time.time()
        ranks = serve_mesh.run_world(mesh_rank, plan.size, (spec, t0))
        up = max(r["ready_s"] for r in ranks)
        devs = ", ".join(r["device"] for r in ranks)
        runs = [k for k in ranks[0] if isinstance(ranks[0][k], dict)]
        for r in ranks:
            for name in runs:
                run = r[name]
                check(run["identities"] and run["completed"] == len(PROMPTS)
                      and run["mismatches"] == 0,
                      f"mesh {spec} rank {r['rank']} {name}: identities "
                      f"{run['identities']}, completed {run['completed']}, "
                      f"plane mismatches {run['mismatches']}")
                n = sum(run["launches"].values())
                fam = ("block_step_kernel", "block_chunk_kernel") \
                    if run["tier"] == "block-fused" else \
                    ("mingru_step_kernel", "mingru_chunk_kernel")
                check(n == layers * run["rounds"]
                      == sum(run["launches"][k] for k in fam),
                      f"mesh {spec} rank {r['rank']} {name}: launches "
                      f"{run['launches']} for {layers} layers x "
                      f"{run['rounds']} rounds on the {run['tier']} tier")
                merge(launches, run["launches"])
        for name in runs:
            check(all(r[name]["streams"] == ranks[0][name]["streams"]
                      for r in ranks), f"mesh {spec} {name}: ranks drained "
                  f"different streams")
        if plan.model == 1:
            for name in runs:
                run = ranks[0][name]
                want = single["cell C1" if name == "cell C1" else
                              "block C1" if name == "failover" else name]
                check(run["streams"] == want["streams"],
                      f"mesh {spec} {name}: streams differ from one card's")
                check(run["tier"] == want["tier"],
                      f"mesh {spec} {name}: tier {run['tier']}")
            check(ranks[0]["failover"]["dead_shards"] == [1],
                  f"mesh {spec}: dead shards "
                  f"{ranks[0]['failover']['dead_shards']}")
            print(f"mesh {spec} ({plan.size} ranks, {serve_mesh.BACKEND}; "
                  f"devices {devs}; world up in {up:.1f}s): streams equal "
                  f"the one card's on "
                  f"{', '.join(runs)} (failover: shard 1 crashed at round "
                  f"4, {ranks[0]['failover']['rounds']} rounds against "
                  f"{ranks[0]['block C1']['rounds']}); one kernel launch "
                  f"per layer per round on every rank (rank 0: " + ", ".join(
                      f"{n} {sum(ranks[0][n]['launches'].values())}"
                      for n in runs) + "); decoded tok/s " + ", ".join(
                      f"{n} {ranks[0][n]['rate']:.1f}" for n in runs))
            continue
        for r in ranks:
            for name in ("bf16", "fp32"):
                run = r[name]
                check(run["tier"] == "cell-fused"
                      and run["launches"]["block_step_kernel"]
                      + run["launches"]["block_chunk_kernel"] == 0
                      and run["h_block"][2] == 1536 // plan.model,
                      f"mesh {spec} {name}: tier {run['tier']}, launches "
                      f"{run['launches']}, h block {run['h_block']}")
            check(r["bf16"]["bodies"]["mingru_step_kernel/tc"]
                  == r["bf16"]["launches"]["mingru_step_kernel"],
                  f"mesh {spec}: bf16 TP launches off the tensor-core body "
                  f"{r['bf16']['bodies']}")
            row0 = ranks[r["rank"] - r["rank"] % plan.model]
            check(torch.equal(r["logits"], row0["logits"]),
                  f"mesh {spec}: model ranks' logits differ")
        err = max(max_err(
            r["logits"], ref_logits[serve_mesh.shard_rows(
                r["rank"] // plan.model, 8 // plan.data)],
            torch.bfloat16, f"mesh {spec} first-step logits against one "
            f"card") for r in ranks)
        check(ranks[0]["fp32"]["streams"] == single["fp32"]["streams"],
              f"mesh {spec}: fp32 streams differ from one card's")
        bf, one = ranks[0]["bf16"]["streams"], single["cell C1"]["streams"]
        div = [first_divergence(a, b) for a, b in zip(bf, one)]
        same = sum(a == b for s_, t_ in zip(bf, one) for a, b in zip(s_, t_))
        ar = [r["allreduce_ms"] for r in ranks]
        print(f"mesh {spec} ({plan.size} ranks, {serve_mesh.BACKEND}; "
              f"devices {devs}; world up in {up:.1f}s): cell tier at Dh "
              f"{1536 // plan.model}, model ranks' planes equal bit for "
              f"bit; first-step logits max abs err {err:.3g} against one "
              f"card (bf16 limit atol {TOL[torch.bfloat16][0]} rtol "
              f"{TOL[torch.bfloat16][1]}); fp32 streams equal the one "
              f"card's; bf16 streams: {same} of "
              f"{len(PROMPTS) * MESH_NEW} tokens equal, first divergence "
              f"{div}; decode_step launches per rank at Dh "
              f"{1536 // plan.model}: "
              f"{[r['bf16']['launches']['mingru_step_kernel'] for r in ranks]}"
              f" (bf16) {[r['fp32']['launches']['mingru_step_kernel'] for r in ranks]}"
              f" (fp32); decoded tok/s bf16 {ranks[0]['bf16']['rate']:.1f} "
              f"fp32 {ranks[0]['fp32']['rate']:.1f} (one card's cell tier "
              f"{single['cell C1']['rate']:.1f} / "
              f"{single['fp32']['rate']:.1f}); ms per TP all-reduce "
              f"(8 x 768 bf16) {', '.join(f'{a:.3f}' for a in ar)}")
    print(f"mesh: launches of every rank's counted runs {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f}s")
    return launches



# ---------------------------------------------------------------------------
# 7b. mesh training: worlds of ranks on the one card
# ---------------------------------------------------------------------------

MT_SEED = 28
MT_STEPS = 3
MT_OPT = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
# deepseek-moe-16b at full width, cut to 1 dense + 1 MoE layer so that
# four ranks' weights, grads and AdamW moments fit the card together
EP_LAYERS = 2
EP_B, EP_T = 8, 512
EP_PUBLISHED_CF = 1.25
# the drops check's capacity factor: seeded random tokens route almost
# evenly (no expert overflowed at the published 1.25 on an H100 80GB
# HBM3), so the check runs where capacity equals the mean load
EP_DROP_CF = 1.0
SP_SHAPE = (8, 4096, 1536)
MT_DIR = os.path.join(SCRATCH, "mesh_train")
# the reference's trend tolerance for the compressed DP step against the
# one-device step (tests/test_spmd.py)
DP_RTOL, DP_ATOL, DP_LOSS = 0.1, 2e-3, 1e-2
_CORPUS = []


def mt_batch(i):
    """mingru-lm's training traffic, B 8 x T 256 of the corpus."""
    if not _CORPUS:
        _CORPUS.append(lm_corpus.build_corpus()[0])
    return lm_corpus.lm_batch(_CORPUS[0], 0, i, TB, TT)


def ep_cfg(cf, dtype="bfloat16", mode="auto"):
    cfg = archs.get("deepseek-moe-16b")
    return cfg.replace(n_layers=EP_LAYERS, param_dtype=dtype,
                       compute_dtype=dtype, moe=dataclasses.replace(
                           cfg.moe, first_dense_layers=1,
                           capacity_factor=cf, ep_2d=mode))


def ep_batch(cfg):
    """B 8 x T 512 seeded token ids, each labelled with the next."""
    toks = torch.randint(0, cfg.vocab_size, (EP_B, EP_T + 1),
                         generator=torch.Generator().manual_seed(MT_SEED))
    return {"tokens": toks[:, :-1].to(torch.int32),
            "labels": toks[:, 1:].to(torch.int32)}


def ep_layer_and_x(cfg, dev):
    """The MoE layer's weights and B 8 x T 512 tokens, drawn from one
    seed on ``dev`` (every rank and this process draw the same bits)."""
    gen = torch.Generator(device=dev).manual_seed(MT_SEED)
    layer = moe_lib.moe_init(gen, cfg, dtype=cfg.pdtype)
    x = torch.randn((EP_B, EP_T, cfg.d_model), generator=gen, device=dev)
    return layer, x.to(cfg.cdtype)


def mt_timed_steps(step, params, state, batch_of):
    """MT_STEPS steps: losses, the launches of each step, ms of each."""
    losses, per_step, ms = [], [], []
    for i in range(MT_STEPS):
        reset_train_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch_of(i))
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v for k, v in train_launches().items() if v})
    return params, state, losses, per_step, ms


def nbytes(*trees):
    return sum(a.numel() * a.element_size() for t in trees
               for a in leaves(t))


def mt_dp(mesh_spec, dev):
    """The compressed DP step of full-width mingru-lm on this rank of a
    world: its losses, launches a step, ms a step, its params against the
    one card's (the reference's trend tolerance) and the replicas' bits
    against rank 0's."""
    import torch.distributed as dist
    cfg = archs.get("mingru-lm")
    mesh = serve_mesh.MeshPlan.parse(mesh_spec).build()
    params = lm.init_params(torch.Generator(device=dev).manual_seed(MT_SEED),
                            cfg, device=dev)
    state = opt_lib.init(MT_OPT, params)
    step = ts_lib.make_dp_compressed_step(cfg, MT_OPT, mesh)
    params, state, losses, per_step, ms = mt_timed_steps(
        step, params, state, mt_batch)
    out = {"losses": losses, "per_step": per_step, "ms": ms,
           "n_params": sum(a.numel() for a in leaves(params))}
    for name in ("plain", "micro"):
        ref = torch.load(os.path.join(MT_DIR, f"dp_{name}.pt"), mmap=True)
        worst, n_bad = 0.0, 0
        with torch.no_grad():
            for path, p_ in leaves_with_path(params):
                want = ref["|".join(path)].to(dev).float()
                err = (p_.float() - want).abs()
                worst = max(worst, float(err.max()))
                n_bad += int((err > DP_ATOL + DP_RTOL * want.abs()).sum())
        out[name] = {"max_err": worst, "n_bad": n_bad}
    with torch.no_grad():
        flat = torch.cat([a.float().reshape(-1) for a in leaves(params)])
        first = flat.clone()
        dist.broadcast(first, src=0)
        out["replicas_equal"] = bool(torch.equal(first, flat))
    del params, state, flat, first
    torch.cuda.empty_cache()
    return out


def mt_ep(mesh_spec, mode, dev):
    """Expert parallelism of full-width deepseek-moe-16b's MoE on this
    rank of a world: the layer's forward at capacity factor 16 (no
    drops) in bf16 and fp32, its drops at capacity factor 1, the
    layout ``ep_2d="auto"`` takes at the published 1.25, and one
    train step of the 1 dense + 1 MoE layer model at 16: its grads
    against the one card's, the mesh's global norm, and the bytes this
    rank holds."""
    mesh = serve_mesh.MeshPlan.parse(mesh_spec).build()
    n_data = mesh.plan.data
    rows = slice(mesh.data_index * EP_B // n_data,
                 (mesh.data_index + 1) * EP_B // n_data)
    tokens = EP_B // n_data * EP_T
    published = moe_lib.ep_layout(ep_cfg(EP_PUBLISHED_CF), mesh, tokens)
    out = {"layout": {}, "auto_published": (published.ep, published.two_d)}
    for cf, dtype in ((NO_DROP_CF, "bfloat16"), (NO_DROP_CF, "float32"),
                      (EP_DROP_CF, "bfloat16")):
        cfg = ep_cfg(cf, dtype, mode)
        layout = moe_lib.ep_layout(cfg, mesh, tokens)
        out["layout"][(cf, dtype)] = (layout.ep, layout.two_d)
        layer, x = ep_layer_and_x(cfg, dev)
        specs = moe_lib.expert_placements(layer, layout)
        local = map_with_path(lambda path, a: sharding.shard_of(
            a, at(specs, path), mesh, mesh.coords), layer)
        x_loc = x[rows].contiguous()
        del layer, x
        with torch.no_grad(), moe_lib.count_drops() as drops:
            y, aux = moe_lib.moe_apply(local, cfg, x_loc, mesh=mesh)
        dropped, assigned, _ = dropped_share(drops)
        out[(cf, dtype)] = {"y": y.cpu(), "aux": float(aux),
                            "dropped": dropped, "assigned": assigned}
        del local, x_loc, y
        torch.cuda.empty_cache()
    # one train step of the cut model at capacity factor 16
    cfg = ep_cfg(NO_DROP_CF, "bfloat16", mode)
    layout = moe_lib.ep_layout(cfg, mesh, tokens)
    full = lm.init_params(torch.Generator(device=dev).manual_seed(MT_SEED),
                          cfg, device=dev)
    specs = moe_lib.expert_placements(full, layout)
    params = map_with_path(lambda path, a: sharding.shard_of(
        a, at(specs, path), mesh, mesh.coords), full)
    del full
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, grads, gnorm = ts_lib.mesh_value_and_grad(
        cfg, mesh, specs, params, ep_batch(cfg))
    torch.cuda.synchronize()
    out["grad_s"] = time.perf_counter() - t0
    ref = torch.load(os.path.join(MT_DIR, "ep_grads.pt"), mmap=True)
    worst, worst_at = 0.0, ""
    for path, g in leaves_with_path(grads):
        sp = at(specs, path)
        want = sharding.shard_of(ref["|".join(path)], sp, mesh,
                                 mesh.coords).to(dev).float()
        e = float((g.float() - want).abs().max()
                  / want.abs().max().clamp(min=1e-30))
        check(bool(torch.isfinite(g).all()), f"EP {mesh_spec} {mode}: "
              f"non-finite grad of {'/'.join(path)}")
        if e > worst:
            worst, worst_at = e, "/".join(path)
    state = opt_lib.init(MT_OPT, params)
    params, state, om = opt_lib.apply(MT_OPT, state, params, grads,
                                      grad_norm=gnorm)
    check(all(bool(torch.isfinite(a).all()) for a in leaves(params)),
          f"EP {mesh_spec} {mode}: non-finite params after the step")
    out["step"] = {"loss": float(metrics["loss"]),
                   "moe_aux": float(metrics["moe_aux"]),
                   "grad_norm": float(gnorm), "grad_rel_err": worst,
                   "worst_leaf": worst_at,
                   "bytes": (nbytes(params), nbytes(grads),
                             nbytes(state.mu, state.nu)),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del params, grads, state
    torch.cuda.empty_cache()
    return out


def mt_sp_scan(dev):
    """This rank's block of the sequence-parallel scan over the world at
    B 8 x T 4096 x D 1536, fp32, and its ms."""
    import torch.distributed as dist
    a, b, c0 = scan_ref.inputs(torch.Generator().manual_seed(MT_SEED),
                               "linear", torch.float32, SP_SHAPE, True, "cpu")
    n, r = dist.get_world_size(), dist.get_rank()
    t = SP_SHAPE[1] // n
    a, b = (v[:, r * t:(r + 1) * t].contiguous().to(dev) for v in (a, b))
    c0 = c0.to(dev)
    h = scan_lib.scan_sequence_parallel(a, b, dist.group.WORLD, h0=c0)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        scan_lib.scan_sequence_parallel(a, b, dist.group.WORLD, h0=c0)
    torch.cuda.synchronize()
    return {"h": h.cpu(), "ms": (time.perf_counter() - t0) / 3 * 1e3}


def mt_ckpt(dev):
    """The whole checkpoint of full-width mingru-lm restored as this
    rank's blocks of a 2x2 world (``params_pspecs``) on the card: each
    block against its slice of the whole, and every leaf reassembled by
    ``join_blocks`` against the whole, bit for bit."""
    mesh = serve_mesh.MeshPlan(2, 2).build()
    path = os.path.join(MT_DIR, "ckpt", f"step_{MT_STEPS:08d}")
    _, whole, wstate = ckpt_lib.restore(path, device="cpu")
    specs = sharding.params_pspecs(whole, mesh)
    step, blocks, st = ckpt_lib.restore(path, device=dev, placements=specs,
                                        mesh=mesh)
    n_leaves = n_split = 0
    ok_blocks = ok_joined = True
    held = 0
    for (wt, bt) in ((whole, blocks), (wstate.mu, st.mu),
                     (wstate.nu, st.nu)):
        for path_, w in leaves_with_path(wt):
            b, sp = at(bt, path_), at(specs, path_)
            n_leaves += 1
            n_split += tuple(b.shape) != tuple(w.shape)
            held += b.numel() * b.element_size()
            ok_blocks &= b.device.type == "cuda" and torch.equal(
                b.cpu(), sharding.shard_of(w, sp, mesh, mesh.coords))
            ok_joined &= torch.equal(
                sharding.join_blocks(b, sp, mesh).cpu(), w)
    return {"step": step, "opt_step": int(st.step), "leaves": n_leaves,
            "split": n_split, "blocks_equal": ok_blocks,
            "joined_equal": ok_joined, "held": held,
            "whole": nbytes(whole, wstate.mu, wstate.nu)}


def mt_rank(size, t_spawn):
    """One rank of a training world on the card: DP (2x1 or 2x2), EP (1x2,
    or 2x2 with ep_2d off and on), and in the 4-rank world the
    sequence-parallel scan and the checkpoint restored onto the mesh."""
    dev = serve_mesh.rank_device("cuda")
    out = {"rank": int(os.environ["RANK"]), "device": str(dev),
           "ready_s": time.time() - t_spawn}
    dp = "2x1" if size == 2 else "2x2"
    out["dp"] = mt_dp(dp, dev)
    if size == 2:
        out["ep 1x2"] = mt_ep("1x2", "on", dev)
        return out
    for mode in ("off", "on"):
        out[f"ep 2x2 {mode}"] = mt_ep("2x2", mode, dev)
    out["sp"] = mt_sp_scan(dev)
    out["ckpt"] = mt_ckpt(dev)
    return out


def mesh_train_refs(card):
    """The one card's references, written under MT_DIR for the ranks: the
    DP run of full-width mingru-lm (its params, losses, launches and ms a
    step), the whole checkpoint after it, the MoE layer's forward and
    drops, and the cut deepseek-moe-16b's grads on the whole batch."""
    shutil.rmtree(MT_DIR, ignore_errors=True)
    os.makedirs(MT_DIR)
    refs = {}
    cfg = archs.get("mingru-lm")
    # the one card's step on the whole batch, and on the data ranks' two
    # halves as microbatches (their grads accumulated in fp32)
    for name, micro in (("micro", 2), ("plain", 1)):
        params = lm.init_params(
            torch.Generator(device=DEV).manual_seed(MT_SEED), cfg,
            device=DEV)
        state = opt_lib.init(MT_OPT, params)
        step = ts_lib.make_train_step(cfg, MT_OPT, microbatches=micro)
        params, state, losses, per_step, ms = mt_timed_steps(
            step, params, state, mt_batch)
        torch.save({"|".join(p_): a.detach().cpu()
                    for p_, a in leaves_with_path(params)},
                   os.path.join(MT_DIR, f"dp_{name}.pt"))
    refs["dp"] = {"losses": losses, "per_step": per_step, "ms": ms}
    ckpt_lib.save(os.path.join(MT_DIR, "ckpt"), MT_STEPS, params, state)
    print(f"mesh train one card: mingru-lm (bf16, remat full, B {TB} x T "
          f"{TT}) {MT_STEPS} steps, losses "
          + " ".join(f"{v:.4f}" for v in losses)
          + f"; launches a step {per_step}; ms a step "
          + " ".join(f"{v:.2f}" for v in ms) + f" [{card}]")
    del params, state
    fresh_card()
    for cf, dtype in ((NO_DROP_CF, "bfloat16"), (NO_DROP_CF, "float32"),
                      (EP_DROP_CF, "bfloat16")):
        cfg = ep_cfg(cf, dtype)
        layer, x = ep_layer_and_x(cfg, DEV)
        with torch.no_grad(), moe_lib.count_drops() as drops:
            y, aux = moe_lib.moe_apply(layer, cfg, x)
        halves = []
        for i in range(2):
            with torch.no_grad(), moe_lib.count_drops() as d_:
                moe_lib.moe_apply(layer, cfg, x[i * EP_B // 2:
                                               (i + 1) * EP_B // 2])
            halves.append(dropped_share(d_)[0])
        refs[(cf, dtype)] = {"y": y.cpu(), "aux": float(aux),
                             "dropped": dropped_share(drops)[:2],
                             "halves": halves}
        del layer, x, y
        fresh_card()
    cfg = ep_cfg(NO_DROP_CF)
    params = lm.init_params(torch.Generator(device=DEV).manual_seed(MT_SEED),
                            cfg, device=DEV)
    (loss, metrics), grads = ts_lib.value_and_grad(
        ts_lib.make_loss_fn(cfg), params,
        ts_lib.batch_to(ep_batch(cfg), DEV))
    refs["ep_step"] = {"loss": float(loss),
                       "grad_norm": float(opt_lib.global_norm(grads)),
                       "bytes": nbytes(params),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    torch.save({"|".join(p_): a.detach().cpu()
                for p_, a in leaves_with_path(grads)},
               os.path.join(MT_DIR, "ep_grads.pt"))
    del params, grads
    fresh_card()
    a, b, c0 = scan_ref.inputs(torch.Generator().manual_seed(MT_SEED),
                               "linear", torch.float32, SP_SHAPE, True, DEV)
    refs["sp"] = scan_ops.linear_scan(a, b, c0).cpu()
    refs["sp_ms"] = eager_ms([lambda: scan_ops.linear_scan(a, b, c0)], 5)
    del a, b, c0
    fresh_card()
    return refs


def mesh_train_phase():
    """Training on data x model worlds of ranks that share the card (gloo,
    every rank on cuda:0): the compressed DP step of full-width mingru-lm
    at 2x1 and 2x2 against the one card (trend tolerance, replicas
    bit-equal, the one card's launches a step on every rank); expert
    parallelism of full-width deepseek-moe-16b at 1x2 and 2x2 with ep_2d
    off and on (forward against the one card in bf16 and fp32, the
    dropped share at 1.25, one train step's gathered grads); the
    sequence-parallel scan over 4 ranks against the one-card kernel; a
    whole checkpoint restored onto a 2x2 world and reassembled bit for
    bit.  Returns the launches of every rank's DP steps."""
    t_phase = time.perf_counter()
    card = card_line()
    refs = mesh_train_refs(card)
    want_step = refs["dp"]["per_step"][0]
    check(all(p_ == want_step for p_ in refs["dp"]["per_step"])
          and want_step == {"fused_mingru_kernel": 2 * 12,
                            "linear_scan_kernel": 12},
          f"one-card DP reference launches {refs['dp']['per_step']}")
    launches = {}
    for size in (2, 4):
        t0 = time.time()
        ranks = serve_mesh.run_world(mt_rank, size, (size, t0))
        up = max(r["ready_s"] for r in ranks)
        dp_spec = "2x1" if size == 2 else "2x2"
        for r in ranks:
            d = r["dp"]
            check(r["device"] == "cuda:0", f"rank on {r['device']}")
            check(d["replicas_equal"], f"DP {dp_spec}: rank {r['rank']}'s "
                  f"params differ from rank 0's")
            check(d["micro"]["n_bad"] == 0, f"DP {dp_spec} rank "
                  f"{r['rank']}: {d['micro']['n_bad']} params outside rtol "
                  f"{DP_RTOL} atol {DP_ATOL} of the one card's step on the "
                  f"same halves (max abs err {d['micro']['max_err']:.3g})")
            check(all(abs(a - b_) <= DP_LOSS for a, b_ in
                      zip(d["losses"], refs["dp"]["losses"])),
                  f"DP {dp_spec}: losses {d['losses']} against one card "
                  f"{refs['dp']['losses']}")
            check(d["per_step"] == refs["dp"]["per_step"],
                  f"DP {dp_spec} rank {r['rank']}: launches a step "
                  f"{d['per_step']} != one card's {refs['dp']['per_step']}")
            for p_ in d["per_step"]:
                merge(launches, p_)
        d0 = ranks[0]["dp"]
        print(f"mesh train DP {dp_spec} ({size} ranks, {serve_mesh.BACKEND}; "
              f"world up in {up:.1f}s): losses "
              + " ".join(f"{v:.4f}" for v in d0["losses"])
              + f" (one card "
              + " ".join(f"{v:.4f}" for v in refs["dp"]["losses"])
              + f"); params within rtol {DP_RTOL} atol {DP_ATOL} of the "
              f"one card's step on the data ranks' halves as 2 "
              f"microbatches (max abs err "
              f"{max(r['dp']['micro']['max_err'] for r in ranks):.3g}); "
              f"against the one card's whole-batch step "
              f"{d0['plain']['n_bad']} of {d0['n_params']} params outside "
              f"that tolerance (max abs err {d0['plain']['max_err']:.3g}; "
              f"not gated: an fp32 all-reduce parts the same ones, "
              f"|grad| ~1e-7 against 1e-2 in their leaf, where AdamW's "
              f"sign-like step follows the rounding); replicas "
              f"bit-equal on all {size} ranks; launches a step on every "
              f"rank {d0['per_step'][0]} == one card's; ms a step (rank 0) "
              + " ".join(f"{v:.2f}" for v in d0["ms"])
              + " against one card "
              + " ".join(f"{v:.2f}" for v in refs["dp"]["ms"])
              + f" [{card}]")
        eps = [k for k in ranks[0] if k.startswith("ep ")]
        for key in eps:
            spec, mode = key.split()[1], (key.split() + ["on"])[2]
            plan = serve_mesh.MeshPlan.parse(spec)
            for (cf, dtype), ref in ((k, v) for k, v in refs.items()
                                     if isinstance(k, tuple)):
                tol_dtype = torch.float32 if dtype == "float32" \
                    else torch.bfloat16
                for r in ranks:
                    got = r[key][(cf, dtype)]
                    check(r[key]["layout"][(cf, dtype)][0],
                          f"EP {key}: expert parallelism off")
                    # f_e counts routes alike; p_e's means part by fp32
                    # rounding alone
                    check(abs(got["aux"] - ref["aux"]) <= 1e-4
                          * abs(ref["aux"]),
                          f"EP {key} cf {cf} {dtype}: aux {got['aux']} "
                          f"against one card's {ref['aux']}")
                rows = EP_B // plan.data
                y = torch.cat([ranks[i * plan.model][key][(cf, dtype)]["y"]
                               for i in range(plan.data)])
                for r in ranks:
                    row0 = ranks[r["rank"] - r["rank"] % plan.model]
                    check(torch.equal(r[key][(cf, dtype)]["y"],
                                      row0[key][(cf, dtype)]["y"]),
                          f"EP {key}: model ranks' y differ")
                dropped = sum(r[key][(cf, dtype)]["dropped"] for r in ranks)
                want_drop = ref["dropped"][0] if plan.data == 1 \
                    else sum(ref["halves"])
                check(dropped == want_drop,
                      f"EP {key} cf {cf}: dropped {dropped} against the "
                      f"one card's {want_drop}")
                if cf == NO_DROP_CF:
                    err = max_err(y, ref["y"], tol_dtype,
                                  f"EP {key} {dtype} y against one card")
                    print(f"mesh train EP {key} cf {cf:g} {dtype}: y max abs "
                          f"err {err:.3g} against the one-card moe_apply "
                          f"(limit atol {TOL[tol_dtype][0]} rtol "
                          f"{TOL[tol_dtype][1]}), aux "
                          f"{ranks[0][key][(cf, dtype)]['aux']:.6f} against "
                          f"{ref['aux']:.6f}; layout (EP, 2D) "
                          f"{ranks[0][key]['layout'][(cf, dtype)]}")
                else:
                    check(dropped > 0, f"EP {key} cf {cf}: no drops")
                    auto = ranks[0][key]["auto_published"]
                    check(auto == (True, plan.data > 1),
                          f"EP {key}: ep_2d auto at cf {EP_PUBLISHED_CF} "
                          f"gave (EP, 2D) {auto}")
                    print(f"mesh train EP {key} cf {cf:g}: dropped "
                          f"{dropped} of {EP_B * EP_T * ep_cfg(cf).moe.top_k}"
                          f" assignments == the one card's on each data "
                          f"rank's tokens ({want_drop}; on the whole batch "
                          f"{ref['dropped'][0]}); ep_2d auto at "
                          f"{EP_B // plan.data * EP_T} tokens a rank and the "
                          f"published cf {EP_PUBLISHED_CF}: (EP, 2D) {auto}")
            st = [r[key]["step"] for r in ranks]
            worst = max(s_["grad_rel_err"] for s_ in st)
            at_leaf = max(st, key=lambda s_: s_["grad_rel_err"])["worst_leaf"]
            check(worst <= GRAD_TOL[torch.bfloat16],
                  f"EP {key}: grads {worst:.3g} of the max from the one "
                  f"card's ({at_leaf})")
            check(abs(st[0]["loss"] - refs["ep_step"]["loss"]) <= DP_LOSS,
                  f"EP {key}: loss {st[0]['loss']} against "
                  f"{refs['ep_step']['loss']}")
            held = [sum(s_["bytes"]) for s_ in st]
            print(f"mesh train EP {key} (deepseek-moe-16b, d 2048, 64 experts "
                  f"of 1408 top-6, 1 dense + 1 MoE layer, bf16, B {EP_B} x T "
                  f"{EP_T}, cf {NO_DROP_CF:g}): one train step, loss "
                  f"{st[0]['loss']:.4f} (one card "
                  f"{refs['ep_step']['loss']:.4f}), grads within "
                  f"{worst:.3g} of the max of the one card's (limit "
                  f"{GRAD_TOL[torch.bfloat16]}), global norm "
                  f"{st[0]['grad_norm']:.4f} (one card "
                  f"{refs['ep_step']['grad_norm']:.4f}); bytes a rank "
                  f"(weights, grads, AdamW moments) "
                  f"{[tuple(round(b_ / 1e9, 2) for b_ in s_['bytes'])
                      for s_ in st]}"
                  f" GB, {sum(held) / 1e9:.2f} GB on the card together "
                  f"(the whole model's weights "
                  f"{refs['ep_step']['bytes'] / 1e9:.2f} GB); peak GiB a rank "
                  f"{[round(s_['peak_gib'], 1) for s_ in st]}")
        if size == 4:
            h = torch.cat([r["sp"]["h"] for r in ranks], dim=1)
            err = max_err(h, refs["sp"], torch.float32,
                          "sequence-parallel scan against the one-card "
                          "linear_scan_kernel")
            print(f"mesh train sequence-parallel scan, B {SP_SHAPE[0]} x T "
                  f"{SP_SHAPE[1]} x D {SP_SHAPE[2]} fp32 over 4 ranks: max "
                  f"abs err {err:.3g} against the one-card "
                  f"linear_scan_kernel (limit atol {TOL[torch.float32][0]} "
                  f"rtol {TOL[torch.float32][1]}); ms a call per rank "
                  f"{[round(r['sp']['ms'], 2) for r in ranks]} against "
                  f"the kernel's {refs['sp_ms']:.3f} [{card}]")
            for r in ranks:
                c = r["ckpt"]
                check(c["blocks_equal"] and c["joined_equal"]
                      and c["step"] == MT_STEPS
                      and c["opt_step"] == MT_STEPS and c["split"] > 0,
                      f"checkpoint onto 2x2, rank {r['rank']}: {c}")
            c = ranks[0]["ckpt"]
            print(f"mesh train checkpoint: full-width mingru-lm's whole "
                  f"checkpoint (params, mu, nu: {c['leaves']} leaves, "
                  f"{c['whole'] / 1e9:.3f} GB) restored onto a 2x2 world, "
                  f"{c['split']} leaves split; every rank's blocks equal "
                  f"their slices and every leaf reassembles bit for bit "
                  f"(bytes held a rank "
                  f"{[round(r['ckpt']['held'] / 1e9, 3) for r in ranks]} GB)")
        print(f"mesh train world of {size} ranks up in {up:.1f}s [{card}]")
    shutil.rmtree(MT_DIR, ignore_errors=True)
    print(f"mesh train: launches of every rank's DP steps {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f}s")
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
    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"phase {what}: {now - clock[0]:.1f}s")
        clock[0] = now

    main_k = kernel_phase(gen)
    main_k.update(cell_kernel_phase(gen))
    lap("decode kernels")
    main_k.update(train_kernel_phase(gen))
    lap("training kernels")
    launches, (cfg, params, block_streams) = serve_phase(gen)
    lap("block-tier serving")
    launches.update(cell_serve_phase(gen, cfg, params, block_streams))
    del params
    torch.cuda.empty_cache()
    lap("cell-tier serving")
    merge(launches, gemma_phase())
    lap("gemma-2b-mingru")
    merge(launches, gemma2b_phase())
    lap("gemma-2b")
    merge(launches, prefill_phase(gen))
    lap("prefill")
    merge(launches, spec_phase(gen))
    torch.cuda.empty_cache()
    lap("speculative serving")
    merge(launches, train_phase(gen))
    torch.cuda.empty_cache()
    lap("training")
    merge(launches, mamba2_phase())
    lap("mamba2-370m")
    merge(launches, heads_phase())
    lap("task heads")
    rnn_baselines_phase()
    lap("GRU / LSTM")
    merge(launches, zamba2_phase())
    lap("zamba2-2.7b")
    merge(launches, deepseek_phase())
    lap("deepseek-moe-16b")
    merge(launches, starcoder2_phase())
    lap("starcoder2-15b")
    merge(launches, pixtral_phase())
    lap("pixtral-12b")
    merge(launches, deepseek67_phase())
    lap("deepseek-67b")
    merge(launches, whisper_phase())
    lap("whisper-base")
    merge(launches, deepseek_v3_phase())
    lap("deepseek-v3-671b")
    rgen = torch.Generator().manual_seed(21)
    robust, (cfg, params) = robustness_phase(rgen)
    merge(launches, robust)
    lap("faults")
    merge(launches, recovery_phase(cfg, params))
    del params
    lap("recovery")
    merge(launches, tuning_phase(rgen))
    shutil.rmtree(SCRATCH, ignore_errors=True)
    lap("tuning")
    merge(launches, mesh_phase())
    lap("mesh serving")
    merge(launches, mesh_train_phase())
    lap("mesh training")

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
