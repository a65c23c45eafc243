"""GPU smoke run of the PyTorch port: builds the CUDA kernels from source,
holds each against its plain PyTorch version at full model width, then
serves full-width mingru-lm (and a short minlstm-lm run) through the
port's ServingEngine and checks that every layer of every device round
went through the kernels.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failed check exits non-zero before the result line):
  1. the card's name and power limit; kernel build time;
  2. kernels at mingru-lm widths (Dx 768, Dh 1536, Dm 3072, K 4), B = 8,
     C = 8, both cells, fp32 and bf16: kernel vs plain version, chunk ==
     C steps bit for bit, a row independent of B, kernel / plain times
     and the bound;
  3. serving: full-width mingru-lm (bf16, seeded init), 8 slots, 8 byte
     prompts, 32 new tokens, K = 4, C in {1, 8}: greedy streams equal
     across C and to ``generate_one``, launches == layers x rounds;
     then a short full-width minlstm-lm run; then, outside the counted
     main path, decoded tok/s over 5 windows per C (min / median / max)
     and the cost of sampled requests;
  4. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script "
          "needs an NVIDIA GPU", file=sys.stderr)
    sys.exit(1)

from repro_torch.configs import archs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.block_step import ops, ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving.engine import ServingEngine, generate_one  # noqa

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
GATES = {"mingru": ("wz", "wh"), "minlstm": ("wf", "wi", "wh")}
REPLACES = {"block_step_kernel": "src/repro/kernels/block_step/kernel.py:298",
            "block_chunk_kernel": "src/repro/kernels/block_step/kernel.py:349"}


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
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got - want).abs()
    atol, rtol = TOL[dtype]
    bad = err > atol + rtol * want.abs()
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} elements outside atol {atol} rtol "
          f"{rtol} (max abs err {float(err.max()):.3g})")
    return float(err.max())


def time_ms(fns, iters):
    """Device time per call over ``iters`` calls, rotating over ``fns``
    (separate weight sets, together larger than the 50 MB L2, so each
    call streams its weights from HBM as a 12-layer stack does)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def kernel_phase(gen):
    rows, traces = [], []
    main = {}
    valid = torch.tensor([8, 1, 3, 8, 5, 2, 8, 7], dtype=torch.int32,
                         device=DEV)
    full = torch.full((B,), C, dtype=torch.int32, device=DEV)
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

            # chunk == C step launches, bit for bit; frozen rows too
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
            # a row's result does not depend on B
            y3, s3 = ops.fused_block_step(
                sets[0], x[:3, 0].contiguous(),
                {k: v[:3].contiguous() for k, v in st.items()},
                compute_dtype=dtype, **kw)
            check(torch.equal(y3, y[:3]) and torch.equal(s3["h"], s1["h"][:3]),
                  f"{tag}: rows changed with the batch size")

            # times: kernel (raw launches), plain version, bound
            step_l = [ops.prepare_launch(b, xs[0][:, None], st, None,
                                         mode="log")[0] for b in bound]
            chunk_l = [ops.prepare_launch(b, x, st, valid, mode="log")[0]
                       for b in bound]
            t_step = time_ms([raw(f) for f in step_l], 200)
            t_chunk = time_ms([raw(f) for f in chunk_l], 100)
            # the wrapper as the engine calls it: weights bound once
            t_step_wrap = time_ms([lambda p=p, b=b: ops.fused_block_step(
                p, xs[0], st, compute_dtype=dtype, operands=b, **kw)
                for p, b in zip(sets, bound)], 100)
            t_step_plain = time_ms([lambda k_=k_: ref.block_step_ref(
                k_, xs[0], st, compute_dtype=dtype, **kw) for k_ in kp], 50)
            t_chunk_plain = time_ms([lambda k_=k_: ref.block_chunk_ref(
                k_, x, st, valid, compute_dtype=dtype, **kw) for k_ in kp], 20)
            phases = {"step": traced_phases(bound, xs[0][:, None], st, None),
                      "chunk": traced_phases(bound, x, st, valid)}
            b_step = bound_ms(cell, dtype, B, 1)
            b_chunk = bound_ms(cell, dtype, B, C)
            rows.append((tag, step_l[0].grid.value, t_step, t_step_wrap,
                         t_step_plain, b_step[0], e_step, t_chunk,
                         t_chunk_plain, b_chunk[0], e_chunk))
            traces.append((tag, phases))
            if cell == "mingru" and dtype == torch.bfloat16:
                main = {"block_step_kernel": (e_step, t_step, t_step_plain,
                                              b_step),
                        "block_chunk_kernel": (e_chunk, t_chunk,
                                               t_chunk_plain, b_chunk)}
            del sets, kp, bound, step_l, chunk_l
            torch.cuda.empty_cache()
    print(f"kernels at Dx {DX} Dh {DH} Dm {DM} K {K}, B {B}, chunk C {C} "
          f"(ms per launch; weights rotate over 4 sets, > L2):")
    print("  cell/dtype      grid  step_ms  step_wrapper_ms  step_plain_ms "
          " step_bound_ms  step_err  chunk_ms  chunk_plain_ms  "
          "chunk_bound_ms  chunk_err")
    for r in rows:
        print("  {:<15} {:>4}  {:.5f}  {:.5f}  {:.5f}  {:.5f}  {:.3g}  "
              "{:.5f}  {:.5f}  {:.5f}  {:.3g}".format(*r))
    print("phase times per launch (us, block 0's %globaltimer; sync_X = "
          "wait at the barrier after phase X):")
    for tag, phases in traces:
        for form, ph in phases.items():
            print(f"  {tag:<15} {form:<5} total {sum(ph.values()):8.2f}  "
                  + "  ".join(f"{k_} {v:7.2f}" for k_, v in ph.items()))
    return main


# ---------------------------------------------------------------------------
# 3. serving
# ---------------------------------------------------------------------------

PROMPTS = ["To be, o", "Friends,", "Now is t", "What's i", "O Romeo,",
           "All the ", "Tomorrow", "Double, "]


def serve(cfg, params, chunk, prompts, max_new, k=4, label="serve",
          quiet=False, **submit_kw):
    """One closed batch through a fresh engine; returns the streams (and
    the decoded tok/s with ``quiet``, which prints nothing)."""
    eng = ServingEngine(cfg, params, max_batch=8, max_len=128, seed=0,
                        decode_block=k, prompt_chunk=chunk, device=DEV)
    before = dict(ops.LAUNCHES)
    rids = [eng.submit(list(p.encode()), max_new=max_new, **submit_kw)
            for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.run_to_completion()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = sum(ops.LAUNCHES[n] - before[n] for n in ops.LAUNCHES)
    rounds = eng.stats.decode_steps
    check(launched == cfg.n_layers * rounds,
          f"{cfg.name} C={chunk}: {launched} kernel launches for "
          f"{cfg.n_layers} layers x {rounds} rounds")
    check(eng.stats.completed == len(prompts)
          and eng.stats.shard_identities_ok(),
          f"{cfg.name} C={chunk}: engine stats {eng.stats.snapshot()}")
    snap = eng.stats.snapshot()
    n_tok = snap["decode_tokens"]
    streams = [tuple(outs[r]) for r in rids]
    if quiet:
        return streams, n_tok / dt
    print(f"{label} {cfg.name} K={k} C={chunk}: {n_tok} tokens in {dt:.3f}s "
          f"({n_tok / dt:.1f} decoded tok/s, "
          f"{snap['tokens_per_second']:.1f} tok/s incl. prompt), "
          f"{rounds} rounds, {snap['decode_calls']} host round-trips, "
          f"{launched} kernel launches, ttft mean "
          f"{snap['ttft_s_mean'] * 1e3:.2f} ms, itl mean "
          f"{snap['itl_s_mean'] * 1e3:.2f} ms")
    print("  engine stats: " + ", ".join(
        f"{k_}={v:.4g}" if isinstance(v, float) else f"{k_}={v}"
        for k_, v in sorted(snap.items()) if k_ != "shards"))
    return streams


def rate_spread(cfg, params, reps=5):
    """Decoded tok/s over ``reps`` windows of the serving traffic per C:
    min / median / max, since one window of 8 requests is short and the
    host clock varies."""
    for c in (1, 8):
        rates = sorted(serve(cfg, params, c, PROMPTS, 32, quiet=True)[1]
                       for _ in range(reps))
        print(f"rate {cfg.name} K=4 C={c}, {reps} windows of 8 requests x "
              f"32 tokens: decoded tok/s min {rates[0]:.1f} median "
              f"{rates[reps // 2]:.1f} max {rates[-1]:.1f}")


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
    greedy = serve(cfg, params, 1, PROMPTS, 32, quiet=True)[1]
    print(f"sampled {cfg.name} K=4 C=1 (T 0.8, top-k 40, top-p 0.95): host "
          f"key catch-up + Gumbel table {host_ms:.3f} ms per superstep; "
          f"decoded tok/s {runs[0][1]:.1f} / {runs[1][1]:.1f} sampled "
          f"against {greedy:.1f} greedy; seeded streams repeat")


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
    ops.reset_launches()
    streams = {c: serve(cfg, params, c, PROMPTS, 32) for c in (1, 8)}
    lstm_cfg = archs.get("minlstm-lm")
    lstm_params = lm.init_params(gen, lstm_cfg, device=DEV)
    lstm_streams = serve(lstm_cfg, lstm_params, 8, PROMPTS[:4], 8)
    launches = dict(ops.LAUNCHES)
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
    return launches


def main():
    t_start = time.perf_counter()
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all([ops.SOURCE])
    print(f"built {ops.SOURCE.name} in {time.perf_counter() - t0:.1f}s")
    print(build.ptxas_log(ops.SOURCE).strip())

    gen = torch.Generator().manual_seed(0)
    main_k = kernel_phase(gen)
    launches = serve_phase(gen)

    entries = []
    for name in ("block_step_kernel", "block_chunk_kernel"):
        err, t_k, t_p, (b_ms, b_by) = main_k[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/block_step/csrc/block_step.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": t_k, "kernel_ms": t_k,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
