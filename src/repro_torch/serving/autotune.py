"""Decode-path autotuner: sweep the serving knobs on one device, persist
the winner as a tune plan (``serving/tuning.py``).

    python -m repro_torch.serving.autotune --arch mingru-lm
    python -m repro_torch.serving.autotune --arch minlstm-lm --points 2 \\
        --out-dir /tmp/plans
    python -m repro_torch.serving.autotune --smoke --device cpu --points 2

The counterpart of ``benchmarks/autotune.py`` with wall-clock scoring
only.  Grid: ``fuse_block`` in {on, off} x prompt chunk C in
{1, 4, 8, 16} x decode block K in {1, 4, 8, 16, 32}, tier-major, then K,
then C as 16, 1, 8, 4, so that a run truncated with ``--points N``
still sets a packed point beside an unpacked one.  Each point replays
one seeded mixed arrival trace (``make_trace``: 48 requests, batch 8,
arrival rate 2.0 x service capacity, greedy) on the real
``ServingEngine`` through ``replay_trace``: one warm-up replay, then 3
scored replays, each on a fresh engine; the score is the median decoded
tokens/s (``EngineStats.decode_tokens_per_second``: decoded tokens over
the synchronised superstep time).

Greedy streams are the engine's contract across C and K: every scored
replay of every point must give the streams of the first point of its
tier, and the sweep aborts naming the first diverging request
otherwise.  Across tiers the streams are compared and recorded, not
required: the block kernel and the cell tier's kernel + library products
round bf16 differently (their first-round logits agree to the bf16
tolerance; a greedy tie can flip a token).

The plan (``TUNE_<name>_L<n>_d<d>_<device slug>.json``, by
``tuning.save_plan``) records the sweep, the winner, the device's name
and, on a CUDA device, the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import archs
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving import tuning
from repro_torch.serving.engine import ServingEngine, replay_trace

TIERS = ("on", "off")
CHUNKS = (16, 1, 8, 4)
KS = (1, 4, 8, 16, 32)
WARMUP, REPS = 1, 3
BATCH, RATE, MAX_LEN = 8, 2.0, 160


def make_trace(n: int, batch: int, seed: int = 0, rate: float = 2.0):
    """Heavy mixed traffic (a copy of ``benchmarks.engine_throughput.
    make_trace``): staggered arrivals at ``rate`` x service capacity,
    log-normal prompt lengths in [3, 48], 12-32 new tokens.  Arrival
    times are in device rounds."""
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(mean=1.8, sigma=0.7, size=n), 3, 48
                   ).astype(int)
    news = rng.integers(12, 33, size=n)
    gaps = rng.exponential(scale=float(news.mean()) / (batch * rate),
                           size=n)
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    return [dict(arrival=int(a), prompt_len=int(l), max_new=int(m))
            for a, l, m in zip(arrivals, lens, news)]


def trace_prompt(i: int, n: int) -> List[int]:
    """Request ``i``'s seeded prompt of ``n`` byte ids."""
    return [int(t) for t in np.random.default_rng(i).integers(1, 250,
                                                              size=n)]


def grid():
    return [(fb, c, k) for fb in TIERS for k in KS for c in CHUNKS]


def card_line() -> Optional[str]:
    """The card's ``name, power limit`` from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def replay(cfg, params, trace, fuse_block: str, chunk: int, k: int,
           device):
    """One replay of ``trace`` on a fresh engine; returns (decoded
    tokens/s, greedy streams by trace index)."""
    eng = ServingEngine(cfg, params, max_batch=BATCH, max_len=MAX_LEN,
                        decode_block=k, prompt_chunk=chunk,
                        fuse_block=fuse_block, device=device)
    rids = []
    replay_trace(eng, trace, lambda i, r: rids.append(eng.submit(
        trace_prompt(i, r["prompt_len"]), max_new=r["max_new"])))
    if eng.stats.completed != len(trace):
        raise SystemExit(f"autotune: {eng.stats.completed} of "
                         f"{len(trace)} requests completed at "
                         f"fuse_block={fuse_block} C={chunk} K={k}")
    return (eng.stats.decode_tokens_per_second(),
            [list(eng.finished[r].out) for r in rids])


def first_divergence(a, b):
    """(request, position) of the first differing token, or None."""
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            pos = next((i for i, (s, t) in enumerate(zip(x, y)) if s != t),
                       min(len(x), len(y)))
            return j, pos
    return None


def sweep(arch: str, *, smoke: bool = False, device="cuda",
          n_requests: int = 48, points: int = 0, out_dir=None,
          log=print) -> Dict:
    """Score the grid (or its first ``points``) and return the plan,
    written to ``out_dir`` when one is given."""
    dev = resolve_device(device)
    cfg = archs.smoke(arch) if smoke else archs.get(arch)
    full = grid()
    pts = full[:max(1, int(points))] if points else full
    trace = make_trace(n_requests, BATCH, rate=RATE)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(gen, cfg, device=dev)
    name = tuning.device_name(dev)
    card = card_line() if dev.type == "cuda" else None
    log(f"autotune {arch} ({tuning.fingerprint(cfg)}) on {name}"
        + (f" [{card}]" if card else "") + f": {len(pts)}/{len(full)} "
        f"points, {n_requests} requests, batch {BATCH}, rate {RATE}")

    scored: List[Dict] = []
    first: Dict[str, List] = {}     # the first point's streams, per tier
    t0 = time.perf_counter()
    for fb, c, k in pts:
        for _ in range(WARMUP):
            replay(cfg, params, trace, fb, c, k, dev)
        rates = []
        for _ in range(REPS):
            tps, streams = replay(cfg, params, trace, fb, c, k, dev)
            ref = first.setdefault(fb, streams)
            bad = first_divergence(streams, ref)
            if bad is not None:
                raise SystemExit(
                    f"autotune: greedy streams diverge at fuse_block={fb} "
                    f"C={c} K={k} from the tier's first point: request "
                    f"{bad[0]}, token {bad[1]}")
            rates.append(tps)
        med = statistics.median(rates)
        scored.append({"fuse_block": fb, "prompt_chunk": c,
                       "decode_block": k, "decode_tokens_per_s": med,
                       "decode_tokens_per_s_reps": rates})
        log(f"  fuse_block={fb} C={c:2d} K={k:2d}: {med:10.1f} decoded "
            f"tok/s (median of {REPS}: "
            + ", ".join(f"{r:.1f}" for r in rates) + ")")
    best = max(scored, key=lambda r: r["decode_tokens_per_s"])
    cross = None
    if len(first) == 2:
        a, b = first["on"], first["off"]
        cross = sum(x == y for x, y in zip(a, b))
    plan = {
        "config": tuning.config_stamp(cfg, dev),
        "arch": arch,
        "fuse_block": best["fuse_block"],
        "prompt_chunk": best["prompt_chunk"],
        "decode_block": best["decode_block"],
        "score_decode_tokens_per_s": best["decode_tokens_per_s"],
        "mode": "wallclock",
        "device": name,
        "card": card,
        "batch": BATCH,
        "n_requests": n_requests,
        "rate": RATE,
        "warmup_replays": WARMUP,
        "scored_replays": REPS,
        "points_scored": len(pts),
        "grid_total": len(full),
        "streams_identical_within_tier": True,
        "streams_equal_across_tiers": cross,
        "sweep_s": time.perf_counter() - t0,
        "sweep": scored,
    }
    log(f"  best: fuse_block={best['fuse_block']} "
        f"C={best['prompt_chunk']} K={best['decode_block']}: "
        f"{best['decode_tokens_per_s']:.1f} decoded tok/s"
        + ("" if cross is None else
           f"; greedy streams equal across tiers for {cross} of "
           f"{n_requests} requests"))
    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / tuning.tune_filename(cfg, dev)
        tuning.save_plan(path, plan)
        plan["path"] = str(path)
        log(f"wrote {path}")
    return plan


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mingru-lm",
                    choices=["mingru-lm", "minlstm-lm"])
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke-width config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=0,
                    help="score only the first N grid points (0 = all)")
    ap.add_argument("--n-requests", type=int, default=48)
    ap.add_argument("--out-dir", default=str(tuning._REPO_ROOT),
                    help="directory for the plan (default: the repo "
                         "root, where 'auto' finds it last)")
    args = ap.parse_args(argv)
    if args.n_requests < 1:
        raise SystemExit("--n-requests must be >= 1")
    sweep(args.arch, smoke=args.smoke, device=args.device,
          points=args.points, n_requests=args.n_requests,
          out_dir=args.out_dir)


if __name__ == "__main__":
    main()
