"""A/B of two trees' serving engines on the cell-fused tier, in turns.

    PYTHONPATH=src python3 -m repro_torch.serving.ab OLD_TREE \\
        [--new TREE] [--rounds 2] [--windows 3]

OLD_TREE and NEW (by default this checkout) are repository roots, e.g. a
``git archive`` of another commit.  Each round runs old, new, new, old,
every run a fresh process with that tree's ``src`` on its path, all in
one call on one card.  A run serves full-width mingru-lm (bf16, weights
seeded) on the cell-fused tier (``fuse_block="off"``) through the plain
(non-speculative) engine: 8 slots, K 4, C 8, 32 new tokens, two
traffics: 8 prompts of 8 bytes (``chip_smoke.py``'s serving prompts) and
8 prompts of 49 tokens (a byte of their own and a seeded 16-byte phrase
three times: the speculative traffic).  It warms up, then serves
``windows`` windows of each traffic.  Prints the card and its power
limit, then per tree and traffic the decoded tok/s over all windows (min
/ median / max) and the mean TTFT, and whether the trees' greedy streams
agree.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
PROMPTS = ["To be, o", "Friends,", "Now is t", "What's i", "O Romeo,",
           "All the ", "Tomorrow", "Double, "]


def _worker(windows: int) -> None:
    """One tree's run; prints one JSON line."""
    import time

    import torch

    from repro_torch.configs import archs
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServingEngine

    dev = torch.device("cuda")
    cfg = archs.get("mingru-lm").replace(fuse_block="off")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device=dev)
    phrase = torch.randint(32, 127, (16,), generator=torch.Generator()
                           .manual_seed(1)).tolist()
    traffics = {"bytes8": [list(p.encode()) for p in PROMPTS],
                "phrase49": [[65 + i] + phrase * 3 for i in range(8)]}

    def window(prompts, max_new):
        eng = ServingEngine(cfg, params, max_batch=8, max_len=128, seed=0,
                            decode_block=4, prompt_chunk=8, device=dev)
        rids = [eng.submit(p, max_new=max_new) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.run_to_completion()
        torch.cuda.synchronize()
        snap = eng.stats.snapshot()
        return ([list(outs[r]) for r in rids],
                snap["decode_tokens"] / (time.perf_counter() - t0),
                snap["ttft_s_mean"] * 1e3)

    for prompts in traffics.values():
        window(prompts, 4)
    out = {name: {"rates": [], "ttft_ms": []} for name in traffics}
    for _ in range(windows):
        for name, prompts in traffics.items():
            streams, rate, ttft = window(prompts, 32)
            out[name]["rates"].append(rate)
            out[name]["ttft_ms"].append(ttft)
            out[name]["streams"] = streams
    print(json.dumps(out))


def _run(tree: Path, windows: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    proc = subprocess.run([sys.executable, __file__, "--worker",
                           "--windows", str(windows)], env=env,
                          capture_output=True, text=True, cwd=tree)
    if proc.returncode != 0:
        raise SystemExit(f"the run of {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", type=Path, nargs="?")
    ap.add_argument("--new", type=Path, default=ROOT)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--worker", action="store_true")
    a = ap.parse_args(argv)
    if a.worker:
        _worker(a.windows)
        return
    if a.old is None:
        ap.error("OLD_TREE is required")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("serving/ab.py needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    trees = {"old": a.old.resolve(), "new": a.new.resolve()}
    runs = {"old": [], "new": []}
    for _ in range(a.rounds):
        for name in ("old", "new", "new", "old"):
            runs[name].append(_run(trees[name], a.windows))
    for traffic in runs["old"][0]:
        for name in ("old", "new"):
            rates = sorted(r for run in runs[name]
                           for r in run[traffic]["rates"])
            ttft = statistics.mean(t for run in runs[name]
                                   for t in run[traffic]["ttft_ms"])
            print(f"{name} {traffic} cell tier C 8: decoded tok/s over "
                  f"{len(rates)} windows min {rates[0]:.1f} median "
                  f"{statistics.median(rates):.1f} max {rates[-1]:.1f}; "
                  f"ttft mean {ttft:.2f} ms ({trees[name]})")
        same = runs["old"][0][traffic]["streams"] == \
            runs["new"][0][traffic]["streams"]
        print(f"{traffic}: greedy streams of the two trees "
              f"{'equal' if same else 'differ'}")


if __name__ == "__main__":
    main()
