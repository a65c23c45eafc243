"""Continuous-batching serving demo on the PyTorch port: the engine
superstep.  The port's counterpart of ``examples/serve_batched.py``.

Multiple requests of different lengths share one fixed-capacity batch.
Prompt consumption, decode, sampling, EOS retirement and re-admission
from per-slot staging buffers all happen inside one device loop
(``lm.superstep``) of ``--decode-block K`` rounds per host round-trip;
on the card every layer of every round is one whole-block CUDA kernel
launch.  A long prompt occupies one row while every other row keeps
decoding: there is no prefill phase and no barrier.

    PYTHONPATH=src python examples/torch_serve_batched.py --decode-block 4

``--trace N`` replays a synthetic N-request arrival trace instead of the
fixed prompt list (mid-flight submissions, per-request TTFT).
``--chaos`` arms the deterministic fault injector (NaN state corruption,
dropped staging uploads, stragglers); every request still reaches a
terminal status.  ``--snapshot-dir DIR`` journals and snapshots the
engine; after a kill, ``--restore DIR`` resumes it bit-identically.

``--mesh DxM`` serves on a world of D*M ranks, one process each
(``distributed/serve_mesh.py``, gloo): the slot pool over D data shards,
the minRNN projections over M model ranks; every rank on ``cuda:0`` on
one card, or on the CPU with ``--device cpu``.  Rank 0 prints.

    PYTHONPATH=src python examples/torch_serve_batched.py --trace 12 \\
        --mesh 2x1 --device cpu

The examples run on the card unless given ``--device cpu``.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import archs
from repro_torch.data.lm_corpus import decode_bytes
from repro_torch.distributed import serve_mesh
from repro_torch.models import lm
from repro_torch.serving.engine import ServingEngine, replay_trace
from repro_torch.serving.faults import FaultInjector


def run_fixed(engine, max_new):
    prompts = [b"To be, or not to be", b"Now is the winter",
               b"Friends, Romans, countrymen", b"All the world's a stage",
               b"If music be the food of love", b"Once more unto the breach",
               b"O for a Muse of fire, that would ascend the brightest "
               b"heaven of invention"]        # long prompt: prefills in-loop
    for i, p in enumerate(prompts):           # 7 requests, 4 slots: queueing
        # mix of greedy and sampled requests in the same superstep batch
        engine.submit(list(p), max_new=max_new,
                      temperature=0.0 if i % 2 == 0 else 0.8,
                      top_k=0 if i % 2 == 0 else 40, top_p=0.95)
    t0 = time.time()
    outs = engine.run_to_completion()
    dt = time.time() - t0
    return outs, dt, [f"req {rid}: {decode_bytes(outs[rid])!r}"
                      for rid in sorted(outs)]


def run_trace(engine, n_requests, max_new=None, seed=0):
    """Replay a synthetic arrival trace: request i becomes visible once
    the engine has advanced past its arrival round, so admissions happen
    mid-flight (staged between supersteps, armed in-loop)."""
    rng = np.random.default_rng(seed)
    trace = [dict(arrival=int(rng.integers(0, 6 * n_requests)),
                  prompt=[int(t) for t in
                          rng.integers(1, 250, size=int(rng.integers(3, 17)))],
                  max_new=int(rng.integers(8, 25)))
             for _ in range(n_requests)]
    if max_new is not None:
        for r in trace:
            r["max_new"] = min(r["max_new"], max_new)
    trace.sort(key=lambda r: r["arrival"])
    t0 = time.time()
    replay_trace(engine, trace,
                 lambda i, r: engine.submit(r["prompt"],
                                            max_new=r["max_new"],
                                            temperature=0.8, top_k=40,
                                            top_p=0.95))
    dt = time.time() - t0
    lines = [f"req {rid}: arrived@{req.submit_round} "
             f"ttft={req.first_round - req.submit_round + 1} rounds, "
             f"{len(req.out)} tokens"
             for rid, req in sorted(engine.finished.items())]
    return {r: q.out for r, q in engine.finished.items()}, dt, lines


def serve(args, mesh=None):
    """The demo on one device, or as one rank of ``mesh``'s world (a
    ``MeshPlan``); rank 0 prints."""
    device = torch.device(args.device) if mesh is None else \
        serve_mesh.rank_device(args.device)
    cfg = archs.smoke("mingru-lm")
    params = lm.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device=device)
    lines = []
    faults = None
    if args.restore:
        engine = ServingEngine.restore(args.restore, cfg, params,
                                       device=device)
        rep = engine.recovery_report
        lines.append(f"restored from {args.restore}: snapshot "
                     f"@{rep['snapshot_round']}, replayed "
                     f"{rep['replayed_records']} journal records "
                     f"({rep['replayed_rounds']} rounds) in "
                     f"{rep['recovery_s']:.2f}s")
        t0 = time.time()
        outs = engine.run_to_completion()
        dt = time.time() - t0
        lines += [f"req {rid}: {len(outs[rid])} tokens"
                  for rid in sorted(outs)]
    else:
        if args.chaos:
            faults = FaultInjector(seed=2, nan_rate=0.01, drop_rate=0.05,
                                   straggler_rate=0.05, straggler_s=0.002)
        engine = ServingEngine(cfg, params, max_batch=4, max_len=256,
                               decode_block=args.decode_block,
                               prompt_chunk=args.prompt_chunk,
                               speculative=args.speculative,
                               draft_len=args.draft_len,
                               faults=faults, max_retries=2, mesh=mesh,
                               fuse_block=args.fuse_block,
                               tune=args.tune_file,
                               recover_dir=args.snapshot_dir,
                               snapshot_every=args.snapshot_every,
                               device=device)
        if args.trace:
            outs, dt, more = run_trace(engine, args.trace, args.max_new)
        else:
            outs, dt, more = run_fixed(engine, args.max_new or 16)
        lines += more
    if mesh is not None and mesh.size > 1 and \
            int(torch.distributed.get_rank()) != 0:
        return None
    n = sum(len(o) for o in outs.values())
    snap = engine.stats.snapshot()
    plan = engine.tune_plan
    lines.append(f"{len(outs)} requests, {n} tokens, {n / dt:.1f} tok/s")
    lines.append(f"kernel tier: {engine.kernel_tier} "
                 f"(fuse_block={args.fuse_block}"
                 + (f", plan {plan.get('source', '<dict>')}" if plan else "")
                 + f", device {device})")
    lines.append(
        f"prefill tokens (in-loop): {snap['prefill_tokens']} "
        f"over {snap['prefill_rounds']} rounds (C={engine.prompt_chunk}), "
        f"decode rounds: {snap['decode_steps']} in "
        f"{snap['decode_calls']} host round-trips "
        f"(K={engine.decode_block}, "
        f"{snap['host_roundtrips_per_decode_token']:.2f} round-trips/token), "
        f"wasted slot steps: {snap['wasted_slot_steps']} "
        f"({snap['wasted_slot_fraction']:.1%}), "
        f"queue peak: {snap['queue_peak']}")
    lines.append(f"ttft mean: {snap['ttft_rounds_mean']:.1f} rounds "
                 f"({snap['ttft_s_mean'] * 1e3:.1f}ms), "
                 f"inter-token: {snap['itl_s_mean'] * 1e3:.1f}ms "
                 f"({snap['itl_rounds_mean']:.2f} rounds/token)")
    if mesh is not None:
        per = " | ".join(
            f"shard {i}: {s['decode_tokens']} tok, "
            f"{s['wasted_slot_steps']} wasted"
            for i, s in enumerate(snap["shards"]))
        lines.append(f"mesh {mesh} ({serve_mesh.BACKEND}): {per} "
                     f"(identities ok: {snap['shard_identities_ok']})")
    if faults is not None:
        lines.append(f"chaos: injected {faults.counts()} -> "
                     f"{snap['completed']}/{snap['submitted']} completed, "
                     f"quarantined {snap['quarantined']}, "
                     f"retried {snap['retried']}, failed {snap['failed']} "
                     f"(every request terminal)")
    print("\n".join(lines), flush=True)
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--decode-block", type=int, default=None,
                    help="device rounds per host round-trip (K); default "
                         "4, or the --tune-file plan's K when one loads")
    ap.add_argument("--prompt-chunk", type=int, default=None,
                    help="prompt tokens a prefilling slot consumes per "
                         "device round (C; default 1, or the plan's C)")
    ap.add_argument("--fuse-block", default="auto",
                    choices=["auto", "on", "off"],
                    help="whole-block decode kernel (kernels/block_step): "
                         "one launch per layer per round; 'off' keeps the "
                         "cell-only kernel tier")
    ap.add_argument("--tune-file", default=None, metavar="PATH|auto",
                    help="autotune plan of this device: a TUNE_*.json path "
                         "or 'auto'; fills the K / C defaults")
    ap.add_argument("--trace", type=int, default=0, metavar="N",
                    help="replay a synthetic N-request arrival trace "
                         "instead of the fixed prompt list")
    ap.add_argument("--max-new", type=int, default=None,
                    help="new tokens per fixed prompt (default 16); caps "
                         "the trace's draws")
    ap.add_argument("--speculative", default=None, choices=["ngram"],
                    help="speculative decoding: n-gram self-drafts "
                         "verified in one chunk pass per round")
    ap.add_argument("--draft-len", type=int, default=4,
                    help="max draft tokens proposed per round (S)")
    ap.add_argument("--chaos", action="store_true",
                    help="inject deterministic faults and watch every "
                         "request reach a terminal status")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="arm crash recovery: write-ahead journal + "
                         "periodic engine snapshots under DIR")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="device rounds between snapshots (default 8)")
    ap.add_argument("--restore", default=None, metavar="DIR",
                    help="resume a crashed run from DIR")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serving mesh, e.g. 2x1 (slot pool over 2 data "
                         "shards) or 2x2 (+ d_hidden over 2 model ranks): "
                         "one process per rank")
    args = ap.parse_args(argv)
    if args.tune_file is None and args.decode_block is None:
        args.decode_block = 4           # the untuned demo default
    plan = serve_mesh.MeshPlan.parse(args.mesh)
    if plan is None or plan.size == 1:
        serve(args, plan)
        return
    serve_mesh.run_world(serve, plan.size, (args, plan))


if __name__ == "__main__":
    main()
