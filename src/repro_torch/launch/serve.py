"""Batched serving driver (PyTorch port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mingru-lm \
        --device cuda --prompts "To be" "Friends," --decode-block 4

Serves the given prompts from a seeded random init through the
continuous-batching superstep engine: one whole-block CUDA kernel launch
per layer per device round, or with ``--fuse-block off`` (and always for
``--arch gemma-2b-mingru``) one cell-only kernel launch per layer per
round between PyTorch norms, projections and MLPs; ``--arch gemma-2b``,
``mamba2-370m``, ``zamba2-2.7b`` and ``deepseek-moe-16b`` serve in
PyTorch ops (C 1 only).  Prints the
completions, the kernel tier, the superstep / latency lines and the
engine stats snapshot.  ``--device cpu`` runs the plain PyTorch versions
of the kernels.  On the card the weights are drawn there, from the
seed.

``--speculative ngram --draft-len S`` serves with n-gram self-drafting:
decoding rows propose up to S tokens a round, verified in one chunk pass
per layer (streams unchanged).  ``--prefill`` runs the prompts through
``lm.prefill`` instead (one parallel pass, right-padded, one fused-cell
kernel launch per layer), then greedy ``decode_step`` rounds, and prints
the prefill time.

``--tune-file PATH|auto|none`` serves under an autotuned plan measured on
this device (``serving/tuning.py``): it fills K, C and the decode tier
where the flags leave them open.  ``--snapshot-dir DIR`` arms crash
recovery (a write-ahead journal and a snapshot every
``--snapshot-every`` rounds); ``--restore DIR`` resumes a killed run from
DIR bit-identically, given the same weights: the same ``--seed``, or the
training checkpoint in ``--ckpt-dir``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import archs
from repro_torch.data.lm_corpus import decode_bytes
from repro_torch.models import lm
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import checkpoint as ckpt_lib


def prefill_and_decode(cfg, params, prompts, max_new: int, max_len: int,
                       device):
    """The prompts right-padded into one ``lm.prefill``, then greedy
    ``decode_step`` rounds for the whole batch.  Returns the streams and
    the prefill's seconds (synchronised)."""
    lens = [len(p) for p in prompts]
    toks = torch.zeros((len(prompts), max(lens)), dtype=torch.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = torch.tensor(p, dtype=torch.int32)
    toks = toks.to(device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    layers = lm.bind_layers(params, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, cfg, toks, max_len, lengths=lengths)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_prefill = time.perf_counter() - t0
    outs = [logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)]
    for _ in range(max_new - 1):
        logits, cache = lm.decode_step(params, cfg, outs[-1], cache,
                                       layers=layers)
        outs.append(logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32))
    return torch.stack(outs, dim=1).tolist(), t_prefill


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mingru-lm", choices=archs.all_names())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the newest good training checkpoint in "
                         "this directory instead of the seeded init")
    ap.add_argument("--prompts", nargs="*",
                    default=["To be, or not to be", "Friends, Romans"])
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--decode-block", type=int, default=None,
                    help="device rounds per host round-trip (K; default: "
                         "the --tune-file plan's K, else 1)")
    ap.add_argument("--prompt-chunk", type=int, default=None,
                    help="prompt tokens a prefilling slot consumes per "
                         "device round (C; default: the --tune-file "
                         "plan's C, else 1)")
    ap.add_argument("--fuse-block", default=None,
                    choices=["auto", "on", "off"],
                    help="decode tier of the minRNN LMs: 'auto' / 'on' "
                         "run each layer as one whole-block kernel, 'off' "
                         "keeps the cell-only kernel tier (default: the "
                         "--tune-file plan's tier, else the config's)")
    ap.add_argument("--tune-file", default=None, metavar="PATH|auto|none",
                    help="autotune plan (python -m "
                         "repro_torch.serving.autotune): a TUNE_*.json "
                         "path (config and device checked, a mismatch "
                         "raises), 'auto' for the discovery order "
                         "($REPRO_TUNE_DIR, cwd, repo root; plans of "
                         "other devices are skipped), or 'none'; fills "
                         "K, C and the tier -- explicit flags win")
    ap.add_argument("--speculative", default=None, choices=["ngram"],
                    help="speculative decoding draft source: decoding "
                         "rows propose up to --draft-len tokens a round, "
                         "verified in one chunk pass (streams unchanged)")
    ap.add_argument("--draft-len", type=int, default=4,
                    help="most draft tokens proposed per round (S)")
    ap.add_argument("--prefill", action="store_true",
                    help="prefill the prompts in one parallel pass "
                         "(lm.prefill), then decode greedily with "
                         "decode_step, instead of the engine")
    ap.add_argument("--priority", type=int, default=1)
    ap.add_argument("--deadline-rounds", type=int, default=None)
    ap.add_argument("--max-queue", type=int, default=0)
    ap.add_argument("--max-retries", type=int, default=1)
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="arm crash recovery: journal every submit / "
                         "cancel / step to DIR/journal.jsonl and "
                         "snapshot the serving state every "
                         "--snapshot-every rounds (starts a NEW journal "
                         "epoch; resume a killed one with --restore DIR)")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="snapshot cadence in device rounds")
    ap.add_argument("--restore", default=None, metavar="DIR",
                    help="resume a killed serving run: rebuild the engine "
                         "from DIR's newest good snapshot + journal-tail "
                         "replay (the engine's knobs come from the "
                         "journal, not the flags), finish its requests, "
                         "then serve --prompts on top; keeps journaling "
                         "into DIR")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.tune_file == "none":
        args.tune_file = None

    cfg = archs.smoke(args.arch) if args.smoke else archs.get(args.arch)
    if cfg.vocab_size != 256:       # byte prompts, as the reference serves
        cfg = cfg.replace(vocab_size=256)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(gen, cfg, device=device)
    if args.ckpt_dir:
        restored = ckpt_lib.CheckpointManager(
            args.ckpt_dir, device=device).restore_latest()
        if restored is not None:
            step, params, _ = restored
            print(f"loaded checkpoint step {step}")
    if args.prefill:
        prompts = [list(p.encode()) for p in args.prompts]
        t0 = time.time()
        outs, t_prefill = prefill_and_decode(cfg, params, prompts,
                                             args.max_new, args.max_len,
                                             device)
        dt = time.time() - t0
        for p, toks in zip(args.prompts, outs):
            print(f"--- [{p!r}] -> {decode_bytes(toks)!r}")
        n_prompt = sum(len(p) for p in prompts)
        print(f"prefill: {len(prompts)} prompts, {n_prompt} tokens in one "
              f"parallel pass in {t_prefill * 1e3:.2f} ms "
              f"({n_prompt / max(t_prefill, 1e-9):.1f} prompt tok/s), "
              f"then {args.max_new - 1} decode_step rounds; "
              f"{len(prompts) * args.max_new} tokens in {dt:.2f}s, device "
              f"{device}")
        return
    if args.restore:
        engine = ServingEngine.restore(args.restore, cfg, params,
                                       device=device)
        rep = engine.recovery_report
        print(f"restored from {args.restore}: snapshot "
              f"@{rep['snapshot_round']}, replayed "
              f"{rep['replayed_records']} journal records "
              f"({rep['replayed_rounds']} rounds) in "
              f"{rep['recovery_s']:.2f}s"
              + (f"; fell past corrupt snapshot(s) "
                 f"{rep['corrupt_snapshots_skipped']}"
                 if rep["corrupt_snapshots_skipped"] else ""))
    else:
        engine = ServingEngine(cfg, params, max_batch=args.max_batch,
                               max_len=args.max_len, seed=args.seed,
                               decode_block=args.decode_block,
                               prompt_chunk=args.prompt_chunk,
                               max_queue=args.max_queue,
                               max_retries=args.max_retries,
                               fuse_block=args.fuse_block, device=device,
                               speculative=args.speculative,
                               draft_len=args.draft_len,
                               tune=args.tune_file,
                               recover_dir=args.snapshot_dir,
                               snapshot_every=args.snapshot_every)
    rids = {}
    for p in args.prompts:
        rid = engine.submit(list(p.encode()), max_new=args.max_new,
                            temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, priority=args.priority,
                            deadline=args.deadline_rounds)
        rids[rid] = p

    t0 = time.time()
    outs = engine.run_to_completion()
    dt = time.time() - t0
    n_tokens = sum(len(o) for o in outs.values())
    for rid, toks in sorted(outs.items()):
        req = engine.finished[rid]
        tag = "" if req.status == "COMPLETED" else f" [{req.status}]"
        # a restored engine also finishes the killed run's requests,
        # whose prompts came back from the journal
        label = rids.get(rid, decode_bytes(req.prompt))
        print(f"--- [{label!r}]{tag} -> {decode_bytes(toks)!r}")
    print(f"{n_tokens} tokens in {dt:.2f}s "
          f"({n_tokens / max(dt, 1e-9):.1f} tok/s, batched, "
          f"device {engine.device})")
    snap = engine.stats.snapshot()
    plan = engine.tune_plan
    print(f"kernel tier: {engine.kernel_tier} (fuse_block="
          f"{engine.cfg.fuse_block}"
          + (f", plan {plan.get('source', '<dict>')}" if plan else
             ", no tune plan") + ")")
    print(f"superstep K={engine.decode_block} C={engine.prompt_chunk}: "
          f"{snap['decode_calls']} host round-trips for "
          f"{snap['decode_tokens']} decoded tokens "
          f"({snap['host_roundtrips_per_decode_token']:.3f} "
          f"round-trips/token); {snap['prefill_tokens']} prompt tokens "
          f"prefilled in-loop over {snap['prefill_rounds']} packed rounds; "
          f"wasted slot steps: {snap['wasted_slot_steps']} "
          f"({snap['wasted_slot_fraction']:.1%} of slot steps)")
    print(f"latency: ttft mean {snap['ttft_s_mean'] * 1e3:.1f}ms "
          f"(p95 {snap['ttft_s_p95'] * 1e3:.1f}ms, "
          f"{snap['ttft_rounds_mean']:.1f} device rounds), "
          f"inter-token {snap['itl_s_mean'] * 1e3:.1f}ms "
          f"({snap['itl_rounds_mean']:.2f} rounds/token)")
    if engine.draft is not None:
        print(f"speculative {type(engine.draft).__name__} "
              f"S={engine.draft.draft_len}: "
              f"{snap['draft_accepted']} of {snap['draft_proposed']} drafts "
              f"accepted ({snap['accept_rate']:.1%}); "
              f"{snap['non_spec_tokens']} emitting slot-rounds for "
              f"{snap['decode_tokens']} tokens")
    print("engine stats: " + ", ".join(
        f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in sorted(snap.items())))


if __name__ == "__main__":
    main()
