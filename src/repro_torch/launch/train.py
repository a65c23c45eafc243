"""End-to-end training driver (PyTorch port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch mingru-lm --task lm --steps 200 --batch 8 --seq 256

Config registry -> seeded init -> AdamW -> the deterministic data
pipeline -> the fault-tolerant supervisor (checkpoint / restart,
straggler watchdog).  Every minRNN layer's forward (and gemma-2b-mingru's
mixer) runs the fused CUDA cell kernel and its backward the reversed
CUDA scan; ``--arch gemma-2b`` trains native GQA, ``--arch
mamba2-370m`` the SSD trunk, ``--arch zamba2-2.7b`` the hybrid and
``--arch deepseek-moe-16b`` the MoE trunk (its log lines carry the
router loss, ``moe_aux``) in PyTorch ops (the reference has no kernel
there).  ``--smoke`` takes the
reduced config; ``--device cpu`` runs the plain PyTorch versions of the
kernels; ``--simulate-failure N`` kills step N once to show recovery.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import archs
from repro_torch.data import lm_corpus, synthetic
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_step as ts_lib
from repro_torch.training.fault_tolerance import TrainSupervisor


def build_batch_fn(task: str, cfg, batch: int, seq: int, seed: int):
    if task == "lm":
        train_data, _ = lm_corpus.build_corpus()
        if cfg.vocab_size < 256:
            raise ValueError("char LM needs vocab >= 256")
        return lambda step: lm_corpus.lm_batch(train_data, seed, step,
                                               batch, seq)
    if task == "selective_copy":
        return lambda step: synthetic.selective_copy_batch(
            seed, step, batch, seq_len=seq, vocab=cfg.vocab_size)
    raise ValueError(task)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mingru-lm", choices=archs.all_names())
    ap.add_argument("--task", default="lm",
                    choices=["lm", "selective_copy"])
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-scale)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = archs.smoke(args.arch) if args.smoke else archs.get(args.arch)
    if args.task == "lm" and cfg.vocab_size != 256:
        cfg = cfg.replace(vocab_size=256)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"params dtype={cfg.param_dtype} device={dev}")

    ocfg = opt_lib.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                               total_steps=args.steps)
    # drawn on the device: a CPU draw of gemma-2b's 2.5 B weights is slow
    model = lm.MinRNNLM(cfg, lm.init_params(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev))
    params = model.params()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{n_params / 1e6:.1f}M parameters")
    opt_state = opt_lib.init(ocfg, params)

    step_fn = ts_lib.make_train_step(cfg, ocfg,
                                     microbatches=args.microbatches)
    batch_fn = build_batch_fn(args.task, cfg, args.batch, args.seq,
                              args.seed)

    manager = ckpt_lib.CheckpointManager(args.ckpt_dir, keep=2,
                                         save_interval=args.ckpt_every,
                                         device=dev)
    sup = TrainSupervisor(_logged(step_fn, args.log_every), batch_fn,
                          manager)
    if args.simulate_failure >= 0:
        fired = []

        def hook(step):
            if step == args.simulate_failure and not fired:
                fired.append(step)
                raise RuntimeError("simulated node failure")

        sup.failure_hook = hook

    restored = manager.restore_latest()
    start = 0
    if restored is not None:
        start, params, opt_state = restored
        print(f"resumed from step {start}")

    t0 = time.time()
    params, opt_state, report = sup.run(params, opt_state, args.steps,
                                        start_step=start)
    dt = time.time() - t0
    print(f"ran {report.steps_run} steps in {dt:.1f}s "
          f"({dt / max(report.steps_run, 1):.2f} s/step); "
          f"recovered failures={report.failures_recovered} "
          f"stragglers={report.straggler_events}")
    if report.final_metrics:
        print("final:", {k: float(v) for k, v in
                         report.final_metrics.items()})
    manager.maybe_save(args.steps, params, opt_state, force=True)
    return report


def _logged(step_fn, every):
    count = [0]

    def run(params, opt_state, batch):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        count[0] += 1
        if count[0] % every == 0:
            print(f"  step {count[0]}: " +
                  " ".join(f"{k}={float(v):.4f}"
                           for k, v in metrics.items() if v.ndim == 0))
        return params, opt_state, metrics

    return run


if __name__ == "__main__":
    main()
