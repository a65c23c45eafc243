"""Quickstart on the PyTorch port: the paper's minGRU in 40 lines.

Builds a minGRU language model, trains it briefly on embedded Shakespeare,
and generates text -- the parallel-scan training mode (the fused CUDA
kernels on the card) and the sequential decode mode side by side.  The
port's counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import torch

from repro_torch.configs import archs
from repro_torch.data import lm_corpus
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving.engine import generate_one
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_step as ts_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--max-new", type=int, default=48)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = archs.smoke("mingru-lm")           # 3-layer minGRU LM (paper arch)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)

    ocfg = opt_lib.AdamWConfig(lr=2e-3, warmup_steps=10,
                               total_steps=args.steps)
    opt_state = opt_lib.init(ocfg, params)
    step = ts_lib.make_train_step(cfg, ocfg)

    train, _ = lm_corpus.build_corpus()
    every = max(1, min(20, args.steps))
    for i in range(args.steps):
        batch = lm_corpus.lm_batch(train, seed=0, step=i, batch=8,
                                   seq_len=128)
        params, opt_state, metrics = step(params, opt_state, batch)
        if (i + 1) % every == 0:
            print(f"step {i + 1}: loss {float(metrics['loss']):.3f}")

    prompt = list(b"To be, or ")
    out = generate_one(cfg, params, prompt, max_new=args.max_new,
                       max_len=256, device=dev)
    print("prompt:    ", bytes(prompt).decode())
    print("generated: ", lm_corpus.decode_bytes(out))


if __name__ == "__main__":
    main()
