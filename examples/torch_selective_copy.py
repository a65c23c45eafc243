"""Paper Tables 1-2 on the PyTorch port: the Selective Copying task (Gu &
Dao 2024).

Trains minGRU / minLSTM classifying-LM models at 1/2/3 layers and prints
the layer-ablation accuracy table -- the paper's demonstration that
stacking restores the expressivity lost by dropping h_{t-1} from the gates.
Scaled down: seq 32, 4 data tokens, ~350 steps (paper: 4096/16/400k).  The
port's counterpart of ``examples/selective_copy.py``.

    PYTHONPATH=src python examples/torch_selective_copy.py [--steps 300] \\
        [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.base import MinRNNConfig, ModelConfig
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_step as ts_lib


def run(cell: str, n_layers: int, steps: int, dev, seq_len: int = 32,
        seed: int = 0, eval_batches: int = 8):
    cfg = ModelConfig(
        name=f"{cell}-{n_layers}l", block_kind="minrnn", n_layers=n_layers,
        d_model=64, d_ff=256, vocab_size=16, tie_embeddings=False,
        minrnn=MinRNNConfig(cell=cell, expansion=6.0, mode="log",
                            use_conv=False, use_mlp=False))
    params = lm.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg, device=dev)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=30, total_steps=steps,
                               weight_decay=0.0)
    opt_state = opt_lib.init(ocfg, params)
    step = ts_lib.make_train_step(cfg, ocfg)
    for i in range(steps):
        batch = synthetic.selective_copy_batch(seed, i, 32, seq_len=seq_len,
                                               n_data=4)
        params, opt_state, metrics = step(params, opt_state, batch)
    # eval
    accs = []
    with torch.no_grad():
        for i in range(eval_batches):
            batch = synthetic.selective_copy_batch(seed + 999, i, 32,
                                                   seq_len=seq_len, n_data=4)
            logits, _ = lm.forward(params, cfg, torch.as_tensor(
                batch["tokens"]).to(dev))
            accs.append(synthetic.selective_copy_accuracy(
                logits.float().cpu().numpy(), batch["labels"]))
    return float(np.mean(accs))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=350)
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"{'model':10s} {'layers':>6s} {'accuracy':>9s}")
    for cell in ("minlstm", "mingru"):
        for n_layers in (1, 2, 3):
            acc = run(cell, n_layers, args.steps, dev,
                      eval_batches=args.eval_batches)
            print(f"{cell:10s} {n_layers:6d} {acc:9.3f}")


if __name__ == "__main__":
    main()
