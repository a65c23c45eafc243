"""End-to-end driver on the PyTorch port (paper Fig. 2 setting): train the
~100M-parameter minGRU LM on the embedded Shakespeare corpus with the full
stack -- AdamW + cosine schedule, checkpointing, the fault-tolerant
supervisor -- then serve batched completions from the trained weights.
The port's counterpart of ``examples/lm_shakespeare.py``.

Full run (on the card):
    PYTHONPATH=src python examples/torch_lm_shakespeare.py --steps 600 \\
        --batch 64

A few steps of the reduced model on the CPU:

    PYTHONPATH=src python examples/torch_lm_shakespeare.py --smoke \\
        --device cpu
"""

import argparse
import os
import tempfile

from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model instead of the 100M config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_shakespeare"))
    args = ap.parse_args(argv)

    train_args = ["--arch", "mingru-lm", "--task", "lm",
                  "--steps", str(args.steps), "--batch", str(args.batch),
                  "--seq", str(args.seq), "--ckpt-dir", args.ckpt_dir,
                  "--ckpt-every", "100", "--device", args.device]
    if args.smoke:
        train_args.append("--smoke")
    train_cli.main(train_args)

    serve_args = ["--arch", "mingru-lm", "--ckpt-dir", args.ckpt_dir,
                  "--max-new", "24", "--device", args.device,
                  "--prompts", "To be, or not", "Friends, Romans"]
    if args.smoke:
        serve_args.append("--smoke")
    serve_cli.main(serve_args)


if __name__ == "__main__":
    main()
