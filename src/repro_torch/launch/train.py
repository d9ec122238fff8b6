"""Training launcher: the trainer on the synthetic token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        [--scale smoke] [--steps 100] [--ckpt-dir DIR] \\
        [--microbatches 8] [--compress bf16] [--device cuda]

The flags of ``repro.launch.train``, plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions).  ``--ckpt-dir``
defaults to a directory under the temporary directory.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs import ARCHS, smoke_config
from ..core.device import resolve_device
from ..data.synthetic import ShardedTokenStream
from ..models import get_model
from ..train.optimizer import AdamW, cosine_schedule
from ..train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=sorted(ARCHS))
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", default=None, choices=[None, "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.scale == "smoke":
        cfg = smoke_config(cfg)
    api = get_model(cfg)

    data = ShardedTokenStream(cfg.vocab_size, args.seq, args.batch)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=min(100, args.steps // 10
                                                       or 1),
                                   total=args.steps))
    trainer = Trainer(
        api, opt, iter(data), ckpt_dir=args.ckpt_dir,
        tcfg=TrainerConfig(total_steps=args.steps,
                           ckpt_every=args.ckpt_every,
                           microbatches=args.microbatches,
                           grad_compression=args.compress),
        device=dev)
    state = trainer.init_or_restore(
        torch.Generator(device=dev).manual_seed(0))
    trainer.run(state)
    return trainer


if __name__ == "__main__":
    main()
