"""End-to-end LM training: data pipeline -> train step ->
checkpoints -> fault-tolerance hooks (port of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--size 100m] \\
        [--steps 300] [--arch qwen2-7b] [--microbatches 2] \\
        [--compress int8] [--device cpu]

The reference's flags and sizes: the architecture's family at a ~10M
(``--size 10m``, the default) or ~100M parameter width over an 8k
vocabulary in f32, the trainer with AdamW under a cosine schedule
(3e-4, 20 warm-up steps) on the synthetic token stream; the loss of the
last ten steps must be below that of the first ten.  ``--device`` (the
port's) picks where it runs: the card unless ``--device cpu`` is given.
It prints ``train_lm complete`` at the end.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core import resolve_device
from repro_torch.core.tree import tree_leaves
from repro_torch.data.synthetic import ModelInputs, ShardedTokenStream
from repro_torch.models import get_model
from repro_torch.train.optimizer import AdamW, cosine_schedule
from repro_torch.train.trainer import Trainer, TrainerConfig

SIZES = {
    # (layers, d_model, heads, kv, d_ff): about these parameter counts
    # with an 8k vocabulary
    "10m": (4, 256, 4, 2, 1024),
    "100m": (12, 768, 12, 4, 3072),
}


def main(argv=None) -> np.ndarray:
    """Train; returns the losses of the steps."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-7b", choices=sorted(ARCHS))
    ap.add_argument("--size", default="10m", choices=sorted(SIZES))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", default=None,
                    choices=[None, "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n_layers, d_model, heads, kv, d_ff = SIZES[args.size]
    cfg = ARCHS[args.arch].scaled(
        n_layers=n_layers, d_model=d_model, n_heads=heads, n_kv_heads=kv,
        d_head=d_model // heads, d_ff=d_ff, vocab_size=8192,
        param_dtype="float32", compute_dtype="float32",
        q_chunk=128, kv_chunk=128)
    if cfg.family == "moe":
        cfg = cfg.scaled(n_experts=8, experts_per_token=2, moe_d_ff=d_ff // 2)
    api = get_model(cfg)
    data = ModelInputs(cfg, iter(ShardedTokenStream(
        cfg.vocab_size, args.seq, args.batch, seed=0)))
    opt = AdamW(lr=cosine_schedule(3e-4, warmup=20, total=args.steps))
    trainer = Trainer(
        api, opt, data, ckpt_dir=args.ckpt_dir,
        tcfg=TrainerConfig(total_steps=args.steps, ckpt_every=50,
                           log_every=10, microbatches=args.microbatches,
                           grad_compression=args.compress),
        device=dev)
    state = trainer.init_or_restore(
        torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    print(f"arch family {cfg.family}; params {n_params / 1e6:.1f}M")
    trainer.run(state)
    losses = trainer.losses()
    print(f"loss: first10 {losses[:10].mean():.4f} -> "
          f"last10 {losses[-10:].mean():.4f}")
    assert losses[-10:].mean() < losses[:10].mean(), "loss did not improve"
    print("train_lm complete")
    return losses


if __name__ == "__main__":
    main()
