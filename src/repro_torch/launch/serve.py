"""Serving launcher: the continuous-batching engine over random prompts.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        [--requests 16] [--slots 4] [--max-new 16] [--device cuda]

The LM families (dense, moe, and the state models ssm and hybrid);
``encdec`` and ``vlm`` are refused, being served through ``prefill`` and
``decode_step``.  The flags of ``repro.launch.serve``, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, smoke_config
from ..core.device import resolve_device
from ..models import get_model
from ..serve.engine import Request, ServeEngine

#: The families the engine serves: those whose batches are tokens alone.
ENGINE_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=sorted(ARCHS))
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if cfg.family not in ENGINE_FAMILIES:
        raise SystemExit(
            f"{args.arch}: the {cfg.family} family is served through "
            "prefill and decode_step (its batches carry frames or patches "
            "beside the tokens); the engine feeds tokens only")
    dev = resolve_device(args.device)
    if args.scale == "smoke":
        cfg = smoke_config(cfg)
    api = get_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    engine = ServeEngine(api, params, slots=args.slots,
                         max_len=args.max_len,
                         temperature=args.temperature, device=dev)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        engine.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size,
                                size=int(rng.integers(4, 16)),
                                dtype=np.int32),
            max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    results = engine.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s) on {dev.type}")
    return results


if __name__ == "__main__":
    main()
