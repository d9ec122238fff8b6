"""Batched serving demo: continuous batching over KV-cache slots (port of
``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

The reference's setup: the qwen2-7b smoke config at d_model 128 and 4
layers, random weights from seed 0, 4 slots serving 10 requests of 4-11
prompt tokens, 8 greedy tokens each.  It runs on the card unless
``--device cpu`` is given and prints ``serve_lm complete`` at the end.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import resolve_device
from repro_torch.models import get_model
from repro_torch.serve import Request, ServeEngine


def main(argv=None) -> dict:
    """Serve the requests; returns {request id: its tokens}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = smoke_config(ARCHS["qwen2-7b"]).scaled(d_model=128, n_layers=4)
    api = get_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)

    engine = ServeEngine(api, params, slots=4, max_len=96, temperature=0.0,
                         device=dev)
    rng = np.random.default_rng(0)
    for rid in range(10):
        prompt = rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12),
                              dtype=np.int32)
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=8))

    results = engine.run_to_completion()
    for rid in sorted(results):
        print(f"request {rid}: {results[rid]}")
    assert len(results) == 10 and all(len(v) == 8 for v in results.values())
    print("serve_lm complete (10 requests, 4 slots, continuous batching)")
    return results


if __name__ == "__main__":
    main()
