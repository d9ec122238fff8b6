"""Synthetic token pipeline (port of ``repro/data/synthetic.py``, the
reference's numpy code, so both draw the same tokens bit for bit):
deterministic, shardable, host-partitioned.

``ShardedTokenStream`` yields fixed-shape batches; each data-parallel host
draws a disjoint slice of the global batch (by host index), the standard
multi-host input layout. A Zipf-ish unigram distribution gives non-uniform
token statistics so losses move realistically during the example runs.
"""
from __future__ import annotations

import numpy as np


class ShardedTokenStream:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, host_index: int = 0, host_count: int = 1, seed: int = 0,
                 zipf_a: float = 1.2):
        assert global_batch % host_count == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // host_count
        self.rng = np.random.default_rng(seed * 1000003 + host_index)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** -zipf_a
        self.p = p / p.sum()
        self._step = 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        self._step += 1
        tokens = self.rng.choice(
            self.vocab, size=(self.local_batch, self.seq), p=self.p
        ).astype(np.int32)
        return {"tokens": tokens}

    def state(self) -> dict:
        """Checkpointable pipeline position."""
        return {"step": self._step,
                "bit_generator": self.rng.bit_generator.state}

    def restore(self, state: dict):
        self._step = state["step"]
        self.rng.bit_generator.state = state["bit_generator"]


class ModelInputs:
    """A token stream's batches with the inputs a model family reads
    beside the tokens (the port's; the reference's stream gives tokens
    alone): frame embeddings ``encoder_embeds`` (B, encoder_seq, D) for
    ``encdec`` and patch embeddings ``patch_embeds`` (B, n_vision_tokens,
    D) for ``vlm``, standard normal f32 from a seeded stream of their own.
    Other families' batches pass through unchanged."""

    def __init__(self, cfg, tokens, seed: int = 0):
        self.cfg, self.tokens = cfg, tokens
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = dict(next(self.tokens))
        b, cfg = len(batch["tokens"]), self.cfg
        if cfg.family == "encdec":
            batch["encoder_embeds"] = self.rng.standard_normal(
                (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
        if cfg.family == "vlm":
            batch["patch_embeds"] = self.rng.standard_normal(
                (b, cfg.n_vision_tokens, cfg.d_model), dtype=np.float32)
        return batch
