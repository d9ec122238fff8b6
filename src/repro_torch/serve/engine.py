"""Batched serving engine (port of ``repro/serve/engine.py``): continuous
batching over a fixed-slot KV cache.

Slots hold independent sequences; ``step`` decodes one token for every
active slot with one ``decode_step`` over the whole slot batch.  Finished
slots are refilled from the request queue by per-slot prefill; sampling
is greedy or by temperature.

Kept from the reference as it is, for parity: the cache has one
position ``pos`` for all slots, set by the last prefill, so prompts of
one wave must have equal lengths (ROADMAP.md §3).  The sparse
side-channel (``prepare_sparse``, ``prepare_dist``, ``prepare_moe``,
``moe_dispatch_schedule``, ``spmm``) needs the tuner and is not ported
yet (ROADMAP.md, queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..core.device import check_on, resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16


class ServeEngine:
    def __init__(self, api, params, *, slots: int = 4, max_len: int = 128,
                 temperature: float = 0.0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        check_on(self.device, embed=params["embed"])
        self.api = api
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.queue: deque[Request] = deque()
        self.active: dict[int, dict] = {}  # slot -> {rid, remaining, out}
        self.cache = api.init_cache(slots, max_len, device=self.device)
        self.results: dict[int, list[int]] = {}
        self._next_tokens = np.zeros((slots,), np.int64)

    def submit(self, req: Request):
        """Queue ``req``; refuse one whose prompt and decode steps would
        write past the cache (positions ``0 .. len(prompt) +
        max_new_tokens - 2`` must lie below ``max_len``)."""
        need = len(req.prompt) + req.max_new_tokens - 1
        if need > self.max_len:
            raise ValueError(
                f"request {req.rid}: {len(req.prompt)} prompt tokens and "
                f"{req.max_new_tokens} new tokens need {need} cache "
                f"positions, more than max_len {self.max_len}")
        self.queue.append(req)

    def _slot_prefill(self, slot: int, req: Request):
        """Prefill one slot: run the prompt batched by 1 and splice its
        keys and values into the shared cache."""
        tokens = torch.as_tensor(np.asarray(req.prompt)[None, :],
                                 dtype=torch.int64, device=self.device)
        logits, cache1 = self.api.prefill(self.params, {"tokens": tokens},
                                          self.max_len)
        self.cache["k"][:, slot] = cache1["k"][:, 0]
        self.cache["v"][:, slot] = cache1["v"][:, 0]
        # NOTE: per-slot positions would need a vector 'pos'; as in the
        # reference, one wave's prompts share their length
        self.cache["pos"] = cache1["pos"]
        tok = int(torch.argmax(logits[0]))
        self.active[slot] = {"rid": req.rid,
                             "remaining": req.max_new_tokens - 1,
                             "out": [tok]}
        self._next_tokens[slot] = tok

    def _fill_slots(self):
        for slot in range(self.slots):
            if slot not in self.active and self.queue:
                self._slot_prefill(slot, self.queue.popleft())

    def _sample(self, logits):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32) / self.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def step(self):
        """One decode wave across all active slots."""
        self._fill_slots()
        if not self.active:
            return False
        toks = torch.as_tensor(self._next_tokens, device=self.device)
        logits, self.cache = self.api.decode_step(self.params, self.cache,
                                                  toks)
        nxt = self._sample(logits).cpu().numpy()
        for slot, st in list(self.active.items()):
            tok = int(nxt[slot])
            st["out"].append(tok)
            st["remaining"] -= 1
            self._next_tokens[slot] = tok
            if st["remaining"] <= 0:
                self.results[st["rid"]] = st["out"]
                del self.active[slot]
        return True

    def run_to_completion(self, max_steps: int = 1000):
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step()
            steps += 1
        return self.results
