"""Batched serving engine (port of ``repro/serve/engine.py``): continuous
batching over a fixed-slot KV cache.

Slots hold independent sequences; ``step`` decodes one token for every
active slot with one ``decode_step`` over the whole slot batch.  The
engine feeds tokens only: it serves the LM families (dense, moe, and the
state models ssm and hybrid, whose cache it splices leaf by leaf);
``encdec`` and ``vlm`` are served through ``prefill`` and
``decode_step``, as in the reference.  Finished
slots are refilled from the request queue by per-slot prefill; sampling
is greedy or by temperature.

Sparse side-channel operands (retrieval adapters, graph features) go
through :meth:`ServeEngine.spmm`, and the MoE dispatch through
:meth:`ServeEngine.moe_dispatch_schedule`: both resolve their schedule
from the engine's memo, then the persistent tuner cache
(``repro_torch.tune``), else the static default, and never measure on
the request path.  Tuning happens ahead of time in
:meth:`ServeEngine.prepare_sparse` and :meth:`ServeEngine.prepare_moe`
(or ``launch.hillclimb --spmm`` / ``--moe``), and for a sharded operand
in :meth:`ServeEngine.prepare_dist` (or ``launch.hillclimb --dist``),
which ``dist_spmm(schedule="tune")`` replays.

Under a ``ShardingCtx`` with a mesh (``ctx=``) every rank of the mesh
runs an engine alike, on the same requests, with its blocks of the
parameters (``sharding.shard_params``): the cache holds the rank's data
block of the slots and its block of the sequence (``max_len / model``
positions, ``transformer.init_cache``); a slot's prefill runs on every
rank (its batch of one is not split over the data axes) and is spliced
into the rank holding the slot; a decode step runs the global slots and
all-gathers the slots' logits over the data axes, so every rank samples
alike.  Every family the engine serves is served so: dense and moe, and
the state models ssm and hybrid, whose caches hold the rank's blocks of
the mixer's state (``models/mamba2.py``) and, for hybrid, of the
sequence; the splice writes the slot's blocks, the prefill of one slot
having run under the same model axis.

Kept from the reference as it is, for parity: the cache has one
position ``pos`` for all slots, set by the last prefill, so prompts of
one wave must have equal lengths (ROADMAP.md §3).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..core.device import check_on, resolve_device
from ..core.tree import tree_map
from ..distributed import collectives as coll
from ..distributed import sharding


#: The families the engine serves (it feeds tokens only), and those of
#: them whose cache holds keys and values over ``max_len`` positions.
SERVED = ("dense", "moe", "ssm", "hybrid")
KV_FAMILIES = ("dense", "moe", "hybrid")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16


class ServeEngine:
    def __init__(self, api, params, *, slots: int = 4, max_len: int = 128,
                 temperature: float = 0.0, seed: int = 0, device=None,
                 tuner_cache=None, ctx=None):
        self.device = resolve_device(device)
        check_on(self.device, embed=params["embed"])
        self.api = api
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.ctx = ctx if ctx is not None and ctx.mesh is not None else None
        self._first_slot, self._local_slots = 0, slots
        kw = {}
        if self.ctx is not None:
            self._check_mesh(api.cfg, slots, max_len)
            kw["ctx"] = self.ctx
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.queue: deque[Request] = deque()
        self.active: dict[int, dict] = {}  # slot -> {rid, remaining, out}
        self.cache = api.init_cache(self._local_slots, max_len,
                                    device=self.device, **kw)
        self.results: dict[int, list[int]] = {}
        self._next_tokens = np.zeros((slots,), np.int64)
        # the tuner's ScheduleCache (None: the default cache of the
        # engine's device); the memo maps fingerprint cache keys to tuned
        # schedules, so it survives operand re-creation and never
        # aliases two matrices
        self.tuner_cache = tuner_cache
        self._sched_memo: dict[str, object] = {}

    def _check_mesh(self, cfg, slots: int, max_len: int) -> None:
        """The rank's slots under the engine's ctx (its data block of
        them); raises unless the engine serves the family, ``max_len``
        divides the model axis (where the cache holds keys and values)
        and the slots the data axes."""
        ctx = self.ctx
        if cfg.family not in SERVED:
            raise ValueError(f"the engine serves the {', '.join(SERVED)} "
                             f"families, not {cfg.family!r}")
        mesh = ctx.mesh
        if cfg.family in KV_FAMILIES and sharding.MODEL_AXIS in \
                mesh.axis_names:
            m = mesh.axis(sharding.MODEL_AXIS).size
            if max_len % m:
                raise ValueError(f"max_len {max_len} does not split over a "
                                 f"model axis of {m}: the cache holds "
                                 "max_len / model positions a rank")
        mine = sharding.data_block(mesh, ctx.data_axes, torch.arange(slots))
        self._first_slot, self._local_slots = int(mine[0]), len(mine)

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

    # -- tuned sparse side channel ------------------------------------------

    def prepare_sparse(self, csr, n_dense_cols: int, *, value_dtypes=None,
                       error_budget=None):
        """Ahead-of-time tuning of a sparse operand this engine will serve
        with: measures on the CSR's device (or replays the fingerprint
        cache) and persists the winner, so :meth:`spmm` replays it for
        free.  ``value_dtypes`` / ``error_budget`` forward to
        ``tune_schedule``'s dtype axis: ``value_dtypes=()`` pins f32."""
        from ..tune import cache_key, tune_schedule

        kw = {}
        if value_dtypes is not None:
            kw["value_dtypes"] = value_dtypes
        if error_budget is not None:
            kw["error_budget"] = error_budget
        sched = tune_schedule(csr, n_dense_cols, cache=self.tuner_cache,
                              **kw).schedule
        self._sched_memo[cache_key(csr, n_dense_cols)] = sched
        return sched

    def prepare_dist(self, csr, n_dense_cols: int, *, mesh, axis: str,
                     value_dtypes=None):
        """Ahead-of-time tuning of a sharded sparse operand: one search
        over local tiling x collective mode x value dtype
        (``tune_dist_spmm``, every rank of the mesh calling it alike),
        persisted under the mesh-extent key so ``dist_spmm(...,
        schedule="tune")`` replays it for free.  ``value_dtypes=()`` pins
        f32 storage."""
        from ..tune import cache_key, tune_dist_spmm

        kw = {}
        if value_dtypes is not None:
            kw["value_dtypes"] = value_dtypes
        res = tune_dist_spmm(csr, n_dense_cols, mesh=mesh, axis=axis,
                             cache=self.tuner_cache, **kw)
        axis_size = int(mesh.shape[axis])
        self._sched_memo[
            f"dist:{cache_key(csr, n_dense_cols)}|mesh:{axis_size}"
        ] = res.schedule
        return res.schedule

    def prepare_moe(self, cfg, t_tokens: int, expert_lengths=None):
        """Ahead-of-time tuning of the MoE dispatch this engine will run:
        measures the grouped-matmul kernel on the engine's device (or
        replays the cache) for this config's expert histogram, so
        :meth:`moe_dispatch_schedule` replays it for free."""
        from ..models.moe import moe_tune_dispatch

        res = moe_tune_dispatch(cfg, t_tokens, expert_lengths=expert_lengths,
                                cache=self.tuner_cache, device=self.device)
        self._sched_memo[res.key] = res.schedule
        return res.schedule

    def moe_dispatch_schedule(self, cfg, t_tokens: int,
                              expert_lengths=None):
        """Serving-path resolver for ``apply_moe(..., dispatch=...)``: the
        memo, then the persistent cache, else the config's static default;
        never a measurement.  An assumed (None) histogram resolves only
        the no-shrink record, as ``moe_tune_dispatch`` keys it."""
        from ..models.moe import balanced_expert_lengths, moe_dispatch_schedule
        from ..tune.moe import moe_cache_key

        observed = expert_lengths is not None
        lengths = (expert_lengths if observed
                   else balanced_expert_lengths(cfg, t_tokens))
        key = moe_cache_key(lengths, cfg.d_model, cfg.moe_d_ff,
                            str(cfg.param_dtype), shrink=observed,
                            max_tokens=t_tokens)
        sched = self._sched_memo.get(key)
        if sched is None:
            sched = moe_dispatch_schedule(cfg, t_tokens,
                                          expert_lengths=expert_lengths,
                                          cache=self.tuner_cache,
                                          device=self.device)
        return sched

    def spmm(self, a, b):
        """Serving-path SpMM on the engine's device: the schedule comes
        from the memo, then the persistent cache, else the static
        selector; never from a measurement.  Misses are not memoized, so
        tuning done later is picked up on the next call.  A non-CSR
        operand has no fingerprint and runs ``spmm(...,
        schedule="auto")``."""
        from ..sparse import spmm as _spmm
        from ..sparse.formats import CSR
        from ..tune import cache_key, cached_or_auto

        if not isinstance(a, CSR):
            return _spmm(a, b, schedule="auto", device=self.device)
        key = cache_key(a, int(b.shape[1]))  # memoized on the CSR
        sched = self._sched_memo.get(key)
        if sched is None:
            sched = cached_or_auto(a, int(b.shape[1]),
                                   cache=self.tuner_cache, key=key)
        return _spmm(a, b, schedule=sched, device=self.device)

    def _slot_prefill(self, slot: int, req: Request):
        """Prefill one slot: run the prompt batched by 1 and splice its
        cache into the shared one by the reference's rule: every leaf of
        the cache tree whose slot axis (axis 1) has one entry is written
        at the slot's index (keys and values; a state model's states)."""
        tokens = torch.as_tensor(np.asarray(req.prompt)[None, :],
                                 dtype=torch.int64, device=self.device)
        if self.ctx is None:
            logits, cache1 = self.api.prefill(self.params, {"tokens": tokens},
                                              self.max_len)
        else:  # every rank runs the slot; its holder splices it
            logits, cache1 = self.api.prefill(
                self.params, {"tokens": tokens}, self.max_len,
                dataclasses.replace(self.ctx, data_axes=()))
        here = slot - self._first_slot
        mine = 0 <= here < self._local_slots

        def splice(full, one):
            if (mine and torch.is_tensor(one) and one.dim() >= 2
                    and one.shape[1] == 1):
                full[:, here] = one[:, 0].to(full.dtype)
            return full

        tree_map(splice, self.cache, cache1)
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
                                                  toks, self.ctx)
        if self.ctx is not None:  # every slot's logits on every rank
            for a in reversed(self.ctx.data_axes):
                logits = coll.all_gather(logits, self.ctx.mesh.axis(a), 0)
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
