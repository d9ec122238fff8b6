"""Training loop (port of ``repro/train/trainer.py``): the eager step,
checkpoint and restart, heartbeat and straggler hooks and the elastic
restart plan.  Runs on the card unless ``device='cpu'`` is given.

With a ``ctx`` holding a mesh every rank of it runs a ``Trainer`` alike
on the same token stream (the global batch, from one seed): the step is
data-parallel (``train_step.py``) and the parameters are the rank's
blocks, the moments ZeRO-1's blocks over the data axes
(``train_step.init_state``).  Checkpoints are whole, as the reference's
global arrays are: each split leaf is gathered over the axes its spec
splits it over (``train_step.state_shardings``: a parameter's applied
spec, a moment's ZeRO-1 spec), leaf by leaf, and data-rank 0, model-rank
0 writes them; every rank restores the whole tree and keeps its blocks
under the fresh state's layout, so a checkpoint written on one mesh, with
or without ZeRO-1, restores on another, or in one process.  The ranks
must share the checkpoint directory."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..core.device import resolve_device
from ..core.tree import key_str, tree_leaves_with_path, tree_unflatten
from ..distributed import collectives as coll
from ..distributed.fault_tolerance import HeartbeatMonitor, make_elastic_plan
from .optimizer import AdamW
from .train_step import (TrainState, gather_state, init_state,
                         make_train_step, shard_state, state_shardings)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    keep_ckpts: int = 3
    microbatches: int = 1
    grad_compression: str | None = None


class Trainer:
    def __init__(self, api, optimizer: AdamW, data_iter, *,
                 ckpt_dir, tcfg: TrainerConfig = TrainerConfig(),
                 ctx=None, hosts=("host0",), host_index: int = 0,
                 device=None):
        self.api = api
        self.optimizer = optimizer
        self.data = data_iter
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.mesh = None if ctx is None else ctx.mesh
        self.ckpt = CheckpointManager(ckpt_dir, keep=tcfg.keep_ckpts)
        self.monitor = HeartbeatMonitor(hosts)
        self.host = hosts[host_index]
        self.step_fn = make_train_step(
            api, optimizer, ctx, microbatches=tcfg.microbatches,
            grad_compression=tcfg.grad_compression)
        self.history: list[dict] = []

    def init_or_restore(self, generator: torch.Generator) -> TrainState:
        """A fresh state drawn from ``generator`` (on the trainer's
        device), or the latest checkpoint restored into it."""
        state = init_state(self.api, self.optimizer, generator,
                           device=self.device, mesh=self.mesh)
        latest = self.ckpt.latest_step()
        if latest is not None:
            specs = (None if self.mesh is None else
                     state_shardings(self.mesh, self.api, state))
            whole, step = self.ckpt.restore(state)
            state = (whole if specs is None else
                     shard_state(self.mesh, whole, state, specs))
            print(f"[trainer] restored checkpoint step {step}")
        return state

    def _axes(self):
        return [self.mesh.axis(a) for a in self.mesh.axis_names]

    def save(self, step: int, state: TrainState) -> None:
        """A whole checkpoint of ``state``; under a mesh every rank calls
        it, each leaf is gathered whole and copied to the host on the
        writing rank (data-rank 0, model-rank 0) alone."""
        if self.mesh is None:
            self.ckpt.save(step, state)
            return
        writer = all(ax.index == 0 for ax in self._axes())
        like = init_state(self.api, self.optimizer, torch.Generator(),
                          device="meta")
        leaves = {}
        for path, whole in gather_state(
                self.mesh, state, state_shardings(self.mesh, self.api,
                                                  state), like):
            if writer:
                leaves[key_str(path)] = whole.cpu()
        if writer:
            self.ckpt.save(step, tree_unflatten(state, [
                leaves[key_str(p)] for p, _ in tree_leaves_with_path(
                    state)]))

    def run(self, state: TrainState) -> TrainState:
        t = self.tcfg
        start = int(state.opt.step)
        for step in range(start, t.total_steps):
            batch = next(self.data)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])  # also waits for the step
            dt = time.perf_counter() - t0
            self.monitor.beat(self.host, dt)
            self.history.append({"step": step + 1, "loss": loss,
                                 "grad_norm": float(metrics["grad_norm"]),
                                 "dt_s": dt})
            if (step + 1) % t.log_every == 0:
                print(f"[trainer] step {step + 1} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} {dt:.3f}s")
            if (step + 1) % t.ckpt_every == 0:
                self.save(step + 1, state)
            plan = make_elastic_plan(self.monitor, self.ckpt.all_steps(),
                                     global_batch=len(batch["tokens"]))
            if plan is not None:
                print(f"[trainer] ELASTIC RESTART NEEDED: {plan.note}")
                break
        self.ckpt.wait()
        if self.mesh is not None:  # the writer's checkpoint is committed
            for ax in self._axes():
                coll.barrier(ax)
        return state

    def losses(self) -> np.ndarray:
        return np.asarray([h["loss"] for h in self.history])
