"""Training loop (port of ``repro/train/trainer.py``): the eager step,
checkpoint and restart, heartbeat and straggler hooks and the elastic
restart plan.  Runs on the card unless ``device='cpu'`` is given."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..core.device import resolve_device
from ..distributed.fault_tolerance import HeartbeatMonitor, make_elastic_plan
from .optimizer import AdamW
from .train_step import TrainState, init_state, make_train_step


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
                           device=self.device)
        latest = self.ckpt.latest_step()
        if latest is not None:
            state, step = self.ckpt.restore(state)
            print(f"[trainer] restored checkpoint step {step}")
        return state

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
                self.ckpt.save(step + 1, state)
            plan = make_elastic_plan(self.monitor, self.ckpt.all_steps(),
                                     global_batch=len(batch["tokens"]))
            if plan is not None:
                print(f"[trainer] ELASTIC RESTART NEEDED: {plan.note}")
                break
        self.ckpt.wait()
        return state

    def losses(self) -> np.ndarray:
        return np.asarray([h["loss"] for h in self.history])
