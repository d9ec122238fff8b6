"""Fault tolerance (port of ``repro/distributed/fault_tolerance.py``, the
reference's code: it is host-side and imports neither JAX nor torch):
heartbeats, straggler detection, elastic re-mesh, CPU-simulatable.

Model: the trainer ticks a HeartbeatMonitor with per-host step latencies.
A host that misses ``timeout_s`` is *dead* -> restart from checkpoint on a
smaller mesh (``plan_remesh``). A host whose step time exceeds
``straggler_factor`` × the fleet p50 for ``patience`` consecutive steps is
a *straggler* -> it is reported for eviction (a pod cannot re-balance a
single slow chip; eviction + elastic re-mesh is the production response).
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque


@dataclasses.dataclass
class HostStatus:
    alive: bool
    straggler: bool
    last_seen: float
    p50_ratio: float


class HeartbeatMonitor:
    def __init__(self, hosts, *, timeout_s: float = 60.0,
                 straggler_factor: float = 1.5, patience: int = 3,
                 window: int = 20, clock=time.monotonic):
        self.hosts = list(hosts)
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.patience = patience
        self.clock = clock
        self.last_seen = {h: clock() for h in self.hosts}
        self.lat = {h: deque(maxlen=window) for h in self.hosts}
        self.slow_streak = defaultdict(int)

    def beat(self, host, step_latency_s: float):
        self.last_seen[host] = self.clock()
        self.lat[host].append(step_latency_s)

    def _p50(self):
        vals = sorted(v for d in self.lat.values() for v in d)
        return vals[len(vals) // 2] if vals else 0.0

    def poll(self) -> dict:
        """host -> HostStatus; updates straggler streaks."""
        now = self.clock()
        p50 = self._p50()
        out = {}
        for h in self.hosts:
            alive = (now - self.last_seen[h]) < self.timeout_s
            mine = self.lat[h][-1] if self.lat[h] else 0.0
            ratio = (mine / p50) if p50 > 0 else 1.0
            if alive and p50 > 0 and ratio > self.straggler_factor:
                self.slow_streak[h] += 1
            else:
                self.slow_streak[h] = 0
            out[h] = HostStatus(
                alive=alive,
                straggler=self.slow_streak[h] >= self.patience,
                last_seen=self.last_seen[h],
                p50_ratio=ratio,
            )
        return out

    def dead_hosts(self):
        return [h for h, s in self.poll().items() if not s.alive]

    def stragglers(self):
        return [h for h, s in self.poll().items() if s.straggler]


def plan_remesh(n_healthy_hosts: int, chips_per_host: int = 4,
                model_parallel: int = 16) -> tuple:
    """Largest (data, model) mesh that fits the healthy fleet, keeping the
    model-parallel degree fixed (params must still fit) and data parallel a
    power-of-two for collective efficiency. Returns (data, model)."""
    chips = n_healthy_hosts * chips_per_host
    data = chips // model_parallel
    p = 1
    while p * 2 <= data:
        p *= 2
    if p < 1:
        raise RuntimeError("not enough healthy chips for one model replica")
    return (p, model_parallel)


@dataclasses.dataclass
class ElasticPlan:
    """Restart plan after failures: new mesh shape + which checkpoint step
    to restore + how the global batch is re-tiled."""
    mesh_shape: tuple
    restore_step: int | None
    global_batch: int
    note: str


def make_elastic_plan(monitor: HeartbeatMonitor, ckpt_steps,
                      global_batch: int, chips_per_host: int = 4,
                      model_parallel: int = 16) -> ElasticPlan | None:
    dead = set(monitor.dead_hosts()) | set(monitor.stragglers())
    if not dead:
        return None
    healthy = [h for h in monitor.hosts if h not in dead]
    shape = plan_remesh(len(healthy), chips_per_host, model_parallel)
    step = max(ckpt_steps) if ckpt_steps else None
    dp = shape[0]
    batch = max(dp, (global_batch // dp) * dp)
    return ElasticPlan(
        mesh_shape=shape, restore_step=step, global_batch=batch,
        note=f"evicting {sorted(dead)}; resharding to mesh {shape}")
