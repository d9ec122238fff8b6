"""Quickstart: the Sgap segment-group SpMM through the unified Schedule API
(port of ``examples/quickstart.py``, sections 1-9).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

It runs on the card unless ``--device cpu`` is given (the kernels' plain
versions) and prints ``done`` at the end.  Each section checks its
results against the oracle (``impl="ref"``) at the reference's 1e-4,
except a result of ``schedule="tune"``: the tuner may pick a narrow
storage type, and such a result is held to the reference's tolerance for
that type (``TOL``, relative L2; an f32 pick stays at 1e-4).  Section 3
registers a strategy in the port's form (``core.register_strategy``: a
spec, and a realization that gets the tile's global ids, its partials
and the whole accumulator, ``kernels/common.py::apply_user_tile``);
section 7 runs on a one-process world, as the reference runs on its
one-device mesh.
"""
from __future__ import annotations

import argparse
import re

import numpy as np
import torch

from repro_torch import fuse
from repro_torch.core import fp8_supported, register_strategy, resolve_device
from repro_torch.launch.mesh import make_reduction_mesh
from repro_torch.models.layers import gcn_layer
from repro_torch.sparse import (
    Schedule,
    dist_spmm,
    matrix_stats,
    power_law_csr,
    quantize_csr,
    random_csr,
    segment_reduce,
    spmm,
)
from repro_torch.tune import ScheduleCache, tune_dist_spmm, tune_schedule

#: Relative L2 tolerance of a result at each narrow storage type: the
#: reference's ``TOL`` (``tests/test_lowprec.py``), storage rounding
#: only, the sums being f32.
TOL = {"bfloat16": 2e-2, "float16": 3e-3, "float8_e4m3fn": 1.5e-1,
       "int8": 5e-2}


def _np(t):
    return t.detach().cpu().numpy()


def check(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def check_tuned(got, want, value_dtype):
    """A ``schedule="tune"`` result: 1e-4 for an f32 pick, else the
    pick's storage tolerance in relative L2."""
    if value_dtype in (None, "float32"):
        check(got, want)
        return
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    err = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12)
    assert err <= TOL[value_dtype], (value_dtype, err)


def normal(shape, seed, dev):
    """Standard normal f32 from a numpy seed, on ``dev``."""
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape),
                        dtype=torch.float32, device=dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: the kernels) or 'cpu' (their "
                         "plain versions)")
    dev = resolve_device(ap.parse_args(argv).device)

    # A skewed sparse matrix (a few very long rows): the regime where the
    # paper's flexible reduction wins.
    a = random_csr(512, 512, density=0.02, skew=1.5, seed=0, device=dev)
    b = normal((512, 8), 0, dev)

    # 1. schedule='auto' runs the data-aware selector.
    stats = matrix_stats(a)
    print(f"matrix: {stats['nnz']} nnz, row CV {stats['row_cv']:.2f}")
    print(f"auto schedule: {Schedule.auto(stats, b.shape[1])}")
    ref = spmm(a, b, impl="ref", device=dev)
    check(spmm(a, b, schedule="auto", device=dev), ref)
    print("auto schedule matches oracle")

    # 2. The four DA-SpMM points, and explicit schedules.
    for name in ("EB+PR", "EB+SR", "RB+PR", "RB+SR"):
        check(spmm(a, b, schedule=name, device=dev), ref)
        print(f"{name}: OK")
    for r in (8, 32):
        s = Schedule("eb", nnz_tile=256, col_tile=8, group_size=r,
                     strategy="segment")
        check(spmm(a, b, schedule=s, device=dev), ref)
        print(f"group size r={r}: OK")

    # 3. A user-defined reduction strategy: a spec and its realization,
    #    a one-hot product per tile over the whole accumulator.
    def onehot(ids, n, dtype):
        return (ids[:, None] == torch.arange(n, device=ids.device)).to(dtype)

    def spec(partials, seg_ids, num_segments, group_size):
        return onehot(seg_ids, num_segments, partials.dtype).T @ partials

    def realization(rows, partial, out, group_size):
        out += onehot(rows, out.shape[0], partial.dtype).T @ partial

    register_strategy("onehot-tile", spec, realization, overwrite=True)
    rng = np.random.default_rng(0)
    seg = torch.tensor(np.sort(rng.integers(0, 40, 200)), dtype=torch.int32,
                       device=dev)
    data = normal((200, 8), 1, dev)
    got = segment_reduce(seg, data, 40,
                         schedule=Schedule("eb", nnz_tile=64, group_size=32,
                                           strategy="onehot-tile"),
                         device=dev)
    want = torch.zeros(40, 8, device=dev).index_add_(0, seg.long(), data)
    check(got, want)
    print("custom strategy through the kernel: OK")

    # 4. Monoids and fused epilogues: a segment max, and a GCN layer's
    #    act(A @ XW + b) as one kernel.
    got_max = segment_reduce(seg, data, 40, op="max", device=dev)
    want_max = torch.full((40, 8), -torch.inf, device=dev).scatter_reduce_(
        0, seg.long()[:, None].expand_as(data), data, "amax")
    check(got_max, want_max)
    print("segment_reduce(op='max') through the registry: OK")
    w = normal((512, 16), 2, dev) * 0.1
    bias = normal((16,), 3, dev)
    fused = gcn_layer(a, torch.eye(512, device=dev), w, bias,
                      activation="relu", schedule="auto", device=dev)
    check(fused, torch.relu(spmm(a, w, impl="ref", device=dev) + bias))
    print("fused GCN layer (bias+relu epilogue, one kernel): OK")

    # 5. The fusion planner: the two-layer GCN chain plans to two launches.
    w1 = normal((16, 8), 4, dev) * 0.1
    chain, params = fuse.gcn_chain(a, (w, w1), (bias, None),
                                   schedule="EB+PR")
    plan = fuse.plan(chain)
    print("GCN chain plan:", plan.decision.tag,
          f"({plan.n_launches} planned launches)")
    assert plan.n_launches <= 2
    for boundary, reason in enumerate(plan.reasons):
        if reason:
            print(f"  boundary {boundary} split: {reason}")
    x = torch.eye(512, device=dev)
    check(fuse.run_plan(plan, x, params, device=dev),
          fuse.run_chain_ref(chain, x, params))
    print("planned 2-layer GCN matches the unfused spec: OK")
    cache = ScheduleCache(path=None)  # memory only
    res = fuse.tune_plan(chain, x, params, cache=cache, warmup=0, iters=1)
    print("tuned decision:", res.schedule.tag, "| cached replay:",
          fuse.tune_plan(chain, x, params, cache=cache).from_cache)

    # 6. Skew-aware two-level scheduling on a power-law graph.
    g = power_law_csr(1024, 1024, avg_degree=8.0, alpha=1.8, seed=0,
                      device=dev)
    gstats = matrix_stats(g)
    print(f"power-law graph: {gstats['nnz']} nnz, row CV "
          f"{gstats['row_cv']:.2f}, q50/q90/q99 row lengths "
          f"{[q for _, q in gstats['row_quantiles']]}")
    res = tune_schedule(g, 4, cache=cache, warmup=1, iters=3)
    print("tuned schedule:", res.schedule)
    best_static = min(us for key, us in res.measured.items()
                      if not re.search(r":s\d", key))  # no skew layout
    print(f"tuned vs best static point: {best_static / res.us_per_call:.2f}x")
    bg = normal((1024, 4), 5, dev)
    spmm(g, bg, schedule=res.schedule, device=dev)
    print("skew-tuned spmm runs: OK | cached replay:",
          tune_schedule(g, 4, cache=cache).from_cache)

    # 7. Reduction strategies one level up, across the ranks of a mesh
    #    (here the one-process world).
    mesh = make_reduction_mesh(device=dev)
    print(f"mesh: {mesh.shape}")
    out_d = dist_spmm(g, bg, mesh=mesh, axis="shards", schedule="tune",
                      cache=cache)
    res_d = tune_dist_spmm(g, 4, mesh=mesh, axis="shards", cache=cache)
    check_tuned(out_d, spmm(g, bg, impl="ref", device=dev),
                res_d.schedule.value_dtype)
    print("distributed spmm matches oracle: OK | tuned collective:",
          res_d.schedule.collective, "| cached replay:", res_d.from_cache)

    # 8. Low-precision value storage, f32 accumulation.
    s16 = Schedule("eb", nnz_tile=256, col_tile=8, group_size=8,
                   strategy="segment", value_dtype="bfloat16")
    out16 = spmm(a, b, schedule=s16, device=dev)
    err16 = float(torch.linalg.norm(out16 - ref) / torch.linalg.norm(ref))
    print(f"bf16 storage, f32 accumulation: rel err {err16:.1e}")
    qa = quantize_csr(a)  # int8 values and per-row f32 scales
    qerr = float((qa.dequantize().vals - a.vals).abs().max())
    print(f"int8 per-row quantization round-trip: max abs err {qerr:.1e}")
    res8 = tune_schedule(a, 8, cache=ScheduleCache(path=None), warmup=0,
                         iters=1, value_dtypes=("bfloat16", "int8"))
    print("tuned with dtype axis:", res8.schedule.value_dtype or "float32",
          "| fp8 native here:", fp8_supported())

    # 9. Joint axis search: local tiling x collective x value dtype.
    res_j = tune_dist_spmm(g, 4, mesh=mesh, axis="shards",
                           cache=ScheduleCache(path=None), warmup=0, iters=1)
    sj = res_j.schedule
    print(f"joint collective x dtype search: collective={sj.collective}",
          f"| dtype={sj.value_dtype or 'float32'}",
          f"| points measured={res_j.n_measurements}")
    print("done")


if __name__ == "__main__":
    main()
