#!/usr/bin/env python3
"""What a distributed SpMM's shard-local EB call costs at full height
against the rows its nnz slice covers (``sparse/distributed.py::
_local_spmm``), in one process on one GPU.

    PYTHONPATH=src python3 probes/dist_local_fill.py [--nodes 169344]

An nnz split hands each rank a slice of the row-sorted stream that covers
a fraction of the rows, and the EB kernel stores every row a worker steps
over: run at the full height, the first and the last worker write the
rows before and after the slice alone.  For the social and roadnet graphs
(``chip_smoke.py``'s, normalized) at N = 256 and each slice of a 2- and
4-way ``partition_nnz_coo``, this times (CUDA events, the median of 5
windows of 5 calls): ``kernels/ops.py::spmm`` over the slice at full
height, ``_local_spmm`` (the slice's row range placed in the full
output), and ``torch.zeros`` of the full output, beside the bound of
writing that output once at 3.35 TB/s.
"""
import argparse
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def ms(fn, calls=5, windows=5):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return statistics.median(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=169_344)
    ap.add_argument("--n", type=int, default=256)
    args = ap.parse_args()
    import torch
    from repro_torch.core import Schedule
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.models import normalized_adjacency
    from repro_torch.sparse import (GroupedCOO, graph_pattern_csr,
                                    matrix_stats, partition_nnz_coo)
    from repro_torch.sparse.distributed import _local_spmm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build(("spmm_eb",))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for name in ("social", "roadnet"):
        host = normalized_adjacency(graph_pattern_csr(name, args.nodes,
                                                      seed=0, device="cpu"),
                                    device="cpu")
        n_rows = host.shape[0]
        b = torch.randn(n_rows, args.n, generator=gen).to(dev)
        sched = Schedule.auto(matrix_stats(host), args.n)
        if sched.kernel != "eb":
            sched = Schedule("eb", col_tile=sched.col_tile)
        bound = n_rows * args.n * 4 / 3.35e12 * 1e3
        zeros = ms(lambda: torch.zeros((n_rows, args.n), device=dev))
        print(f"{name}: {n_rows} rows, nnz {host.nnz}, {sched}; torch.zeros "
              f"of the output {zeros:.4f} ms (bound {bound:.4f} ms)",
              flush=True)
        for world in (2, 4):
            rows, cols, vals, _ = partition_nnz_coo(host, world,
                                                    sched.nnz_tile)
            block = rows.shape[0] // world
            for s in range(world):
                r, c, v = (t[s * block:(s + 1) * block].to(dev)
                           for t in (rows, cols, vals))
                g = GroupedCOO(rows=r, cols=c, vals=v,
                               shape=(n_rows, n_rows), nnz=block,
                               nnz_tile=sched.nnz_tile)
                full = kops.spmm(g, b, sched)
                ranged = _local_spmm(r, c, v, b, n_rows, sched)
                same = bool(torch.equal(full, ranged))
                lo, hi = int(r[0]), int(r[-1])
                t_full = ms(lambda: kops.spmm(g, b, sched))
                t_range = ms(lambda: _local_spmm(r, c, v, b, n_rows, sched))
                print(f"  P={world} slice {s}: rows {lo}-{hi} "
                      f"({hi - lo + 1} of {n_rows}); EB at full height "
                      f"{t_full:.4f} ms, over the slice's rows placed in "
                      f"the output {t_range:.4f} ms; same bits {same}",
                      flush=True)


if __name__ == "__main__":
    main()
