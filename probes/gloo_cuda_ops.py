#!/usr/bin/env python3
"""Which collectives a gloo process group takes on CUDA tensors, with
several ranks sharing one GPU (NCCL refuses two ranks on one device).

    python3 probes/gloo_cuda_ops.py [--ranks 2 4] [--rows 169344]

For each world size it starts that many rank processes on ``cuda:0``
meeting at a ``FileStore`` in a temporary directory, and each rank tries
``all_reduce`` (SUM, MAX), ``reduce_scatter_tensor``, ``reduce_scatter``
(a list of blocks) and ``all_gather_into_tensor`` on CUDA tensors and on
CPU tensors, in f32 and in bf16: whether the call is taken, whether its
result is right, and its time (host clock, after a barrier; the largest
over the ranks) on a (rows, 256) tensor, the size of a distributed
SpMM's partial.  This is the probe behind ``distributed/collectives.py``
handing CUDA tensors to gloo for every op it calls, in their own type
(the expert-parallel MoE's all-gather and the trainer's bf16 gradients
included).
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

RANK = r"""
import json, sys, time, traceback
import torch
import torch.distributed as dist
rank, world, store_path, rows = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], int(sys.argv[4]))
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)
out = {}
for dev, dt in (("cuda", torch.float32), ("cpu", torch.float32),
                ("cuda", torch.bfloat16), ("cpu", torch.bfloat16)):
    for op in ("all_reduce_sum", "all_reduce_max", "reduce_scatter_tensor",
               "reduce_scatter", "all_gather_into_tensor"):
        try:
            x = torch.full((rows, 256), float(rank + 1), device=dev,
                           dtype=dt)
            dist.barrier()
            t0 = time.perf_counter()
            if op == "all_reduce_sum":
                dist.all_reduce(x, op=dist.ReduceOp.SUM)
                y, want = x, sum(range(1, world + 1))
            elif op == "all_reduce_max":
                dist.all_reduce(x, op=dist.ReduceOp.MAX)
                y, want = x, world
            elif op == "reduce_scatter_tensor":
                y = torch.empty((rows // world, 256), device=dev, dtype=dt)
                dist.reduce_scatter_tensor(y, x)
                want = sum(range(1, world + 1))
            elif op == "reduce_scatter":
                y = torch.empty((rows // world, 256), device=dev, dtype=dt)
                dist.reduce_scatter(y, list(x.chunk(world)))
                want = sum(range(1, world + 1))
            else:
                y = torch.empty((rows * world, 256), device=dev, dtype=dt)
                dist.all_gather_into_tensor(y, x)
                want = None
            if dev == "cuda":
                torch.cuda.synchronize()
            s = time.perf_counter() - t0
            if want is None:
                ok = bool(torch.equal(
                    y.view(world, rows, 256)[:, 0, 0].float().cpu(),
                    torch.arange(1, world + 1, dtype=torch.float32)))
            else:
                ok = bool((y == want).all())
            t = torch.tensor([s])
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            name = f"{dev} {str(dt)[6:]} {op}"
            out[name] = {"taken": True, "right": ok,
                                  "ms": float(t) * 1e3}
        except Exception as e:  # the probe's question is whether it raises
            out[f"{dev} {str(dt)[6:]} {op}"] = {"taken": False,
                                  "error": f"{type(e).__name__}: {e}"[:300]}
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--rows", type=int, default=169_344)
    args = ap.parse_args()
    import torch

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for world in args.ranks:
        with tempfile.TemporaryDirectory() as tmp:
            store = os.path.join(tmp, "store")
            procs = [subprocess.Popen(
                [sys.executable, "-c", RANK, str(r), str(world), store,
                 str(args.rows)], stdout=subprocess.PIPE, text=True)
                for r in range(world)]
            t0 = time.perf_counter()
            outs = []
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=300)[0])
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    sys.exit(f"world {world}: a rank hung")
            print(f"world {world} ({time.perf_counter() - t0:.1f} s, rcs "
                  f"{[p.returncode for p in procs]}):", flush=True)
            res = json.loads(outs[0].strip().splitlines()[-1])
            for k, v in res.items():
                print(f"  {k:32s} {json.dumps(v)}", flush=True)


if __name__ == "__main__":
    main()
