"""Where the first attention backward (a warp per (head, row), walking
the whole row) spent its time on the social graph of ``chip_smoke.py``
(169,343 nodes, 4 heads x 64, the adjacency's values as the score bias;
PERF.md section 6).

    PYTHONPATH=src python3 probes/attribute_attn_bwd.py

Builds ``probes/first_attn_bwd.cu`` (that kernel with switches) with the
port's nvcc flags and times, as medians of five 3-call CUDA-event
windows: the launch as it was; with the three hub rows left out; the hub
rows alone; with the dK and dV atomics of the hub columns (the same
nodes: the graph is symmetrised) sent to a scratch row per warp, with
and without the hub rows.  The roadnet graph's launch is timed beside
it.  Needs one GPU.
"""
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import fused_attention as fa  # noqa: E402

HUBS = 3
SCRATCH_ROWS = 8192  # as in first_attn_bwd.cu


def ms(fn):
    return statistics.median(cs.cuda_ms(fn, 3, 1) for _ in range(5))


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    lib_path = build.BUILD_DIR / "libfirst_attn_bwd.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib_path),
                    str(ROOT / "probes/first_attn_bwd.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.attn_bwd_probe_launch.argtypes = ([ctypes.c_void_p] * 14
                                          + [ctypes.c_int] * 5
                                          + [ctypes.c_float]
                                          + [ctypes.c_int] * 2
                                          + [ctypes.c_void_p])
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    graphs = cs.make_graphs(cs.N_NODES, dev)
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    stream = torch.cuda.current_stream().cuda_stream
    scale = cs.HEAD_DIM ** -0.5
    for name, (adj, _) in graphs.items():
        n = adj.shape[0]
        q, k, v, do = (cs.head_major(t)
                       for t in cs.attention_operands(adj, gen, dev))
        _, m, l = fa.fused_sparse_attention(adj.indptr, adj.indices, q, k, v,
                                            scale=scale, bias=adj.vals)
        lengths = (adj.indptr[1:] - adj.indptr[:-1]).long()
        top = torch.topk(lengths, HUBS + 1)
        long_len = int(top.values[HUBS])
        hub_col = torch.zeros(n, dtype=torch.uint8, device=dev)
        hub_col[top.indices[:HUBS]] = 1
        scratch = torch.zeros(SCRATCH_ROWS, 2 * cs.HEAD_DIM, device=dev)
        dq = torch.empty_like(q)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)

        def run(mode):
            err = lib.attn_bwd_probe_launch(
                adj.indptr.data_ptr(), adj.indices.data_ptr(),
                adj.vals.data_ptr(), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                hub_col.data_ptr(), scratch.data_ptr(), n, n, cs.HEADS,
                cs.HEAD_DIM, cs.HEAD_DIM, scale, mode, long_len, stream)
            if err:
                cs.fail(f"attn_bwd_probe_launch: cudaError_t {err}")

        res = {"launch as it was": ms(lambda: run(0))}
        if name == "social":
            res.update({
                f"the {HUBS} hub rows left out": ms(lambda: run(1)),
                f"the {HUBS} hub rows alone": ms(lambda: run(2)),
                "hub columns' atomics to scratch": ms(lambda: run(4)),
                "hub rows left out, their columns' atomics to scratch":
                    ms(lambda: run(5))})
        print(f"attention backward {name} ({n} rows, nnz {adj.nnz}, "
              f"{cs.HEADS} heads x {cs.HEAD_DIM}; rows longer than "
              f"{long_len}: {top.values[:HUBS].tolist()}, in "
              f"{int(hub_col.sum())} hub columns):", flush=True)
        for key, val in res.items():
            print(f"  {key:54s} {val:.4f} ms", flush=True)
        del q, k, v, do, m, l, dq, dk, dv
        torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
