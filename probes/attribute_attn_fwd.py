"""Where the first attention forward (a warp per (head, row), walking
the whole row) spends its time on the two graphs of ``chip_smoke.py``
(169,343 nodes, 4 heads x 64, the adjacency's values as the score bias;
PERF.md section 6).

    PYTHONPATH=src python3 probes/attribute_attn_fwd.py

Builds ``probes/first_attn_fwd.cu`` (that kernel with switches) with the
port's nvcc flags and times, as medians of five 3-call CUDA-event
windows: the launch as it was; with the rows longer than ``LONG``
nonzeros left out (the launch a split leaves to whole rows); those rows
alone; the longest row alone (a one-row pattern); and, on the launch
without the long rows, the walk with no V accumulation, with every K
gather and with every V gather sent to one L2-resident row.  Needs one
GPU.
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

#: Rows longer than this are the ones a split takes (``BWD_CHUNK``).
LONG = 512
#: Switches of first_attn_fwd.cu.
OUT, ONLY, NO_V, K_HIT, V_HIT = 1, 2, 4, 8, 16


def ms(fn):
    return statistics.median(cs.cuda_ms(fn, 3, 1) for _ in range(5))


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    lib_path = build.BUILD_DIR / "libfirst_attn_fwd.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib_path),
                    str(ROOT / "probes/first_attn_fwd.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).attn_fwd_probe_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    graphs = cs.make_graphs(cs.N_NODES, dev)
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    stream = torch.cuda.current_stream().cuda_stream
    scale = cs.HEAD_DIM ** -0.5
    for name, (adj, _) in graphs.items():
        n = adj.shape[0]
        q, k, v, _ = (cs.head_major(t)
                      for t in cs.attention_operands(adj, gen, dev))
        out = torch.empty_like(v)
        m = torch.empty(cs.HEADS, n, device=dev)
        l = torch.empty_like(m)

        def run(mode, ip=adj.indptr, cols=adj.indices, bias=adj.vals, qq=q,
                rows=n):
            err = fn(ip.data_ptr(), cols.data_ptr(), bias.data_ptr(),
                     qq.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), m.data_ptr(), l.data_ptr(), rows, n,
                     cs.HEADS, cs.HEAD_DIM, cs.HEAD_DIM, scale, mode, LONG,
                     stream)
            if err:
                cs.fail(f"attn_fwd_probe_launch: cudaError_t {err}")

        lengths = (adj.indptr[1:] - adj.indptr[:-1]).long()
        long_rows = lengths > LONG
        res = {"launch as it was": ms(lambda: run(0))}
        if bool(long_rows.any()):
            hub = int(lengths.argmax())
            lo, hi = int(adj.indptr[hub]), int(adj.indptr[hub + 1])
            ip = torch.tensor([0, hi - lo], dtype=torch.int32, device=dev)
            qh = q[:, hub:hub + 1].contiguous()
            res.update({
                f"rows over {LONG} left out": ms(lambda: run(OUT)),
                f"rows over {LONG} alone": ms(lambda: run(ONLY)),
                f"the longest row ({hi - lo} nnz) alone": ms(
                    lambda: run(0, ip, adj.indices[lo:hi], adj.vals[lo:hi],
                                qh, 1))})
            base = OUT
        else:
            base = 0
        tag = f" (rows over {LONG} left out)" if base else ""
        res.update({
            f"no V accumulation{tag}": ms(lambda: run(base | NO_V)),
            f"K gathers to one row{tag}": ms(lambda: run(base | K_HIT)),
            f"V gathers to one row{tag}": ms(lambda: run(base | V_HIT)),
            f"K and V gathers to one row{tag}": ms(
                lambda: run(base | K_HIT | V_HIT))})
        print(f"attention forward {name} ({n} rows, nnz {adj.nnz}, "
              f"{cs.HEADS} heads x {cs.HEAD_DIM}; {int(long_rows.sum())} "
              f"rows over {LONG} hold {int(lengths[long_rows].sum())} nnz, "
              f"row max {int(lengths.max())}):", flush=True)
        for key, val in res.items():
            print(f"  {key:60s} {val:.4f} ms", flush=True)
        del q, k, v, out, m, l
        torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
