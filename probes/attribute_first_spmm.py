"""Where the first EB and RB kernels spent their time, at the serving
shapes of ``chip_smoke.py`` (PERF.md section 5).

    PYTHONPATH=src python3 probes/attribute_first_spmm.py

Builds ``probes/first_spmm.cu`` (the first kernels, with switches) with
the port's nvcc flags and times, as medians of five 10-call CUDA-event
windows: EB's zero fill, its epilogue launch, the kernel alone, with
plain stores in place of its atomics, its gathers alone, the hub rows'
tiles against as many other tiles; RB with 4- and 16-byte gathers, with
and without its padding slots; ``torch.sparse.mm`` beside them.  Needs
one GPU.
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
from repro_torch.core import Epilogue, Schedule  # noqa: E402
from repro_torch.kernels import build, common  # noqa: E402
from repro_torch.models import GCN  # noqa: E402
from repro_torch.sparse import matrix_stats  # noqa: E402


def ms(fn):
    return statistics.median(cs.cuda_ms(fn, 10, 2) for _ in range(5))


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    lib_path = build.BUILD_DIR / "libfirst_spmm.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib_path), str(ROOT / "probes/first_spmm.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.eb_probe_launch.argtypes = ([ctypes.c_void_p] * 5
                                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.rb_probe_launch.argtypes = ([ctypes.c_void_p] * 4
                                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.epilogue_launch.argtypes = ([ctypes.c_void_p] * 4
                                    + [ctypes.c_longlong]
                                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    graphs = cs.make_graphs(cs.N_NODES, dev)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(cs.N_NODES, cs.N_FEAT, generator=gen).to(dev)
    model = GCN(cs.N_FEAT, cs.HIDDEN, cs.N_CLASS, device=dev,
                generator=torch.Generator().manual_seed(0))
    stream = torch.cuda.current_stream().cuda_stream
    adj = graphs["social"][0]
    n = adj.shape[0]
    lengths = (adj.indptr[1:] - adj.indptr[:-1]).long()
    hubs = torch.topk(lengths, 3).indices.tolist()
    relu = Epilogue("relu", bias=True)
    with torch.no_grad():
        b1 = (x @ model.w1).contiguous()
        b2 = torch.randn(n, cs.N_CLASS, generator=gen).to(dev)
        for b in (b1, b2):
            w = b.shape[1]
            s = Schedule.auto(matrix_stats(adj), w)
            g, tile = adj.grouped(s.nnz_tile), s.nnz_tile
            tiles = g.nnz_padded // tile
            out = torch.zeros((n, w), device=dev)
            res = {"zero fill": ms(lambda: torch.zeros((n, w), device=dev))}
            if w == cs.HIDDEN:
                bias_c, _, act, _ = common.cuda_epilogue_args(
                    relu, model.b1, None, model.b1.device)
                res["epilogue launch (bias + relu)"] = ms(
                    lambda: lib.epilogue_launch(
                        out.data_ptr(), bias_c.data_ptr(), None,
                        out.data_ptr(), out.numel(), w, act, 0, 0, stream))

            def eb(mode, tile0=0, count=tiles):
                off = 4 * tile0 * tile
                return lib.eb_probe_launch(
                    g.rows.data_ptr() + off, g.cols.data_ptr() + off,
                    g.vals.data_ptr() + off, b.data_ptr(), out.data_ptr(),
                    count, w, tile, s.col_tile, s.group_size, mode, stream)

            for mode, label in ((0, "kernel alone (atomics)"),
                                (1, "plain stores for the atomics"),
                                (2, "gathers alone")):
                res[label] = ms(lambda m=mode: eb(m))
            spans = [(int(adj.indptr[h]) // tile,
                      -(-int(adj.indptr[h + 1]) // tile)
                      - int(adj.indptr[h]) // tile) for h in hubs]
            n_hub = sum(c for _, c in spans)
            res[f"hub rows' {n_hub} tiles, atomics"] = ms(
                lambda: [eb(0, a, c) for a, c in spans])
            res[f"hub rows' {n_hub} tiles, plain stores"] = ms(
                lambda: [eb(1, a, c) for a, c in spans])
            res[f"{n_hub} other tiles, atomics"] = ms(lambda: eb(0, 10, n_hub))
            lib_csr = cs.library_csr(adj)
            res["torch.sparse.mm"] = ms(lambda: torch.sparse.mm(lib_csr, b))
            print(f"EB social N={w} ({s}): gathers requested "
                  f"{adj.nnz * w * 4} bytes", flush=True)
            for k, v in res.items():
                print(f"  {k:40s} {v:.4f} ms", flush=True)
        adj, rs = graphs["roadnet"]
        e = adj.ell(row_tile=rs.row_tile)
        for b in ((x @ model.w1).contiguous(), b2):
            w = b.shape[1]
            out = torch.empty((n, w), device=dev)
            res = {}
            for mode, label in ((0, "4-byte gathers"), (1, "skip padding"),
                                (2, "16-byte gathers"),
                                (3, "16-byte, skip padding")):
                res[label] = ms(lambda m=mode: lib.rb_probe_launch(
                    e.cols.data_ptr(), e.vals.data_ptr(), b.data_ptr(),
                    out.data_ptr(), n, e.width, w, rs.row_tile,
                    min(rs.col_tile, w), m, stream))
            lib_csr = cs.library_csr(adj)
            res["torch.sparse.mm"] = ms(lambda: torch.sparse.mm(lib_csr, b))
            print(f"RB roadnet N={w}: ELL {tuple(e.cols.shape)}, "
                  f"{1 - adj.nnz / (n * e.width):.3f} of its slots padding",
                  flush=True)
            for k, v in res.items():
                print(f"  {k:40s} {v:.4f} ms", flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
