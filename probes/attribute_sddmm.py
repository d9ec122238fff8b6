"""Where the first SDDMM kernel (a warp per nonzero, its lanes across
the feature axis) spends its time on the training path of
``chip_smoke.py``: the gradient in the adjacency's values, over the
CSR's row-sorted stream of each 169,343-node graph at both layers'
widths (256 and 40; PERF.md section 6, row 3).

    PYTHONPATH=src python3 probes/attribute_sddmm.py

Builds ``probes/first_sddmm.cu`` (that kernel with switches) with the
port's nvcc flags and times, per (graph, width), as medians of five
CUDA-event windows of about 5 ms: the launch as it was (nnz tile 256,
the wrapper's default); with every B gather sent to one L2-resident
row; without the shuffle reduction; with both.  Beside them, the bytes
bound (index stream, output, A and B once) and the gathers requested
(nnz x width x 4 bytes for B, as many for A).  Needs one GPU.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

NNZ_TILE = 256
#: Switches of first_sddmm.cu.
B_HIT, NO_REDUCE = 1, 2


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    lib_path = build.BUILD_DIR / "libfirst_sddmm.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(ROOT / "probes/first_sddmm.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).sddmm_probe_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    graphs = cs.make_graphs(cs.N_NODES, dev)
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    stream = torch.cuda.current_stream().cuda_stream
    total = {}
    for name, (adj, _) in graphs.items():
        n, nnz = adj.shape[0], adj.nnz
        coo = adj.tocoo()
        for width in (cs.HIDDEN, cs.N_CLASS):
            dz, b = (torch.randn(n, width, generator=gen).to(dev)
                     for _ in range(2))
            out = torch.empty(nnz, device=dev)

            def run(mode):
                err = fn(coo.rows.data_ptr(), coo.cols.data_ptr(),
                         dz.data_ptr(), b.data_ptr(), None, out.data_ptr(),
                         nnz, width, NNZ_TILE, mode, stream)
                if err:
                    cs.fail(f"sddmm_probe_launch: cudaError_t {err}")

            res = {"launch as it was": cs.cuda_ms_median(lambda: run(0)),
                   "B gathers to one row": cs.cuda_ms_median(
                       lambda: run(B_HIT)),
                   "no shuffle reduction": cs.cuda_ms_median(
                       lambda: run(NO_REDUCE)),
                   "both": cs.cuda_ms_median(lambda: run(B_HIT | NO_REDUCE))}
            bound_ms, _ = cs.bound(nnz * 12 + 2 * n * width * 4,
                                   2 * nnz * width)
            for key, val in res.items():
                total[key] = total.get(key, 0.0) + val
            print(f"SDDMM {name} width {width} (nnz {nnz}; bound "
                  f"{bound_ms:.4f} ms by bytes; gathers requested "
                  f"{2 * nnz * width * 4} bytes):", flush=True)
            for key, val in res.items():
                print(f"  {key:24s} {val:.4f} ms", flush=True)
            del dz, b, out
        torch.cuda.empty_cache()
    print("SDDMM, the four (graph, width) cases summed: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in total.items()), flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
