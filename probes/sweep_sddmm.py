"""The SDDMM kernel (``csrc/sddmm.cu``) beside the first one
(``probes/first_sddmm.cu``) on the training path of ``chip_smoke.py``:
the gradient in the adjacency's values over the CSR's row-sorted stream
of each 169,343-node graph at both layers' widths (256 and 40; PERF.md
section 6, row 3).

    PYTHONPATH=src python3 probes/sweep_sddmm.py

Builds the first kernel, and the kernel with the entries a worker keeps
in flight (``U``) as it is and at 2, 4 and 8 over the vectors a lane
holds (``VPL``), each from a copy of the source with that constant
rewritten, printing each kernel's registers.  Per (graph, width), as
medians of five CUDA-event windows of about 5 ms: the first kernel;
each variant through the wrapper (nnz tile 256, its default); the
kernel as it is at
nnz tiles of 1024 and 4096; with every column index 0 (each B gather
reads one L2-resident row) and with every row index 0 (A's row never
reloaded).  Each variant's output is held to the plain version at
``chip_smoke.F32_TOL``.  Needs one GPU.
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import sddmm  # noqa: E402

U_LINE = "constexpr int U = VPL == 1 ? 4 : 1;"
#: name -> (text replaced, replacement); "as is" builds the source as it is
VARIANTS = {
    "as is": None,
    "U = 2 / VPL": (U_LINE, "constexpr int U = VPL >= 2 ? 1 : 2 / VPL;"),
    "U = 4 / VPL": (U_LINE, "constexpr int U = VPL >= 4 ? 1 : 4 / VPL;"),
    "U = 8 / VPL": (U_LINE, "constexpr int U = VPL >= 8 ? 1 : 8 / VPL;"),
}


def registers(report):
    """{kernel<template arguments>: registers} from nvcc's ``-Xptxas -v``
    report."""
    out, name = {}, None
    for line in report.splitlines():
        hit = re.search(r"entry function '.*?(sddmm_(?:kernel|wide_kernel|"
                        r"probe))(?:I(\w+?)EEv)?", line)
        if hit:
            args = ",".join(re.findall(r"Li(\d+)E", (hit.group(2) or "")
                                       + "E"))
            name = f"{hit.group(1)}<{args}>"
        elif "Used" in line and name:
            out[name] = int(line.split("Used ")[1].split(" ")[0])
            name = None
    return out


def nvcc(src, lib):
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(lib), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "sddmm.cu").read_text()
    procs = {}
    for i, (name, edit) in enumerate(VARIANTS.items()):
        if edit is not None and edit[0] not in text:
            cs.fail(f"sddmm.cu no longer holds {edit[0]!r}")
        src = build.BUILD_DIR / f"sddmm_variant{i}.cu"
        src.write_text(text if edit is None else text.replace(*edit))
        procs[name] = (src.with_suffix(".so"),
                       nvcc(src, src.with_suffix(".so")))
    first_lib = build.BUILD_DIR / "libfirst_sddmm.so"
    procs["first"] = (first_lib, nvcc(ROOT / "probes/first_sddmm.cu",
                                      first_lib))
    fns = {}
    for name, (lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            cs.fail(f"nvcc {name}:\n{report}")
        print(f"build {name}: registers {registers(report)}", flush=True)
        if name == "first":
            first = ctypes.CDLL(str(lib)).sddmm_probe_launch
            first.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            first.restype = ctypes.c_int
        else:
            fn = ctypes.CDLL(str(lib)).sddmm_launch
            fn.argtypes = sddmm.KERNEL.argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    graphs = cs.make_graphs(cs.N_NODES, dev)
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    stream = torch.cuda.current_stream().cuda_stream
    total = {}
    for gname, (adj, _) in graphs.items():
        n, nnz = adj.shape[0], adj.nnz
        coo = adj.tocoo()
        zeros = torch.zeros_like(coo.cols)
        for width in (cs.HIDDEN, cs.N_CLASS):
            dz, b = (torch.randn(n, width, generator=gen).to(dev)
                     for _ in range(2))
            out = torch.empty(nnz, device=dev)
            want = sddmm.sddmm_plain(coo.rows, coo.cols, dz, b)

            def run_first():
                err = first(coo.rows.data_ptr(), coo.cols.data_ptr(),
                            dz.data_ptr(), b.data_ptr(), None,
                            out.data_ptr(), nnz, width, 256, 0, stream)
                if err:
                    cs.fail(f"sddmm_probe_launch: cudaError_t {err}")

            res = {"the first kernel": cs.cuda_ms_median(run_first)}
            for name, fn in fns.items():
                sddmm.KERNEL._fn = fn
                err, _, ok = cs.compare(
                    sddmm.sddmm(coo.rows, coo.cols, dz, b), want)
                res[f"{name} (max_abs_err {err:.2e} "
                    f"{'ok' if ok else 'FAIL'})"] = cs.cuda_ms_median(
                        lambda: sddmm.sddmm(coo.rows, coo.cols, dz, b))
            sddmm.KERNEL._fn = fns["as is"]
            for tile in (1024, 4096):
                res[f"as is, nnz tile {tile}"] = cs.cuda_ms_median(
                    lambda: sddmm.sddmm(coo.rows, coo.cols, dz, b,
                                        nnz_tile=tile))
            res["as is, every B gather to row 0"] = cs.cuda_ms_median(
                lambda: sddmm.sddmm(coo.rows, zeros, dz, b))
            res["as is, every row index 0"] = cs.cuda_ms_median(
                lambda: sddmm.sddmm(zeros, coo.cols, dz, b))
            bound_ms, _ = cs.bound(nnz * 12 + 2 * n * width * 4,
                                   2 * nnz * width)
            g = sddmm.sddmm_geometry(width, True)
            print(f"SDDMM {gname} width {width} (nnz {nnz}; bound "
                  f"{bound_ms:.4f} ms by bytes; gathers of B requested "
                  f"{nnz * width * 4} bytes; workers of {g.lw} lanes, "
                  f"{g.workers} a warp, {g.vpl} vectors a lane):",
                  flush=True)
            for key, val in res.items():
                total[key.split(" (")[0]] = total.get(
                    key.split(" (")[0], 0.0) + val
                print(f"  {key:44s} {val:.4f} ms", flush=True)
            del dz, b, out, want
        del zeros
        torch.cuda.empty_cache()
    print("SDDMM, the four (graph, width) cases summed: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in total.items()), flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
