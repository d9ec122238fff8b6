"""The combine of a user strategy's tile result into the accumulator
(``csrc/eb_partials.cu``'s ``user_combine_kernel``, PERF.md section 6,
row 1c) beside ``acc.add_(tile)`` on the blocks of ``chip_smoke.py``'s
``user`` phase: the social graph's 169,343 rows at the GCN's widths (256
and 40).

    PYTHONPATH=src python3 probes/sweep_combine.py

Builds the source as it is (one pass of the grid, 2 vectors of each
array in flight a thread, 256 threads a block), at ``COMBINE_UNROLL`` 4
and 8 and at ``COMBINE_THREADS`` 128 and 512 (``-D``), and from copies
of it with one line rewritten: the tile read through the read-only path
instead of a streaming load; the accumulator read under every tile
vector (no skip); every vector written back.  Each variant's device
time under the profiler (``chip_smoke.device_ms``, 20 combines a
window) on three tiles: all ones under add (every element changes, the
dense replay), a seg-generic result under add (+0.0 but on 4,096 random
rows) and a ``seg-max`` result under max (-inf but on 4,096 rows); each
variant's accumulator is held to ``combine_plain``'s bit for bit.  Needs
one GPU.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402
from repro_torch.core import MONOIDS  # noqa: E402
from repro_torch.kernels import build, common, eb_partials  # noqa: E402

#: name -> (-D flags, (text, replacement) or None)
VARIANTS = {
    "as is": ((), None),
    "unroll 4": (("-DCOMBINE_UNROLL=4",), None),
    "unroll 8": (("-DCOMBINE_UNROLL=8",), None),
    "128 threads": (("-DCOMBINE_THREADS=128",), None),
    "512 threads": (("-DCOMBINE_THREADS=512",), None),
    "tile by __ldg": ((), ("__ldcs(reinterpret_cast<const float4*>(p))",
                           "__ldg(reinterpret_cast<const float4*>(p))")),
    "no skip": ((), ("      need[u] = !all;", "      need[u] = true;")),
    "always write": ((), ("if (moved) store_acc", "store_acc")),
}
TILE_ROWS = 4096
COMBINES = 20


def build_variants():
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "eb_partials.cu").read_text()
    procs = {}
    for i, (name, (flags, edit)) in enumerate(VARIANTS.items()):
        src = build.CSRC / "eb_partials.cu"
        if edit is not None:
            if edit[0] not in text:
                cs.fail(f"eb_partials.cu no longer holds {edit[0]!r}")
            src = build.BUILD_DIR / f"probe_combine_{i}.cu"
            src.write_text(text.replace(edit[0], edit[1]))
        lib = build.BUILD_DIR / f"libcombine_probe_{i}.so"
        procs[name] = (src, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *flags, "-I",
             str(build.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (src, lib, p) in procs.items():
        out = p.communicate()[0]
        if src.parent == build.BUILD_DIR:
            src.unlink()
        if p.returncode:
            cs.fail(f"nvcc for {name}:\n{out}")
        regs = [line.split("Used ")[1].split(",")[0]
                for line in out.splitlines() if "Used" in line]
        print(f"{name}: registers {sorted(set(regs))}", flush=True)
        fn = getattr(ctypes.CDLL(str(lib)), "user_combine_launch")
        fn.argtypes = eb_partials.COMBINE.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    fns = build_variants()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(cs.SEED)
    for width in (cs.HIDDEN, cs.N_CLASS):
        shape = (cs.N_NODES, width)
        hit = torch.randperm(cs.N_NODES, generator=gen)[:TILE_ROWS].to(dev)
        cases = {}
        for label, op, empty in (("ones, add", "add", None),
                                 ("seg-generic, add", "add", 0.0),
                                 ("seg-max, max", "max", -float("inf"))):
            if empty is None:
                tile = torch.ones(shape, device=dev)
            else:
                tile = torch.full(shape, empty, device=dev)
                tile[hit] = torch.randn(TILE_ROWS, width, generator=gen).to(
                    dev)
            cases[label] = (op, tile)
        nbytes = 3 * cs.N_NODES * width * 4
        for label, (op, tile) in cases.items():
            acc0 = torch.randn(shape, generator=gen).to(dev)
            times = {}
            if op == "add":
                acc = acc0.clone()
                times["acc.add_"] = sum(cs.device_ms(lambda: [
                    acc.add_(tile) for _ in range(COMBINES)], 1, 3).values())
            for name, fn in fns.items():
                acc = acc0.clone()

                def run(fn=fn, acc=acc):
                    for _ in range(COMBINES):
                        err = fn(acc.data_ptr(), tile.data_ptr(),
                                 acc.numel(), common.CUDA_OPS[op], 4, 0,
                                 dev.index or 0, stream)
                        if err:
                            cs.fail(f"{name}: cudaError_t {err}")

                got = acc0.clone()
                fn(got.data_ptr(), tile.data_ptr(), got.numel(),
                   common.CUDA_OPS[op], 4, 0, dev.index or 0, stream)
                want = acc0.clone()
                common.combine_plain(want, tile, MONOIDS[op])
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    cs.fail(f"{name} {label}: not combine_plain's bits")
                times[name] = sum(cs.device_ms(run, 1, 3).values())
            print(f"width {width}, {label} (one combine; {nbytes} bytes "
                  f"moved when every element is read and written, "
                  f"{nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms): "
                  + ", ".join(f"{k} {v / COMBINES:.4f} ms"
                              for k, v in times.items()), flush=True)


if __name__ == "__main__":
    main()
