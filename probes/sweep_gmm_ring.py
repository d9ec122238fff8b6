"""The tensor-core grouped matmul's ring geometry (``WARPS``,
``STAGES`` and the launch bounds of ``gmm_mma_kernel`` in
``csrc/grouped_matmul.cu``) at layer 0's decode (tile 4) and prefill (tile 10) shapes of
``chip_smoke.py``'s ``moe_serve`` phase (Qwen3-MoE: 128 experts, D 4096,
F 1536; PERF.md section 6).

    PYTHONPATH=src python3 probes/sweep_gmm_ring.py

Builds one library per variant from a copy of the source with those
constants rewritten, with the port's nvcc flags, all at once, and times each variant's launch on the
tensor-core route for the gate (4096 -> 1536) and down (1536 -> 4096)
projections beside ``torch.bmm``, in turns, as medians of five 10-call
CUDA-event windows; each output is held to the first variant's.
Needs one GPU.
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models.moe import _capacity  # noqa: E402

#: (warps, stages, blocks an SM must hold; None: the compiler's register
#: choice): the first is the kernel's default.
VARIANTS = ((4, 4, None), (4, 4, 1), (4, 3, 4), (4, 6, None), (4, 5, 2),
            (8, 3, 2), (8, 4, None))


def ms(fn):
    return statistics.median(cs.cuda_ms(fn, 10, 2) for _ in range(5))


def variant_source(wv, st, mb):
    """``grouped_matmul.cu`` with the tensor-core route's warps, stages
    and launch bounds rewritten (the first of each is that route's)."""
    src = (build.CSRC / "grouped_matmul.cu").read_text()
    bounds = "THREADS" if mb is None else f"THREADS, {mb}"
    for old, new in (("constexpr int WARPS = 4;",
                      f"constexpr int WARPS = {wv};"),
                     ("constexpr int STAGES = 4;",
                      f"constexpr int STAGES = {st};"),
                     ("__launch_bounds__(THREADS)\n    gmm_mma_kernel",
                      f"__launch_bounds__({bounds})\n    gmm_mma_kernel")):
        if old not in src:
            cs.fail(f"grouped_matmul.cu no longer holds {old!r}")
        src = src.replace(old, new, 1)
    return src


def build_variants():
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for wv, st, mb in VARIANTS:
        stem = build.BUILD_DIR / f"gmm_w{wv}_s{st}_m{mb}"
        src = stem.with_suffix(".cu")
        src.write_text(variant_source(wv, st, mb))
        lib = stem.with_suffix(".so")
        procs[(wv, st, mb)] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            cs.fail(f"nvcc {key}:\n{report}")
        fn = ctypes.CDLL(str(lib)).grouped_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[key] = fn
        regs, entry = set(), ""
        for line in report.splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif "registers" in line and "gmm_mma" in entry:
                regs.add(int(line.split("Used ")[1].split(" ")[0]))
        print(f"variant warps {key[0]} stages {key[1]} min blocks "
              f"{key[2]}: registers of the tensor-core instances "
              f"{sorted(regs)}", flush=True)
    return libs


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    libs = build_variants()
    cfg = get_config(cs.MOE_ARCH)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    index = torch.cuda.current_device()
    weights = {"gate": (torch.randn(e, d, f, generator=gen, device=dev)
                        * d ** -0.5).to(torch.bfloat16),
               "down": (torch.randn(e, f, d, generator=gen, device=dev)
                        * f ** -0.5).to(torch.bfloat16)}
    te = torch.arange(e, dtype=torch.int32, device=dev)
    for phase, tokens in (("decode", cs.MOE_SLOTS), ("prefill",
                                                     cs.MOE_PROMPT)):
        tile = min(_capacity(cfg, tokens), 128)
        for proj, w in weights.items():
            _, dd, ff = w.shape
            x = torch.randn(e * tile, dd, generator=gen, device=dev).to(
                torch.bfloat16)
            nbytes = x.numel() * 2 + w.numel() * 2 + e * tile * ff * 4
            outs = {}

            def run(key):
                out = outs.setdefault(key, torch.empty(e * tile, ff,
                                                       device=dev))
                err = libs[key](x.data_ptr(), te.data_ptr(), w.data_ptr(),
                                None, out.data_ptr(), e, tile, e, dd, ff, 1,
                                1, 0, 0, 1, 0, index, stream)
                if err:
                    cs.fail(f"grouped_matmul_launch {key}: cudaError_t {err}")

            res = {}
            for key in VARIANTS:
                run(key)
            first = outs[VARIANTS[0]]
            xb = x.reshape(e, tile, dd)
            for key in VARIANTS:
                res[key] = ms(lambda k=key: run(k))
            lib_ms = ms(lambda: torch.bmm(xb, w))
            print(f"{phase} {proj} (tile {tile}, {dd} -> {ff}): bound "
                  f"{nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms; torch.bmm "
                  f"{lib_ms:.4f} ms", flush=True)
            for key, t in res.items():
                same = float((outs[key] - first).abs().max())
                print(f"  warps {key[0]} stages {key[1]} min blocks {key[2]}:"
                      f" {t:.4f} ms ({nbytes / t / 1e6:.0f} GB/s, "
                      f"{t / lib_ms:.3f}x torch.bmm); max |out - first| "
                      f"{same:.3e}", flush=True)
            del x, outs
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
