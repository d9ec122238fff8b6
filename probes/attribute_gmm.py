"""Where the first grouped-matmul kernel (FMAs on the CUDA cores) spent
its time, at layer 0's decode (tile 4) and prefill (tile 10) shapes of
``chip_smoke.py``'s ``moe_serve`` phase (Qwen3-MoE: 128 experts, D 4096,
F 1536; PERF.md section 6).

    PYTHONPATH=src python3 probes/attribute_gmm.py

Builds ``probes/first_gmm.cu`` (that kernel for bf16 on bf16, with
switches) with the port's nvcc flags and times, as medians of five
10-call CUDA-event windows, for the gate (D 4096 -> F 1536) and down
(D 1536 -> F 4096) projections at both tiles: the kernel as it was; the
weights streamed with no FMAs (the bytes floor of its access pattern);
its FMAs on weights already in L2 (every tile on expert 0, 12.6 MB);
without the per-chunk barriers of its loop over D; at tile 10, one
16-row block against its 8 + 2 row chunks; and ``torch.bmm`` on the
same operands.  The byte bound counts x, the weights and the f32 output
once, at 3.35 TB/s.  Needs one GPU.
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


def ms(fn):
    return statistics.median(cs.cuda_ms(fn, 10, 2) for _ in range(5))


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    lib_path = build.BUILD_DIR / "libfirst_gmm.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib_path), str(ROOT / "probes/first_gmm.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.gmm_probe_launch.argtypes = ([ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    cfg = get_config(cs.MOE_ARCH)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    weights = {"gate": torch.randn(e, d, f, generator=gen, device=dev).to(
                   torch.bfloat16) * d ** -0.5,
               "down": torch.randn(e, f, d, generator=gen, device=dev).to(
                   torch.bfloat16) * f ** -0.5}
    te = torch.arange(e, dtype=torch.int32, device=dev)
    te0 = torch.zeros_like(te)
    for phase, tokens in (("decode", cs.MOE_SLOTS), ("prefill",
                                                     cs.MOE_PROMPT)):
        tile = min(_capacity(cfg, tokens), 128)
        rb = 4 if tile <= 4 else 8
        for proj, w in weights.items():
            _, dd, ff = w.shape
            x = torch.randn(e * tile, dd, generator=gen, device=dev).to(
                torch.bfloat16)
            out = torch.empty(e * tile, ff, device=dev)

            def run(mode, rows=rb, experts=te):
                err = lib.gmm_probe_launch(x.data_ptr(), experts.data_ptr(),
                                           w.data_ptr(), out.data_ptr(), e,
                                           tile, dd, ff, rows, mode, stream)
                if err:
                    cs.fail(f"gmm_probe_launch: cudaError_t {err}")

            run(0)
            want = torch.bmm(x.reshape(e, tile, dd).float(), w.float())
            err = float((out - want.reshape(-1, ff)).abs().max())
            nbytes = x.numel() * 2 + w.numel() * 2 + out.numel() * 4
            res = {f"kernel ({rb}-row chunks)": ms(lambda: run(0)),
                   "weights streamed, no FMAs": ms(lambda: run(1)),
                   "FMAs on weights in L2 (expert 0)": ms(
                       lambda: run(0, experts=te0)),
                   "no barriers in the loop over D": ms(lambda: run(2))}
            if tile > 8:
                res["one 16-row block"] = ms(lambda: run(0, rows=16))
            xb = x.reshape(e, tile, dd)
            res["torch.bmm"] = ms(lambda: torch.bmm(xb, w))
            print(f"{phase} {proj} (tile {tile}, {e} tiles, {dd} -> {ff}): "
                  f"bound {nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms by "
                  f"bytes ({nbytes} bytes); kernel max_abs_err {err:.3e} "
                  "against the f32 product", flush=True)
            for k, v in res.items():
                print(f"  {k:36s} {v:.4f} ms ({nbytes / v / 1e6:.0f} GB/s)",
                      flush=True)
            del x, out, want
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
