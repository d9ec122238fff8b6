"""The grouped matmul backward's tensor-core route (row 7b): its precision
and its geometry, at Qwen3-MoE's training shapes (128 experts, D 4096,
F 1536, two tiles of 128 rows an expert: T_pad 32,768; PERF.md section 6).

    PYTHONPATH=src python3 probes/probe_gmm_bwd_split.py

Precision.  dz (f32, zero mean) is split into three bf16 parts whose
products with the bf16 partner are exact, so only the f32 sums can
differ from an f64 product.  One token tile's dx (128 rows, 256 output
columns) at K = 1536 and 4096, and one expert's dW (256 rows, 1536 x
256), each on the kernel as built (each chunk of 64 of the contraction
summed from zero, then added to the running sum) and on a copy whose
wgmma products go straight into the running sum, against the f64 product
of the same operands: k, the largest error in units of 2^-24 x the sum
of |terms| of that output, beside the plain f32 version's (the
``torch.bmm`` of the port's plain versions).  The route is kept while
the built kernel's k stays within ``K_TERMS`` (16).

Ceiling.  The card's mma.sync m16n8k16 bf16 rate with no memory traffic.

Geometry.  Copies of the two sources with dx's warpgroups a block and
ring stages, and dW's stages and D slabs a block walks, rewritten, built
with the port's nvcc flags all at once, each timed on the launches of a
layer's backward (dx and dW for wg and wi up, wo down) in turns, as
medians of five CUDA-event windows, beside ``torch.bmm`` in f32; every
variant's output is held to the default's bit for bit (a variant changes
no sum's order).  Needs one GPU.
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
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import grouped_matmul_dw as gmd  # noqa: E402

#: dx: (warpgroups a block, stages); the first is the kernel's.
DX_VARIANTS = ((2, 4), (2, 3), (1, 4), (1, 3))
#: dW: (stages, D slabs a block walks); the first is the kernel's.
DW_VARIANTS = ((3, 4), (3, 1), (3, 2), (3, 12))
E, D, F, TILE = 128, 4096, 1536, 128

#: The products straight into the running sums (no chunk sums): dx's
#: and dW's (whose B is MN-major, wgmma_n128<., 1>).
_DIRECT = (("wgmma_n128<true>(part", "wgmma_n128<false>(acc"),
           ("wgmma_n128<false>(part", "wgmma_n128<false>(acc"),
           ("acc[i] += part[i];", "(void)part[i];"))
_DIRECT_DW = tuple((a.replace(">(", ", 1>("), b.replace(">(", ", 1>("))
                   for a, b in _DIRECT[:2]) + _DIRECT[2:]


def rewrite(source, pairs):
    src = (build.CSRC / source).read_text()
    for old, new in pairs:
        if old not in src:
            cs.fail(f"{source} no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def dx_pairs(wgs, st):
    return (("constexpr int WGS = 2;  // warpgroups a block\n"
             "constexpr int STAGES = 4;",
             f"constexpr int WGS = {wgs};\nconstexpr int STAGES = {st};"),)


def dw_pairs(st, sl):
    return (("constexpr int STAGES = 3;\n"
             "constexpr int SLABS = 4;   // D slabs a block walks",
             f"constexpr int STAGES = {st};\nconstexpr int SLABS = {sl};"),)


_FLAGS = [f for f in build.NVCC_FLAGS if f != "-shared"]
_INC = ["-I", str(build.CSRC)]
#: grouped_matmul.cu's parts other than the transposed read's tensor-core
#: kernel (part 4): compiled once from the source as it stands and linked
#: into every dx variant.
_GMM_SHARED = [build.BUILD_DIR / f"probe_gmm_part{k}.o" for k in range(4)]


def _nvcc(args):
    return subprocess.Popen([build._nvcc(), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def start_build(name, source, text):
    """Compile ``text`` (a rewritten ``source``) into its own library:
    grouped_matmul.cu's part 4 alone, linked after with the shared parts
    0-3, or grouped_matmul_dw.cu whole; returns (library, processes,
    link command)."""
    stem = build.BUILD_DIR / f"probe_{name}"
    src = stem.with_suffix(".cu")
    src.write_text(text)
    lib = stem.with_suffix(".so")
    if source == "grouped_matmul_dw.cu":
        return lib, [_nvcc([*build.NVCC_FLAGS, *_INC, "-o", str(lib),
                            str(src)])], None
    obj = f"{stem}.part4.o"
    return lib, [_nvcc([*_FLAGS, *_INC, "-c", "-DKERNEL_PART=4", "-o", obj,
                        str(src)])], \
        [build._nvcc(), "-shared", "-o", str(lib), *map(str, _GMM_SHARED),
         obj]


def finish_build(name, lib, procs, link, symbol, argtypes):
    report = "".join(p.communicate()[0] for p in procs)
    if any(p.returncode for p in procs):
        cs.fail(f"nvcc {name}:\n{report}")
    if link is not None:
        r = subprocess.run(link, capture_output=True, text=True)
        if r.returncode:
            cs.fail(f"link {name}:\n{r.stdout}{r.stderr}")
    regs, entry = set(), ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "registers" in line and "split" in entry:
            regs.add(int(line.split("Used ")[1].split(" ")[0]))
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = list(argtypes) + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    print(f"built {name}: registers of the split kernels {sorted(regs)}",
          flush=True)
    return fn


DX_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
DW_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6


def build_all():
    jobs = {}
    for v in DX_VARIANTS:
        jobs[("dx", v)] = ("grouped_matmul.cu", rewrite(
            "grouped_matmul.cu", dx_pairs(*v)))
    for v in DW_VARIANTS:
        jobs[("dw", v)] = ("grouped_matmul_dw.cu", rewrite(
            "grouped_matmul_dw.cu", dw_pairs(*v)))
    jobs[("dx", "direct")] = ("grouped_matmul.cu", rewrite(
        "grouped_matmul.cu", _DIRECT))
    jobs[("dw", "direct")] = ("grouped_matmul_dw.cu", rewrite(
        "grouped_matmul_dw.cu", _DIRECT_DW))
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    shared = [_nvcc([*_FLAGS, *_INC, "-c", f"-DKERNEL_PART={k}", "-o",
                     str(o), str(build.CSRC / "grouped_matmul.cu")])
              for k, o in enumerate(_GMM_SHARED)]
    started = {}
    for key, (source, text) in jobs.items():
        tag = key[1] if isinstance(key[1], str) else "_".join(
            map(str, key[1]))
        name = f"{key[0]}_{tag}"
        started[key] = (name, *start_build(name, source, text))
    report = "".join(p.communicate()[0] for p in shared)
    if any(p.returncode for p in shared):
        cs.fail(f"nvcc grouped_matmul.cu parts 0-3:\n{report}")
    fns = {}
    for key, (name, lib, procs, link) in started.items():
        fns[key] = finish_build(
            name, lib, procs, link,
            "grouped_matmul_launch" if key[0] == "dx"
            else "grouped_matmul_dw_launch",
            DX_ARGS if key[0] == "dx" else DW_ARGS)
    return fns


def launch_dx(fn, dz, te, w, out, token_tile):
    e, n, k = w.shape
    out_type = 0 if out.dtype == torch.float32 else 1  # f32 or bf16
    err = fn(dz.data_ptr(), te.data_ptr(), w.data_ptr(), None,
             out.data_ptr(), te.numel(), token_tile, e, k, n, 0, 1, 0,
             out_type, 1, 1, torch.cuda.current_device(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        cs.fail(f"grouped_matmul_launch: cudaError_t {err}")


def launch_dw(fn, x, dz, te, n_experts, out, token_tile):
    offsets, order = gmd.tile_csr(te, n_experts)
    w_type = 0 if out.dtype == torch.float32 else 1  # f32 or bf16
    err = fn(x.data_ptr(), dz.data_ptr(), offsets.data_ptr(),
             order.data_ptr(), out.data_ptr(), None, n_experts, x.shape[1],
             dz.shape[1], token_tile, 1, w_type, torch.cuda.current_device(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        cs.fail(f"grouped_matmul_dw_launch: cudaError_t {err}")


def k_units(got, want64, terms):
    err = (got.double() - want64).abs()
    return float((err / (2.0 ** -24 * terms.double()).clamp_min(1e-300))
                 .max())


def precision(fns, dev, gen):
    print("precision (k: largest error over 2^-24 x sum |terms| against "
          "f64; zero-mean dz)", flush=True)
    te = torch.zeros(1, dtype=torch.int32, device=dev)
    for k in (1536, 4096):
        dz = torch.randn(TILE, k, generator=gen, device=dev)
        w = (torch.randn(1, 256, k, generator=gen, device=dev)
             * k ** -0.5).bfloat16()
        want = gm.grouped_matmul_plain(dz.double(), te, w.double(),
                                       token_tile=TILE, w_trans=True)
        terms = gm.grouped_matmul_plain(dz.abs().double(), te,
                                        w.abs().double(), token_tile=TILE,
                                        w_trans=True)
        plain = gm.grouped_matmul_plain(dz, te, w, token_tile=TILE,
                                        w_trans=True)
        res = {}
        for name in (DX_VARIANTS[0], "direct"):
            out = torch.empty(TILE, 256, device=dev)
            launch_dx(fns[("dx", name)], dz, te, w, out, TILE)
            torch.cuda.synchronize()
            res[name] = k_units(out, want, terms)
        print(f"  dx one tile, K {k}: built {res[DX_VARIANTS[0]]:.3f}, "
              f"direct {res['direct']:.3f}, plain f32 "
              f"{k_units(plain, want, terms):.3f}", flush=True)
    te = torch.zeros(2, dtype=torch.int32, device=dev)
    x = torch.randn(2 * TILE, F, generator=gen, device=dev).bfloat16()
    dz = torch.randn(2 * TILE, 256, generator=gen, device=dev)
    want = (x.double().t() @ dz.double())[None]
    terms = (x.double().abs().t() @ dz.double().abs())[None]
    plain, _ = gmd.grouped_matmul_dw_plain(x, dz, te, 1, token_tile=TILE,
                                           w_dtype=torch.float32)
    res = {}
    for name in (DW_VARIANTS[0], "direct"):
        out = torch.empty(1, F, 256, device=dev)
        launch_dw(fns[("dw", name)], x, dz, te, 1, out, TILE)
        torch.cuda.synchronize()
        res[name] = k_units(out, want, terms)
    print(f"  dW one expert, 256 rows: built {res[DW_VARIANTS[0]]:.3f}, "
          f"direct {res['direct']:.3f}, plain f32 "
          f"{k_units(plain, want, terms):.3f}", flush=True)


#: The card's mma.sync m16n8k16 bf16 -> f32 rate with no memory traffic:
#: each warp keeps 16 independent sums and issues 16 products an
#: iteration on fixed fragments.
PEAK_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void mma_peak(float* out, int iters) {
  uint32_t a[4], b0 = 0x3f803f80u ^ threadIdx.x, b1 = 0x3f803f80u;
  for (int i = 0; i < 4; ++i) a[i] = 0x3c003c00u + i + threadIdx.x;
  float acc[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak_launch(float* out, int iters, int blocks, int threads,
                               cudaStream_t stream) {
  mma_peak<<<blocks, threads, 0, stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_peak(dev):
    src = build.BUILD_DIR / "probe_mma_peak.cu"
    src.write_text(PEAK_SRC)
    lib = src.with_suffix(".so")
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], capture_output=True, text=True)
    if r.returncode:
        cs.fail(f"nvcc mma_peak:\n{r.stdout}{r.stderr}")
    fn = ctypes.CDLL(str(lib)).mma_peak_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    iters = 4096
    for warps in (4, 8, 16):
        blocks = 132 * 4
        out = torch.empty(blocks * warps * 32, device=dev)

        def run():
            if fn(out.data_ptr(), iters, blocks, warps * 32,
                  torch.cuda.current_stream().cuda_stream):
                cs.fail("mma_peak did not launch")

        t = ms(run)
        flops = blocks * warps * iters * 16 * 2 * 16 * 8 * 16
        print(f"  mma.sync m16n8k16 bf16 ceiling, {warps} warps a block x "
              f"{blocks} blocks: {t:.4f} ms, {flops / t / 1e9:.0f} TFLOP/s",
              flush=True)


def ms(fn):
    return statistics.median(cs.cuda_ms(fn, 3, 1) for _ in range(5))


def geometry(fns, dev, gen):
    te = torch.arange(E, dtype=torch.int32, device=dev).repeat_interleave(2)
    t = E * 2 * TILE
    print(f"geometry (T_pad {t}; the layer's three launches: wg and wi "
          "up, wo down)", flush=True)
    for label, n, k, count in (("up", D, F, 2), ("down", F, D, 1)):
        w = (torch.randn(E, n, k, generator=gen, device=dev)
             * k ** -0.5).bfloat16()
        dz = torch.randn(t, k, generator=gen, device=dev)
        outs = {v: torch.empty(t, n, dtype=torch.bfloat16, device=dev)
                for v in DX_VARIANTS}
        times = {v: [] for v in DX_VARIANTS}
        for v in DX_VARIANTS:
            launch_dx(fns[("dx", v)], dz, te, w, outs[v], TILE)
        for _ in range(2):  # in turns, twice
            for v in DX_VARIANTS:
                times[v].append(ms(lambda v=v: launch_dx(
                    fns[("dx", v)], dz, te, w, outs[v], TILE)))
        w32 = w.float().transpose(1, 2)
        dzb = dz.view(E, -1, k)
        lib = ms(lambda: torch.bmm(dzb, w32))
        del w32
        fl = 3 * 2 * t * n * k
        print(f"  dx {label} ({t} x {k} -> {n}, x{count} a layer): "
              f"torch.bmm f32 {lib:.4f} ms", flush=True)
        for v in DX_VARIANTS:
            tv = statistics.median(times[v])
            same = torch.equal(outs[v], outs[DX_VARIANTS[0]])
            print(f"    warpgroups {v[0]} stages {v[1]}: {tv:.4f} ms "
                  f"({fl / tv / 1e9:.0f} bf16 TFLOP/s, {tv / lib:.3f}x "
                  f"torch.bmm); same bits as the default: {same}",
                  flush=True)
        del w, dz, outs
        torch.cuda.empty_cache()
    for label, dd, ff, count in (("up", D, F, 2), ("down", F, D, 1)):
        x = torch.randn(t, dd, generator=gen, device=dev).bfloat16()
        dz = torch.randn(t, ff, generator=gen, device=dev)
        outs = {v: torch.empty(E, dd, ff, dtype=torch.bfloat16, device=dev)
                for v in DW_VARIANTS}
        times = {v: [] for v in DW_VARIANTS}
        for v in DW_VARIANTS:
            launch_dw(fns[("dw", v)], x, dz, te, E, outs[v], TILE)
        for _ in range(2):
            for v in DW_VARIANTS:
                times[v].append(ms(lambda v=v: launch_dw(
                    fns[("dw", v)], x, dz, te, E, outs[v], TILE)))
        xb = x.float().view(E, -1, dd).transpose(1, 2)
        dzb = dz.view(E, -1, ff)
        lib = ms(lambda: torch.bmm(xb, dzb))
        del xb
        fl = 3 * 2 * t * dd * ff
        print(f"  dW {label} ({t} rows, {dd} x {ff}, x{count} a layer): "
              f"torch.bmm f32 {lib:.4f} ms", flush=True)
        for v in DW_VARIANTS:
            tv = statistics.median(times[v])
            same = torch.equal(outs[v], outs[DW_VARIANTS[0]])
            print(f"    stages {v[0]} slabs {v[1]}: "
                  f"{tv:.4f} ms ({fl / tv / 1e9:.0f} bf16 TFLOP/s, "
                  f"{tv / lib:.3f}x torch.bmm); same bits as the default: "
                  f"{same}", flush=True)
        del x, dz, outs
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    fns = build_all()
    gen = torch.Generator(device=dev).manual_seed(0)
    precision(fns, dev, gen)
    mma_peak(dev)
    geometry(fns, dev, gen)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
