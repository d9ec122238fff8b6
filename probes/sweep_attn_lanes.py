"""``attn_lanes`` (``csrc/attn_user.cu``, PERF.md section 6, row 5c) on
the social graph's stream of ``chip_smoke.py``'s ``attn_user`` phase (4
heads x 64, f32, nnz tile 4096): what holds its modes 0 (scores) and 1
(weights) back.

    PYTHONPATH=src python3 probes/sweep_attn_lanes.py

Builds the source at ``ATTN_LANES_U`` (the lanes a group keeps in
flight) 1, 2, 4 and 8, printing each instantiation's registers, and
times, as medians of five CUDA-event windows of about 5 ms, each mode's
four launches of one pass beside its bytes bound:
  - each U at the shipped geometry;
  - the shipped U at groups of 4, 8, 16 and 32 threads (a group of
    fewer threads than a row has vectors loops over the row);
  - the shipped U and group at ``LANES_TARGET_WARPS`` from 1,024 to
    65,536 (the chunk a warp takes), and a few of those settings
    together;
  - the shipped kernel with every column index 0 (each K and V gather
    from one row that stays in the L1 and L2), every row index 0 (q and
    dout never reloaded) and both: what is left of the time without the
    gathers is the index loads, the shuffles and the stores.
Every variant's scores are held to the plain version within K_TERMS
units of 2^-24 of their terms.  Needs one GPU.
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
from repro_torch.kernels import attn_user as au  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import fused_attention as fa  # noqa: E402
from repro_torch.kernels.common import DTYPE_CODES  # noqa: E402

UNROLLS = (1, 2, 4, 8)
SHIPPED_U = 2
GROUPS = (4, 8, 16, 32)
TARGETS = (1024, 2048, 4096, 8192, 16384, 65536)
#: (U, group, target warps) together
COMBINED = ((2, 8, 8192), (2, 16, 65536), (2, 8, 65536), (1, 8, 65536),
            (4, 8, 65536))
TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "fp16",
         "13__nv_fp8_e4m3": "e4m3"}


def registers(report):
    """{(type, VEC, MODE): registers} of ``attn_lanes_kernel`` from
    nvcc's ``-Xptxas -v`` report."""
    out, key = {}, None
    for line in report.splitlines():
        hit = re.search(r"entry function '_Z\d+attn_lanes_kernelI(\w+?)"
                        r"Li(\d+)ELi(\d+)EEv", line)
        if hit:
            key = (TYPES.get(hit.group(1), hit.group(1)),
                   int(hit.group(2)), int(hit.group(3)))
        elif "Used" in line and key:
            out[key] = int(line.split("Used ")[1].split(" ")[0])
            key = None
    return out


def build_variants():
    """{U: the attn_lanes_launch entry point of a build at that U}."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for u in UNROLLS:
        lib = build.BUILD_DIR / f"libattn_user_probe_u{u}.so"
        procs[u] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-DATTN_LANES_U={u}", "-I",
             str(build.CSRC), "-o", str(lib),
             str(build.CSRC / "attn_user.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for u, (lib, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            cs.fail(f"nvcc at ATTN_LANES_U={u}:\n{out}")
        regs = registers(out)
        print(f"ATTN_LANES_U={u}: registers "
              + ", ".join(f"{t} vec {v} mode {m}: {r}"
                          for (t, v, m), r in sorted(regs.items())
                          if t == "f32"), flush=True)
        fn = getattr(ctypes.CDLL(str(lib)), "attn_lanes_launch")
        fn.argtypes = au.LANES.argtypes
        fn.restype = ctypes.c_int
        fns[u] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    fns = build_variants()
    adj = cs.make_graphs(cs.N_NODES, dev)["social"][0]
    gen = torch.Generator().manual_seed(cs.SEED + 4)
    q, k, v, do = (cs.head_major(t)
                   for t in cs.attention_operands(adj, gen, dev))
    nnz, rows, cols, bias = cs.attn_stream(adj, cs.ATTN_USER_TILE)
    d = cs.HEAD_DIM
    scale = d ** -0.5
    _, m, l = fa.fused_sparse_attention(adj.indptr, adj.indices, q, k, v,
                                        scale=scale, bias=adj.vals)
    n, t = adj.shape[0], rows.numel()
    outs = torch.empty(3, t, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    qk = 2 * n * d * 4
    bounds = {0: cs.bound(cs.HEADS * (4 * t * 4 + qk), cs.HEADS * 2 * t * d),
              1: cs.bound(cs.HEADS * (6 * t * 4 + 2 * qk + 2 * n * 4),
                          cs.HEADS * 4 * t * d)}
    want = torch.stack([au.attn_scores_plain(rows, cols, q[h], k[h],
                                             nnz=nnz, scale=scale,
                                             bias=bias)
                        for h in range(cs.HEADS)])
    r_, c_ = rows.long(), cols.long()
    terms = torch.stack([(q[h][r_] * k[h][c_]).abs().sum(-1) * scale
                         + bias.abs() for h in range(cs.HEADS)])

    def launch(fn, mode, h, rw, cl, group, chunk):
        err = fn(mode, rw.data_ptr(), cl.data_ptr(), bias.data_ptr(),
                 q[h].data_ptr(), k[h].data_ptr(), v[h].data_ptr(),
                 do[h].data_ptr(), m[h].data_ptr(), l[h].data_ptr(),
                 outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
                 t, nnz, d, d, scale, DTYPE_CODES[torch.float32], 4, group,
                 chunk, dev.index or 0, stream)
        if err:
            cs.fail(f"attn_lanes_launch: cudaError_t {err}")

    def run(label, u=SHIPPED_U, group=None, target=au.LANES_TARGET_WARPS,
            rw=rows, cl=cols):
        geo = au.lanes_geometry(t, d, d, 4, True)
        group = group or geo.group
        chunk = 32 * max(1, -(-t // (target * 32)))
        fn = fns[u]
        if rw is rows and cl is cols:
            got = []
            for h in range(cs.HEADS):
                launch(fn, 0, h, rw, cl, group, chunk)
                got.append(outs[0].clone())
            got = torch.stack(got)
            bad = (got - want).abs() > cs.K_TERMS * 2.0 ** -24 * (
                terms + want.abs())
            if bool(bad.any()):
                cs.fail(f"{label}: scores beyond K_TERMS of the plain "
                        "version")
        times = {mode: cs.cuda_ms_median(lambda mode=mode: [
            launch(fn, mode, h, rw, cl, group, chunk)
            for h in range(cs.HEADS)]) for mode in (0, 1)}
        print(f"{label} (U {u}, group {group}, chunk {chunk}, "
              f"{-(-t // chunk)} warps): scores "
              f"{times[0]:.4f} ms (bound {bounds[0][0]:.4f}), weights "
              f"{times[1]:.4f} ms (bound {bounds[1][0]:.4f})", flush=True)

    for u in UNROLLS:
        run(f"ATTN_LANES_U={u}", u=u)
    for group in GROUPS:
        run(f"group {group}", group=group)
    for target in TARGETS:
        run(f"LANES_TARGET_WARPS={target}", target=target)
    for u, group, target in COMBINED:
        run("combined", u=u, group=group, target=target)
    zeros = torch.zeros_like(rows)
    run("every column 0", cl=zeros)
    run("every row 0", rw=zeros)
    run("every row and column 0", rw=zeros, cl=zeros)


if __name__ == "__main__":
    main()
