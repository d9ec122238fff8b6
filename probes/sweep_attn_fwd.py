"""The attention forward's chunk size (``fused_attention.FWD_CHUNK``) and
register budget (the blocks an SM must hold, in the launch bounds of
``csrc/fused_attention_fwd.cu``) on the two graphs of ``chip_smoke.py``
(169,343 nodes, 4 heads x 64, the adjacency's values as the score bias;
PERF.md section 6), and what its K and V gathers cost.

    PYTHONPATH=src python3 probes/sweep_attn_fwd.py

Builds the kernel as it is, each variant from a copy of the source with
one constant rewritten, and the first kernel
(``probes/first_attn_fwd.cu``), printing each kernel's registers. The
first kernel and the kernel as it is are also timed bare (no wrapper),
in turns. For each variant on both graphs, and for each chunk size on
the social graph with the kernel as it is: the forward's time through
its wrapper and, on the social graph, its longest
row alone (medians of five 3-call CUDA-event windows), out, m and l held
to the plain version at ``chip_smoke.F32_TOL``; and the kernel as it is
with every column index 0 (each K and V gather reads one L2-resident
row; the plan, which reads only the row pointer, is unchanged).  Needs
one GPU.
"""
import ctypes
import re
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

CHUNKS = (256, 512, 1024, 2048)
BOUNDS = "__launch_bounds__(ATTN_WARPS * 32)"
#: name -> (text replaced, replacement); "as is" builds the source as it is
VARIANTS = {
    "as is": None,
    "min blocks 8": (BOUNDS, "__launch_bounds__(ATTN_WARPS * 32, 8)"),
    "min blocks 12": (BOUNDS, "__launch_bounds__(ATTN_WARPS * 32, 12)"),
}


def ms(fn):
    return statistics.median(cs.cuda_ms(fn, 3, 1) for _ in range(5))


def registers(report):
    """{kernel<NC>: registers} from nvcc's ``-Xptxas -v`` report."""
    out, name = {}, None
    for line in report.splitlines():
        hit = re.search(r"entry function '.*?(attn_fwd_(?:walk|combine|probe))"
                        r"ILi(\d+)E", line)
        if hit:
            name = f"{hit.group(1)}<{hit.group(2)}>"
        elif "Used" in line and name:
            out[name] = int(line.split("Used ")[1].split(" ")[0])
            name = None
    return out


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "fused_attention_fwd.cu").read_text()
    procs = {}
    for i, (name, edit) in enumerate(VARIANTS.items()):
        if edit is not None and edit[0] not in text:
            cs.fail(f"fused_attention_fwd.cu no longer holds {edit[0]!r}")
        src = build.BUILD_DIR / f"attn_fwd_variant{i}.cu"
        src.write_text(text if edit is None else text.replace(*edit))
        procs[name] = (src.with_suffix(".so"), src)
    procs["first"] = (build.BUILD_DIR / "libfirst_attn_fwd.so",
                      ROOT / "probes/first_attn_fwd.cu")
    procs = {name: (lib, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(lib), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for name, (lib, src) in procs.items()}
    fns = {}
    for name, (lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            cs.fail(f"nvcc {name}:\n{report}")
        spills = sorted({line.split(",")[1].strip()
                         for line in report.splitlines()
                         if "spill stores" in line})
        print(f"build {name}: registers {registers(report)}; {spills}",
              flush=True)
        if name == "first":
            first = ctypes.CDLL(str(lib)).attn_fwd_probe_launch
            first.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                              + [ctypes.c_float] + [ctypes.c_int] * 2
                              + [ctypes.c_void_p])
            first.restype = ctypes.c_int
            continue
        fn = ctypes.CDLL(str(lib)).attn_fwd_launch
        fn.argtypes = fa.FWD_KERNEL.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    graphs = cs.make_graphs(cs.N_NODES, dev)
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    scale = cs.HEAD_DIM ** -0.5
    default_chunk = fa.FWD_CHUNK
    for gname, (adj, _) in graphs.items():
        q, k, v, _ = (cs.head_major(t)
                      for t in cs.attention_operands(adj, gen, dev))
        args = (adj.indptr, adj.indices, q, k, v)
        kw = dict(scale=scale, bias=adj.vals)
        want = fa.fused_sparse_attention_plain(*args, **kw)
        lengths = (adj.indptr[1:] - adj.indptr[:-1]).long()
        hub = int(lengths.argmax())
        lo, hi = int(adj.indptr[hub]), int(adj.indptr[hub + 1])
        ip = torch.tensor([0, hi - lo], dtype=torch.int32, device=dev)
        hub_args = (ip, adj.indices[lo:hi], q[:, hub:hub + 1].contiguous(),
                    k, v)
        hub_kw = dict(scale=scale, bias=adj.vals[lo:hi])
        runs = [(name, default_chunk) for name in fns]
        if gname == "social":
            runs += [("as is", c) for c in CHUNKS if c != default_chunk]
        for name, chunk in runs:
            fa.FWD_KERNEL._fn = fns[name]
            fa.FWD_CHUNK = chunk
            plan = fa.attn_row_plan(adj.indptr, chunk)
            got = fa.fused_sparse_attention(*args, **kw)
            errs = [cs.compare(g, w, per_element=i > 0)
                    for i, (g, w) in enumerate(zip(got, want))]
            t = ms(lambda: fa.fused_sparse_attention(*args, **kw))
            fa.fused_sparse_attention(*hub_args, **hub_kw)  # its plan
            t_hub = ms(lambda: fa.fused_sparse_attention(*hub_args,
                                                         **hub_kw))
            print(f"{gname} {name} chunk {chunk}: {plan.n_split} split "
                  f"rows, {plan.n_chunks} chunks; forward {t:.4f} ms, the "
                  f"longest row ({hi - lo} nnz) alone {t_hub:.4f} ms; "
                  "max_abs_err out/m/l "
                  + "/".join(f"{e:.3e}" for e, _, _ in errs)
                  + f" {'ok' if all(ok for *_, ok in errs) else 'FAIL'}",
                  flush=True)
            del got
        fa.FWD_CHUNK = default_chunk
        fa.FWD_KERNEL._fn = fns["as is"]
        # both kernels launched bare, beside each other, with no wrapper
        n = adj.shape[0]
        out = torch.empty_like(v)
        m = torch.empty(cs.HEADS, n, device=dev)
        l = torch.empty_like(m)
        plan = fa.attn_row_plan(adj.indptr, default_chunk)
        part = torch.empty(max(1, cs.HEADS * plan.n_chunks
                               * (cs.HEAD_DIM + 2)), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        p = (adj.indptr.data_ptr(), adj.indices.data_ptr(),
             adj.vals.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), m.data_ptr(), l.data_ptr())

        def bare_first():
            if first(*p, n, n, cs.HEADS, cs.HEAD_DIM, cs.HEAD_DIM, scale, 0,
                     1 << 30, stream):
                cs.fail("attn_fwd_probe_launch refused")

        def bare_new():
            for phase in ((0, 1) if plan.n_chunks else (0,)):
                if fns["as is"](
                        *p, plan.chunk_row.data_ptr(),
                        plan.chunk_start.data_ptr(),
                        plan.split_first.data_ptr(),
                        plan.split_rows.data_ptr(), part.data_ptr(), n, n,
                        cs.HEADS, cs.HEAD_DIM, cs.HEAD_DIM, scale,
                        plan.chunk, plan.n_chunks, plan.n_split, phase,
                        torch.cuda.current_device(), stream):
                    cs.fail("attn_fwd_launch refused")

        print(f"{gname} bare launches: the first kernel "
              f"{ms(bare_first):.4f} ms, as is {ms(bare_new):.4f} ms, the "
              f"first kernel {ms(bare_first):.4f} ms", flush=True)
        del out, m, l, part
        zeros = torch.zeros_like(adj.indices)
        t = ms(lambda: fa.fused_sparse_attention(
            adj.indptr, zeros, q, k, v, **kw))
        print(f"{gname} as is, every K and V gather to row 0: forward "
              f"{t:.4f} ms", flush=True)
        del q, k, v, want, zeros
        torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
