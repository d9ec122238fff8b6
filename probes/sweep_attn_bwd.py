"""The attention backward's chunk size (``fused_attention.BWD_CHUNK``)
and register budget (the blocks an SM must hold, in the launch bounds
of ``csrc/fused_attention_bwd.cu``) on the two graphs of ``chip_smoke.py``
(169,343 nodes, 4 heads x 64, the adjacency's values as the score bias;
PERF.md section 6), beside the first kernel (``probes/first_attn_bwd.cu``).

    PYTHONPATH=src python3 probes/sweep_attn_bwd.py

Builds the kernel with each budget, from a copy of the source with its
launch bounds rewritten, and the first kernel with the port's nvcc
flags.  For each budget and chunk size: the chunks of the
plan, the backward's time through its wrapper and its longest row alone
(medians of five 3-call CUDA-event windows), dq, dk and dv held to the
plain version at ``chip_smoke.F32_TOL``; the first kernel's launch with
the same zero fills of dK and dV.  Needs one GPU.
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
from repro_torch.kernels import fused_attention as fa  # noqa: E402

CHUNKS = (256, 512, 1024, 2048, 4096)
#: Register budgets, as blocks an SM must hold (None: the compiler's).
MIN_BLOCKS = (None, 8)


def ms(fn):
    return statistics.median(cs.cuda_ms(fn, 3, 1) for _ in range(5))


def nvcc(src, lib):
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
         "-o", str(lib), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def budget_source(mb):
    """``fused_attention_bwd.cu`` with ``mb`` blocks an SM named in its
    launch bounds (None: the source as it is)."""
    src = (build.CSRC / "fused_attention_bwd.cu").read_text()
    old = "__launch_bounds__(ATTN_WARPS * 32)"
    if old not in src:
        cs.fail(f"fused_attention_bwd.cu no longer holds {old!r}")
    return src if mb is None else src.replace(
        old, f"__launch_bounds__(ATTN_WARPS * 32, {mb})")


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for mb in MIN_BLOCKS:
        stem = build.BUILD_DIR / f"attn_bwd_m{mb}"
        src = stem.with_suffix(".cu")
        src.write_text(budget_source(mb))
        lib = stem.with_suffix(".so")
        procs[mb] = (lib, nvcc(src, lib))
    old_lib = build.BUILD_DIR / "libfirst_attn_bwd.so"
    procs["old"] = (old_lib, nvcc(ROOT / "probes/first_attn_bwd.cu",
                                  old_lib))
    fns = {}
    for key, (lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            cs.fail(f"nvcc {key}:\n{report}")
        regs = sorted({int(line.split("Used ")[1].split(" ")[0])
                       for line in report.splitlines()
                       if "registers" in line})
        spills = sorted({line.split(",")[1].strip()
                         for line in report.splitlines()
                         if "spill stores" in line})
        print(f"build {key}: registers per instance {regs}; {spills}",
              flush=True)
        if key != "old":
            fn = ctypes.CDLL(str(lib)).attn_bwd_launch
            fn.argtypes = fa.BWD_KERNEL.argtypes
            fn.restype = ctypes.c_int
            fns[key] = fn
    old = ctypes.CDLL(str(old_lib)).attn_bwd_probe_launch
    old.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
                    + [ctypes.c_float] + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])
    graphs = cs.make_graphs(cs.N_NODES, dev)
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    stream = torch.cuda.current_stream().cuda_stream
    kw = dict(scale=cs.HEAD_DIM ** -0.5)
    default_chunk = fa.BWD_CHUNK
    for name, (adj, _) in graphs.items():
        n = adj.shape[0]
        q, k, v, do = (cs.head_major(t)
                       for t in cs.attention_operands(adj, gen, dev))
        args = (adj.indptr, adj.indices, q, k, v)
        _, m, l = fa.fused_sparse_attention(*args, bias=adj.vals, **kw)
        want = fa.fused_sparse_attention_bwd_plain(*args, do, m, l,
                                                   bias=adj.vals, **kw)
        dq = torch.empty_like(q)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)

        def old_launch():
            dk.zero_()
            dv.zero_()
            err = old(adj.indptr.data_ptr(), adj.indices.data_ptr(),
                      adj.vals.data_ptr(), q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), do.data_ptr(), m.data_ptr(),
                      l.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), None, None, n, n, cs.HEADS,
                      cs.HEAD_DIM, cs.HEAD_DIM, kw["scale"], 0, 1 << 30,
                      stream)
            if err:
                cs.fail(f"attn_bwd_probe_launch: cudaError_t {err}")

        print(f"{name}: the first kernel, zero fills and one launch "
              f"{ms(old_launch):.4f} ms", flush=True)
        lengths = (adj.indptr[1:] - adj.indptr[:-1]).long()
        hub = int(lengths.argmax())
        lo, hi = int(adj.indptr[hub]), int(adj.indptr[hub + 1])
        ip = torch.tensor([0, hi - lo], dtype=torch.int32, device=dev)
        hub_args = (ip, adj.indices[lo:hi], q[:, hub:hub + 1], k, v,
                    do[:, hub:hub + 1], m[:, hub:hub + 1], l[:, hub:hub + 1])
        chunks = CHUNKS if name == "social" else (default_chunk,)
        for mb, fn in fns.items():
            fa.BWD_KERNEL._fn = fn
            for chunk in chunks:
                fa.BWD_CHUNK = chunk
                plan = fa.attn_row_plan(adj.indptr, chunk)
                got = fa.fused_sparse_attention_bwd(*args, do, m, l,
                                                    bias=adj.vals, **kw)
                errs = [cs.compare(g, w) for g, w in zip(got, want)]
                t = ms(lambda: fa.fused_sparse_attention_bwd(
                    *args, do, m, l, bias=adj.vals, **kw))
                t_hub = ms(lambda: fa.fused_sparse_attention_bwd(
                    *hub_args, bias=adj.vals[lo:hi], **kw))
                print(f"{name} min blocks {mb} chunk {chunk}: "
                      f"{plan.n_split} split rows, {plan.n_chunks} chunks; "
                      f"backward {t:.4f} ms, the longest row ({hi - lo} "
                      f"nnz) alone {t_hub:.4f} ms; max_abs_err dq/dk/dv "
                      + "/".join(f"{e:.3e}" for e, _, _ in errs)
                      + f" {'ok' if all(ok for *_, ok in errs) else 'FAIL'}",
                      flush=True)
                del got
        fa.BWD_CHUNK = default_chunk
        del q, k, v, do, m, l, want, dq, dk, dv
        torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
