"""EB, RB, SDDMM, attention and grouped-matmul kernel times of the port
in a given source tree, at the storage earlier slices ran (f32 values,
B and q, k, v; bf16 tokens and weights, and f32 ones), so that two
commits can be timed in turns within one run on the same card.

    PYTHONPATH=src python3 probes/time_kernels.py [SRC]

SRC is the ``src`` directory of a checkout (by default this one's); its
``repro_torch`` is imported and its kernels built, while the graphs
(``chip_smoke.make_graphs``: social and roadnet at 169,343 nodes, seed
0) and the timers come from this checkout's ``chip_smoke.py``.  EB runs
on social under ``Schedule.auto`` at N = 256 (bias and relu fused) and
N = 40, each launch timed apart (``chip_smoke.launch_ms``: the main
kernel and its finishing launch); RB runs on roadnet under ``RB+PR`` at
the same widths (``chip_smoke.cuda_ms``).  The grouped matmul runs one
MoE decode launch at Qwen3-MoE's width (4 slots x top-8 = 32 tokens in
tiles of 4 over 8 experts of 128, D 4096, F 1536, bf16, SiLU with a
bias: the tensor-core route), and the same launch at f32 tokens and
weights (the CUDA-core route).  SDDMM runs on both graphs at N = 256
(the training step's layer-1 gradient), the attention forward and
backward on both graphs at 4 heads of 64 (the adjacency's values as the
bias), f32.  Operands come from a generator seeded 0.  Five timings
each, every one printed with their median.  Needs one GPU.
"""
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    sys.path[:0] = [str(src), str(ROOT)]
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    import repro_torch
    from repro_torch.core import Epilogue, Schedule
    from repro_torch.kernels import build, sddmm, spmm_eb, spmm_rb
    from repro_torch.kernels import fused_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.sparse import matrix_stats

    print(cs.card_line(), flush=True)
    print(f"repro_torch from {Path(repro_torch.__file__).parent}",
          flush=True)
    build.build()
    dev = torch.device("cuda")
    graphs = cs.make_graphs(cs.N_NODES, dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    n = cs.N_NODES
    bs = {w: torch.randn(n, w, generator=gen).to(dev)
          for w in (cs.HIDDEN, cs.N_CLASS)}
    bias = torch.randn(cs.HIDDEN, generator=gen).to(dev)
    cases = [(w, Epilogue("relu", bias=True), {"bias": bias})
             if w == cs.HIDDEN else (w, Epilogue(), {}) for w in bs]

    def report(label, ms):
        print(f"{label}: ms " + ", ".join(f"{t:.4f}" for t in ms)
              + f"; median {statistics.median(ms):.4f}", flush=True)

    adj = graphs["social"][0]
    st = matrix_stats(adj)
    with torch.no_grad():
        for w, ep, ops in cases:
            s = Schedule.auto(st, w)
            g = adj.grouped(s.nnz_tile)
            kw = dict(n_rows=n, nnz_tile=s.nnz_tile, group_size=s.group_size,
                      strategy=s.strategy, epilogue=ep, **ops)
            runs = [cs.launch_ms(lambda: spmm_eb.spmm_eb(
                g.rows, g.cols, g.vals, bs[w], **kw)) for _ in range(5)]
            report(f"EB social N={w}", [r["spmm_eb"] for r in runs])
            report(f"EB finish social N={w}",
                   [r["spmm_eb_finish"] for r in runs])
        adj, rs = graphs["roadnet"]
        e = adj.ell(row_tile=rs.row_tile)
        for w, ep, ops in cases:
            report(f"RB roadnet N={w}", [cs.cuda_ms(lambda: spmm_rb.spmm_rb(
                e.cols, e.vals, bs[w], n_rows=n, epilogue=ep, **ops))
                for _ in range(5)])
        for name, (adj, _) in graphs.items():
            coo = adj.tocoo()
            report(f"SDDMM {name} N={cs.HIDDEN}", [cs.cuda_ms(
                lambda: sddmm.sddmm(coo.rows, coo.cols, bs[cs.HIDDEN],
                                    bs[cs.HIDDEN])) for _ in range(5)])
            q, k, v, do = (cs.head_major(t) for t in cs.attention_operands(
                adj, gen, dev))
            kw = dict(scale=cs.HEAD_DIM ** -0.5, bias=adj.vals)
            args = (adj.indptr, adj.indices, q, k, v)
            _, m, l = fa.fused_sparse_attention(*args, **kw)
            report(f"attention forward {name}", [cs.cuda_ms(
                lambda: fa.fused_sparse_attention(*args, **kw), 5, 1)
                for _ in range(5)])
            report(f"attention backward {name}", [cs.cuda_ms(
                lambda: fa.fused_sparse_attention_bwd(*args, do, m, l, **kw),
                5, 1) for _ in range(5)])
            del q, k, v, do, m, l
        del graphs, bs
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(32, 4096, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(128, 4096, 1536, generator=g, device=dev)
             * 4096 ** -0.5).to(torch.bfloat16)
        te = torch.randperm(128, generator=g, device=dev)[:8].to(
            torch.int32)
        gb = torch.randn(128, 1536, generator=g, device=dev)
        kw = dict(bias=gb, epilogue=Epilogue("silu", bias=True),
                  token_tile=4)
        report("grouped matmul decode", [cs.cuda_ms(
            lambda: gm.grouped_matmul(x, te, w, **kw)) for _ in range(5)])
        x, w = x.float(), w.float()
        report("grouped matmul decode f32", [cs.cuda_ms(
            lambda: gm.grouped_matmul(x, te, w, **kw)) for _ in range(5)])


if __name__ == "__main__":
    main()
