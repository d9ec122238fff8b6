"""EB's chunk size (``spmm_eb.TARGET_WARPS``) at the serving shapes of
``chip_smoke.py``, with RB and ``torch.sparse.mm`` beside it (PERF.md
section 6).

    PYTHONPATH=src python3 probes/sweep_eb_chunk.py

For each target: EB's kernel and finishing launch, launch by launch
(CUDA events, 20 calls), and the wrapper's median of five 10-call
windows, each output held to the plain version within ``K_TERMS``.
Needs one GPU.
"""
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402
from repro_torch.core import Epilogue, Schedule  # noqa: E402
from repro_torch.kernels import spmm_eb, spmm_rb  # noqa: E402
from repro_torch.models import GCN  # noqa: E402
from repro_torch.sparse import matrix_stats  # noqa: E402

TARGETS = (4096, 8192, 16384)


def ms(fn):
    return statistics.median(cs.cuda_ms(fn, 10, 2) for _ in range(5))


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    graphs = cs.make_graphs(cs.N_NODES, dev)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(cs.N_NODES, cs.N_FEAT, generator=gen).to(dev)
    model = GCN(cs.N_FEAT, cs.HIDDEN, cs.N_CLASS, device=dev,
                generator=torch.Generator().manual_seed(0))
    n = cs.N_NODES
    checker = cs.Checker(("spmm_eb", "spmm_rb"))
    relu = Epilogue("relu", bias=True)
    with torch.no_grad():
        b1 = (x @ model.w1).contiguous()
        b2 = torch.randn(n, cs.N_CLASS, generator=gen).to(dev)
        layers = ((b1, relu, {"bias": model.b1}), (b2, Epilogue(), {}))
        adj = graphs["social"][0]
        lib_csr = cs.library_csr(adj)
        for b, ep, ops in layers:
            w = b.shape[1]
            s = Schedule.auto(matrix_stats(adj), w)
            g = adj.grouped(s.nnz_tile)
            plain_kw = dict(n_rows=n, nnz_tile=s.nnz_tile,
                            group_size=s.group_size, strategy=s.strategy)
            want = spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b,
                                         epilogue=ep, **plain_kw, **ops)
            terms = cs.terms_of(spmm_eb.spmm_eb_plain, g.rows, g.cols,
                                g.vals, b, **plain_kw, **ops)
            print(f"EB social N={w}: torch.sparse.mm "
                  f"{ms(lambda: torch.sparse.mm(lib_csr, b)):.4f} ms",
                  flush=True)
            for target in TARGETS:
                spmm_eb.TARGET_WARPS = target

                def fn():
                    return spmm_eb.spmm_eb(g.rows, g.cols, g.vals, b,
                                           epilogue=ep, **plain_kw, **ops)

                checker.record_terms("spmm_eb", f"N={w} target {target}",
                                     fn(), want, terms)
                split = cs.launch_ms(fn, 20)
                chunk = spmm_eb.eb_geometry(g.nnz_padded, s.nnz_tile, w, 4)[2]
                print(f"EB social N={w} TARGET_WARPS {target} (chunk "
                      f"{chunk}): kernel {split['spmm_eb']:.4f} + finish "
                      f"{split['spmm_eb_finish']:.4f} ms; the wrapper "
                      f"{ms(fn):.4f} ms", flush=True)
            del want, terms
        spmm_eb.TARGET_WARPS = TARGETS[1]
        adj, rs = graphs["roadnet"]
        e = adj.ell(row_tile=rs.row_tile)
        lib_csr = cs.library_csr(adj)
        for b, ep, ops in layers:
            kw = dict(n_rows=n, epilogue=ep, **ops)
            fn = lambda: spmm_rb.spmm_rb(e.cols, e.vals, b, **kw)  # noqa
            checker.record_terms(
                "spmm_rb", f"N={b.shape[1]}", fn(),
                spmm_rb.spmm_rb_plain(e.cols, e.vals, b, **kw),
                cs.terms_of(spmm_rb.spmm_rb_plain, e.cols, e.vals, b,
                            n_rows=n, **ops))
            print(f"RB roadnet N={b.shape[1]}: {ms(fn):.4f} ms; "
                  f"torch.sparse.mm "
                  f"{ms(lambda: torch.sparse.mm(lib_csr, b)):.4f} ms",
                  flush=True)
        checker.done()
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
