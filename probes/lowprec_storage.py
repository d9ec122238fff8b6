"""What each value-storage type does to the GCN configuration's
normalized adjacencies, on the plain path (no kernel, no card needed).

    PYTHONPATH=src python3 probes/lowprec_storage.py [N_NODES] [--device cpu]

For the social and roadnet graphs of ``chip_smoke.py`` (169,343 nodes by
default, seed 0): the values' range, the share of them that e4m3 stores
as 0 (below 2^-10, half its smallest subnormal) and below its smallest
normal (2^-6), and for bf16, fp16, fp8 and int8 the relative L2 error of
one SpMM on a random B (4 columns, seed 0) with the values and B rounded
to their storage (``core.dtypes.cast``; int8 quantized per row),
summed in f32 (``kernels.ref.spmm_coo_ref``), against f32.  It separates
what a storage type does to this data from what the kernels add.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    sys.path[:0] = [str(ROOT / "src")]
    import torch
    from repro_torch.core.dtypes import cast, operand_dtype, storage_dtype
    from repro_torch.kernels import ref
    from repro_torch.models import normalized_adjacency
    from repro_torch.sparse import graph_pattern_csr

    argv = sys.argv[1:]
    dev = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        dev = argv[i + 1]
        del argv[i:i + 2]
    n = int(argv[0]) if argv else 169_343
    gen = torch.Generator().manual_seed(0)
    for name in ("social", "roadnet"):
        raw = graph_pattern_csr(name, n, seed=0, device="cpu")
        adj = normalized_adjacency(raw, device=dev)
        v = adj.vals
        zero = float((cast(v, torch.float8_e4m3fn).float() == 0).float()
                     .mean())
        print(f"{name}: {n} nodes, {adj.nnz} values in [{float(v.min()):.3e}"
              f", {float(v.max()):.3e}], median {float(v.median()):.3e}; "
              f"e4m3 stores {zero:.4f} of them as 0, "
              f"{float((v < 2.0 ** -6).float().mean()):.4f} lie below its "
              "smallest normal", flush=True)
        coo = adj.tocoo()
        b = torch.randn(n, 4, generator=gen).to(dev)
        want = ref.spmm_coo_ref(coo.rows, coo.cols, v, b, n)
        for vd in ("bfloat16", "float16", "float8_e4m3fn", "int8"):
            vals = (adj.quantized().dequantize().vals if vd == "int8"
                    else cast(v, storage_dtype(vd)))
            got = ref.spmm_coo_ref(coo.rows, coo.cols, vals,
                                   cast(b, operand_dtype(vd)), n)
            err = float((got - want).norm() / want.norm())
            print(f"  {vd}: one SpMM, relative L2 {err:.4e} against f32",
                  flush=True)


if __name__ == "__main__":
    main()
