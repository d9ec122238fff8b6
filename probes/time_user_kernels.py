"""The user-strategy kernels' timing rows of ``chip_smoke.py`` (PERF.md
section 6, rows 1c and 5c) for the ``repro_torch`` under SRC (another
checkout's ``src``, e.g. a parent unpacked under ``checkouts/``; this
one's by default), so that two commits' kernels can be timed in turns in
one call on the same card.

    PYTHONPATH=src python3 probes/time_user_kernels.py [SRC]

Builds the four libraries the rows use (EB for layer 1's output, the
attention forward for m and l, the partials and combine, the attention
user walk), then on the social graph runs ``chip_smoke.user_kernel_rows``
(the partials and the combine: the dense replay beside ``acc.add_``, and
the combine on one seg-generic forward's own results beside
``acc.add_``) and ``chip_smoke.attn_user_kernel_rows`` (``attn_lanes``
whole and by mode, with ``sampled_addmm`` beside the scores, and
``attn_rescale``), and prints each row.  Needs one GPU.
"""
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
sys.path[:0] = [str(SRC), str(ROOT)]
import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from repro_torch.kernels import build
    from repro_torch.models import GCN

    dev = torch.device("cuda")
    print(f"{cs.card_line()}; repro_torch from {SRC}", flush=True)
    t0 = time.perf_counter()
    build.build(("spmm_eb", "fused_attention_fwd", "eb_partials",
                 "attn_user"))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    adj = cs.make_graphs(cs.N_NODES, dev)["social"][0]
    gen = torch.Generator(device="cpu").manual_seed(cs.SEED)
    x = torch.randn(cs.N_NODES, cs.N_FEAT, generator=gen).to(dev)
    model = GCN(cs.N_FEAT, cs.HIDDEN, cs.N_CLASS, device=dev,
                generator=torch.Generator().manual_seed(cs.SEED))
    cs.user_strategies()
    with torch.no_grad():
        rows = cs.user_kernel_rows(adj, x, model)
        rows.update(cs.attn_user_kernel_rows(adj))
    for name, r in rows.items():
        b_ms, b_by = cs.bound(r["bytes"], r["flops"])
        print(json.dumps({"name": name, "ms": r["ms"],
                          "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": r["library_ms"],
                          **r.get("detail", {})}), flush=True)


if __name__ == "__main__":
    main()
