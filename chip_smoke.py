#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into the
git-ignored ``_build`` directory beside them), holds each kernel against
its plain PyTorch version on the card, then serves a two-layer GCN
forward (169,343 nodes as in ogbn-arxiv, 128 -> 256 -> 40) three times on
a power-law "social" graph (``Schedule.auto`` -> the EB kernel) and three
times on a near-regular "roadnet" graph (``RB+PR`` -> the RB kernel), with
random weights from a seed.  It prints kernel and forward times, the
launch counts of the serving runs, a ``{"kernels": [...]}`` line and, as
its last line, ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero without that line; so does a machine without CUDA.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_NODES, N_FEAT, HIDDEN, N_CLASS = 169_343, 128, 256, 40
SEED = 0
REQUESTS = 3
DEVICE = "cuda"
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s
#: outside the tensor cores (the kernels run FMAs on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: f32 tolerance, relative to the largest magnitude of the plain result:
#: atomics and the kernels' loop order reorder every f32 sum.
F32_TOL = 1e-4
#: bf16 outputs may round to neighbouring values: one bf16 step (2^-7
#: relative) on top of the f32 tolerance.
BF16_RTOL = 2.0 ** -7


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want):
    """(max |got - want|, tolerance text, within tolerance) in f32."""
    import torch

    g, w = got.float(), want.float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        return float("inf"), "finite, same shape", False
    scale = max(1.0, float(w.abs().max()))
    err = (g - w).abs()
    if got.dtype == torch.bfloat16:
        ok = bool((err <= BF16_RTOL * w.abs() + F32_TOL * scale).all())
        return float(err.max()), f"2^-7|ref| + {F32_TOL * scale:.2e}", ok
    return float(err.max()), f"{F32_TOL * scale:.2e}", \
        float(err.max()) <= F32_TOL * scale


def library_csr(adj):
    """``torch.sparse_csr_tensor`` of a port CSR: the operand of the
    ``torch.sparse.mm`` yardstick (``library_ms``), which the port never
    calls."""
    import warnings

    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta state"
        return torch.sparse_csr_tensor(adj.indptr, adj.indices, adj.vals,
                                       adj.shape, check_invariants=False)


def make_graphs(n_nodes: int, dev):
    """The two adjacencies, normalized, each with the schedule it is
    served with."""
    from repro_torch.core import Schedule
    from repro_torch.models import normalized_adjacency
    from repro_torch.sparse import graph_pattern_csr, matrix_stats

    graphs = {}
    for name, sched in (("social", "auto"),
                        ("roadnet", Schedule.named("RB+PR"))):
        t0 = time.perf_counter()
        raw = graph_pattern_csr(name, n_nodes, seed=SEED, device="cpu")
        adj = normalized_adjacency(raw, device=dev)
        st = matrix_stats(adj)
        print(f"graph {name}: {n_nodes} nodes, nnz {raw.nnz} generated, "
              f"{adj.nnz} after symmetrising and self-loops; row_max "
              f"{st['row_max']}, row_cv {st['row_cv']:.2f}; built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        graphs[name] = (adj, sched)
    return graphs


def check_kernels(graphs, x, model, dev):
    """Each kernel's wrapper against its plain version on the same
    inputs; returns the worst error per kernel."""
    import torch
    from repro_torch.core import Epilogue, Schedule
    from repro_torch.kernels import common, spmm_eb, spmm_rb
    from repro_torch.sparse import matrix_stats

    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    worst = {"spmm_eb": 0.0, "spmm_rb": 0.0, "epilogue": 0.0}
    failures = []

    def record(kernel, label, got, want):
        err, tol, ok = compare(got, want)
        worst[kernel] = max(worst[kernel], err)
        print(f"  {kernel:9s} {label:48s} max_abs_err {err:.3e} "
              f"tol {tol} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"{kernel} {label}")

    b1 = (x @ model.w1).contiguous()
    rand = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    bias = rand(HIDDEN)
    n = x.shape[0]
    res = rand(n, HIDDEN)
    b2 = rand(n, N_CLASS)
    variants = {
        "none": (Epilogue(), {}),
        "bias+relu": (Epilogue("relu", bias=True), {"bias": bias}),
        "bias+gelu+residual": (Epilogue("gelu", bias=True, residual=True),
                               {"bias": bias, "residual": res}),
        "bias+silu": (Epilogue("silu", bias=True), {"bias": bias}),
        "tanh": (Epilogue("tanh"), {}),
        "sigmoid+residual": (Epilogue("sigmoid", residual=True),
                             {"residual": res}),
        "bf16": (Epilogue(out_dtype="bfloat16"), {}),
    }

    adj, _ = graphs["social"]
    stats = matrix_stats(adj)
    print("check: EB (spmm_eb) on the social graph", flush=True)
    eb_cases = []
    for G in (8, 32):
        for strat in ("segment", "accumulate"):
            eb_cases.append((Schedule("eb", nnz_tile=128, group_size=G,
                                      strategy=strat), f"G={G} {strat}"))
    split = max(64, stats["row_quantiles"][-1][1])
    for strat, merge in (("segment", 2), ("segment", 0), ("parallel", 0)):
        eb_cases.append((Schedule("eb", nnz_tile=128, group_size=8,
                                  strategy=strat, split_threshold=split,
                                  merge_threshold=merge),
                         f"skew split>={split} merge<={merge} {strat}"))
    for sched, label in eb_cases:
        g = adj.grouped(sched.nnz_tile, group_size=sched.group_size,
                        split_threshold=sched.split_threshold,
                        merge_threshold=sched.merge_threshold)
        kw = dict(n_rows=n, nnz_tile=sched.nnz_tile, group_size=sched.group_size,
                  strategy=sched.strategy, heavy_tiles=g.heavy_tiles)
        if sched.is_skew and g.heavy_tiles == 0:
            failures.append(f"{label}: layout has no heavy tiles")
        record("spmm_eb", f"{label} heavy_tiles={g.heavy_tiles} N={HIDDEN}",
               spmm_eb.spmm_eb(g.rows, g.cols, g.vals, b1,
                               col_tile=128, **kw),
               spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b1, **kw))
    auto1 = Schedule.auto(stats, HIDDEN)
    auto2 = Schedule.auto(stats, N_CLASS)
    g = adj.grouped(auto1.nnz_tile)
    for vname, (ep, ops) in variants.items():
        kw = dict(n_rows=adj.shape[0], nnz_tile=auto1.nnz_tile,
                  group_size=auto1.group_size, strategy=auto1.strategy,
                  epilogue=ep, **ops)
        record("spmm_eb", f"auto {vname} N={HIDDEN}",
               spmm_eb.spmm_eb(g.rows, g.cols, g.vals, b1,
                               col_tile=auto1.col_tile, **kw),
               spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b1, **kw))
    g2 = adj.grouped(auto2.nnz_tile)
    kw = dict(n_rows=adj.shape[0], nnz_tile=auto2.nnz_tile,
              group_size=auto2.group_size, strategy=auto2.strategy)
    record("spmm_eb", f"auto none N={N_CLASS}",
           spmm_eb.spmm_eb(g2.rows, g2.cols, g2.vals, b2,
                           col_tile=auto2.col_tile, **kw),
           spmm_eb.spmm_eb_plain(g2.rows, g2.cols, g2.vals, b2, **kw))

    print("check: epilogue on the EB accumulator", flush=True)
    acc = spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b1,
                                n_rows=adj.shape[0],
                                nnz_tile=auto1.nnz_tile,
                                group_size=auto1.group_size)
    for vname, (ep, ops) in variants.items():
        if ep.is_noop:
            continue
        record("epilogue", vname,
               common.apply_epilogue(acc.clone(), ep, **ops),
               common.apply_epilogue_plain(acc.clone(), ep, **ops))

    adj, rb_sched = graphs["roadnet"]
    print("check: RB (spmm_rb) on the roadnet graph", flush=True)
    for row_tile in (8, 32):
        e = adj.ell(row_tile=row_tile)
        for vname, (ep, ops) in variants.items():
            kw = dict(n_rows=adj.shape[0], epilogue=ep, **ops)
            record("spmm_rb",
                   f"row_tile={row_tile} W={e.width} {vname} N={HIDDEN}",
                   spmm_rb.spmm_rb(e.cols, e.vals, b1, row_tile=row_tile,
                                   col_tile=rb_sched.col_tile, **kw),
                   spmm_rb.spmm_rb_plain(e.cols, e.vals, b1, **kw))
        record("spmm_rb", f"row_tile={row_tile} none N={N_CLASS}",
               spmm_rb.spmm_rb(e.cols, e.vals, b2, n_rows=adj.shape[0],
                               row_tile=row_tile, col_tile=N_CLASS),
               spmm_rb.spmm_rb_plain(e.cols, e.vals, b2,
                                     n_rows=adj.shape[0]))
    torch.cuda.synchronize()
    if failures:
        fail("kernel disagrees with its plain version: "
             + "; ".join(failures))
    return worst


def reference_forward(model, adj, x):
    """The GCN forward through the plain oracle path (impl='ref')."""
    from repro_torch.core import Epilogue
    from repro_torch.sparse import spmm

    dev = x.device
    h = spmm(adj, x @ model.w1, bias=model.b1, epilogue=Epilogue("relu"),
             impl="ref", device=dev)
    return spmm(adj, h @ model.w2, impl="ref", device=dev)


def serve(name, model, adj, x, counters):
    """REQUESTS forwards on one CSR instance, counts zeroed just before
    and read just after; checks the outputs and the conversion memo."""
    import torch

    for k in counters.values():
        k.launches = 0
    times, outs, memo = [], [], []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        outs.append(model(adj, x))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        memo.append(len(adj.__dict__.get("_convcache", {})))
    counts = {n: k.launches for n, k in counters.items()}
    print(f"serve {name}: schedule {model.schedule}; request ms "
          + ", ".join(f"{t:.3f}" for t in times)
          + f"; launches {counts}; memo entries {memo}", flush=True)
    if memo[1:] != memo[:-1]:
        fail(f"{name}: the feed conversion was not memoized: {memo}")
    want = reference_forward(model, adj, x)
    for i, out in enumerate(outs):
        if out.shape != (adj.shape[0], N_CLASS):
            fail(f"{name}: output shape {tuple(out.shape)}")
        err, tol, ok = compare(out, want)
        if not ok:
            fail(f"{name} request {i}: max_abs_err {err:.3e} above {tol} "
                 "against the plain path")
    print(f"serve {name}: outputs finite, (n, {N_CLASS}), match the plain "
          f"path within {tol}", flush=True)
    return times, counts


def bound(nbytes: int, flops: int):
    """(least ms, what bounds it): bytes at the HBM rate or f32
    operations at the peak rate, whichever takes longer."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def time_kernels(graphs, social_model, road_model, x):
    """Per-forward times of each kernel, its plain version and the
    library yardstick at the serving shapes, with the bytes and
    operations of that work; and the dense products' time per graph."""
    import torch
    from repro_torch.core import Epilogue, Schedule
    from repro_torch.kernels import common, spmm_eb, spmm_rb
    from repro_torch.sparse import matrix_stats, spmm

    def layer_inputs(model, adj):
        b1 = (x @ model.w1).contiguous()
        h = spmm(adj, b1, bias=model.b1, epilogue=Epilogue("relu"),
                 impl="ref", device=x.device)
        return b1, (h @ model.w2).contiguous(), h

    def zero():
        return {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
                "flops": 0}

    relu_bias = Epilogue("relu", bias=True)
    results, dense_ms = {}, {}
    # EB: layer 1 (N=256) and layer 2 (N=40) on the social graph
    adj = graphs["social"][0]
    st = matrix_stats(adj)
    b1, b2, h = layer_inputs(social_model, adj)
    dense_ms["social"] = (cuda_ms(lambda: x @ social_model.w1)
                          + cuda_ms(lambda: h @ social_model.w2))
    lib_csr = library_csr(adj)
    eb = results["spmm_eb"] = zero()
    for b in (b1, b2):
        s = Schedule.auto(st, b.shape[1])
        g = adj.grouped(s.nnz_tile)
        kw = dict(n_rows=adj.shape[0], nnz_tile=s.nnz_tile,
                  group_size=s.group_size, strategy=s.strategy)
        eb["ms"] += cuda_ms(lambda: spmm_eb.spmm_eb(
            g.rows, g.cols, g.vals, b, col_tile=s.col_tile, **kw))
        eb["plain_ms"] += cuda_ms(lambda: spmm_eb.spmm_eb_plain(
            g.rows, g.cols, g.vals, b, **kw), 3, 1)
        eb["library_ms"] += cuda_ms(lambda: torch.sparse.mm(lib_csr, b))
        eb["bytes"] += (g.nnz_padded * 12 + b.numel() * 4
                        + adj.shape[0] * b.shape[1] * 4)
        eb["flops"] += 2 * adj.nnz * b.shape[1]
    # epilogue: layer 1's bias + relu on the EB accumulator
    s = Schedule.auto(st, HIDDEN)
    g = adj.grouped(s.nnz_tile)
    acc = spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b1,
                                n_rows=adj.shape[0], nnz_tile=s.nnz_tile,
                                group_size=s.group_size)
    acc_k = acc.clone()
    results["epilogue"] = {
        "ms": cuda_ms(lambda: common.apply_epilogue(
            acc_k, relu_bias, bias=social_model.b1)),
        "plain_ms": cuda_ms(lambda: common.apply_epilogue_plain(
            acc, relu_bias, bias=social_model.b1)),
        "library_ms": None,
        "bytes": 2 * acc.numel() * 4 + HIDDEN * 4,
        "flops": 2 * acc.numel()}
    del acc, acc_k
    # RB: layer 1 (bias + relu fused) and layer 2 on the roadnet graph
    adj, rs = graphs["roadnet"]
    b1, b2, h = layer_inputs(road_model, adj)
    dense_ms["roadnet"] = (cuda_ms(lambda: x @ road_model.w1)
                           + cuda_ms(lambda: h @ road_model.w2))
    e = adj.ell(row_tile=rs.row_tile)
    lib_csr = library_csr(adj)
    rb = results["spmm_rb"] = zero()
    for b, ep, ops in ((b1, relu_bias, {"bias": road_model.b1}),
                       (b2, Epilogue(), {})):
        col_tile = min(rs.col_tile, b.shape[1])
        kw = dict(n_rows=adj.shape[0], epilogue=ep, **ops)
        rb["ms"] += cuda_ms(lambda: spmm_rb.spmm_rb(
            e.cols, e.vals, b, row_tile=rs.row_tile, col_tile=col_tile,
            **kw))
        rb["plain_ms"] += cuda_ms(lambda: spmm_rb.spmm_rb_plain(
            e.cols, e.vals, b, **kw), 3, 1)
        rb["library_ms"] += cuda_ms(lambda: torch.sparse.mm(lib_csr, b))
        rb["bytes"] += (e.cols.numel() * 8 + b.numel() * 4
                        + adj.shape[0] * b.shape[1] * 4
                        + (HIDDEN * 4 if ep.bias else 0))
        rb["flops"] += 2 * adj.nnz * b.shape[1]
    return results, dense_ms


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import Schedule
        from repro_torch.kernels import build, common, spmm_eb, spmm_rb
        from repro_torch.models import GCN
        from repro_torch.sparse import matrix_stats
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)

    t0 = time.perf_counter()
    reports = build.build()
    print(f"build: {len(reports)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    graphs = make_graphs(N_NODES, dev)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    x = torch.randn(N_NODES, N_FEAT, generator=gen).to(dev)
    social_model = GCN(N_FEAT, HIDDEN, N_CLASS, device=dev,
                       generator=torch.Generator().manual_seed(SEED))
    road_model = GCN(N_FEAT, HIDDEN, N_CLASS, device=dev,
                     schedule=graphs["roadnet"][1],
                     generator=torch.Generator().manual_seed(SEED))
    for name, (adj, _) in graphs.items():
        st = matrix_stats(adj)
        print(f"auto schedule on {name}: N={HIDDEN} "
              f"{Schedule.auto(st, HIDDEN)}, N={N_CLASS} "
              f"{Schedule.auto(st, N_CLASS)}", flush=True)

    worst = check_kernels(graphs, x, social_model, dev)

    counters = {"spmm_eb": spmm_eb.KERNEL, "spmm_rb": spmm_rb.KERNEL,
                "epilogue": common.EPILOGUE_KERNEL}
    _, social_counts = serve("social", social_model,
                             graphs["social"][0], x, counters)
    _, road_counts = serve("roadnet", road_model, graphs["roadnet"][0], x,
                           counters)
    launches = {n: social_counts[n] + road_counts[n] for n in counters}
    for n, path in (("spmm_eb", social_counts), ("epilogue", social_counts),
                    ("spmm_rb", road_counts)):
        if path[n] == 0:
            fail(f"the {n} kernel was not launched on its serving path")

    fwd_ms = {name: cuda_ms(lambda m=m, a=graphs[name][0]: m(a, x), 5)
              for name, m in (("social", social_model),
                              ("roadnet", road_model))}
    results, dense_ms = time_kernels(graphs, social_model, road_model, x)
    parts = {"social": results["spmm_eb"]["ms"] + results["epilogue"]["ms"],
             "roadnet": results["spmm_rb"]["ms"]}
    for name in graphs:
        print(f"forward {name}: {fwd_ms[name]:.4f} ms (CUDA events, mean "
              f"of 5 after warm-up) = sparse kernels {parts[name]:.4f} + "
              f"dense products {dense_ms[name]:.4f} + the rest "
              f"{fwd_ms[name] - parts[name] - dense_ms[name]:.4f}",
              flush=True)

    meta = {
        "spmm_eb": ("src/repro_torch/kernels/csrc/spmm_eb.cu",
                    "src/repro/kernels/spmm_eb.py:102"),
        "spmm_rb": ("src/repro_torch/kernels/csrc/spmm_rb.cu",
                    "src/repro/kernels/spmm_rb.py:69"),
        "epilogue": ("src/repro_torch/kernels/csrc/epilogue.cu",
                     "src/repro/kernels/common.py:215"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = results[name]
        bound_ms, bound_by = bound(r["bytes"], r["flops"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r["library_ms"]})
        lib = ("null" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        print(f"kernel {name}: {r['ms']:.4f} ms per forward (bound "
              f"{bound_ms:.4f} ms by {bound_by}, {r['bytes']} bytes), "
              f"plain {r['plain_ms']:.4f} ms, library {lib} ms, "
              f"launches {launches[name]}", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
