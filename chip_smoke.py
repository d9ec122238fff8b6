#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into the
git-ignored ``_build`` directory beside them) and holds each kernel
against its plain PyTorch version on the card: EB and RB SpMM, the
epilogue, SDDMM, and fused sparse attention forward and backward.  Then
it drives the paths of the port on a power-law "social" graph
(``Schedule.auto`` -> the EB kernel) and a near-regular "roadnet" graph
(``RB+PR`` -> the RB kernel), both at 169,343 nodes as in ogbn-arxiv,
with random weights from a seed:

- serving: a two-layer GCN forward (128 -> 256 -> 40), three requests;
- training: the GCN of ``examples/gcn_spmm.py`` (mean NLL of
  ``log_softmax`` on teacher labels, SGD at lr 0.5) for a few full-batch
  steps, with the adjacency's values trainable too, so the backward runs
  SDDMM and the transpose SpMM; step 0's gradients are held against the
  plain path (``impl="ref"`` under torch autograd) and the loss must
  fall;
- ``make_spmm``: the pattern-closed differentiable SpMM over the social
  graph's stream, forward and backward, against ``impl="ref"``;
- graph attention: 4 heads of width 64 over the normalized adjacency
  (its values as the score bias), forward and backward, held against the
  plain path.

It prints kernel, forward, training-step and attention times, the launch
counts of each path, a ``{"kernels": [...]}`` line and, as its last
line, ``{"ok": true, "device": {...}}``.  Any failed phase exits
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
#: Attention's row statistics m and l compare per element, at F32_TOL of
#: each value plus this floor: one score's f32 rounding over a 64-long
#: dot is about 1e-6, and a tolerance set by the largest value would let
#: the hub row's denominator (or an empty row's m of -1e30) cover every
#: other row.
STAT_ATOL = 1e-5
#: Gradients of the training loss, as the relative L2 error against the
#: plain path: f32 sums taken in another order (atomics in the kernels,
#: ``index_add_`` in the plain path), chained through both layers.  The
#: plain path takes its relu mask from the kernel path's pre-activation:
#: where the two round a value near 0 to opposite signs, the gradient
#: has a kink, and a handful of such elements moved the gradient of the
#: roadnet adjacency's values by 2.4e-4 of its norm on the H100.
GRAD_RTOL = 1e-4
#: The borrowed mask is allowed only while the two paths disagree on the
#: sign of at most this share of the layer-1 pre-activations (runs on the
#: H100 read 0 to 3 of 43.4 M); more fails the check.
MAX_FLIP_SHARE = 1e-6
TRAIN_STEPS = 5
LR = 0.5
#: Graph attention: HEADS x HEAD_DIM = 256, the GCN's hidden width.
HEADS, HEAD_DIM = 4, 64
#: Where each kernel came from: its source and the TPU kernel it replaces.
KERNEL_META = {
    "spmm_eb": ("src/repro_torch/kernels/csrc/spmm_eb.cu",
                "src/repro/kernels/spmm_eb.py:102"),
    "spmm_rb": ("src/repro_torch/kernels/csrc/spmm_rb.cu",
                "src/repro/kernels/spmm_rb.py:69"),
    "epilogue": ("src/repro_torch/kernels/csrc/epilogue.cu",
                 "src/repro/kernels/common.py:215"),
    "sddmm": ("src/repro_torch/kernels/csrc/sddmm.cu",
              "src/repro/kernels/sddmm.py:55"),
    "fused_attention_fwd": (
        "src/repro_torch/kernels/csrc/fused_attention_fwd.cu",
        "src/repro/kernels/fused_attention.py:225"),
    "fused_attention_bwd": (
        "src/repro_torch/kernels/csrc/fused_attention_bwd.cu",
        "src/repro/kernels/fused_attention.py:373"),
}


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


def compare(got, want, per_element=False):
    """(max |got - want|, tolerance text, within tolerance) in f32; with
    ``per_element`` each value is held to F32_TOL of itself plus
    STAT_ATOL."""
    import torch

    g, w = got.detach().float(), want.detach().float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        return float("inf"), "finite, same shape", False
    if per_element:
        err = (g - w).abs()
        return float(err.max()), f"{F32_TOL:.0e}|ref| + {STAT_ATOL:.0e}", \
            bool((err <= F32_TOL * w.abs() + STAT_ATOL).all())
    scale = max(1.0, float(w.abs().max()))
    err = (g - w).abs()
    if got.dtype == torch.bfloat16:
        ok = bool((err <= BF16_RTOL * w.abs() + F32_TOL * scale).all())
        return float(err.max()), f"2^-7|ref| + {F32_TOL * scale:.2e}", ok
    return float(err.max()), f"{F32_TOL * scale:.2e}", \
        float(err.max()) <= F32_TOL * scale


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in f32 (inf for a non-finite result)."""
    import torch

    g, w = got.detach().float(), want.detach().float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        return float("inf")
    return float(torch.linalg.vector_norm(g - w)
                 / torch.linalg.vector_norm(w).clamp_min(1e-30))


class Checker:
    """Worst error per kernel over its checks, and the checks that
    failed."""

    def __init__(self, kernels):
        self.worst = {k: 0.0 for k in kernels}
        self.failures = []

    def record(self, kernel, label, got, want, per_element=False):
        err, tol, ok = compare(got, want, per_element)
        self.worst[kernel] = max(self.worst[kernel], err)
        print(f"  {kernel:19s} {label:48s} max_abs_err {err:.3e} "
              f"tol {tol} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failures.append(f"{kernel} {label}")

    def done(self):
        import torch

        torch.cuda.synchronize()
        if self.failures:
            fail("kernel disagrees with its plain version: "
                 + "; ".join(self.failures))
        return self.worst


class LaunchTimer:
    """While active, brackets every kernel launch with CUDA events on the
    launching stream; :meth:`ms` sums the device time per kernel."""

    def __enter__(self):
        import torch
        from repro_torch.kernels.build import CudaKernel

        self._cls, self._orig, self.events = CudaKernel, CudaKernel.launch, []

        def launch(kernel, device, *args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self._orig(kernel, device, *args)
            end.record()
            self.events.append((kernel.source, start, end))

        CudaKernel.launch = launch
        return self

    def __exit__(self, *exc):
        self._cls.launch = self._orig

    def ms(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out = {}
        for source, start, end in self.events:
            out[source] = out.get(source, 0.0) + start.elapsed_time(end)
        return out


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
    checker = Checker(("spmm_eb", "spmm_rb", "epilogue"))
    record, failures = checker.record, checker.failures

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
    return checker.done()


def attention_operands(adj, gen, dev, *, grad=False):
    """q, k, v and a cotangent of graph attention over ``adj``: (n, HEADS,
    HEAD_DIM) each, from ``gen``."""
    import torch

    n = adj.shape[0]
    ops = [torch.randn(n, HEADS, HEAD_DIM, generator=gen).to(dev)
           for _ in range(4)]
    return [t.requires_grad_(grad) for t in ops[:3]] + [ops[3]]


def head_major(t):
    """(n, H, d) -> the kernels' (H, n, d), contiguous."""
    return t.detach().movedim(1, 0).contiguous()


def check_sddmm_and_attention(graphs, x, model, dev):
    """SDDMM and the fused attention kernels against their plain versions
    at the shapes of the training and attention paths; returns the worst
    error per kernel."""
    import torch
    from repro_torch.kernels import fused_attention as fa
    from repro_torch.kernels import sddmm

    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    checker = Checker(("sddmm", "fused_attention_fwd",
                       "fused_attention_bwd"))
    adj = graphs["social"][0]
    coo = adj.tocoo()
    print("check: SDDMM on the social graph's stream (the gradient in the "
          "adjacency's values)", flush=True)
    b1 = (x @ model.w1).contiguous()
    for width, b in ((HIDDEN, b1), (N_CLASS, None)):
        if b is None:
            b = torch.randn(x.shape[0], width, generator=gen).to(dev)
        dz = torch.randn(x.shape[0], width, generator=gen).to(dev)
        for scale in (None, adj.vals):
            label = (f"dz ({x.shape[0]} x {width}) . B"
                     + (" * vals" if scale is not None else ""))
            checker.record("sddmm", label,
                           sddmm.sddmm(coo.rows, coo.cols, dz, b, scale),
                           sddmm.sddmm_plain(coo.rows, coo.cols, dz, b,
                                             scale))
    del b1, dz, b
    for name, (adj, _) in graphs.items():
        print(f"check: fused attention on the {name} graph, {HEADS} heads "
              f"of {HEAD_DIM}, bias = the adjacency's values", flush=True)
        q, k, v, do = (head_major(t) for t in attention_operands(adj, gen,
                                                                  dev))
        kw = dict(scale=HEAD_DIM ** -0.5, bias=adj.vals)
        got = fa.fused_sparse_attention(adj.indptr, adj.indices, q, k, v,
                                        **kw)
        want = fa.fused_sparse_attention_plain(adj.indptr, adj.indices, q,
                                               k, v, **kw)
        for label, g, w in zip(("out", "m", "l"), got, want):
            checker.record("fused_attention_fwd", f"{name} {label}", g, w,
                           per_element=label != "out")
        got = fa.fused_sparse_attention_bwd(adj.indptr, adj.indices, q, k, v,
                                            do, got[1], got[2], **kw)
        want = fa.fused_sparse_attention_bwd_plain(
            adj.indptr, adj.indices, q, k, v, do, want[1], want[2], **kw)
        for label, g, w in zip(("dq", "dk", "dv"), got, want):
            checker.record("fused_attention_bwd", f"{name} {label}", g, w)
        del q, k, v, do, got, want
    torch.cuda.empty_cache()
    return checker.done()


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


def train(name, adj, sched, x, counters):
    """The GCN of ``examples/gcn_spmm.py`` at full width on one graph:
    step 0's gradients (w1, b1, w2 and the adjacency's values) against
    the plain path, then TRAIN_STEPS SGD steps with the launch counts
    zeroed just before and read just after, and one more step with every
    launch timed.  Returns the numbers of the run."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import GCN
    from repro_torch.sparse import CSR, spmm

    dev = x.device
    gen = torch.Generator().manual_seed(SEED + 3)
    w_teacher = torch.randn(N_FEAT, N_CLASS, generator=gen).to(dev)
    with torch.no_grad():  # the example's teacher labels
        labels = spmm(adj, x @ w_teacher, impl="ref", device=dev).argmax(1)
    model = GCN(N_FEAT, HIDDEN, N_CLASS, schedule=sched, device=dev,
                generator=torch.Generator().manual_seed(SEED))
    vals = adj.vals.requires_grad_()
    params = [model.w1, model.b1, model.w2]

    def loss_of(logits):  # the example's mean NLL of log_softmax
        return F.cross_entropy(logits, labels)

    got = torch.autograd.grad(loss_of(model(adj, x)), params + [vals])
    leaves = [t.detach().clone().requires_grad_() for t in params + [vals]]
    ref_adj = CSR(adj.indptr, adj.indices, leaves[3], adj.shape)
    z = spmm(ref_adj, x @ leaves[0], bias=leaves[1], impl="ref", device=dev)
    with torch.no_grad():
        z_kernel = spmm(adj, x @ model.w1, bias=model.b1, schedule=sched,
                        device=dev)
    mask = z_kernel > 0
    flips = int((mask != (z > 0)).sum())
    want = torch.autograd.grad(
        loss_of(spmm(ref_adj, (z * mask) @ leaves[2], impl="ref",
                     device=dev)), leaves)
    print(f"train {name}: {flips} of {z.numel()} layer-1 pre-activations "
          "round to opposite signs of 0 in the two paths (bound "
          f"{MAX_FLIP_SHARE:.0e} of them); the plain path takes the kernel "
          "path's relu mask", flush=True)
    if flips > MAX_FLIP_SHARE * z.numel():
        fail(f"train {name}: {flips} pre-activations change sign between "
             "the kernel and the plain path")
    grad_err = {}
    for pname, g, w in zip(("w1", "b1", "w2", "vals"), got, want):
        grad_err[pname] = rel_l2(g, w)
        print(f"train {name}: step-0 d{pname} {tuple(g.shape)} relative L2 "
              f"error {grad_err[pname]:.3e} (max_abs_err "
              f"{float((g - w).abs().max()):.3e}) against the plain path, "
              f"tol {GRAD_RTOL:.0e}", flush=True)
        if not grad_err[pname] <= GRAD_RTOL:
            fail(f"train {name}: step-0 gradient of {pname} disagrees with "
                 "the plain path")
    del got, want, leaves, ref_adj, z, z_kernel, mask

    opt = torch.optim.SGD(model.parameters(), lr=LR)

    def step():
        opt.zero_grad()
        vals.grad = None
        loss = loss_of(model(adj, x))
        loss.backward()
        opt.step()
        return loss.detach()

    for k in counters.values():
        k.launches = 0
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    losses = []
    events[0].record()
    for i in range(TRAIN_STEPS):
        losses.append(step())
        events[i + 1].record()
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in counters.items()}
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(TRAIN_STEPS)]
    losses = [float(t) for t in losses]
    with torch.no_grad():
        final = float(loss_of(model(adj, x)))
    print(f"train {name}: schedule {sched}; loss "
          + " -> ".join(f"{v:.4f}" for v in losses + [final])
          + "; step ms " + ", ".join(f"{t:.3f}" for t in step_ms)
          + f"; launches in {TRAIN_STEPS} steps {counts}", flush=True)
    if not all(v == v and abs(v) != float("inf") for v in losses + [final]):
        fail(f"train {name}: a loss is not finite")
    if not final < losses[0]:
        fail(f"train {name}: the loss did not fall ({losses[0]} -> "
             f"{final})")

    with LaunchTimer() as timer:
        step()
    kernel_ms = timer.ms()
    with torch.no_grad():
        h = torch.relu(x @ model.w1)
        g1 = torch.randn_like(h)
        g2 = torch.randn(x.shape[0], N_CLASS, device=dev)
        # the step's dense products: x @ w1 and h @ w2 forward; dw2, dh
        # and dw1 backward
        dense_ms = cuda_ms(lambda: (x @ model.w1, h @ model.w2,
                                    h.t() @ g2, g2 @ model.w2.t(),
                                    x.t() @ g1))
    del h, g1, g2
    vals.requires_grad_(False)
    vals.grad = None
    mean_ms = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
    sparse_ms = sum(kernel_ms.values())
    print(f"train {name}: step {mean_ms:.4f} ms (CUDA events, mean of steps "
          f"2-{TRAIN_STEPS}) = sparse kernels {sparse_ms:.4f} ("
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(kernel_ms.items()))
          + f") + dense products {dense_ms:.4f} + the rest "
          f"{mean_ms - sparse_ms - dense_ms:.4f}", flush=True)
    return {"counts": counts, "losses": losses + [final],
            "step_ms": mean_ms, "kernel_ms": kernel_ms,
            "dense_ms": dense_ms, "grad_err": grad_err}


def differentiate(adj, counters):
    """``make_spmm`` over the social graph's (rows, cols) stream at the
    hidden width, forward and backward, with the launch counts zeroed
    just before and read just after the kernel run; out, dvals and dB
    against impl='ref' under autograd."""
    import torch
    from repro_torch.sparse import make_spmm

    dev = adj.device
    coo = adj.tocoo()
    gen = torch.Generator().manual_seed(SEED + 6)
    b, cot = (torch.randn(n, HIDDEN, generator=gen).to(dev)
              for n in adj.shape[::-1])
    results = {}
    for impl in ("ref", "kernel"):
        fn = make_spmm(coo.rows, coo.cols, *adj.shape, impl=impl, device=dev)
        vals = adj.vals.detach().clone().requires_grad_()
        b_in = b.clone().requires_grad_()
        for c in counters.values():
            c.launches = 0
        out = fn(vals, b_in)
        results[impl] = (out.detach(),) + torch.autograd.grad(
            out, (vals, b_in), cot)
        torch.cuda.synchronize()
    counts = {n: c.launches for n, c in counters.items()}
    for label, g, w in zip(("out", "dvals", "dB"), results["kernel"],
                           results["ref"]):
        err, tol, ok = compare(g, w)
        print(f"make_spmm social: {label} {tuple(g.shape)} max_abs_err "
              f"{err:.3e} tol {tol} against impl='ref' "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"make_spmm social: {label} disagrees with impl='ref'")
    print(f"make_spmm social: launches {counts}", flush=True)
    if (counts["spmm_eb"], counts["sddmm"]) != (2, 1):
        fail("make_spmm: expected 2 EB launches (forward, dB) and 1 SDDMM "
             f"launch (dvals), got {counts}")
    del results
    torch.cuda.empty_cache()
    return counts


def attend(name, adj, counters):
    """Graph attention forward and backward on one graph, with the launch
    counts zeroed just before and read just after; output and gradients
    against the plain path; forward and backward times."""
    import torch
    from repro_torch.kernels import fused_attention as fa
    from repro_torch.models import graph_attention
    from repro_torch.sparse import sparse_attention

    dev = adj.device
    gen = torch.Generator().manual_seed(SEED + 4)
    q, k, v, cot = attention_operands(adj, gen, dev, grad=True)
    for c in counters.values():
        c.launches = 0
    out = graph_attention(adj, q, k, v, device=dev)
    grads = torch.autograd.grad(out, (q, k, v), cot)
    torch.cuda.synchronize()
    counts = {n: c.launches for n, c in counters.items()}
    out_ref = sparse_attention(adj, q, k, v, impl="ref", device=dev)
    want = torch.autograd.grad(out_ref, (q, k, v), cot)
    for label, g, w in zip(("out", "dq", "dk", "dv"), (out,) + grads,
                           (out_ref,) + want):
        err, tol, ok = compare(g, w)
        print(f"attend {name}: {label} {tuple(g.shape)} max_abs_err "
              f"{err:.3e} tol {tol} against the plain path "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"attend {name}: {label} disagrees with the plain path")
    del out, grads, out_ref, want
    torch.cuda.empty_cache()

    def fwd():
        return graph_attention(adj, q, k, v, device=dev)

    with torch.no_grad():
        fwd_ms = cuda_ms(fwd, 5, 1)
    both_ms = cuda_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), cot),
                      5, 1)
    # the longest row alone: one warp per head walks it
    lengths = (adj.indptr[1:] - adj.indptr[:-1]).long()
    hub = int(lengths.argmax())
    lo, hi = int(adj.indptr[hub]), int(adj.indptr[hub + 1])
    ip = torch.tensor([0, hi - lo], dtype=torch.int32, device=dev)
    hub_args = (ip, adj.indices[lo:hi], head_major(q[hub:hub + 1]),
                head_major(k), head_major(v))
    kw = dict(scale=HEAD_DIM ** -0.5, bias=adj.vals[lo:hi])
    _, m, l = fa.fused_sparse_attention(*hub_args, **kw)
    hub_fwd = cuda_ms(lambda: fa.fused_sparse_attention(*hub_args, **kw),
                      3, 1)
    hub_bwd = cuda_ms(lambda: fa.fused_sparse_attention_bwd(
        *hub_args, head_major(cot[hub:hub + 1]), m, l, **kw), 3, 1)
    print(f"attend {name}: forward {fwd_ms:.4f} ms, backward "
          f"{both_ms - fwd_ms:.4f} ms (forward + backward {both_ms:.4f} ms; "
          f"CUDA events, mean of 5); launches {counts}; the longest row "
          f"({hi - lo} nnz) alone: forward {hub_fwd:.4f} ms, backward "
          f"{hub_bwd:.4f} ms", flush=True)
    return {"counts": counts, "fwd_ms": fwd_ms, "bwd_ms": both_ms - fwd_ms,
            "hub": (hi - lo, hub_fwd, hub_bwd)}


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


def sampled_addmm_ms(lib, dz, b, want):
    """``torch.sparse.sampled_addmm`` (cuSPARSE SDDMM) on the same CSR:
    the SDDMM yardstick (``library_ms``), which the port never calls.
    None where it refuses these operands."""
    import torch

    bt = b.t().contiguous()
    try:
        got = torch.sparse.sampled_addmm(lib, dz, bt, beta=0.0)
    except RuntimeError as e:
        print(f"library SDDMM: torch.sparse.sampled_addmm refused: {e}",
              flush=True)
        return None
    print(f"library SDDMM: sampled_addmm agrees with the kernel to "
          f"max_abs_err {float((got.values() - want).abs().max()):.3e}",
          flush=True)
    return cuda_ms(lambda: torch.sparse.sampled_addmm(lib, dz, bt, beta=0.0))


def time_sddmm_and_attention(graphs):
    """Times of SDDMM and the attention kernels, their plain versions and
    the library yardstick, with the bytes and operations of the work:
    SDDMM for one training step on each graph (the gradient in the
    values, at both layers' widths), each attention kernel for one pass
    on each graph."""
    import torch
    from repro_torch.kernels import fused_attention as fa
    from repro_torch.kernels import sddmm

    gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    res = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bytes": 0,
               "flops": 0}
           for k in ("sddmm", "fused_attention_fwd", "fused_attention_bwd")}
    sd, fw, bw = (res[k] for k in res)
    sd["library_ms"] = 0.0
    hd = HEADS * HEAD_DIM
    for name, (adj, _) in graphs.items():
        dev, n, nnz = adj.device, adj.shape[0], adj.nnz
        coo = adj.tocoo()
        lib = library_csr(adj)
        for width in (HIDDEN, N_CLASS):
            dz, b = (torch.randn(n, width, generator=gen).to(dev)
                     for _ in range(2))
            sd["ms"] += cuda_ms(lambda: sddmm.sddmm(coo.rows, coo.cols, dz,
                                                    b))
            sd["plain_ms"] += cuda_ms(lambda: sddmm.sddmm_plain(
                coo.rows, coo.cols, dz, b), 3, 1)
            lib_ms = sampled_addmm_ms(lib, dz, b, sddmm.sddmm(
                coo.rows, coo.cols, dz, b))
            sd["library_ms"] = (None if lib_ms is None
                                or sd["library_ms"] is None
                                else sd["library_ms"] + lib_ms)
            sd["bytes"] += nnz * 12 + 2 * n * width * 4
            sd["flops"] += 2 * nnz * width
        del dz, b
        q, k, v, do = (head_major(t) for t in attention_operands(adj, gen,
                                                                  dev))
        kw = dict(scale=HEAD_DIM ** -0.5, bias=adj.vals)
        args = (adj.indptr, adj.indices, q, k, v)
        _, m, l = fa.fused_sparse_attention(*args, **kw)
        fw["ms"] += cuda_ms(lambda: fa.fused_sparse_attention(*args, **kw),
                            5, 1)
        fw["plain_ms"] += cuda_ms(
            lambda: fa.fused_sparse_attention_plain(*args, **kw), 2, 1)
        # indptr, cols, bias; q, k, v; out; m and l
        fw["bytes"] += ((n + 1) * 4 + nnz * 8 + 4 * n * hd * 4
                       + 2 * HEADS * n * 4)
        fw["flops"] += 4 * HEADS * nnz * HEAD_DIM
        bw["ms"] += cuda_ms(lambda: fa.fused_sparse_attention_bwd(
            *args, do, m, l, **kw), 5, 1)
        bw["plain_ms"] += cuda_ms(lambda: fa.fused_sparse_attention_bwd_plain(
            *args, do, m, l, **kw), 2, 1)
        # indptr, cols, bias; q, k, v, dout; m, l; dq, dk, dv
        bw["bytes"] += ((n + 1) * 4 + nnz * 8 + 7 * n * hd * 4
                       + 2 * HEADS * n * 4)
        bw["flops"] += 10 * HEADS * nnz * HEAD_DIM
        del q, k, v, do, m, l
        torch.cuda.empty_cache()
    return res


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import Schedule
        from repro_torch.kernels import (
            build,
            common,
            fused_attention,
            sddmm,
            spmm_eb,
            spmm_rb,
        )
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

    with torch.no_grad():
        worst = check_kernels(graphs, x, social_model, dev)
        worst.update(check_sddmm_and_attention(graphs, x, social_model, dev))

    counters = {"spmm_eb": spmm_eb.KERNEL, "spmm_rb": spmm_rb.KERNEL,
                "epilogue": common.EPILOGUE_KERNEL, "sddmm": sddmm.KERNEL,
                "fused_attention_fwd": fused_attention.FWD_KERNEL,
                "fused_attention_bwd": fused_attention.BWD_KERNEL}
    runs, expected = [], []  # each path's counts; the kernels it must use
    with torch.no_grad():  # serving
        for name, model in (("social", social_model),
                            ("roadnet", road_model)):
            runs.append(serve(name, model, graphs[name][0], x, counters)[1])
            expected.append((f"serve {name}",
                             ("spmm_eb", "epilogue") if name == "social"
                             else ("spmm_rb",)))
    trained = {}
    for name, (adj, sched) in graphs.items():
        trained[name] = train(name, adj, sched, x, counters)
        runs.append(trained[name]["counts"])
        expected.append((f"train {name}",
                         ("spmm_eb", "epilogue", "sddmm")
                         if name == "social"
                         else ("spmm_rb", "spmm_eb", "sddmm")))
    runs.append(differentiate(graphs["social"][0], counters))
    expected.append(("make_spmm social", ("spmm_eb", "sddmm")))
    attended = {}
    for name, (adj, _) in graphs.items():
        attended[name] = attend(name, adj, counters)
        runs.append(attended[name]["counts"])
        expected.append((f"attend {name}",
                         ("fused_attention_fwd", "fused_attention_bwd")))
    for (path, kernels), counts in zip(expected, runs):
        for n in kernels:
            if counts[n] == 0:
                fail(f"the {n} kernel was not launched on the {path} path")
    launches = {n: sum(c[n] for c in runs) for n in counters}

    with torch.no_grad():
        fwd_ms = {name: cuda_ms(lambda m=m, a=graphs[name][0]: m(a, x), 5)
                  for name, m in (("social", social_model),
                                  ("roadnet", road_model))}
        results, dense_ms = time_kernels(graphs, social_model, road_model, x)
    results.update(time_sddmm_and_attention(graphs))
    parts = {"social": results["spmm_eb"]["ms"] + results["epilogue"]["ms"],
             "roadnet": results["spmm_rb"]["ms"]}
    for name in graphs:
        print(f"forward {name}: {fwd_ms[name]:.4f} ms (CUDA events, mean "
              f"of 5 after warm-up) = sparse kernels {parts[name]:.4f} + "
              f"dense products {dense_ms[name]:.4f} + the rest "
              f"{fwd_ms[name] - parts[name] - dense_ms[name]:.4f}",
              flush=True)
    for name in graphs:
        t = trained[name]
        per_step = {n: c / TRAIN_STEPS for n, c in t["counts"].items() if c}
        print(f"training step {name}: {t['step_ms']:.4f} ms; per kernel ms "
              + ", ".join(f"{k} {v:.4f}"
                          for k, v in sorted(t["kernel_ms"].items()))
              + f"; launches per step {per_step}", flush=True)

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
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
        print(f"kernel {name}: {r['ms']:.4f} ms (bound {bound_ms:.4f} ms "
              f"by {bound_by}, {r['bytes']} bytes, {r['flops']} "
              f"operations), plain {r['plain_ms']:.4f} ms, library {lib} "
              f"ms, launches {launches[name]}", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
