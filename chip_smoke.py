#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into the
git-ignored ``_build`` directory beside them) and holds each kernel
against its plain PyTorch version on the card: EB and RB SpMM with their
fused epilogue (EB and RB per output element within K_TERMS units of
2^-24 of the terms entering it; EB's carry rows against
``eb_carry_plan`` and two launches bit for bit), SDDMM, fused sparse
attention forward and backward (both walk rows longer than a chunk,
``FWD_CHUNK`` and ``BWD_CHUNK``, in chunks: the split rows' forward out
and backward dQ bit for bit over two launches, the forward also against
its chunk walk's plain version), and
segment reduce (on four profiles: the social graph's row statistics,
batched and hidden graph readout, and G-aligned ``parallel``; max and
min bit for bit, add the same bits over two launches on these ids in
order; the social hub row alone, and shuffled ids on the atomic path).  Then it drives the paths of the port on a
power-law "social" graph (``Schedule.auto`` -> the EB kernel) and a
near-regular "roadnet" graph (``RB+PR`` -> the RB kernel), both at
169,343 nodes as in ogbn-arxiv, with random weights from a seed:

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
  plain path;
- the fusion planner: ``gcn_two_layer`` with the served GCN's weights in
  2 planned launches, three requests, against the GCN's forward and the
  unfused plain composition (``run_chain_ref``);
- graph readout: the same chain ending in ``segment_reduce`` (mean and
  max over segments of 26 nodes) in 3 planned launches, three requests,
  against ``run_chain_ref``;
- MoE serving (``moe_serve``): Qwen3-MoE-235B-A22B at full width (d_model
  4096, 64 heads over 4 kv heads, 128 experts top-8, expert width 1536,
  vocab 151,936, bf16), cut to 4 layers, random weights from seed 0 made
  on the card; the grouped-matmul kernel held against its plain version
  at layer 0's decode (tile 4) and prefill (tile 10) shapes, each on the
  tensor-core route (``mma``, printed with the case), prefill and
  decode logits against the einsum path (``moe_kernel_dispatch=False``),
  and ``ServeEngine`` (4 slots) serving 8 requests of 128-token prompts,
  16 greedy tokens each, with 12 grouped-matmul launches a decode step
  and a prefill, every one on the tensor-core route.

It prints kernel, forward, training-step, attention, readout, prefill and
decode times, EB, RB and ``torch.sparse.mm`` at N = 64 and 128 on both
graphs, the launch counts of each path, a ``{"kernels": [...]}``
line and, as its last line, ``{"ok": true, "device": {...}}``.  Any
failed phase exits non-zero without that line; so does a machine without
CUDA.
"""
import json
import math
import subprocess
import sys
import time
import types
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
#: bf16 dense tensor-core peak (NVIDIA data sheet): the operation bound of
#: a product of bf16 operands.
BF16_FLOP_PER_S = 989e12
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
#: EB and RB against their plain versions, per output element: both sum
#: the same f32 terms in other orders, and the fused epilogue's expf and
#: tanhf differ from torch's by an ulp or two, so each output may differ
#: by K_TERMS units of 2^-24 of the magnitude of everything entering it
#: (the sum of |val * B| over its terms, |bias|, |residual| and itself);
#: a bf16 output one bf16 step more.  A fixed atol cannot hold a row whose
#: terms cancel (it struck twice under atomics).  On the H100 the observed
#: k (printed per case) stayed at or below 4.66 over every EB and RB case
#: here; 16 leaves a margin of 3.4.
K_TERMS = 16
TRAIN_STEPS = 5
LR = 0.5
#: Graph attention: HEADS x HEAD_DIM = 256, the GCN's hidden width.
HEADS, HEAD_DIM = 4, 64
#: Graph readout: the nodes pooled in contiguous segments of 26, the mean
#: graph size of OGB's ogbg-molpcba (a batch of graphs is a node range).
READOUT_SIZE = 26
#: MoE serving: the configuration, its depth cut, and the traffic.
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 4
MOE_SLOTS, MOE_MAX_LEN = 4, 160
MOE_REQUESTS, MOE_PROMPT, MOE_NEW = 8, 128, 16
#: Logits of the kernel path against the einsum path, relative L2 error.
#: Both compute the same function but round to bf16 in other places: the
#: einsum path rounds each expert projection and the SiLU product to bf16,
#: the kernel path keeps them in f32 until h is cast, as in the
#: reference's two paths.  On the CPU, at d_model 512 and 2048 with 4
#: layers, the two differ by 0.8 to 1.3 % of the logits' norm, flat in the
#: width; 2^-5 leaves a margin of 2.5x, where a routing or indexing fault
#: moves the logits by tens of percent.
LOGIT_REL_L2 = 2.0 ** -5
#: Where each kernel came from: its source and the TPU kernel it replaces.
KERNEL_META = {
    "spmm_eb": ("src/repro_torch/kernels/csrc/spmm_eb.cu",
                "src/repro/kernels/spmm_eb.py:102"),
    "spmm_rb": ("src/repro_torch/kernels/csrc/spmm_rb.cu",
                "src/repro/kernels/spmm_rb.py:69"),
    # the epilogue is fused into EB's stores; this row is EB's finishing
    # launch, which applies it to the rows that cross chunks
    "epilogue": ("src/repro_torch/kernels/csrc/spmm_eb.cu",
                 "src/repro/kernels/common.py:215"),
    "sddmm": ("src/repro_torch/kernels/csrc/sddmm.cu",
              "src/repro/kernels/sddmm.py:55"),
    "fused_attention_fwd": (
        "src/repro_torch/kernels/csrc/fused_attention_fwd.cu",
        "src/repro/kernels/fused_attention.py:225"),
    "fused_attention_bwd": (
        "src/repro_torch/kernels/csrc/fused_attention_bwd.cu",
        "src/repro/kernels/fused_attention.py:373"),
    "segment_reduce": ("src/repro_torch/kernels/csrc/segment_reduce.cu",
                       "src/repro/kernels/segment_reduce.py:50"),
    "grouped_matmul": ("src/repro_torch/kernels/csrc/grouped_matmul.cu",
                       "src/repro/kernels/grouped_matmul.py:79"),
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


def cuda_ms_median(fn, window_ms: float = 5.0, windows: int = 5) -> float:
    """Median over ``windows`` CUDA-event windows of the mean time of
    ``fn``, each window holding enough calls to fill about ``window_ms``
    (at least 10): steadier than ``cuda_ms`` for kernels of tens of
    microseconds."""
    import statistics

    iters = max(10, math.ceil(window_ms / max(cuda_ms(fn), 1e-3)))
    return statistics.median(cuda_ms(fn, iters, 0) for _ in range(windows))


def device_ms(fn, calls: int = 20) -> dict:
    """Device ms per call of each kernel ``fn`` launches (fills
    included), by kernel name, from ``torch.profiler``'s CUDA activity
    over ``calls`` calls after two warm-up calls.  Unlike a CUDA-event
    window, it leaves out the device's idle time while the host prepares
    the next launch, which bounds calls of a few tens of microseconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                out[e.key] = out.get(e.key, 0.0) + (
                    e.self_device_time_total / 1e3 / calls)
        if sum(out.values()) > 0:
            return out
    fail("torch.profiler recorded no kernel in three tries")


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


def compare_bits(got, want):
    """(max |got - want| over the non-NaN values, tolerance text, equal bit
    for bit): NaN where the plain result has NaN, every other value with
    its bits.  max and min order -0.0 below +0.0, so their order of
    reduction does not matter."""
    import torch

    g, w = got.detach(), want.detach()
    if g.shape != w.shape or g.dtype != w.dtype:
        return float("inf"), "same bits", False
    nan = torch.isnan(w)
    keep = ~nan
    same = bool(torch.equal(torch.isnan(g), nan)) and bool(torch.equal(
        g[keep].view(torch.int32), w[keep].view(torch.int32)))
    gk, wk = g[keep], w[keep]
    diff = torch.where(gk == wk, 0.0, (gk - wk).abs()).nan_to_num(
        nan=float("inf"))
    err = float(diff.max()) if diff.numel() else 0.0
    return err, "same bits", same


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

    def record(self, kernel, label, got, want, per_element=False,
               exact=False):
        err, tol, ok = (compare_bits(got, want) if exact
                        else compare(got, want, per_element))
        self.worst[kernel] = max(self.worst[kernel], err)
        print(f"  {kernel:19s} {label:48s} max_abs_err {err:.3e} "
              f"tol {tol} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failures.append(f"{kernel} {label}")

    def record_terms(self, kernel, label, got, want, terms):
        """Hold ``got`` to ``want`` per element within K_TERMS units of
        2^-24 of ``terms + |want|`` (one bf16 step more for bf16); print
        the observed k, the largest error in those units."""
        import torch

        g, w = got.detach().float(), want.detach().float()
        if g.shape != w.shape or got.dtype != want.dtype or not bool(
                torch.isfinite(g).all()):
            err, k_obs, ok = float("inf"), float("inf"), False
        else:
            unit = 2.0 ** -24 * (terms + w.abs())
            slack = (2.0 ** -7 * w.abs() if got.dtype == torch.bfloat16
                     else torch.zeros_like(w))
            diff = (g - w).abs()
            err = float(diff.max())
            k_obs = float(((diff - slack).clamp_min(0) / unit.clamp_min(
                1e-30)).max())
            ok = bool((diff <= K_TERMS * unit + slack).all())
        self.worst[kernel] = max(self.worst[kernel], err)
        print(f"  {kernel:19s} {label:48s} max_abs_err {err:.3e} k "
              f"{k_obs:.3f} (tol K_TERMS {K_TERMS} x 2^-24 x terms"
              f"{' + 2^-7|ref|' if got.dtype == torch.bfloat16 else ''}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
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
            self.events.append((kernel.name, start, end))

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


def terms_of(plain, *args, bias=None, residual=None, **kw):
    """Per output, the sum of the magnitudes of the terms entering it: the
    plain version on |values| and |B|, plus |bias| and |residual|."""
    t = plain(*[a.abs() if a.is_floating_point() else a for a in args],
              **kw)
    if bias is not None:
        t = t + bias.abs()
    if residual is not None:
        t = t + residual.abs()
    return t


def check_kernels(graphs, x, model, dev):
    """Each kernel's wrapper against its plain version on the same
    inputs; returns the worst error per kernel.  EB on the social graph
    (its three hub rows of 169,343 nnz cross hundreds of the kernel's
    chunks) under every strategy, with and without heavy tiles, at N =
    256, 40 and 33, the fused epilogue's variants (kernel ``epilogue``,
    EB's finishing launch), the carry rows the kernel writes against
    ``eb_carry_plan`` and two launches bit for bit; RB on the roadnet
    graph at N = 256, 40 and 33 with the same variants."""
    import torch
    from repro_torch.core import Epilogue, Schedule
    from repro_torch.kernels import spmm_eb, spmm_rb
    from repro_torch.sparse import matrix_stats

    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    checker = Checker(("spmm_eb", "spmm_rb", "epilogue"))
    record, failures = checker.record_terms, checker.failures

    b1 = (x @ model.w1).contiguous()
    rand = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    bias = rand(HIDDEN)
    n = x.shape[0]
    res = rand(n, HIDDEN)
    b2 = rand(n, N_CLASS)
    b33 = b1[:, :33].contiguous()
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
        "bias+relu bf16": (Epilogue("relu", bias=True, out_dtype="bfloat16"),
                           {"bias": bias}),
    }

    def eb_record(kernel, label, g, b, kw, ops=None):
        ops = ops or {}
        got = spmm_eb.spmm_eb(g.rows, g.cols, g.vals, b, **kw, **ops)
        want = spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b, **kw, **ops)
        plain_kw = {k: v for k, v in kw.items() if k != "epilogue"}
        record(kernel, label, got, want,
               terms_of(spmm_eb.spmm_eb_plain, g.rows, g.cols, g.vals, b,
                        **plain_kw, **ops))
        return got

    adj, _ = graphs["social"]
    stats = matrix_stats(adj)
    print("check: EB (spmm_eb) on the social graph", flush=True)
    eb_cases = []
    for G in (8, 32):
        for strat in ("segment", "accumulate"):
            eb_cases.append((Schedule("eb", nnz_tile=128, group_size=G,
                                      strategy=strat), f"G={G} {strat}"))
    # parallel over the standard layout: the kernel's group-to-first-lane
    # attribution on groups that span rows (Schedule refuses it, the
    # kernel takes it)
    eb_cases.append((types.SimpleNamespace(
        nnz_tile=128, group_size=8, strategy="parallel", is_skew=False,
        split_threshold=None, merge_threshold=None), "G=8 parallel"))
    split = max(64, stats["row_quantiles"][-1][1])
    for strat, merge in (("segment", 2), ("segment", 0), ("parallel", 0),
                         ("accumulate", 0)):
        eb_cases.append((Schedule("eb", nnz_tile=128, group_size=8,
                                  strategy=strat, split_threshold=split,
                                  merge_threshold=merge),
                         f"skew split>={split} merge<={merge} {strat}"))
    for sched, label in eb_cases:
        g = adj.grouped(sched.nnz_tile, group_size=sched.group_size,
                        split_threshold=sched.split_threshold,
                        merge_threshold=sched.merge_threshold)
        kw = dict(n_rows=n, nnz_tile=sched.nnz_tile,
                  group_size=sched.group_size, strategy=sched.strategy,
                  heavy_tiles=g.heavy_tiles)
        if sched.is_skew and g.heavy_tiles == 0:
            failures.append(f"{label}: layout has no heavy tiles")
        walk = ("carry" if spmm_eb.rows_sorted(g.rows, n) else "atomic")
        eb_record("spmm_eb", f"{label} heavy_tiles={g.heavy_tiles} "
                  f"{walk} N={HIDDEN}", g, b1, kw)
    auto1 = Schedule.auto(stats, HIDDEN)
    auto2 = Schedule.auto(stats, N_CLASS)
    g = adj.grouped(auto1.nnz_tile)
    for vname, (ep, ops) in variants.items():
        kw = dict(n_rows=n, nnz_tile=auto1.nnz_tile,
                  group_size=auto1.group_size, strategy=auto1.strategy,
                  epilogue=ep)
        eb_record("spmm_eb" if ep.is_noop else "epilogue",
                  f"auto {vname} N={HIDDEN}", g, b1, kw, ops)
    g2 = adj.grouped(auto2.nnz_tile)
    for b, vname in ((b2, "none"), (b2, "bias+relu bf16"), (b33, "none"),
                     (b33, "bias+gelu+residual")):
        ep, ops = variants[vname]
        w = b.shape[1]
        ops = {k: (v[:w] if k == "bias" else v[:, :w].contiguous())
               for k, v in ops.items()}
        kw = dict(n_rows=n, nnz_tile=auto2.nnz_tile,
                  group_size=auto2.group_size, strategy=auto2.strategy,
                  epilogue=ep)
        eb_record("spmm_eb" if ep.is_noop else "epilogue",
                  f"auto {vname} N={w}", g2, b, kw, ops)

    print("check: EB's carry walk (rows crossing chunks) and determinism",
          flush=True)
    for sched, b, ep, ops in ((auto1, b1, *variants["bias+relu"]),
                              (auto2, b2, *variants["none"])):
        g = adj.grouped(sched.nnz_tile)
        kw = dict(n_rows=n, nnz_tile=sched.nnz_tile,
                  group_size=sched.group_size, strategy=sched.strategy,
                  heavy_tiles=0, epilogue=ep, **ops)
        kw = {"bias": None, "residual": None, **kw}
        out1, carry, chunk = spmm_eb._launch(g.rows, g.cols, g.vals, b,
                                             **kw)
        out2, _, _ = spmm_eb._launch(g.rows, g.cols, g.vals, b, **kw)
        plan = spmm_eb.eb_carry_plan(g.rows, chunk=chunk,
                                     group_size=sched.group_size,
                                     strategy=sched.strategy,
                                     nnz_tile=sched.nnz_tile)
        same_plan = bool(torch.equal(carry, plan))
        same_bits = bool(torch.equal(out1, out2))
        heads = int((plan[1::2] >= 0).sum())
        cont = int((plan[0::2] >= 0).sum())
        print(f"  N={b.shape[1]}: chunks of {chunk} lanes, "
              f"{plan.numel() // 2} workers; {heads} rows cross chunks, "
              f"{cont} continuation carries; carry rows equal "
              f"eb_carry_plan: {same_plan}; two launches bit for bit: "
              f"{same_bits}", flush=True)
        if not (same_plan and same_bits):
            failures.append(f"EB carry walk N={b.shape[1]}")
        del out1, out2

    adj, rb_sched = graphs["roadnet"]
    print("check: RB (spmm_rb) on the roadnet graph", flush=True)

    def rb_record(label, e, row_tile, b, ep, ops):
        kw = dict(n_rows=adj.shape[0], epilogue=ep, **ops)
        record("spmm_rb", label,
               spmm_rb.spmm_rb(e.cols, e.vals, b, row_tile=row_tile,
                               col_tile=rb_sched.col_tile, **kw),
               spmm_rb.spmm_rb_plain(e.cols, e.vals, b, **kw),
               terms_of(spmm_rb.spmm_rb_plain, e.cols, e.vals, b,
                        n_rows=adj.shape[0], **ops))

    for row_tile in (8, 32):
        e = adj.ell(row_tile=row_tile)
        for vname, (ep, ops) in variants.items():
            rb_record(f"row_tile={row_tile} W={e.width} {vname} N={HIDDEN}",
                      e, row_tile, b1, ep, ops)
        rb_record(f"row_tile={row_tile} none N={N_CLASS}", e, row_tile, b2,
                  Epilogue(), {})
        rb_record(f"row_tile={row_tile} none N=33", e, row_tile, b33,
                  Epilogue(), {})
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
        plan = fa.attn_row_plan(adj.indptr, fa.FWD_CHUNK)
        if plan.n_split:
            split = plan.split_rows.long()
            chunked = fa.fused_sparse_attention_chunked_plain(
                adj.indptr, adj.indices, q, k, v, chunk=fa.FWD_CHUNK, **kw)
            for label, g, w in zip(("out", "m", "l"), got, chunked):
                checker.record("fused_attention_fwd",
                               f"{name} {label} against the chunk walk", g,
                               w, per_element=label != "out")
            del chunked
            again = fa.fused_sparse_attention(adj.indptr, adj.indices, q, k,
                                              v, **kw)
            checker.record("fused_attention_fwd",
                           f"{name} out of {plan.n_split} split rows "
                           f"({plan.n_chunks} chunks), 2 launches",
                           again[0][:, split], got[0][:, split], exact=True)
            del again
        m, l = got[1], got[2]
        got = fa.fused_sparse_attention_bwd(adj.indptr, adj.indices, q, k, v,
                                            do, m, l, **kw)
        want = fa.fused_sparse_attention_bwd_plain(
            adj.indptr, adj.indices, q, k, v, do, want[1], want[2], **kw)
        for label, g, w in zip(("dq", "dk", "dv"), got, want):
            checker.record("fused_attention_bwd", f"{name} {label}", g, w)
        plan = fa.attn_row_plan(adj.indptr, fa.BWD_CHUNK)
        split = plan.split_rows.long()
        again = fa.fused_sparse_attention_bwd(adj.indptr, adj.indices, q, k,
                                              v, do, m, l, **kw)
        checker.record("fused_attention_bwd",
                       f"{name} dq of {plan.n_split} split rows "
                       f"({plan.n_chunks} chunks), 2 launches",
                       again[0][:, split], got[0][:, split], exact=True)
        del q, k, v, do, got, want, again
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
    if counts["sddmm"] != 2 * TRAIN_STEPS:
        fail(f"train {name}: expected one SDDMM launch per layer and step "
             f"({2 * TRAIN_STEPS}), got {counts['sddmm']}")

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
    # rows longer than a chunk: the forward walks and merges (2 launches),
    # the backward takes 3
    split = fa.attn_row_plan(adj.indptr, fa.FWD_CHUNK).n_split > 0
    want_counts = (2, 3) if split else (1, 1)
    got_counts = (counts["fused_attention_fwd"],
                  counts["fused_attention_bwd"])
    if got_counts != want_counts:
        fail(f"attend {name}: expected {want_counts} forward and backward "
             f"launches, got {got_counts}")
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
    # the longest row alone: the warps of both walk a chunk each (the plan
    # of its one-row pattern is built by the first call, before timing)
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


def bound(nbytes: int, flops: int, flop_per_s: float = F32_FLOP_PER_S):
    """(least ms, what bounds it): bytes at the HBM rate or operations at
    the peak rate of their type (f32 unless given), whichever takes
    longer."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / flop_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def launch_ms(fn, reps: int = 10) -> dict:
    """Mean device ms per call of each kernel ``fn`` launches, from CUDA
    events around every launch (``LaunchTimer``), after two warm-up
    calls."""
    for _ in range(2):
        fn()
    with LaunchTimer() as timer:
        for _ in range(reps):
            fn()
    return {k: v / reps for k, v in timer.ms().items()}


def time_kernels(graphs, social_model, road_model, x):
    """Per-forward times of each kernel, its plain version and the
    library yardstick at the serving shapes (layer 1 with its bias and
    relu, as served), with the bytes and operations of that work; the
    gathers each SpMM requests (nnz x N x 4 bytes); and the dense
    products' time per graph.  EB's kernel and its finishing launch
    (row ``epilogue``) are timed apart, launch by launch."""
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
                "flops": 0, "gather_bytes": 0}

    relu_bias = Epilogue("relu", bias=True)
    results, dense_ms = {}, {}
    # EB: layer 1 (N=256, bias + relu) and layer 2 (N=40) on the social
    # graph
    adj = graphs["social"][0]
    st = matrix_stats(adj)
    n = adj.shape[0]
    b1, b2, h = layer_inputs(social_model, adj)
    dense_ms["social"] = (cuda_ms(lambda: x @ social_model.w1)
                          + cuda_ms(lambda: h @ social_model.w2))
    lib_csr = library_csr(adj)
    eb = results["spmm_eb"] = zero()
    fin = results["epilogue"] = zero()
    fin["library_ms"] = None
    for b, ep, ops in ((b1, relu_bias, {"bias": social_model.b1}),
                       (b2, Epilogue(), {})):
        s = Schedule.auto(st, b.shape[1])
        g = adj.grouped(s.nnz_tile)
        kw = dict(n_rows=n, nnz_tile=s.nnz_tile, group_size=s.group_size,
                  strategy=s.strategy, epilogue=ep, **ops)
        split = launch_ms(lambda: spmm_eb.spmm_eb(g.rows, g.cols, g.vals, b,
                                                  **kw))
        total = cuda_ms(lambda: spmm_eb.spmm_eb(g.rows, g.cols, g.vals, b,
                                                **kw))
        eb["ms"] += split["spmm_eb"]
        fin["ms"] += split["spmm_eb_finish"]
        eb["plain_ms"] += cuda_ms(lambda: spmm_eb.spmm_eb_plain(
            g.rows, g.cols, g.vals, b, **kw), 3, 1)
        lib = cuda_ms(lambda: torch.sparse.mm(lib_csr, b))
        eb["library_ms"] += lib
        w = b.shape[1]
        eb["bytes"] += (g.nnz_padded * 12 + b.numel() * 4 + n * w * 4
                        + (w * 4 if ep.bias else 0))
        eb["flops"] += 2 * adj.nnz * w
        eb["gather_bytes"] += adj.nnz * w * 4
        plan = spmm_eb.eb_carry_plan(
            g.rows, chunk=spmm_eb.eb_geometry(g.nnz_padded, s.nnz_tile, w,
                                              4)[2],
            group_size=s.group_size, strategy=s.strategy,
            nnz_tile=s.nnz_tile)
        carries, heads = int((plan >= 0).sum()), int((plan[1::2] >= 0).sum())
        # the finish reads the carry rows and carries, writes each crossing
        # row once (with bias, the epilogue's operand)
        fin["bytes"] += (plan.numel() * 4 + carries * w * 4 + heads * w * 4
                         + (w * 4 if ep.bias else 0))
        fin["flops"] += carries * w + (2 * heads * w if not ep.is_noop
                                       else 0)
        print(f"EB social N={w} ({s}): kernel {split['spmm_eb']:.4f} ms + "
              f"finish {split['spmm_eb_finish']:.4f} ms (launch by launch); "
              f"the wrapper {total:.4f} ms; torch.sparse.mm {lib:.4f} ms; "
              f"{heads} rows cross chunks, {carries} carries; gathers "
              f"requested {adj.nnz * w * 4} bytes", flush=True)
    # the plain epilogue the fused one replaces, on layer 1's accumulator
    s = Schedule.auto(st, HIDDEN)
    g = adj.grouped(s.nnz_tile)
    acc = spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b1, n_rows=n,
                                nnz_tile=s.nnz_tile, group_size=s.group_size)
    fin["plain_ms"] = cuda_ms(lambda: common.apply_epilogue_plain(
        acc, relu_bias, bias=social_model.b1))
    del acc
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
        rb["gather_bytes"] += adj.nnz * b.shape[1] * 4
    return results, dense_ms


def time_widths(graphs):
    """EB, RB and ``torch.sparse.mm`` at the widths between the serving
    ones, N = 64 and 128, on both graphs (CUDA events, mean of 10): EB
    under ``Schedule.auto``'s EB choice on the social graph and an EB
    schedule (nnz_tile 128, G 32, segment) on the roadnet graph; RB on
    the roadnet graph only, as the social graph's ELL would be 169,343
    slots wide."""
    import torch
    from repro_torch.core import Schedule
    from repro_torch.kernels import spmm_eb, spmm_rb
    from repro_torch.sparse import matrix_stats

    gen = torch.Generator().manual_seed(SEED + 9)
    out = {}
    for name, (adj, sched) in graphs.items():
        n = adj.shape[0]
        lib_csr = library_csr(adj)
        for w in (64, 128):
            b = torch.randn(n, w, generator=gen).to(adj.device)
            s = (Schedule.auto(matrix_stats(adj), w) if name == "social"
                 else Schedule("eb", nnz_tile=128, group_size=32))
            g = adj.grouped(s.nnz_tile)
            kw = dict(n_rows=n, nnz_tile=s.nnz_tile,
                      group_size=s.group_size, strategy=s.strategy)
            row = {"spmm_eb": cuda_ms(lambda: spmm_eb.spmm_eb(
                g.rows, g.cols, g.vals, b, **kw)),
                "torch.sparse.mm": cuda_ms(
                    lambda: torch.sparse.mm(lib_csr, b))}
            if name == "roadnet":
                e = adj.ell(row_tile=sched.row_tile)
                row["spmm_rb"] = cuda_ms(lambda: spmm_rb.spmm_rb(
                    e.cols, e.vals, b, n_rows=n))
            out[(name, w)] = row
            print(f"width sweep {name} N={w}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in row.items())
                + f" (EB schedule {s})", flush=True)
        del lib_csr
    return out


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
               "flops": 0, "gather_bytes": 0}
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
            ms = cuda_ms(lambda: sddmm.sddmm(coo.rows, coo.cols, dz, b))
            sd["ms"] += ms
            sd["plain_ms"] += cuda_ms(lambda: sddmm.sddmm_plain(
                coo.rows, coo.cols, dz, b), 3, 1)
            lib_ms = sampled_addmm_ms(lib, dz, b, sddmm.sddmm(
                coo.rows, coo.cols, dz, b))
            sd["library_ms"] = (None if lib_ms is None
                                or sd["library_ms"] is None
                                else sd["library_ms"] + lib_ms)
            nbytes = nnz * 12 + 2 * n * width * 4
            sd["bytes"] += nbytes
            sd["flops"] += 2 * nnz * width
            sd["gather_bytes"] += nnz * width * 4  # B's rows, by column
            g = sddmm.sddmm_geometry(width, True)
            print(f"SDDMM {name} width {width}: {ms:.4f} ms (bound "
                  f"{bound(nbytes, 2 * nnz * width)[0]:.4f} ms; gathers "
                  f"of B requested {nnz * width * 4} bytes; workers of "
                  f"{g.lw} lanes, {g.workers} a warp)", flush=True)
        del dz, b
        q, k, v, do = (head_major(t) for t in attention_operands(adj, gen,
                                                                  dev))
        kw = dict(scale=HEAD_DIM ** -0.5, bias=adj.vals)
        args = (adj.indptr, adj.indices, q, k, v)
        _, m, l = fa.fused_sparse_attention(*args, **kw)
        ms = cuda_ms(lambda: fa.fused_sparse_attention(*args, **kw), 5, 1)
        fw["ms"] += ms
        fw["plain_ms"] += cuda_ms(
            lambda: fa.fused_sparse_attention_plain(*args, **kw), 2, 1)
        # indptr, cols, bias; q, k, v; out; m and l
        nbytes = ((n + 1) * 4 + nnz * 8 + 4 * n * hd * 4
                  + 2 * HEADS * n * 4)
        fw["bytes"] += nbytes
        fw["flops"] += 4 * HEADS * nnz * HEAD_DIM
        # the K and V rows each nonzero requests, per head
        fw["gather_bytes"] += nnz * HEADS * 2 * HEAD_DIM * 4
        plan = fa.attn_row_plan(adj.indptr, fa.FWD_CHUNK)
        print(f"attention forward {name}: {ms:.4f} ms (bound "
              f"{bound(nbytes, 4 * HEADS * nnz * HEAD_DIM)[0]:.4f} ms; "
              f"gathers of K and V requested "
              f"{nnz * HEADS * 2 * HEAD_DIM * 4} bytes; {plan.n_split} "
              f"split rows in {plan.n_chunks} chunks)", flush=True)
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


def segment_profiles(graphs, x, model):
    """The segment-reduce kernel's four input profiles, each ``(label,
    seg ids, data, num_segments, cases)`` with ``cases`` the (strategy,
    op) pairs held and timed on it:

    - row statistics: the social graph's row ids over its nnz, data
      (nnz, HEADS) per-head scores, ops max and add: the per-row pass of
      unfused attention (``benchmarks/beyond.py``); the hub row is one
      segment of 169,343 lanes;
    - batched readout: ids ``arange(n) // READOUT_SIZE``, data the served
      logits plus the count column (n, 41), as the mean readout runs it;
    - hidden readout: the same ids over layer 1's output (n, 256), ops
      max and min (relu's zeros tie);
    - parallel: ids ``arange(n) // 32``, aligned to G = 32, the one
      profile where ``parallel`` may be held against the dense oracle.
    """
    import torch
    from repro_torch.core import Epilogue
    from repro_torch.sparse import spmm

    adj = graphs["social"][0]
    dev, n = x.device, adj.shape[0]
    gen = torch.Generator().manual_seed(SEED + 7)
    scores = torch.randn(adj.nnz, HEADS, generator=gen).to(dev)
    hidden = spmm(adj, x @ model.w1, bias=model.b1,
                  epilogue=Epilogue("relu"), impl="ref", device=dev)
    logits = spmm(adj, hidden @ model.w2, impl="ref", device=dev)
    readout = torch.cat([logits, torch.ones(n, 1, device=dev)], 1)
    nodes = torch.arange(n, device=dev)
    pooled = (nodes // READOUT_SIZE).to(torch.int32)
    aligned = (nodes // 32).to(torch.int32)
    n_pool = -(-n // READOUT_SIZE)
    return [
        ("row statistics", adj.tocoo().rows, scores, n,
         (("segment", "max"), ("segment", "add"), ("accumulate", "max"))),
        ("batched readout", pooled, readout, n_pool,
         (("segment", "add"), ("accumulate", "add"))),
        ("hidden readout", pooled, hidden, n_pool,
         (("segment", "max"), ("segment", "min"))),
        ("parallel", aligned, readout, -(-n // 32),
         (("parallel", "add"), ("parallel", "max"))),
    ]


def hub_row(adj, scores):
    """The social graph's longest row as a stream of its own: (one
    segment's ids, its lanes' score rows)."""
    import torch

    lengths = (adj.indptr[1:] - adj.indptr[:-1]).long()
    hub = int(lengths.argmax())
    lo, hi = int(adj.indptr[hub]), int(adj.indptr[hub + 1])
    return (torch.zeros(hi - lo, dtype=torch.int32, device=scores.device),
            scores[lo:hi])


def check_segment_reduce(profiles, adj):
    """The segment-reduce kernel against its plain version on every
    profile and case, each output over NaN-poisoned memory (a NaN-filled
    tensor of its size freed just before the call, so a segment the walk
    never writes shows): max and min bit for bit, sums at F32_TOL of the
    largest magnitude and, on these ids in order, the same bits over two
    launches; ``parallel`` on its aligned ids against the dense oracle
    too.  The walk's carry segments on the row statistics against
    ``carry_plan``.  Then the social hub row alone (one segment over
    every chunk) under add and max, and the row-statistics profile with
    its ids shuffled under ``accumulate`` (the atomic path: no finishing
    launch).  Returns the worst error."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.kernels.common import carry_plan

    def call(seg, data, **kw):
        poison = torch.full((kw["num_segments"], data.shape[1]),
                            float("nan"), device=data.device)
        del poison
        return sr.segment_reduce(seg, data, **kw)

    checker = Checker(("segment_reduce",))
    for label, seg, data, n_seg, cases in profiles:
        print(f"check: segment_reduce, {label}: {seg.numel()} lanes x "
              f"{data.shape[1]} -> {n_seg} segments", flush=True)
        for strategy, op in cases:
            kw = dict(num_segments=n_seg, strategy=strategy, op=op)
            got = call(seg, data, **kw)
            checker.record("segment_reduce", f"{label} {strategy} {op}", got,
                           sr.segment_reduce_plain(seg, data, **kw),
                           exact=op != "add")
            if op == "add":
                checker.record("segment_reduce",
                               f"{label} {strategy} {op} two launches",
                               got, call(seg, data, **kw), exact=True)
            if strategy == "parallel":
                checker.record(
                    "segment_reduce", f"{label} {strategy} {op} vs oracle",
                    got, ref.segment_reduce_ref(
                        data, seg, n_seg, op="sum" if op == "add" else op),
                    exact=op != "add")
    label, seg, data, n_seg, _ = profiles[0]
    _, rows, chunk = sr._launch(
        seg, data, num_segments=n_seg, group_size=32, strategy="segment",
        op="add", count_column=False, sorted_=True)
    same_plan = bool(torch.equal(rows, carry_plan(seg, chunk).to(
        rows.device)))
    print(f"check: segment_reduce, {label}: the walk's carry segments "
          f"({rows.numel() // 2} chunks of {chunk} lanes, "
          f"{int((rows[1::2] >= 0).sum())} crossing segments) equal "
          f"carry_plan: {same_plan}", flush=True)
    if not same_plan:
        checker.failures.append("segment_reduce carry segments")
    seg, data = hub_row(adj, profiles[0][2])
    print(f"check: segment_reduce, the hub row alone: {seg.numel()} lanes x "
          f"{data.shape[1]} -> 1 segment", flush=True)
    for op in ("add", "max"):
        kw = dict(num_segments=1, op=op)
        checker.record("segment_reduce", f"hub row segment {op}",
                       call(seg, data, **kw),
                       sr.segment_reduce_plain(seg, data, **kw),
                       exact=op != "add")
    label, seg, data, n_seg, _ = profiles[0]
    gen = torch.Generator(device=seg.device).manual_seed(SEED + 8)
    order = torch.randperm(seg.numel(), generator=gen, device=seg.device)
    shuffled = seg[order]
    print(f"check: segment_reduce, {label} with its ids shuffled (the "
          "atomic path)", flush=True)
    for op in ("add", "max"):
        kw = dict(num_segments=n_seg, strategy="accumulate", op=op)
        before = sr.FINISH.launches
        got = sr.segment_reduce(shuffled, data, **kw)
        if sr.FINISH.launches != before:
            fail("segment_reduce: shuffled ids took the carry walk")
        checker.record("segment_reduce", f"{label} shuffled accumulate {op}",
                       got, sr.segment_reduce_plain(shuffled, data, **kw),
                       exact=op != "add")
    return checker.done()


def run_requests(fn, counters):
    """REQUESTS calls of ``fn``, with the launch counts zeroed just before
    and read just after: (outputs, host ms of each, counts, launches per
    request of the kernels that ran)."""
    import torch

    for k in counters.values():
        k.launches = 0
    times, outs = [], []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {n: k.launches for n, k in counters.items()}
    return outs, times, counts, {n: c / REQUESTS for n, c in counts.items()
                                 if c}


def serve_planned(name, model, adj, sched, x, counters, want):
    """REQUESTS forwards of ``gcn_two_layer`` with the served GCN's
    weights, through the fusion planner, with the launch counts zeroed
    just before and read just after; the plan must take 2 launches, the
    CUDA launches per request must be ``want``, and the outputs must
    match the GCN's forward and the unfused plain composition."""
    from repro_torch.fuse import gcn_chain, plan, run_chain_ref
    from repro_torch.models import gcn_two_layer

    weights, biases = (model.w1, model.w2), (model.b1, None)
    chain, params = gcn_chain(adj, weights, biases, schedule=sched)
    n_planned = plan(chain).n_launches

    def request():
        return gcn_two_layer(adj, x, *weights, *biases, schedule=sched,
                             device=x.device)

    outs, times, counts, per_request = run_requests(request, counters)
    ms = cuda_ms(request, 5)
    print(f"planned serve {name}: {n_planned} planned launches; request ms "
          + ", ".join(f"{t:.3f}" for t in times)
          + f"; {ms:.4f} ms (CUDA events, mean of 5); launches per request "
          f"{per_request}", flush=True)
    if n_planned != 2:
        fail(f"planned serve {name}: {n_planned} planned launches, not 2")
    if per_request != want:
        fail(f"planned serve {name}: launches per request {per_request}, "
             f"expected {want}")
    for label, ref_out in (("the GCN forward", model(adj, x)),
                           ("run_chain_ref", run_chain_ref(chain, x,
                                                           params))):
        checks = [compare(out, ref_out) for out in outs]
        for i, (err, tol, ok) in enumerate(checks):
            if not ok:
                fail(f"planned serve {name} request {i}: max_abs_err "
                     f"{err:.3e} above {tol} against {label}")
        print(f"planned serve {name}: outputs (n, {N_CLASS}) match {label} "
              f"within {tol} (max_abs_err "
              f"{max(c[0] for c in checks):.3e})", flush=True)
    return {"counts": counts, "ms": ms}


#: The split reason the reference planner gives at a readout boundary.
READOUT_REASONS = {
    "mean": "consumer 'segment_reduce' reduces over its own iteration "
            "space",
    "max": "consumer monoid 'max' cannot be composed from the producer's "
           "blocked partial outputs",
}


def readout(name, model, adj, sched, x, counters, op, want):
    """Graph readout: the served GCN's chain ending in
    ``segment_reduce(op)`` over segments of READOUT_SIZE nodes, REQUESTS
    runs of its plan with the launch counts zeroed just before and read
    just after.  The plan must take 3 launches, split at the readout for
    the reference's reason; each request launches ``want`` plus one
    segment reduce, whose finishing launch (the segments crossing its
    chunks) must run once a request too.  The output is held against ``run_chain_ref`` and,
    given the same SpMM output, the readout against its plain oracle (bit
    for bit for max)."""
    import torch
    from repro_torch.fuse import (
        gcn_chain,
        plan,
        run_chain_ref,
        run_plan,
        segment_reduce_node,
    )
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_reduce as sr

    dev, n = x.device, adj.shape[0]
    seg = (torch.arange(n, device=dev) // READOUT_SIZE).to(torch.int32)
    n_pool = -(-n // READOUT_SIZE)
    chain, params = gcn_chain(adj, (model.w1, model.w2), (model.b1, None),
                              schedule=sched)
    chain += (segment_reduce_node(op),)
    params += [{"seg_ids": seg, "num_segments": n_pool}]
    p = plan(chain)
    if (p.n_launches, p.decision.fused) != (3, (True, False, False)) or \
            not p.reasons[-1].startswith(READOUT_REASONS[op]):
        fail(f"readout {op} {name}: plan {p.decision.tag}, "
             f"{p.n_launches} launches, last split {p.reasons[-1]!r}")

    def request():
        return run_plan(p, x, params, device=dev)

    sr.FINISH.launches = 0
    outs, times, counts, per_request = run_requests(request, counters)
    finishes = sr.FINISH.launches
    ms = cuda_ms(request, 5)
    busy = sum(device_ms(request, 5).values())
    print(f"readout {op} {name}: {n_pool} segments of {READOUT_SIZE} nodes; "
          f"plan {p.decision.tag}, {p.n_launches} launches; request ms "
          + ", ".join(f"{t:.3f}" for t in times)
          + f"; {ms:.4f} ms (CUDA events, mean of 5), {busy:.4f} ms of it "
          f"on the device; launches per request {per_request}, "
          f"segment-reduce finishing launches {finishes / REQUESTS:g}",
          flush=True)
    if per_request != {**want, "segment_reduce": 1}:
        fail(f"readout {op} {name}: launches per request {per_request}")
    if finishes != REQUESTS:
        fail(f"readout {op} {name}: {finishes} segment-reduce finishing "
             f"launches over {REQUESTS} requests")
    want_out = run_chain_ref(chain, x, params)
    checks = [compare(out, want_out) for out in outs]
    for i, (err, tol, ok) in enumerate(checks):
        if not ok:  # compare() also fails a wrong shape
            fail(f"readout {op} {name} request {i}: max_abs_err {err:.3e} "
                 f"above {tol} against run_chain_ref")
    err = max(c[0] for c in checks)
    h = run_plan(plan(chain[:3]), x, params[:3], device=dev)
    got = run_plan(plan(chain[3:]), h, params[3:], device=dev)
    oracle = ref.segment_reduce_ref(h, seg, n_pool, op=op)
    err2, tol2, ok2 = (compare_bits(got, oracle) if op == "max"
                       else compare(got, oracle))
    print(f"readout {op} {name}: outputs ({n_pool}, {N_CLASS}) match "
          f"run_chain_ref within {tol} (max_abs_err {err:.3e}); on the same "
          f"SpMM output the readout matches its plain oracle: {tol2}, "
          f"max_abs_err {err2:.3e} {'ok' if ok2 else 'FAIL'}", flush=True)
    if not ok2:
        fail(f"readout {op} {name}: the readout disagrees with its plain "
             "oracle on the same SpMM output")
    return {"counts": counts, "ms": ms}


def library_segment_reduce_ms(data, reduce, lengths):
    """``torch.segment_reduce`` over the same rows: the segment-reduce
    yardstick (``library_ms``), which the port never calls, as (device
    ms, call ms) as ``time_segment_reduce`` times the kernel.  None where
    it refuses these operands."""
    import torch

    def call():
        return torch.segment_reduce(data, reduce, lengths=lengths, axis=0)

    try:
        call()
    except RuntimeError as e:
        print(f"library segment reduce: torch.segment_reduce refused: {e}",
              flush=True)
        return None
    return sum(device_ms(call).values()), cuda_ms_median(call)


def time_segment_reduce(profiles, adj):
    """Times of the segment-reduce kernel, its plain version and the
    library yardstick on every profile and case, summed into the kernel's
    row, with the bytes (ids and data read once, the output written once)
    and operations (one per element) of that work; and the social hub row
    alone under 'segment'.  The kernel's and the library's times are
    device times (``device_ms``: the durations of every kernel a call
    launches, the walk and the finishing launch apart): a call takes tens
    of microseconds on the card, and a CUDA-event window of back-to-back
    calls (``cuda_ms_median``, printed beside them as the call's time)
    measures the host's launches as much as the device."""
    import torch
    from repro_torch.kernels import segment_reduce as sr

    row = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
           "flops": 0, "call_ms": 0.0}
    for label, seg, data, n_seg, cases in profiles:
        lengths = torch.bincount(seg.long(), minlength=n_seg)
        t, c = data.shape
        nbytes = t * 4 + t * c * 4 + n_seg * c * 4
        for strategy, op in cases:
            kw = dict(num_segments=n_seg, strategy=strategy, op=op)

            def fn():
                return sr.segment_reduce(seg, data, **kw)

            per_kernel = device_ms(fn)
            ms = sum(per_kernel.values())
            finish = sum(v for k, v in per_kernel.items()
                         if "segred_finish" in k)
            call = cuda_ms_median(fn)
            plain = cuda_ms(lambda: sr.segment_reduce_plain(seg, data, **kw),
                            3, 1)
            lib = library_segment_reduce_ms(data, "sum" if op == "add"
                                            else op, lengths)
            b_ms, by = bound(nbytes, t * c)
            print(f"segment_reduce {label} {strategy} {op} ({t} x {c} -> "
                  f"{n_seg}): {ms:.4f} ms on the device (walk "
                  f"{ms - finish:.4f} + finish {finish:.4f}; bound "
                  f"{b_ms:.4f} ms by {by}), call {call:.4f} ms, plain "
                  f"{plain:.4f} ms, library "
                  + ("null" if lib is None else
                     f"{lib[0]:.4f} ms on the device, call {lib[1]:.4f}")
                  + " ms", flush=True)
            row["ms"] += ms
            row["call_ms"] += call
            row["plain_ms"] += plain
            row["library_ms"] = (None if lib is None or row["library_ms"]
                                 is None else row["library_ms"] + lib[0])
            row["bytes"] += nbytes
            row["flops"] += t * c
    seg, data = hub_row(adj, profiles[0][2])
    hub = {}
    for op in ("max", "add"):
        def fn(op=op):
            return sr.segment_reduce(seg, data, num_segments=1, op=op)

        hub[op] = (sum(device_ms(fn).values()), cuda_ms_median(fn))
    print(f"segment_reduce row statistics: the hub row alone "
          f"({seg.numel()} lanes x {data.shape[1]}, 'segment', one "
          f"segment over every chunk): max {hub['max'][0]:.4f} ms on the "
          f"device (call {hub['max'][1]:.4f}), add {hub['add'][0]:.4f} ms "
          f"(call {hub['add'][1]:.4f}); the nine cases' calls "
          f"{row['call_ms']:.4f} ms", flush=True)
    return row


def moe_model(dev):
    """Qwen3-MoE at full width cut to MOE_LAYERS layers, its parameters
    drawn on the card from seed SEED, and the model API of both MoE paths
    (kernel, einsum) over the same parameters."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config(MOE_ARCH).scaled(n_layers=MOE_LAYERS)
    api = get_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SEED),
                      device=dev)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"moe_serve: {cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.d_head} over {cfg.n_kv_heads} kv, "
          f"{cfg.n_experts} experts top-{cfg.experts_per_token} of width "
          f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype}), "
          f"{cfg.n_layers} of 94 layers; {n_bytes / 1e9:.2f} GB of weights "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    einsum = get_model(cfg.scaled(moe_kernel_dispatch=False))
    return cfg, api, einsum, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def moe_kernel_cases(cfg, params, dev):
    """The grouped-matmul launches of layer 0 at the serving shapes, each
    ``(label, x, tile_experts, weights, epilogue, tile)``: the gate (SiLU
    fused), up and down projections at decode (MOE_SLOTS tokens) and at a
    MOE_PROMPT-token prefill, with the capacity ``models.moe`` gives
    them; x drawn from a seed in bf16."""
    import torch
    from repro_torch.core import Epilogue
    from repro_torch.models.moe import _capacity

    moe = params["layers"][0]["moe"]
    e, d, f = moe["wg"].shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    cases = []
    for phase, tokens in (("decode", MOE_SLOTS), ("prefill", MOE_PROMPT)):
        tile = min(_capacity(cfg, tokens), 128)
        te = torch.arange(e, dtype=torch.int32, device=dev)
        xd, xf = (torch.randn(e * tile, n, generator=gen, device=dev).to(
            torch.bfloat16) for n in (d, f))
        cases += [(f"{phase} gate+silu", xd, te, moe["wg"],
                   Epilogue("silu"), tile),
                  (f"{phase} up", xd, te, moe["wi"], Epilogue(), tile),
                  (f"{phase} down", xf, te, moe["wo"], Epilogue(), tile)]
    return cases


def routes_taken(before):
    """The grouped-matmul routes launched since the counts ``before``."""
    from repro_torch.kernels import grouped_matmul as gm

    return {r: n - before[r] for r, n in gm.ROUTE_LAUNCHES.items()
            if n != before[r]}


def check_grouped_matmul(cases):
    """The grouped-matmul kernel against its plain version on every case,
    at F32_TOL of the output's largest magnitude (both sum the same bf16
    products in f32, in another order); every case, bf16 on bf16, must
    take the tensor-core route."""
    import torch
    from repro_torch.kernels import grouped_matmul as gm

    checker = Checker(("grouped_matmul",))
    for label, x, te, w, ep, tile in cases:
        kw = dict(epilogue=ep, token_tile=tile)
        before = dict(gm.ROUTE_LAUNCHES)
        got = gm.grouped_matmul(x, te, w, f_tile=w.shape[2],
                                d_tile=w.shape[1], **kw)
        route = routes_taken(before)
        checker.record("grouped_matmul",
                       f"{label} ({x.shape[0]} x {w.shape[1]} -> "
                       f"{w.shape[2]}, tile {tile}) route {route}", got,
                       gm.grouped_matmul_plain(x, te, w, **kw))
        if route != {"mma": 1}:
            checker.failures.append(f"grouped_matmul {label}: route {route}, "
                                    "not the tensor cores")
        del got
        torch.cuda.empty_cache()
    return checker.done()


def moe_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab_size, size=MOE_PROMPT, dtype=np.int32)
            for _ in range(MOE_REQUESTS)]


def check_moe_logits(api, einsum, params, prompt, dev):
    """One prefill's last-token logits and one decode step's logits (4
    slots, each the prompt) on the kernel path against the einsum path,
    relative L2 within LOGIT_REL_L2; both finite."""
    import torch

    tokens = torch.as_tensor(prompt[None, :], dtype=torch.int64,
                             device=dev).repeat(MOE_SLOTS, 1)
    lk, cache = api.prefill(params, {"tokens": tokens}, MOE_MAX_LEN)
    nxt = lk.argmax(-1)
    dk, _ = api.decode_step(params, cache, nxt)
    le, cache = einsum.prefill(params, {"tokens": tokens}, MOE_MAX_LEN)
    de, _ = einsum.decode_step(params, cache, nxt)
    del cache
    for label, got, want in (("prefill last-token", lk, le),
                             ("decode step", dk, de)):
        err = rel_l2(got, want)
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        print(f"moe_serve: {label} logits {tuple(got.shape)} {got.dtype}, "
              f"kernel path against the einsum path: relative L2 error "
              f"{err:.3e} (tol {LOGIT_REL_L2:.3e}), max_abs_err "
              f"{float((got.float() - want.float()).abs().max()):.3e} of "
              f"max |logit| {float(want.float().abs().max()):.3f}; argmax "
              f"equal in {agree:.2f} of the rows", flush=True)
        if not err <= LOGIT_REL_L2:
            fail(f"moe_serve: {label} logits of the kernel path disagree "
                 "with the einsum path")
    torch.cuda.empty_cache()


def _counting(api, kernel):
    """``api`` whose prefill and decode_step record the kernel's launches
    in each call."""
    import dataclasses

    calls = {"prefill": [], "decode": []}

    def wrap(fn, key):
        def counted(*args, **kw):
            before = kernel.launches
            out = fn(*args, **kw)
            calls[key].append(kernel.launches - before)
            return out
        return counted

    return dataclasses.replace(
        api, prefill=wrap(api.prefill, "prefill"),
        decode_step=wrap(api.decode_step, "decode")), calls


def serve_moe(cfg, api, params, prompts, dev, counters=None):
    """ServeEngine over the prompts: (results, host seconds, launches per
    prefill and per decode step).  With ``counters``, the counts are
    zeroed just before the run and read just after."""
    import torch
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.serve import Request, ServeEngine

    counted, calls = _counting(api, gm.KERNEL)
    engine = ServeEngine(counted, params, slots=MOE_SLOTS,
                         max_len=MOE_MAX_LEN, device=dev)
    for rid, p in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=p, max_new_tokens=MOE_NEW))
    for k in (counters or {}).values():
        k.launches = 0
    before = dict(gm.ROUTE_LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run_to_completion()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {n: k.launches for n, k in (counters or {}).items()}
    calls["routes"] = routes_taken(before)
    return results, seconds, calls, counts


def moe_serve(cfg, api, einsum, params, dev, counters):
    """The engine on the kernel path (counts zeroed just before, read just
    after; 3 x n_layers grouped-matmul launches in every prefill and
    decode step; every request served in full), then on the einsum path
    for the agreement of the greedy tokens (printed only: near-ties in
    bf16 logits may flip); prefill and decode-step times and the
    grouped-matmul share of a decode step."""
    import torch

    prompts = moe_prompts(cfg)
    check_moe_logits(api, einsum, params, prompts[0], dev)
    results, seconds, calls, counts = serve_moe(cfg, api, params, prompts,
                                                dev, counters)
    want = 3 * cfg.n_layers
    n_tok = sum(len(v) for v in results.values())
    print(f"moe_serve: served {len(results)} requests, {n_tok} tokens in "
          f"{seconds:.3f} s ({n_tok / seconds:.1f} tokens/s, host clock); "
          f"{len(calls['prefill'])} prefills, {len(calls['decode'])} decode "
          f"steps; grouped-matmul launches per prefill "
          f"{sorted(set(calls['prefill']))}, per decode step "
          f"{sorted(set(calls['decode']))} (routes {calls['routes']}); "
          f"launches {counts}", flush=True)
    if sorted(results) != list(range(MOE_REQUESTS)) or any(
            len(v) != MOE_NEW or not all(0 <= t < cfg.vocab_size for t in v)
            for v in results.values()):
        fail("moe_serve: the engine did not serve every request in full")
    if set(calls["prefill"] + calls["decode"]) != {want}:
        fail(f"moe_serve: expected {want} grouped-matmul launches in every "
             f"prefill and decode step, got {calls}")
    if set(calls["routes"]) != {"mma"}:
        fail(f"moe_serve: grouped-matmul routes {calls['routes']}: every "
             "launch of the bf16 model belongs on the tensor cores")
    ref, _, _, _ = serve_moe(cfg, einsum, params, prompts, dev)
    same = sum(a == b for rid in results
               for a, b in zip(results[rid], ref[rid]))
    print(f"moe_serve: greedy tokens of the kernel path equal the einsum "
          f"path's in {same} of {n_tok} ({same / n_tok:.3f}; printed only)",
          flush=True)

    # times: one prefill (one prompt) and one decode step (all slots)
    tokens = torch.as_tensor(prompts[0][None, :], dtype=torch.int64,
                             device=dev)
    cache = api.init_cache(MOE_SLOTS, MOE_MAX_LEN, device=dev)
    cache["pos"] = MOE_PROMPT
    step_tokens = torch.zeros(MOE_SLOTS, dtype=torch.int64, device=dev)
    steps = {"prefill": lambda: api.prefill(params, {"tokens": tokens},
                                            MOE_MAX_LEN),
             "decode step": lambda: api.decode_step(params, cache,
                                                    step_tokens)}
    ms, gmm = {}, {}
    for label, fn in steps.items():
        ms[label] = cuda_ms(fn, 10, 2)
        with LaunchTimer() as timer:
            fn()
        gmm[label] = timer.ms().get("grouped_matmul", 0.0)
        profile_step(label, fn)
    einsum_ms = cuda_ms(lambda: einsum.decode_step(params, cache,
                                                   step_tokens), 10, 2)
    print(f"moe_serve: prefill of {MOE_PROMPT} tokens {ms['prefill']:.4f} "
          f"ms, grouped matmul {gmm['prefill']:.4f} ms of it; decode step "
          f"({MOE_SLOTS} slots) {ms['decode step']:.4f} ms, grouped matmul "
          f"{gmm['decode step']:.4f} ms of it "
          f"({gmm['decode step'] / ms['decode step']:.3f}), on the einsum "
          f"path {einsum_ms:.4f} ms (CUDA events, means of 10 after "
          f"warm-up; the {want} grouped-matmul launches of each timed one "
          "by one)", flush=True)
    prefill_ms, decode_ms, gmm_ms = ms["prefill"], ms["decode step"], \
        gmm["decode step"]
    return {"counts": counts, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "einsum_decode_ms": einsum_ms,
            "gmm_ms": gmm_ms, "tokens_per_s": n_tok / seconds}


def profile_step(label, fn):
    """``torch.profiler`` over one call of ``fn``: the device's busy
    share of the call (kernel time over the CUDA-event time of the same
    window) and the kernels that take most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall_us = start.elapsed_time(end) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    print(f"profile {label}: {wall_us / 1e3:.4f} ms (CUDA events, under "
          f"the profiler), kernels {busy_us / 1e3:.4f} ms in "
          f"{sum(e.count for e in kernels)} launches: busy share "
          f"{busy_us / wall_us:.3f}; top: "
          + "; ".join(f"{e.key[:48]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.4f} ms"
                      for e in top), flush=True)


def time_grouped_matmul(cases):
    """Row 7: the three decode-shape launches of one layer (gate with
    SiLU, up, down), the kernel's median ms over 5 ms windows, its plain
    version's ms and the library yardstick's, ``torch.bmm`` on the
    (E, cap, D) x (E, D, F) bf16 layout that ``_expert_ffn`` builds (which
    the port never calls), summed; bytes: x, each touched expert's weights
    and the output once; operations at the bf16 peak.  The prefill-shape
    launches are timed and printed beside them."""
    import torch
    from repro_torch.kernels import grouped_matmul as gm

    row = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
           "flops": 0, "flop_per_s": BF16_FLOP_PER_S}
    for label, x, te, w, ep, tile in cases:
        e, d, f = w.shape
        kw = dict(epilogue=ep, token_tile=tile)
        ms = cuda_ms_median(lambda: gm.grouped_matmul(
            x, te, w, f_tile=f, d_tile=d, **kw))
        plain = cuda_ms(lambda: gm.grouped_matmul_plain(x, te, w, **kw), 3, 1)
        xb = x.reshape(e, tile, d)
        lib = cuda_ms_median(lambda: torch.bmm(xb, w))
        n_out = x.shape[0] * f
        nbytes = (x.numel() * x.element_size()
                  + len(set(te.tolist())) * d * f * w.element_size()
                  + n_out * 4)
        b_ms, by = bound(nbytes, 2 * x.shape[0] * d * f, BF16_FLOP_PER_S)
        route = gm.gmm_route(x.dtype, w.dtype, d, f, x.data_ptr(),
                             w.data_ptr())
        print(f"grouped_matmul {label} ({x.shape[0]} x {d} -> {f}, tile "
              f"{tile}, route {route}): {ms:.4f} ms (bound {b_ms:.4f} ms by "
              f"{by}; {nbytes / ms / 1e6:.0f} GB/s of {nbytes} bytes, "
              f"{b_ms / ms:.3f} of the bound's {HBM_BYTES_PER_S / 1e9:.0f} "
              f"GB/s), plain {plain:.4f} ms, torch.bmm {lib:.4f} ms "
              f"({nbytes / lib / 1e6:.0f} GB/s)", flush=True)
        if not label.startswith("decode"):
            continue  # the row holds one layer's decode launches
        row["ms"] += ms
        row["plain_ms"] += plain
        row["library_ms"] += lib
        row["bytes"] += nbytes
        row["flops"] += 2 * x.shape[0] * d * f
        torch.cuda.empty_cache()
    return row


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import Schedule
        from repro_torch.kernels import (
            build,
            fused_attention,
            grouped_matmul,
            sddmm,
            segment_reduce,
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
        profiles = segment_profiles(graphs, x, social_model)
        worst.update(check_segment_reduce(profiles, graphs["social"][0]))

    counters = {"spmm_eb": spmm_eb.KERNEL, "spmm_rb": spmm_rb.KERNEL,
                "epilogue": spmm_eb.FINISH, "sddmm": sddmm.KERNEL,
                "fused_attention_fwd": fused_attention.FWD_KERNEL,
                "fused_attention_bwd": fused_attention.BWD_KERNEL,
                "segment_reduce": segment_reduce.KERNEL,
                "grouped_matmul": grouped_matmul.KERNEL}
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
    planned = {}
    with torch.no_grad():  # serving through the fusion planner, readout
        for name, model in (("social", social_model),
                            ("roadnet", road_model)):
            adj, sched = graphs[name]
            sched = None if sched == "auto" else sched
            want = ({"spmm_eb": 2, "epilogue": 2} if name == "social"
                    else {"spmm_rb": 2})
            planned[name] = serve_planned(name, model, adj, sched, x,
                                          counters, want)
            runs.append(planned[name]["counts"])
            expected.append((f"planned serve {name}", tuple(want)))
            for op in ("mean", "max"):
                planned[(name, op)] = readout(name, model, adj, sched, x,
                                              counters, op, want)
                runs.append(planned[(name, op)]["counts"])
                expected.append((f"readout {op} {name}",
                                 tuple(want) + ("segment_reduce",)))
    with torch.no_grad():
        fwd_ms = {name: cuda_ms(lambda m=m, a=graphs[name][0]: m(a, x), 5)
                  for name, m in (("social", social_model),
                                  ("roadnet", road_model))}
        results, dense_ms = time_kernels(graphs, social_model, road_model, x)
        time_widths(graphs)
    results.update(time_sddmm_and_attention(graphs))
    with torch.no_grad():
        results["segment_reduce"] = time_segment_reduce(
            profiles, graphs["social"][0])
    del profiles

    # MoE serving at full width, 4 layers
    with torch.no_grad():
        cfg, api, einsum, moe_params = moe_model(dev)
        cases = moe_kernel_cases(cfg, moe_params, dev)
        worst.update(check_grouped_matmul(cases))
        moe = moe_serve(cfg, api, einsum, moe_params, dev, counters)
        runs.append(moe["counts"])
        expected.append(("moe_serve", ("grouped_matmul",)))
        results["grouped_matmul"] = time_grouped_matmul(cases)
    del cases, moe_params
    torch.cuda.empty_cache()
    for (path, kernels), counts in zip(expected, runs):
        for n in kernels:
            if counts[n] == 0:
                fail(f"the {n} kernel was not launched on the {path} path")
    launches = {n: sum(c[n] for c in runs) for n in counters}

    parts = {"social": results["spmm_eb"]["ms"] + results["epilogue"]["ms"],
             "roadnet": results["spmm_rb"]["ms"]}
    for name in graphs:
        print(f"forward {name}: {fwd_ms[name]:.4f} ms (CUDA events, mean "
              f"of 5 after warm-up) = sparse kernels {parts[name]:.4f} + "
              f"dense products {dense_ms[name]:.4f} + the rest "
              f"{fwd_ms[name] - parts[name] - dense_ms[name]:.4f}",
              flush=True)
    for name in graphs:
        print(f"planned forward {name}: {planned[name]['ms']:.4f} ms "
              f"(gcn_two_layer; GCN.forward {fwd_ms[name]:.4f} ms); readout "
              f"mean {planned[(name, 'mean')]['ms']:.4f} ms, max "
              f"{planned[(name, 'max')]['ms']:.4f} ms (CUDA events, mean of "
              "5)", flush=True)
    for name in graphs:
        t = trained[name]
        per_step = {n: c / TRAIN_STEPS for n, c in t["counts"].items() if c}
        print(f"training step {name}: {t['step_ms']:.4f} ms; per kernel ms "
              + ", ".join(f"{k} {v:.4f}"
                          for k, v in sorted(t["kernel_ms"].items()))
              + f"; launches per step {per_step}", flush=True)
    print(f"moe_serve: prefill {moe['prefill_ms']:.4f} ms, decode step "
          f"{moe['decode_ms']:.4f} ms (einsum path "
          f"{moe['einsum_decode_ms']:.4f} ms), grouped matmul "
          f"{moe['gmm_ms']:.4f} ms of the step, {moe['tokens_per_s']:.1f} "
          "tokens/s", flush=True)

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = results[name]
        bound_ms, bound_by = bound(r["bytes"], r["flops"],
                                   r.get("flop_per_s", F32_FLOP_PER_S))
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r["library_ms"]})
        lib = ("null" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        gathers = (f"; gathers requested {r['gather_bytes']} bytes"
                   if r.get("gather_bytes") else "")
        print(f"kernel {name}: {r['ms']:.4f} ms (bound {bound_ms:.4f} ms "
              f"by {bound_by}, {r['bytes']} bytes, {r['flops']} "
              f"operations{gathers}), plain {r['plain_ms']:.4f} ms, library "
              f"{lib} ms, launches {launches[name]}", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
