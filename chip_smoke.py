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
- the tuner (``tune``): ``repro_torch.tune`` with a cache file in a
  temporary directory (the script sets ``REPRO_TUNE_CACHE``), timing the
  kernels themselves.  On both graphs ``tune_schedule`` at the GCN's two
  widths (N = 256 with layer 1's bias and relu, N = 40), each measured
  point printed with the pick and ``Schedule.auto``'s; then
  ``spmm(schedule="tune")``, which must replay with no measurement, per
  element against the plain version on a zero-mean B and, on the served
  B, within K_TERMS of an f64 result, and the tuned and auto schedules
  re-timed in turns (fail if tuned is over 10 % slower where auto takes
  0.1 ms or more); the GCN forward with ``schedule="tune"``;
  ``tune_segment_reduce`` on the batched and hidden readouts with
  ``segment_reduce(schedule="tune")`` (max bit for bit, add the same bits
  over two launches); ``sddmm(schedule="tune")`` on roadnet at width 256;
  ``tune_sparse_attention`` forward and backward on roadnet, forward on
  social, with ``sparse_attention(schedule="tune")``; ``tune_plan`` on
  roadnet's GCN chain with ``gcn_two_layer(plan=tuned_plan(...))``; and
  ``calibrate`` from the phase's own measurements, whose shipped fit must
  not rank worse than the prior;
- low precision (``lowprec``, with ``Fp8Fallback`` an error): the GCN
  served at bf16, fp16, fp8 (e4m3) and int8 (per-row scales) value
  storage on both graphs against the same schedule at f32 (LOWPREC_TOL,
  the reference's, and within 1 % of the storage's own error on the
  plain path), one bf16 training step against f32 (LOWPREC_GRAD_TOL); EB
  and RB at each storage type per element under K_TERMS; the fp16 and
  e4m3 epilogue stores on EB, RB and the grouped matmul (e4m3 NaN above
  464); int8 codes and scales card against CPU bit for bit; the byte
  model against the EB runner's feed; EB (with its finish) and RB timed
  at each storage type beside f32; and ``tune_schedule`` with the dtype
  axis at N = 256 on both graphs, its replay measuring nothing;
- MoE serving (``moe_serve``): Qwen3-MoE-235B-A22B at full width (d_model
  4096, 64 heads over 4 kv heads, 128 experts top-8, expert width 1536,
  vocab 151,936, bf16), cut to 4 layers, random weights from seed 0 made
  on the card; the grouped-matmul kernel held against its plain version
  at layer 0's decode (tile 4) and prefill (tile 10) shapes, each on the
  tensor-core route (``mma``, printed with the case), prefill and
  decode logits against the einsum path (``moe_kernel_dispatch=False``),
  and ``ServeEngine`` (4 slots) serving 8 requests of 128-token prompts,
  16 greedy tokens each, with 12 grouped-matmul launches a decode step
  and a prefill, every one on the tensor-core route;
- the MoE dispatch tuner (``moe_tune``) on the same model, through
  ``ServeEngine(tuner_cache=...)`` over a cache in a temporary
  directory: ``prepare_moe`` for the eight prompts prefilled as one batch
  (1024 tokens) on three expert histograms (balanced and assumed, layer
  0's router on the batch's hidden states, Zipf-skewed), each measured
  point printed with its (tile, cap_pad), the pick and the default
  re-timed in turns and the dropped tokens of both (fails where a replay
  measures, the pick drops more than the default, or a launch leaves the
  tensor cores); the grouped-matmul kernel against its plain version in
  its three roles at every (tile, cap_pad) measured, timed against its
  bytes bound; ``apply_moe`` at the observed pick on the kernel path
  against the einsum path; and the engine's sparse side channel,
  ``prepare_sparse`` and ``spmm`` on both graphs at N = 256 and 40,
  against f64 within K_TERMS, a second ``prepare_sparse`` replaying.

- narrow operands (``narrow``): SDDMM at bf16, fp16 and e4m3 A and B and
  at f32 A with bf16 B on both graphs at D = 40 and 256 (per element
  within K_TERMS of the plain version on the same stored values, each
  launch handed the stored operands, timed beside the f32 kernel and a
  copy to f32 before it), and one bf16-storage training step with B in
  bf16, whose dvals runs the (f32, bf16) pair; graph attention through
  ``sparse_attention`` at bf16 and fp16 q, k and v on both graphs,
  forward and backward against the plain path, the kernels against
  their plain versions (split rows bit for bit over two launches), and
  one head at d = dv = 320 and 512, f32 and bf16, on both graphs (the
  slabs, and on social the hub row's chunk split); then, on the MoE
  model after ``moe_tune``, its experts cast to e4m3: logits against a
  twin holding their exact bf16 upcast (largest difference printed),
  the grouped matmul at bf16, e4m3 and f32 tokens on e4m3 experts and
  ``ServeEngine`` served; and the same configuration drawn at fp16:
  logits against the einsum path at fp16 on the kernel path's expert
  choices (the free einsum path's routing printed, every token it routes
  otherwise a near tie where the runs first part), the grouped matmul at
  fp16 and f32 tokens, ``ServeEngine`` served; prefill, decode-step ms
  and tokens/s of both serves.

- user-defined reduction strategies (``user``, before ``moe_serve``),
  registered in this script in torch (``user_strategies``: a port of
  quickstart's ``"onehot-tile"``, its spec alone, a segment max with
  ``combine="max"`` and with a callable combine, a spec generic in the
  monoid): the partials kernel against its plain version bit for bit on
  both graphs' streams at N = 256 and 40, window by window, and the
  combine under add, max and min on the whole (n_rows, 256) block; the
  user's code handed global ids and the whole block, as the reference
  hands them, so a one-hot costs 4096 x 169,343 a tile: the GCN served
  at nnz tile 4096 under the one-hot strategy (one request on social)
  and under the generic spec (3 requests on both graphs, each layer
  against f64 within K_TERMS), each against the built-in ``segment``
  forward and timed beside it with the tiles it walks; one training
  step under the generic spec (gradients against the built-in step
  within GRAD_RTOL; its backward must launch the partials kernel); EB
  under the max and the callable combine on both graphs against the
  plain walk on the card bit for bit; the readout (mean, max) under the
  generic spec at nnz tiles 4096 and 256 against the built-in kernel
  (max bit for bit, mean within K_TERMS); and the two kernels timed on
  one social forward's work: the combine on a dense replay (a tile of
  ones, every element changing) and on the walk's own seg-generic
  results, each beside ``acc.add_``, the latter with the bytes those
  results need.
- a user strategy inside the fused attention (``attn_user``, after
  ``user``): ``csrc/attn_user.cu``'s kernels against their plain
  versions on both graphs' streams at 4 heads x 64 and nnz tile 4096
  (``attn_lanes``' scores and dw within K_TERMS of their terms on
  zero-mean operands, w within its score's error through exp plus
  EXP_ULPS, ds bit for bit; ``attn_rescale`` within EXP_ULPS, its
  finish bit for bit; the partials kernel's f32 values on bf16, fp16
  and e4m3 V bit for bit); ``sparse_attention`` forward and backward
  under the generic spec on both graphs against the built-in kernels
  (out within F32_TOL of its largest magnitude, gradients within
  GRAD_RTOL relative L2), timed beside them (host clock) with the tiles
  walked; the forward under ``seg-max`` against the same walk with the
  plain versions on the card, and ``seg-max-callable`` raising at the
  max scatter; quickstart's one-hot, spec and realization, on one
  roadnet head (its one-hot is 4096 x 169,343 f32 for each of three
  scatters a tile: the script prints why, and what social would take);
  and the two kernels timed on one social pass, ``attn_lanes`` also by
  mode, its scores beside ``torch.sparse.sampled_addmm``.

- LM training (``lm_train``, last): Qwen3-MoE at full width cut to one
  layer by memory (its AdamW state is 37.3 GB; the script prints the
  reckoning), launch/train.py's batch of 8 x 256 tokens.  (a) The grouped
  matmul's backward kernels on 8 experts of the full D and F, on both
  routes (bf16 and e4m3 partners on the tensor cores, dz split into three
  bf16 parts; f32 and fp16 on the CUDA cores; the route counted), per
  element within K_TERMS of their plain versions and of the f64 product:
  dx = dz . W[e]^T on the forward kernel reading the weights transposed,
  dW and db on ``grouped_matmul_dw``, on a sorted map and an unsorted one
  with an expert that owns no tile, each kernel's bf16 store against its
  f32 sums rounded; both timed at the training shapes beside their plain
  versions and ``torch.bmm`` in f32, with the bound of three bf16 passes
  and the f32 product's beside it.  (b) One step's loss and every
  leaf's gradient on the kernel path against the einsum path
  (LM_LOSS_REL, LM_GRAD_REL_L2).  (c) ``Trainer`` for 8 steps at lr 1e-3
  (printed) and at that rate scaled to the width (the losses must fall;
  the launches counted, all on the tensor cores, step ms by CUDA events,
  peak memory, the new launches' ms, one step profiled), and a
  checkpoint save and restore at
  smoke size.

It prints kernel, forward, training-step, attention, readout, tuning,
prefill and decode times, EB, RB and ``torch.sparse.mm`` at N = 64 and 128 on both
graphs, the launch counts of each path, a ``{"kernels": [...]}``
line (``launches`` counts every path but the tuners' (the tune and
moe_tune phases and the lowprec phase's dtype-axis tuning), whose counts
follow the points their timing visits and stand apart as
``tune_launches``) and, as its last line, ``{"ok": true, "device": {...}}``.  Any
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
#: One step of a narrow output type, (relative, absolute at the bottom of
#: its subnormals): the kernel and the plain version round f32 results
#: that differ in their last bits, so they may land on neighbours.
OUT_STEP = {"bfloat16": (2.0 ** -7, 0.0), "float16": (2.0 ** -10, 2.0 ** -24),
            "float8_e4m3fn": (2.0 ** -3, 2.0 ** -9)}
#: The low-precision phase: the storage types, the relative L2 of each
#: one's served GCN forward against the same schedule at f32 (the
#: reference's TOL, tests/test_lowprec.py: storage rounding only, the sums
#: are f32), and of a bf16 training step's gradients against the f32
#: step's (the reference's bound, tests/test_lowprec.py:144-156).
LOWPREC_DTYPES = ("bfloat16", "float16", "float8_e4m3fn", "int8")
LOWPREC_TOL = {"bfloat16": 2e-2, "float16": 3e-3, "float8_e4m3fn": 1.5e-1,
               "int8": 5e-2}
LOWPREC_GRAD_TOL = 5e-2
TRAIN_STEPS = 5
LR = 0.5
#: Graph attention: HEADS x HEAD_DIM = 256, the GCN's hidden width.
HEADS, HEAD_DIM = 4, 64
#: The attention's masked-score floor (``kernels/fused_attention.NEG_INF``).
NEG_INF_F32 = -1e30
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
#: The tune phase re-times the tuned and the auto schedule in turns over
#: this many CUDA-event windows each, and fails where the tuned one is
#: more than TUNE_SLACK slower on a workload whose auto schedule takes at
#: least TUNE_MIN_AUTO_MS (shorter calls are host-bound: their schedules
#: differ by less than their noise).
TUNE_WINDOWS, TUNE_SLACK, TUNE_MIN_AUTO_MS = 5, 0.10, 0.1
#: LM training (``lm_train``): Qwen3-MoE at full width cut to LM_LAYERS
#: layers by memory (AdamW holds LM_BYTES_PER_PARAM bytes a parameter),
#: launch/train.py's default batch, LM_STEPS steps of the reference's
#: trainer test at constant learning rate LM_LR; the backward kernels
#: checked on LM_CHECK_EXPERTS experts; tiles of LM_TILE rows (the MoE
#: path's at this batch: capacity 160, cap_pad 256).
LM_LAYERS, LM_BATCH, LM_SEQ, LM_STEPS, LM_LR = 1, 8, 256, 8, 1e-3
LM_BYTES_PER_PARAM, LM_CHECK_EXPERTS, LM_TILE = 12, 8, 128
#: The width of the reference's smoke config, at which its trainer test
#: takes LM_LR.  AdamW's first steps move every weight by about the
#: learning rate, so a hidden product's output moves by about lr x its
#: fan-in: at d_model 4096 a rate of 1e-3 moves each layer's outputs by
#: several times their size (on the H100 the first step took the loss
#: from 13.04 to 36.44).  The trained run takes LM_LR x 64 / d_model,
#: the same move relative to the outputs as the reference's test makes.
LM_REFERENCE_WIDTH = 64
#: The kernel path's gradients against the einsum path's, relative L2
#: per leaf, and the loss's relative error.  Both paths compute the same
#: function but round to bf16 in other places (the einsum path rounds
#: each expert projection and its gradients to bf16, the kernel path
#: keeps the products' sums in f32), and every bf16 gradient is rounded
#: once more when it is stored.  On the H100 at full width the leaves'
#: gradients differed by 0.13 to 0.52 % of their norms and the losses by
#: 3.4e-6: 2^-5 leaves a margin of 6x on the gradients and 2^-10 one of
#: 280x on the loss, where a routing, tiling or transposition fault moves
#: a gradient by tens of percent.
LM_GRAD_REL_L2, LM_LOSS_REL = 2.0 ** -5, 2.0 ** -10
#: The grouped matmul's plain version runs over at most this many tiles
#: at a time (it gathers each tile's expert weights in f32).
GMM_PLAIN_TILES = 128
#: The narrow phase: SDDMM's (A, B) operand types; attention's q, k and v
#: types through ``sparse_attention``; head widths above one slab of the
#: attention kernels (256 columns), run at f32 and bf16.
NARROW_SDDMM_PAIRS = (("bfloat16", "bfloat16"), ("float16", "float16"),
                      ("float8_e4m3fn", "float8_e4m3fn"),
                      ("float32", "bfloat16"))
NARROW_ATTN_DTYPES = ("bfloat16", "float16")
WIDE_HEAD_DIMS = (320, 512)
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
    # the grouped matmul's backward (src/repro/kernels/ops.py:304-325, the
    # custom VJP of the Pallas kernel): dx on the forward kernel with the
    # weights read transposed, dW and db on their own kernel
    "grouped_matmul_dx": ("src/repro_torch/kernels/csrc/grouped_matmul.cu",
                          "src/repro/kernels/grouped_matmul.py:79"),
    "grouped_matmul_dw": ("src/repro_torch/kernels/csrc/grouped_matmul_dw.cu",
                          "src/repro/kernels/grouped_matmul.py:79"),
    # a user strategy on EB: the lane partials (the front of the EB body,
    # before group_reduce_scatter) and the combine of spec_fallback_pallas
    "eb_partials": ("src/repro_torch/kernels/csrc/eb_partials.cu",
                    "src/repro/kernels/spmm_eb.py:44"),
    "user_combine": ("src/repro_torch/kernels/csrc/eb_partials.cu",
                     "src/repro/kernels/common.py:167"),
    # a user strategy inside the fused attention: the lane passes of both
    # bodies (the forward's scores; the backward's w, dw and ds at :333,
    # :340, :343, :360) and the forward's rescale and p (:194-211)
    "attn_lanes": ("src/repro_torch/kernels/csrc/attn_user.cu",
                   "src/repro/kernels/fused_attention.py:184"),
    "attn_rescale": ("src/repro_torch/kernels/csrc/attn_user.cu",
                     "src/repro/kernels/fused_attention.py:194"),
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


def device_ms(fn, calls: int = 20, windows: int = 3) -> dict:
    """Device ms per call of each kernel ``fn`` launches (fills
    included), by kernel name, from ``torch.profiler``'s CUDA activity:
    per name the median over ``windows`` complete profiled windows of
    ``calls`` calls each, after two warm-up calls.  Unlike a CUDA-event
    window, it leaves out the device's idle time while the host prepares
    the next launch, which bounds calls of a few tens of microseconds.
    The profiler now and then records no kernel or only some of a
    window's (one window read a walk at 0.42x its bytes bound on the
    H100), so each window opens with one call in the profiler's warm-up
    step, and a window counts only where every kernel name holds the
    most events any window saw for it, a whole multiple of ``calls``;
    fails after 3 x ``windows`` tries with fewer complete windows."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    seen = []  # (ms per call, events) by kernel name, one per window
    complete = []
    for _ in range(3 * windows):
        # one call in the profiler's warm-up step, whose events it drops:
        # windows that opened on the timed calls recorded one walk launch
        # fewer than the calls in all nine tries of one H100 run
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
        ms, events = {}, {}
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and not e.key.startswith("ProfilerStep")):
                ms[e.key] = ms.get(e.key, 0.0) + (
                    e.self_device_time_total / 1e3 / calls)
                events[e.key] = events.get(e.key, 0) + e.count
        seen.append((ms, events))
        want = {}
        for _, ev in seen:
            for k, n in ev.items():
                want[k] = max(want.get(k, 0), n)
        complete = [m for m, ev in seen if want and ev == want
                    and all(n % calls == 0 for n in ev.values())]
        if len(complete) >= windows:
            break
    if len(complete) < windows:
        fail(f"torch.profiler recorded {len(complete)} complete windows of "
             f"{windows} in {len(seen)} tries (events per kernel: "
             f"{[ev for _, ev in seen]})")
    return {k: statistics.median(m[k] for m in complete[:windows])
            for k in complete[0]}


def dtype_name(t) -> str:
    """'float32', 'bfloat16', ... of a tensor."""
    return str(t.dtype).removeprefix("torch.")


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
        2^-24 of ``terms + |want|`` (one step of a narrow output type
        more, ``OUT_STEP``; NaN, an e4m3 overflow, exactly where the plain
        version has it); print the observed k, the largest error in
        those units."""
        import torch

        g, w = got.detach().float(), want.detach().float()
        nan = torch.isnan(w)
        if (g.shape != w.shape or got.dtype != want.dtype
                or not torch.equal(torch.isnan(g), nan)
                or not bool(torch.isfinite(g[~nan]).all())):
            err, k_obs, ok = float("inf"), float("inf"), False
        else:
            g, w = g.masked_fill(nan, 0.0), w.masked_fill(nan, 0.0)
            unit = 2.0 ** -24 * (terms + w.abs())
            rel, floor = OUT_STEP.get(dtype_name(got), (0.0, 0.0))
            slack = rel * w.abs() + floor
            diff = (g - w).abs()
            err = float(diff.max())
            k_obs = float(((diff - slack).clamp_min(0) / unit.clamp_min(
                1e-30)).max())
            ok = bool((diff <= K_TERMS * unit + slack).all())
        step = (f" + {OUT_STEP[dtype_name(got)][0]:.0e}|ref|"
                if dtype_name(got) in OUT_STEP else "")
        self.worst[kernel] = max(self.worst[kernel], err)
        print(f"  {kernel:19s} {label:48s} max_abs_err {err:.3e} k "
              f"{k_obs:.3f} (tol K_TERMS {K_TERMS} x 2^-24 x terms{step}) "
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


class MeasureCount:
    """While active, counts the tuner's measurements: one per call of the
    ``time_fn`` its default objectives reach (SpMM through
    ``tune.measure``, segment reduce through ``tune.search``, attention
    through ``tune.attention``, the planner through ``tune.measure``, the
    MoE dispatch through ``tune.moe``)."""

    def __enter__(self):
        from repro_torch.tune import attention, measure, moe, search

        self.n, self._saved = 0, []
        for mod in (measure, search, attention, moe):
            orig = mod.time_fn

            def counted(*args, _orig=orig, **kw):
                self.n += 1
                return _orig(*args, **kw)

            self._saved.append((mod, orig))
            mod.time_fn = counted
        return self

    def __exit__(self, *exc):
        for mod, orig in self._saved:
            mod.time_fn = orig


def print_points(label, res):
    """Each measured point of a tuning run (key, ms), in measuring order."""
    src = ("replayed" if res.from_cache
           else f"{res.n_measurements} measurements")
    print(f"tune {label}: {src}; key {res.key}", flush=True)
    for k, us in res.measured.items():
        print(f"  {k:44s} {us / 1e3:.4f} ms", flush=True)


def one_program_spread(res, programs):
    """Points that run one program, grouped by ``programs(point)``: per
    group the (min, max) ms and the spread (max - min) / min."""
    groups = {}
    for k, us in res.measured.items():
        groups.setdefault(programs(res.points[k]), []).append(us / 1e3)
    return {g: (min(v), max(v), (max(v) - min(v)) / min(v))
            for g, v in groups.items()}


def stored(adj, b, value_dtype):
    """(the CSR whose layout the kernels are fed, per-row scales or None,
    B) under ``value_dtype``: the values and B in their storage types, or
    the int8 codes of the CSR's quantization with its scales on a bf16
    B."""
    from repro_torch.core.dtypes import cast, operand_dtype, storage_dtype

    if value_dtype is None:
        return adj, None, b
    bb = cast(b, operand_dtype(value_dtype, b.device))
    if value_dtype == "int8":
        q = adj.quantized()
        return q.csr, q.scales, bb
    return adj.astype(storage_dtype(value_dtype, b.device)), None, bb


def plain_spmm(adj, b, sched, bias):
    """(kernel, out, terms): the plain version of the kernel ``sched``
    selects, on the CSR's feed for it (the grouping of the sums is the
    schedule's) at the schedule's value storage, and the magnitudes of
    the terms entering each output (the stored values upcast)."""
    from repro_torch.kernels import eb_partials, spmm_eb, spmm_rb

    adj_s, scales, b = stored(adj, b, sched.value_dtype)
    if sched.kernel == "eb":
        g = adj_s.grouped(sched.nnz_tile, group_size=sched.group_size,
                          split_threshold=sched.split_threshold,
                          merge_threshold=sched.merge_threshold)
        kernel, plain, args = "spmm_eb", spmm_eb.spmm_eb_plain, (
            g.rows, g.cols, g.vals, b)
        kw = dict(n_rows=adj.shape[0], nnz_tile=sched.nnz_tile,
                  group_size=sched.group_size, strategy=sched.strategy,
                  heavy_tiles=g.heavy_tiles)
        term_args = (g.rows, g.cols,
                     eb_partials.lane_values(g.vals, g.rows, scales),
                     b.float())
    else:
        e = adj_s.ell(row_tile=sched.row_tile)
        kernel, plain, args = "spmm_rb", spmm_rb.spmm_rb_plain, (
            e.cols, e.vals, b)
        kw = dict(n_rows=adj.shape[0])
        v = e.vals.float()
        term_args = (e.cols, v if scales is None else
                     v[:adj.shape[0]] * scales[:, None], b.float())
    return (kernel, plain(*args, epilogue=sched.epilogue, scales=scales,
                          bias=bias, **kw),
            terms_of(plain, *term_args, bias=bias, **kw))


def exact_spmm(adj, b, epilogue, bias):
    """epilogue(A @ B) in f64, the terms summed by ``index_add_``."""
    import torch

    coo = adj.tocoo()
    out = torch.zeros((adj.shape[0], b.shape[1]), dtype=torch.float64,
                      device=b.device)
    out.index_add_(0, coo.rows.long(), coo.vals.double()[:, None]
                   * b.double()[coo.cols.long()])
    return epilogue.apply(out, bias=None if bias is None
                          else bias.double().reshape(1, -1))


def f64_k(adj, b, sched, bias, got):
    """(kernel k, plain k): the largest error of ``got`` and of the plain
    version at ``sched`` against the f64 result, in units of 2^-24 of
    the terms entering each output."""
    _, want, terms = plain_spmm(adj, b, sched, bias)
    exact = exact_spmm(adj, b, sched.epilogue, bias)
    unit = 2.0 ** -24 * (terms.double() + exact.abs())
    return tuple(float(((t.double() - exact).abs() / unit).max())
                 for t in (got, want))


def retime_in_turns(fn_a, args_a, fn_b, args_b):
    """(median ms of a, median ms of b) over TUNE_WINDOWS CUDA-event
    windows of 10 calls each, a and b in turns."""
    import statistics

    ta, tb = [], []
    for _ in range(TUNE_WINDOWS):
        ta.append(cuda_ms(lambda: fn_a(*args_a), 10, 1))
        tb.append(cuda_ms(lambda: fn_b(*args_b), 10, 1))
    return statistics.median(ta), statistics.median(tb)


def tune_spmm(checker, mc, name, adj, n, b, bias, ep):
    """``tune_schedule`` at width ``n`` (with the served epilogue), then
    ``spmm(schedule="tune")``, which must replay with no measurement, held
    per element against the plain version; then the tuned and the auto
    schedule re-timed in turns, TUNE_WINDOWS CUDA-event windows each."""
    import torch
    from repro_torch.core import Epilogue, Schedule
    from repro_torch.sparse import matrix_stats, spmm
    from repro_torch.tune import make_runner, tune_schedule

    label = f"spmm {name} N={n}"
    t0 = time.perf_counter()
    # f32 storage: the dtype axis is the lowprec phase's
    res = tune_schedule(adj, n, epilogue=ep, value_dtypes=())
    took = time.perf_counter() - t0
    auto = Schedule.auto(matrix_stats(adj), n)
    auto = auto if ep is None else auto.replace(epilogue=ep)
    print_points(label, res)
    print(f"tune {label}: pick {res.schedule} ({res.us_per_call / 1e3:.4f} "
          f"ms); Schedule.auto {auto}; {took:.2f} s", flush=True)
    before = mc.n
    act = None if ep is None else Epilogue(ep.activation)
    gen = torch.Generator(device=b.device).manual_seed(SEED + 9)
    b_rand = torch.randn(b.shape, generator=gen, device=b.device)
    got, served = (spmm(adj, bb, schedule="tune", bias=bias, epilogue=act,
                        device=b.device) for bb in (b_rand, b))
    if mc.n != before:
        fail(f"{label}: spmm(schedule='tune') measured {mc.n - before} "
             "points instead of replaying")
    # per element on a zero-mean B, as check_kernels holds EB and RB
    kernel, want, terms = plain_spmm(adj, b_rand, res.schedule, bias)
    checker.record_terms(kernel, f"tuned {label}", got, want, terms)
    # the served B against the plain version at F32_TOL of its largest
    # magnitude, and both against the f64 result in units of 2^-24 of the
    # terms entering each output
    _, want, terms = plain_spmm(adj, b, res.schedule, bias)
    checker.record(kernel, f"tuned {label} served B", served, want)
    k_kernel, k_plain = f64_k(adj, b, res.schedule, bias, served)
    ok = k_kernel <= K_TERMS
    print(f"tune {label}: served B against the f64 result: kernel k "
          f"{k_kernel:.3f} (tol K_TERMS {K_TERMS}) "
          f"{'ok' if ok else 'FAIL'}, plain version k {k_plain:.3f} "
          "(printed only)", flush=True)
    if not ok:
        checker.failures.append(f"{kernel} tuned {label} served B, f64")
    del b_rand, got, served, want, terms
    auto_ms, tuned_ms = retime_in_turns(*make_runner(adj, n, auto),
                                       *make_runner(adj, n, res.schedule))
    ratio = tuned_ms / auto_ms
    print(f"tune {label}: re-timed in turns ({TUNE_WINDOWS} windows of 10): "
          f"tuned {tuned_ms:.4f} ms, auto {auto_ms:.4f} ms, ratio "
          f"{ratio:.4f}", flush=True)
    if auto_ms >= TUNE_MIN_AUTO_MS and ratio > 1.0 + TUNE_SLACK:
        fail(f"{label}: the tuned schedule is {ratio:.4f}x auto, more than "
             f"{TUNE_SLACK:.0%} slower")
    torch.cuda.empty_cache()
    return {"res": res, "auto": auto, "auto_ms": auto_ms,
            "tuned_ms": tuned_ms, "ratio": ratio, "s": took}


def tune_phase(graphs, x, model, profiles, counters):
    """The tuner on the card (``repro_torch.tune``), with a cache file in
    a temporary directory: SpMM tuned at the GCN's two widths on both
    graphs and replayed through ``spmm(schedule="tune")``, the GCN
    forward with ``schedule="tune"``, segment reduce on the batched and
    hidden readout profiles, SDDMM on roadnet at width 256, attention
    (forward and backward on roadnet, forward on social), the fusion
    planner on roadnet's GCN chain, and a calibration from the phase's
    own measurements.  Every replay must measure nothing; every tuned
    output is held against its plain version.  Returns the launch counts
    (zeroed just before, read just after) and the worst errors."""
    import os
    import tempfile

    import torch
    from repro_torch import tune
    from repro_torch.core import Epilogue, Schedule
    from repro_torch.fuse import (gcn_chain, run_chain_ref, tune_plan,
                                  tuned_plan)
    from repro_torch.kernels import fused_attention as fa
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.models import GCN, gcn_two_layer
    from repro_torch.sparse import (sddmm, segment_reduce, sparse_attention,
                                    spmm)

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tune_")
    os.environ["REPRO_TUNE_CACHE"] = str(Path(tmp.name) / "tune.json")
    tune.set_default_cache(None)
    checker = Checker(("spmm_eb", "spmm_rb", "sddmm", "segment_reduce",
                       "fused_attention_fwd"))
    dev = x.device
    for c in counters.values():
        c.launches = 0
    out = {"spmm": {}, "segred": {}, "attn": {}}
    with MeasureCount() as mc:
        relu_b = Epilogue("relu", bias=True)
        for name, (adj, _) in graphs.items():
            xw = (x @ model.w1).contiguous()
            h = spmm(adj, xw, bias=model.b1, epilogue=Epilogue("relu"),
                     device=dev)
            hw = (h @ model.w2).contiguous()
            out["spmm"][(name, HIDDEN)] = tune_spmm(
                checker, mc, name, adj, HIDDEN, xw, model.b1, relu_b)
            out["spmm"][(name, N_CLASS)] = tune_spmm(
                checker, mc, name, adj, N_CLASS, hw, None, None)
            del xw, h, hw

        # the GCN forward, every aggregation replayed
        tuned = GCN(N_FEAT, HIDDEN, N_CLASS, device=dev, schedule="tune",
                    generator=torch.Generator().manual_seed(SEED))
        for name, (adj, _) in graphs.items():
            before = mc.n
            logits = tuned(adj, x)
            torch.cuda.synchronize()
            if mc.n != before:
                fail(f"tune gcn {name}: the forward measured "
                     f"{mc.n - before} points instead of replaying")
            err, tol, ok = compare(logits, reference_forward(tuned, adj, x))
            print(f"tune gcn {name}: GCN(schedule='tune') forward, 0 "
                  f"measurements, max_abs_err {err:.3e} tol {tol} against "
                  f"the plain path {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"tune gcn {name}: the tuned forward disagrees")

        # segment reduce: the reference's pool of eight points; the CUDA
        # kernel ignores the tile, so (G, strategy) names its program
        for label, op, idx in (("batched readout", "sum", 1),
                               ("hidden readout", "max", 2)):
            _, seg, data, n_seg, _ = profiles[idx]
            t0 = time.perf_counter()
            res = tune.tune_segment_reduce(seg, data.shape[1], n_seg)
            took = time.perf_counter() - t0
            print_points(f"segment_reduce {label}", res)
            spread = one_program_spread(
                res, lambda s: f"G{s.group_size}:{s.strategy}")
            print(f"tune segment_reduce {label}: pick {res.schedule}; "
                  f"{took:.2f} s; one program, two tiles: " + ", ".join(
                      f"{g} {lo:.4f}-{hi:.4f} ms ({sp:.1%})"
                      for g, (lo, hi, sp) in spread.items()), flush=True)
            before = mc.n
            got = segment_reduce(seg, data, n_seg, schedule="tune", op=op,
                                 device=dev)
            if mc.n != before:
                fail(f"tune segment_reduce {label}: did not replay")
            s = res.schedule
            kw = dict(num_segments=n_seg, tile=s.nnz_tile,
                      group_size=s.group_size, strategy=s.strategy,
                      op="add" if op == "sum" else op)
            want = sr.segment_reduce_plain(seg, data, **kw)
            checker.record("segment_reduce", f"tuned {label} {op}", got,
                           want, exact=op == "max")
            if op == "sum":
                checker.record("segment_reduce",
                               f"tuned {label} {op} two launches", got,
                               segment_reduce(seg, data, n_seg,
                                              schedule="tune", op=op,
                                              device=dev),
                               exact=True)
            out["segred"][label] = {"res": res, "spread": spread,
                                    "s": took}

        # SDDMM takes the tile tune_segment_reduce picks for its rows
        adj = graphs["roadnet"][0]
        coo = adj.tocoo()
        a_dense = (x @ model.w1).contiguous()
        t0 = time.perf_counter()
        res = tune.tune_segment_reduce(coo.rows, HIDDEN,
                                       int(coo.rows.max()) + 1)
        took = time.perf_counter() - t0
        print_points("sddmm roadnet 256 (segment-reduce profile)", res)
        before = mc.n
        got = sddmm(coo.rows, coo.cols, a_dense, a_dense, schedule="tune",
                    device=dev)
        if mc.n != before:
            fail("tune sddmm roadnet: did not replay")
        want = sddmm(coo.rows, coo.cols, a_dense, a_dense, impl="ref",
                     device=dev)
        checker.record("sddmm", "tuned roadnet 256", got, want)
        print(f"tune sddmm roadnet 256: nnz_tile {res.schedule.nnz_tile}, "
              f"{took:.2f} s", flush=True)
        del a_dense, got, want

        # attention: the kernels take no schedule, so the eight points of
        # each run are one program
        gen = torch.Generator().manual_seed(SEED + 4)
        for name, directions in (("roadnet", ("fwd", "bwd")),
                                 ("social", ("fwd",))):
            adj = graphs[name][0]
            q, k, v, _ = attention_operands(adj, gen, dev)
            for direction in directions:
                t0 = time.perf_counter()
                res = tune.tune_sparse_attention(
                    fa.rows_of(adj.indptr), adj.indices, q, k, v,
                    n_rows=adj.shape[0], bias=adj.vals, direction=direction)
                took = time.perf_counter() - t0
                print_points(f"attention {name} {direction}", res)
                lo, hi, sp = one_program_spread(res, lambda s: 0)[0]
                print(f"tune attention {name} {direction}: pick "
                      f"{res.schedule}; one program {lo:.4f}-{hi:.4f} ms "
                      f"(spread {sp:.1%}); {took:.2f} s", flush=True)
                out["attn"][(name, direction)] = {"res": res,
                                                  "spread": (lo, hi, sp),
                                                  "s": took}
            before = mc.n
            got = sparse_attention(adj, q, k, v, schedule="tune", device=dev)
            if mc.n != before:
                fail(f"tune attention {name}: did not replay")
            checker.record("fused_attention_fwd", f"tuned {name}", got,
                           sparse_attention(adj, q, k, v, impl="ref",
                                            device=dev))
            del q, k, v, got

        # the fusion planner on roadnet's GCN chain
        adj, sched = graphs["roadnet"]
        chain, params = gcn_chain(adj, (model.w1, model.w2), (model.b1, None),
                                  schedule=sched)
        t0 = time.perf_counter()
        res = tune_plan(chain, x, params)
        took = time.perf_counter() - t0
        print_points("plan roadnet", res)
        before = mc.n
        p = tuned_plan(chain, x, params)
        got = gcn_two_layer(adj, x, model.w1, model.w2, model.b1,
                            schedule=sched, plan=p, device=dev)
        if mc.n != before or p.decision != res.schedule:
            fail("tune plan roadnet: tuned_plan did not replay the pick")
        err, tol, ok = compare(got, run_chain_ref(chain, x, params))
        print(f"tune plan roadnet: pick {res.schedule.tag} "
              f"({len(p.launches)} launches), {took:.2f} s; "
              f"gcn_two_layer(plan=tuned_plan(...)) max_abs_err {err:.3e} "
              f"tol {tol} against run_chain_ref {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail("tune plan roadnet: the tuned plan disagrees")
        out["plan"] = {"res": res, "s": took}

        # calibration from the phase's own SpMM measurements
        before = mc.n
        samples = tune.samples_from_results(
            [(graphs[name][0], n, r["res"])
             for (name, n), r in out["spmm"].items()])
        cal = tune.calibrate(samples=samples)
        if mc.n != before:
            fail("tune calibrate: measured instead of reusing the phase's "
                 "results")
        print(f"tune calibrate: {cal.n_samples} samples, weights "
              f"{tuple(round(w, 6) for w in cal.weights)}, regret before "
              f"{cal.regret_before:.4f}, after {cal.regret_after:.4f}",
              flush=True)
        if cal.regret_after > cal.regret_before:
            fail("tune calibrate: the shipped fit is worse than the prior")
        out["calibrate"] = cal
        out["measurements"] = mc.n
    torch.cuda.synchronize()
    out["counts"] = {n: c.launches for n, c in counters.items()}
    out["worst"] = checker.done()
    out["s"] = time.perf_counter() - t_phase
    print(f"tune: {out['measurements']} measurements, phase {out['s']:.1f} "
          f"s; launches {out['counts']}", flush=True)
    tune.set_default_cache(None)
    del os.environ["REPRO_TUNE_CACHE"]
    tmp.cleanup()
    return out


def lowprec_phase(graphs, x, models, counters):
    """Low-precision SpMM on the card (bf16, fp16, fp8 and int8 value
    storage) at the GCN's full width, with ``Fp8Fallback`` an error:

    - served: the GCN forward on both graphs under each one's served
      schedule with ``.replace(value_dtype=vd)``, against the same
      schedule at f32 within LOWPREC_TOL, and its error within 1 % of
      the storage's alone (the plain path over the rounded values and B):
      where the storage alone exceeds LOWPREC_TOL (e4m3 flushes values
      below 2^-10 to 0), that error is printed and the kernels are held
      to it.  Twice on one CSR instance (the value cast is memoized: a
      served matrix is cast once); then one training
      step under bf16 against the f32 step (LOWPREC_GRAD_TOL).  The
      launch counts are zeroed just before and read just after these;
    - EB (auto schedules at N = 256 with bias and relu, N = 40, and the
      skew layout under 'parallel') and RB (roadnet) on each storage type
      against their plain versions per element under K_TERMS on a
      zero-mean B (narrow inputs upcast exactly: the f32 bound holds);
    - the fp16 and e4m3 epilogue stores on EB, RB and the grouped matmul
      against their plain versions, with outputs above 448 (e4m3 NaN);
    - int8 codes and scales made on the card against the CPU's, bit for
      bit, both calibrations, both graphs;
    - ``predict_spmm_arg_bytes`` against the bytes the EB runner feeds
      (``tune.make_eb_runner``) on the social graph at N = 256, each
      storage type;
    - EB (kernel and finishing launch apart) and RB at N = 256 and 40 at
      each storage type beside f32, CUDA events, with the bytes bound of
      ``predict_spmm_traffic_bytes`` at the HBM rate;
    - ``tune_schedule`` with the dtype axis on both graphs at N = 256
      (bias and relu), a cache in a temporary directory: the parity of
      each dtype against its budget, the points measured, the pick, a
      replay through ``spmm(schedule="tune")`` measuring nothing and held
      per element against the plain version, and the pick against its
      f32 twin re-timed in turns.  Its launches count apart.
    """
    import os
    import tempfile
    import warnings

    import torch
    import torch.nn.functional as F
    from repro_torch import tune
    from repro_torch.core import Epilogue, Schedule
    from repro_torch.core.dtypes import (Fp8Fallback, cast, operand_dtype,
                                         storage_dtype)
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import spmm_eb, spmm_rb
    from repro_torch.roofline import (predict_spmm_arg_bytes,
                                      predict_spmm_traffic_bytes)
    from repro_torch.sparse import CSR, matrix_stats, quantize_csr, spmm
    from repro_torch.tune import (make_eb_runner, make_runner, search,
                                  tune_schedule)

    t_phase = time.perf_counter()
    dev = x.device
    checker = Checker(("spmm_eb", "spmm_rb", "epilogue", "grouped_matmul"))
    relu, relu_b = Epilogue("relu"), Epilogue("relu", bias=True)
    stats = {name: matrix_stats(adj) for name, (adj, _) in graphs.items()}

    def sched_of(name, n, vd):
        served = graphs[name][1]
        s = (Schedule.auto(stats[name], n) if served == "auto" else served)
        return s.replace(value_dtype=vd)

    def forward(name, model, vd, adj=None):
        adj = graphs[name][0] if adj is None else adj
        h = spmm(adj, x @ model.w1, sched_of(name, HIDDEN, vd),
                 bias=model.b1, epilogue=relu, device=dev)
        return spmm(adj, h @ model.w2, sched_of(name, N_CLASS, vd),
                    device=dev)

    def forward_plain(name, model, vd):
        """The forward on the plain path (``impl="ref"``) over the values
        and B rounded to ``vd``'s storage (int8: dequantized), summed in
        f32: what the storage alone does to the output."""
        adj = graphs[name][0]
        if vd is not None:
            adj = (adj.quantized() if vd == "int8"
                   else adj.astype(storage_dtype(vd, dev)))
        op = torch.float32 if vd is None else operand_dtype(vd, dev)
        h = spmm(adj, cast(x @ model.w1, op), bias=model.b1, epilogue=relu,
                 impl="ref", device=dev)
        return spmm(adj, cast(h @ model.w2, op), impl="ref", device=dev)

    out = {"served": {}, "grad": {}, "times": {}, "tune": {}}
    with warnings.catch_warnings():
        warnings.simplefilter("error", Fp8Fallback)  # no fallback here
        for c in counters.values():
            c.launches = 0
        # served forwards, then one training step under bf16
        for name, model in models.items():
            adj = graphs[name][0]
            with torch.no_grad():
                want = forward(name, model, None)
                plain32 = forward_plain(name, model, None)
                for vd in LOWPREC_DTYPES:
                    outs, memo = [], []
                    for _ in range(2):
                        outs.append(forward(name, model, vd))
                        memo.append(sorted(
                            (str(k), id(v[1])) for k, v in
                            adj.__dict__.get("_convcache", {}).items()
                            if k[0] in ("vals_astype", "quantized")))
                    torch.cuda.synchronize()
                    err = rel_l2(outs[-1], want)
                    storage = rel_l2(forward_plain(name, model, vd), plain32)
                    same = bool(torch.equal(outs[0], outs[1]))
                    out["served"][(name, vd)] = (err, storage)
                    # the kernels add nothing to the storage's error; that
                    # error is within the reference's TOL unless the
                    # storage alone exceeds it (values below the type's
                    # smallest subnormal flush to 0)
                    within = (err <= LOWPREC_TOL[vd]
                              or storage > LOWPREC_TOL[vd])
                    ok = (within and abs(err - storage) <= 0.01 * storage
                          + 1e-5 and same and memo[0] and memo[0] == memo[1]
                          and outs[-1].shape == want.shape)
                    print(f"lowprec serve {name} {vd}: "
                          f"{sched_of(name, HIDDEN, vd)}; relative L2 "
                          f"{err:.3e} against f32 (tol {LOWPREC_TOL[vd]:.1e}"
                          f"); the storage alone (plain path) {storage:.3e}"
                          + (" exceeds the tol" if storage > LOWPREC_TOL[vd]
                             else "")
                          + f"; two requests bit for bit {same}; cast memo "
                          f"kept {memo[0] == memo[1]} "
                          f"{'ok' if ok else 'FAIL'}", flush=True)
                    if not ok:
                        fail(f"lowprec serve {name} {vd}")
                labels = want.argmax(1)
            grads = {}
            for vd in (None, "bfloat16"):
                leaves = [t.detach().clone().requires_grad_() for t in
                          (model.w1, model.b1, model.w2, adj.vals)]
                m = types.SimpleNamespace(w1=leaves[0], b1=leaves[1],
                                          w2=leaves[2])
                a = CSR(adj.indptr, adj.indices, leaves[3], adj.shape)
                loss = F.cross_entropy(forward(name, m, vd, adj=a), labels)
                grads[vd] = torch.autograd.grad(loss, leaves)
            for pname, g, w in zip(("w1", "b1", "w2", "vals"),
                                   grads["bfloat16"], grads[None]):
                err = rel_l2(g, w)
                out["grad"][(name, pname)] = err
                print(f"lowprec train {name}: bf16 step d{pname} relative "
                      f"L2 {err:.3e} against the f32 step (tol "
                      f"{LOWPREC_GRAD_TOL:.0e})", flush=True)
                if not err <= LOWPREC_GRAD_TOL:
                    fail(f"lowprec train {name}: d{pname} under bf16")
            del grads
        torch.cuda.synchronize()
        out["counts"] = {n: k.launches for n, k in counters.items()}
        print(f"lowprec: launches of the served forwards and training "
              f"steps {out['counts']}", flush=True)

        with torch.no_grad():
            gen = torch.Generator(device="cpu").manual_seed(SEED + 11)

            def rand(*shape):
                return torch.randn(*shape, generator=gen).to(dev)

            n = N_NODES
            b_wide, b_narrow = rand(n, HIDDEN), rand(n, N_CLASS)
            bias = rand(HIDDEN)
            adj = graphs["social"][0]
            print("lowprec check: EB per element on the social graph",
                  flush=True)
            split = max(64, stats["social"]["row_quantiles"][-1][1])
            skew = Schedule("eb", nnz_tile=128, group_size=8,
                            strategy="parallel", split_threshold=split,
                            merge_threshold=0)
            for vd in LOWPREC_DTYPES:
                for s, b, ep, ops in (
                        (sched_of("social", HIDDEN, vd), b_wide, relu_b,
                         {"bias": bias}),
                        (sched_of("social", N_CLASS, vd), b_narrow,
                         Epilogue(), {}),
                        (skew.replace(value_dtype=vd), b_narrow,
                         Epilogue(), {})):
                    kernel, want, terms = plain_spmm(
                        adj, b, s.replace(epilogue=ep), ops.get("bias"))
                    a_s, scales, bq = stored(adj, b, vd)
                    g = a_s.grouped(s.nnz_tile, group_size=s.group_size,
                                    split_threshold=s.split_threshold,
                                    merge_threshold=s.merge_threshold)
                    got = spmm_eb.spmm_eb(
                        g.rows, g.cols, g.vals, bq, n_rows=n,
                        nnz_tile=s.nnz_tile, group_size=s.group_size,
                        strategy=s.strategy, heavy_tiles=g.heavy_tiles,
                        epilogue=ep, scales=scales, **ops)
                    checker.record_terms(
                        "spmm_eb" if ep.is_noop else "epilogue",
                        f"{vd} G={s.group_size} {s.strategy} heavy_tiles="
                        f"{g.heavy_tiles} {ep.tag or 'none'} N={b.shape[1]}",
                        got, want, terms)
            adj, rs = graphs["roadnet"]
            print("lowprec check: RB per element on the roadnet graph",
                  flush=True)
            for vd in LOWPREC_DTYPES:
                for b, ep, ops in ((b_wide, relu_b, {"bias": bias}),
                                   (b_narrow, Epilogue(), {})):
                    s = rs.replace(value_dtype=vd, epilogue=ep)
                    _, want, terms = plain_spmm(adj, b, s, ops.get("bias"))
                    a_s, scales, bq = stored(adj, b, vd)
                    e = a_s.ell(row_tile=rs.row_tile)
                    got = spmm_rb.spmm_rb(e.cols, e.vals, bq, n_rows=n,
                                          epilogue=ep, scales=scales, **ops)
                    checker.record_terms(
                        "spmm_rb", f"{vd} {ep.tag or 'none'} "
                        f"N={b.shape[1]}", got, want, terms)

            print("lowprec check: fp16 and e4m3 epilogue stores (B x 512: "
                  "e4m3 overflows to NaN above 464)", flush=True)
            big = b_wide * 512
            for out_dtype in ("float16", "float8_e4m3fn"):
                ep = Epilogue("relu", bias=True, out_dtype=out_dtype)
                for name, s in (("social", sched_of("social", HIDDEN, None)),
                                ("roadnet", rs)):
                    adj = graphs[name][0]
                    kernel, want, terms = plain_spmm(
                        adj, big, s.replace(epilogue=ep), bias)
                    if s.kernel == "eb":
                        g = adj.grouped(s.nnz_tile)
                        got = spmm_eb.spmm_eb(
                            g.rows, g.cols, g.vals, big, n_rows=n,
                            nnz_tile=s.nnz_tile, group_size=s.group_size,
                            strategy=s.strategy, epilogue=ep, bias=bias)
                    else:
                        e = adj.ell(row_tile=s.row_tile)
                        got = spmm_rb.spmm_rb(e.cols, e.vals, big, n_rows=n,
                                              epilogue=ep, bias=bias)
                    nans = int(torch.isnan(want.float()).sum())
                    checker.record_terms(
                        "epilogue" if kernel == "spmm_eb" else kernel,
                        f"{name} {out_dtype} out ({nans} NaN)", got, want,
                        terms)
                    if out_dtype == "float8_e4m3fn" and not nans:
                        checker.failures.append(f"{name} e4m3: no output "
                                                "above 464")
                # the grouped matmul on both of its routes
                for dt, f in ((torch.bfloat16, 256), (torch.float32, 40)):
                    gg = torch.Generator().manual_seed(SEED + 12)
                    xx = (torch.randn(320, 512, generator=gg) * 256).to(
                        dt).to(dev)
                    ww = (torch.randn(16, 512, f, generator=gg)
                          * 512 ** -0.5).to(dt).to(dev)
                    te = torch.randint(0, 16, (32,), generator=gg,
                                       dtype=torch.int32).to(dev)
                    bb = torch.randn(16, f, generator=gg).to(dev)
                    ep_g = Epilogue("silu", bias=True, out_dtype=out_dtype)
                    kw = dict(bias=bb, epilogue=ep_g, token_tile=10)
                    got = gm.grouped_matmul(xx, te, ww, f_tile=min(f, 128),
                                            **kw)
                    want = gm.grouped_matmul_plain(xx, te, ww, **kw)
                    terms = gm.grouped_matmul_plain(
                        xx.abs(), te, ww.abs(), token_tile=10) + bb.abs()[
                            te.long()].repeat_interleave(10, 0)
                    nans = int(torch.isnan(want.float()).sum())
                    checker.record_terms(
                        "grouped_matmul", f"{dt} x {f} {out_dtype} out "
                        f"({nans} NaN)", got, want, terms)

            print("lowprec check: int8 codes and scales, card against CPU",
                  flush=True)
            for name, (adj, _) in graphs.items():
                cpu = CSR(adj.indptr.cpu(), adj.indices.cpu(),
                          adj.vals.cpu(), adj.shape)
                for method in ("absmax", "percentile"):
                    qd, qc = (quantize_csr(a, method=method)
                              for a in (adj, cpu))
                    same = bool(torch.equal(qd.csr.vals.cpu(),
                                            qc.csr.vals)) and bool(
                        torch.equal(qd.scales.cpu().view(torch.int32),
                                    qc.scales.view(torch.int32)))
                    print(f"  {name} {method}: {adj.nnz} codes, "
                          f"{adj.shape[0]} scales; card and CPU bit for "
                          f"bit {same}", flush=True)
                    if not same:
                        checker.failures.append(f"int8 {name} {method}")
            checker.done()

            print("lowprec check: predict_spmm_arg_bytes against the bytes "
                  "the EB runner feeds", flush=True)
            adj = graphs["social"][0]
            for vd in (None,) + LOWPREC_DTYPES:
                _, (feed, bb) = make_eb_runner(adj, HIDDEN, group_size=32,
                                               strategy="segment",
                                               value_dtype=vd)
                scales = None
                if vd == "int8":
                    feed, scales = feed.csr.grouped(256, group_size=32), \
                        feed.scales
                fed = sum(t.nbytes for t in (feed.rows, feed.cols, feed.vals,
                                             bb))
                fed += 0 if scales is None else scales.nbytes
                want = predict_spmm_arg_bytes(
                    feed.nnz_padded, adj.shape[1], HIDDEN, value_dtype=vd,
                    scales_rows=0 if scales is None else n)
                print(f"  {vd or 'float32'}: fed {fed} bytes, predicted "
                      f"{want} {'ok' if fed == want else 'FAIL'}",
                      flush=True)
                if fed != want:
                    fail(f"lowprec: predict_spmm_arg_bytes at {vd}")
                del feed, bb

            print("lowprec times (CUDA events; bound = "
                  "predict_spmm_traffic_bytes at 3.35 TB/s)", flush=True)
            for vd in (None,) + LOWPREC_DTYPES:
                row = {}
                adj = graphs["social"][0]
                for b, ep, ops in ((b_wide, relu_b, {"bias": bias}),
                                   (b_narrow, Epilogue(), {})):
                    s = sched_of("social", b.shape[1], vd)
                    a_s, scales, bq = stored(adj, b, vd)
                    g = a_s.grouped(s.nnz_tile)
                    kw = dict(n_rows=n, nnz_tile=s.nnz_tile,
                              group_size=s.group_size, strategy=s.strategy,
                              epilogue=ep, scales=scales, **ops)
                    split_ms = launch_ms(lambda: spmm_eb.spmm_eb(
                        g.rows, g.cols, g.vals, bq, **kw))
                    nbytes = predict_spmm_traffic_bytes(
                        g.nnz_padded, n, b.shape[1], value_dtype=vd,
                        scales_rows=n if scales is not None else 0)
                    row[("eb", b.shape[1])] = (split_ms["spmm_eb"],
                                               split_ms["spmm_eb_finish"],
                                               nbytes)
                adj, rs = graphs["roadnet"]
                for b, ep, ops in ((b_wide, relu_b, {"bias": bias}),
                                   (b_narrow, Epilogue(), {})):
                    a_s, scales, bq = stored(adj, b, vd)
                    e = a_s.ell(row_tile=rs.row_tile)
                    ms = cuda_ms(lambda: spmm_rb.spmm_rb(
                        e.cols, e.vals, bq, n_rows=n, epilogue=ep,
                        scales=scales, **ops))
                    nbytes = predict_spmm_traffic_bytes(
                        e.cols.numel(), n, b.shape[1], value_dtype=vd,
                        scales_rows=n if scales is not None else 0)
                    row[("rb", b.shape[1])] = (ms, None, nbytes)
                out["times"][vd or "float32"] = row
                print(f"lowprec time {vd or 'float32'}: " + "; ".join(
                    f"{k.upper()} N={w} {ms:.4f} ms"
                    + (f" (+ finish {fin:.4f} ms)" if fin is not None
                       else "")
                    + f" bound {nb / HBM_BYTES_PER_S * 1e3:.4f} ms "
                    f"({nb} bytes)"
                    for (k, w), (ms, fin, nb) in row.items()), flush=True)

        # the tuner's dtype axis
        saved_env = os.environ.get("REPRO_TUNE_CACHE")
        tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_lowprec_")
        os.environ["REPRO_TUNE_CACHE"] = str(Path(tmp.name) / "tune.json")
        tune.set_default_cache(None)
        for c in counters.values():
            c.launches = 0
        tcheck = Checker(("spmm_eb", "spmm_rb"))
        with MeasureCount() as mc, torch.no_grad():
            for name, model in models.items():
                adj = graphs[name][0]
                b = (x @ model.w1).contiguous()
                budget = 0.05
                parity = {vd: search._dtype_parity_error(adj, HIDDEN, vd)
                          for vd in LOWPREC_DTYPES}
                print(f"lowprec tune {name} N={HIDDEN}: parity against f32 "
                      + ", ".join(f"{vd} {e:.3e}" for vd, e in
                                  parity.items())
                      + f" (budget {budget}); admitted "
                      f"{[vd for vd, e in parity.items() if e <= budget]}",
                      flush=True)
                t0 = time.perf_counter()
                res = tune_schedule(adj, HIDDEN, epilogue=relu_b,
                                    value_dtypes=LOWPREC_DTYPES,
                                    error_budget=budget)
                took = time.perf_counter() - t0
                print_points(f"lowprec {name} N={HIDDEN}", res)
                before = mc.n
                b_rand = torch.randn(b.shape, generator=torch.Generator(
                    device=dev).manual_seed(SEED + 13), device=dev)
                got = spmm(adj, b_rand, schedule="tune", bias=model.b1,
                           epilogue=relu, device=dev)
                if mc.n != before:
                    fail(f"lowprec tune {name}: spmm(schedule='tune') "
                         f"measured {mc.n - before} points")
                kernel, want, terms = plain_spmm(adj, b_rand, res.schedule,
                                                 model.b1)
                tcheck.record_terms(kernel, f"lowprec tuned {name} "
                                    f"{res.schedule.value_dtype}", got, want,
                                    terms)
                f32_ms, tuned_ms = retime_in_turns(
                    *make_runner(adj, HIDDEN,
                                 res.schedule.replace(value_dtype=None)),
                    *make_runner(adj, HIDDEN, res.schedule))
                out["tune"][name] = (res, f32_ms, tuned_ms)
                print(f"lowprec tune {name} N={HIDDEN}: pick {res.schedule} "
                      f"({res.n_measurements} measurements, {took:.2f} s); "
                      f"replayed with 0 measurements; re-timed in turns: "
                      f"pick {tuned_ms:.4f} ms, its f32 twin {f32_ms:.4f} "
                      f"ms, ratio {tuned_ms / f32_ms:.4f}", flush=True)
                del b, b_rand, got, want, terms
        tcheck.done()
        for k, v in tcheck.worst.items():
            checker.worst[k] = max(checker.worst[k], v)
        out["tune_counts"] = {n: k.launches for n, k in counters.items()}
        if saved_env is None:
            os.environ.pop("REPRO_TUNE_CACHE", None)
        else:
            os.environ["REPRO_TUNE_CACHE"] = saved_env
        tune.set_default_cache(None)
        tmp.cleanup()
    out["worst"] = checker.worst
    out["s"] = time.perf_counter() - t_phase
    print(f"lowprec: phase {out['s']:.1f} s; tuner launches "
          f"{out['tune_counts']}", flush=True)
    torch.cuda.empty_cache()
    return out


def moe_model(dev):
    """Qwen3-MoE at full width cut to MOE_LAYERS layers, its parameters
    drawn on the card from seed SEED, and the model API of both MoE paths
    (kernel, einsum) over the same parameters."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import get_model

    cfg = get_config(MOE_ARCH).scaled(n_layers=MOE_LAYERS)
    api = get_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SEED),
                      device=dev)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"moe_serve: {cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.d_head} over {cfg.n_kv_heads} kv, "
          f"{cfg.n_experts} experts top-{cfg.experts_per_token} of width "
          f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype}), "
          f"{cfg.n_layers} of 94 layers; {n_bytes / 1e9:.2f} GB of weights "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    einsum = get_model(cfg.scaled(moe_kernel_dispatch=False))
    return cfg, api, einsum, params


def gmm_role_cases(moe, gen, label, tile, cap_pad):
    """The three grouped-matmul launches of ``_expert_ffn`` at ``(tile,
    cap_pad)`` on one layer's experts, each ``(label, x, tile_experts,
    weights, epilogue, tile)``: the gate (SiLU fused), up and down
    projections over E x cap_pad expert-sorted rows, ``cap_pad // tile``
    tiles an expert; x drawn from ``gen`` in bf16."""
    import torch
    from repro_torch.core import Epilogue

    e, d, f = moe["wg"].shape
    dev = moe["wg"].device
    te = torch.arange(e, dtype=torch.int32, device=dev).repeat_interleave(
        cap_pad // tile)
    xd, xf = (torch.randn(e * cap_pad, n, generator=gen, device=dev).to(
        torch.bfloat16) for n in (d, f))
    return [(f"{label} gate+silu", xd, te, moe["wg"], Epilogue("silu"), tile),
            (f"{label} up", xd, te, moe["wi"], Epilogue(), tile),
            (f"{label} down", xf, te, moe["wo"], Epilogue(), tile)]


def moe_kernel_cases(cfg, params, dev):
    """The grouped-matmul launches of layer 0 at the serving shapes
    (:func:`gmm_role_cases`) at decode (MOE_SLOTS tokens) and at a
    MOE_PROMPT-token prefill, with the capacity ``models.moe`` gives
    them, one tile an expert."""
    import torch
    from repro_torch.models.moe import _capacity

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    cases = []
    for phase, tokens in (("decode", MOE_SLOTS), ("prefill", MOE_PROMPT)):
        tile = min(_capacity(cfg, tokens), 128)
        cases += gmm_role_cases(params["layers"][0]["moe"], gen, phase, tile,
                                tile)
    return cases


def plain_gmm(x, te, w, *, token_tile, **kw):
    """``grouped_matmul_plain`` over at most GMM_PLAIN_TILES tiles at a
    time: it gathers each tile's expert weights in f32 (1.6 GB a 128
    tiles at the MoE width), and the capacity-padded layouts hold up to
    four tiles an expert."""
    import torch
    from repro_torch.kernels import grouped_matmul as gm

    rows = GMM_PLAIN_TILES * token_tile
    return torch.cat([
        gm.grouped_matmul_plain(x[i:i + rows], te[i // token_tile:
                                                  (i + rows) // token_tile],
                                w, token_tile=token_tile, **kw)
        for i in range(0, x.shape[0], rows)])


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
                       plain_gmm(x, te, w, **kw))
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


def layer0_moe_input(cfg, params, prompts, dev):
    """The tokens that reach layer 0's MoE when the prompts are prefilled
    as one batch: the embedding rows through layer 0's attention block and
    its second norm, (MOE_REQUESTS x MOE_PROMPT, d_model) in bf16."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tr

    tokens = torch.as_tensor(np.stack(prompts), dtype=torch.int64,
                             device=dev)
    p0 = params["layers"][0]
    x = tr._embed_input(cfg, params, tokens)
    positions = torch.arange(x.shape[1], device=dev)
    a, _ = tr.attn_block(cfg, p0["attn"], tr.apply_norm(cfg, p0["ln1"], x),
                         positions)
    h = tr.apply_norm(cfg, p0["ln2"], x + a)
    return h.reshape(-1, cfg.d_model)


def moe_tune(cfg, api, einsum, params, graphs, x, model, dev, counters):
    """The MoE dispatch tuner and the engine's sparse side channel on the
    card (``ServeEngine(tuner_cache=...)`` over a cache in a temporary
    directory), on the ``moe_serve`` model.  The workload is the eight
    prompts prefilled as one batch, MOE_REQUESTS x MOE_PROMPT tokens;
    ``prepare_moe`` tunes three expert histograms: the balanced one
    (assumed, no shrink), layer 0's router on the batch's hidden states
    (observed) and ``skewed_expert_lengths``.  Per histogram it prints
    the points measured, the pick and the default re-timed in turns on
    layer 0's weights, and the dropped tokens of both; it fails where a
    second ``prepare_moe`` or ``moe_dispatch_schedule`` measures, where
    the pick drops more tokens than the default, or where a measured
    launch leaves route ``mma``.  Then the grouped-matmul kernel is held
    against its plain version at every (tile, cap_pad) measured, in its
    three roles (and timed against its bytes bound), ``apply_moe`` at the
    observed pick on the kernel path against the einsum path
    (LOGIT_REL_L2), and ``prepare_sparse`` / ``spmm`` on both graphs at
    N = 256 and 40 against f64 (K_TERMS), a second ``prepare_sparse``
    replaying.  The launch counts are zeroed just before and read just
    after."""
    import os
    import tempfile

    import torch
    from repro_torch import tune
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import ServeEngine
    from repro_torch.tune import moe as tm

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_moe_tune_")
    os.environ["REPRO_TUNE_CACHE"] = str(Path(tmp.name) / "tune.json")
    tune.set_default_cache(None)
    cache = tune.ScheduleCache(Path(tmp.name) / "engine.json")
    engine = ServeEngine(api, params, slots=MOE_SLOTS, max_len=MOE_MAX_LEN,
                         device=dev, tuner_cache=cache)
    t_tokens = MOE_REQUESTS * MOE_PROMPT
    d, f, dtype = cfg.d_model, cfg.moe_d_ff, str(cfg.param_dtype)
    layer0 = params["layers"][0]["moe"]
    weights = (layer0["wg"], layer0["wi"], layer0["wo"])
    for c in counters.values():
        c.launches = 0
    out = {"hists": {}, "programs": {}}
    with MeasureCount() as mc:
        hidden = layer0_moe_input(cfg, params, moe_prompts(cfg), dev)
        gates, _ = moe_mod._route(cfg, hidden, layer0["router"])
        observed = moe_mod.expert_lengths_from_gates(gates)  # on the card
        skewed = moe_mod.skewed_expert_lengths(cfg, t_tokens)
        hists = (("balanced (assumed)", None,
                  moe_mod.balanced_expert_lengths(cfg, t_tokens)),
                 ("observed (layer 0)", observed, observed.cpu().numpy()),
                 ("skewed", skewed, skewed))
        programs = set()
        default = moe_mod.default_dispatch(cfg)
        for label, lengths, hist in hists:
            routes = dict(gm.ROUTE_LAUNCHES)
            before, t0 = mc.n, time.perf_counter()
            pick = engine.prepare_moe(cfg, t_tokens, lengths)
            took, n_meas = time.perf_counter() - t0, mc.n - before
            taken = routes_taken(routes)
            if set(taken) != {"mma"}:
                fail(f"moe_tune {label}: the tuner's launches took routes "
                     f"{taken}, not only the tensor cores")
            key = tm.moe_cache_key(hist, d, f, dtype,
                                   shrink=lengths is not None,
                                   max_tokens=t_tokens)
            rec = cache.get(key)
            by_key = {tm.moe_schedule_key(s): s
                      for s in tm.candidate_moe_schedules(
                          hist, default=default,
                          allow_capacity_shrink=lengths is not None,
                          max_tokens=t_tokens)}
            points = [(k, tm.moe_program(hist, by_key[k], t_tokens), us)
                      for k, us in rec.measured.items()]
            programs.update(p for _, p, _ in points)
            print(f"moe_tune {label}: {int(hist.sum())} routed assignments "
                  f"over {hist.shape[0]} experts (max {int(hist.max())}, "
                  f"min {int(hist.min())}); {n_meas} measurements in "
                  f"{took:.2f} s; key {key}", flush=True)
            for k, (tile, cap_pad), us in points:
                print(f"  {k:36s} tile {tile:3d} cap_pad {cap_pad:3d} "
                      f"{us / 1e3:.4f} ms", flush=True)
            before = mc.n
            again = engine.prepare_moe(cfg, t_tokens, lengths)
            resolved = engine.moe_dispatch_schedule(cfg, t_tokens, lengths)
            fresh = ServeEngine(api, params, slots=1, max_len=MOE_MAX_LEN,
                                device=dev, tuner_cache=cache)
            fresh_pick = fresh.moe_dispatch_schedule(cfg, t_tokens, lengths)
            if mc.n != before or not again == resolved == fresh_pick == pick:
                fail(f"moe_tune {label}: the replays measured "
                     f"{mc.n - before} points or resolved another schedule "
                     f"({again}, {resolved}, {fresh_pick} against {pick})")
            drops = {name: tm.dropped_tokens(hist, tm.moe_capacity(
                hist, s.capacity_factor, max_tokens=t_tokens))
                for name, s in (("pick", pick), ("default", default))}
            if drops["pick"] > drops["default"]:
                fail(f"moe_tune {label}: the pick drops {drops['pick']} "
                     f"tokens, the default {drops['default']}")
            runners = [tm.make_moe_runner(hist, d, f, s, dtype, t_tokens,
                                          device=dev, weights=weights)
                       for s in (pick, default)]
            tuned_ms, default_ms = retime_in_turns(*runners[0], *runners[1])
            del runners
            ratio = tuned_ms / default_ms
            print(f"moe_tune {label}: pick {tm.moe_schedule_key(pick)} "
                  f"(tile, cap_pad) {tm.moe_program(hist, pick, t_tokens)}, "
                  f"{rec.us_per_call / 1e3:.4f} ms measured; default "
                  f"{tm.moe_schedule_key(default)} "
                  f"{tm.moe_program(hist, default, t_tokens)}; re-timed in "
                  f"turns on layer 0's weights ({TUNE_WINDOWS} windows of "
                  f"10): tuned {tuned_ms:.4f} ms, default {default_ms:.4f} "
                  f"ms, ratio {ratio:.4f}; dropped tokens pick "
                  f"{drops['pick']}, default {drops['default']}; replays 0 "
                  "measurements", flush=True)
            out["hists"][label] = {
                "n": n_meas, "s": took, "points": points, "pick": pick,
                "tuned_ms": tuned_ms, "default_ms": default_ms,
                "ratio": ratio, "drops": drops}
        out["measurements"] = mc.n
        torch.cuda.empty_cache()

        # the kernel at every program the tuner measured, in its three roles
        gen = torch.Generator(device=dev).manual_seed(SEED + 10)
        worst = 0.0
        for tile, cap_pad in sorted(programs):
            cases = gmm_role_cases(layer0, gen, f"moe_tune ({tile}, "
                                   f"{cap_pad})", tile, cap_pad)
            worst = max(worst, check_grouped_matmul(cases)["grouped_matmul"])
            row = time_grouped_matmul(cases, row_prefix="")
            b_ms, by = bound(row["bytes"], row["flops"], BF16_FLOP_PER_S)
            print(f"moe_tune program (tile {tile}, cap_pad {cap_pad}): three "
                  f"launches {row['ms']:.4f} ms (bound {b_ms:.4f} ms by {by},"
                  f" {row['bytes']} bytes), plain {row['plain_ms']:.4f} ms, "
                  f"torch.bmm {row['library_ms']:.4f} ms", flush=True)
            out["programs"][(tile, cap_pad)] = {**row, "bound_ms": b_ms}
            del cases
            torch.cuda.empty_cache()
        out["worst"] = worst

        # the slice as a whole at the observed pick
        pick = out["hists"]["observed (layer 0)"]["pick"]
        before = gm.KERNEL.launches
        got, _ = moe_mod.apply_moe(cfg, layer0, hidden, dispatch=pick,
                                   device=dev)
        n_launch = gm.KERNEL.launches - before
        want, _ = moe_mod.apply_moe(cfg.scaled(moe_kernel_dispatch=False),
                                    layer0, hidden, dispatch=pick,
                                    device=dev)
        err = rel_l2(got, want)
        print(f"moe_tune apply_moe {tuple(hidden.shape)} {hidden.dtype} at "
              f"the observed pick: {n_launch} grouped-matmul launches, kernel "
              f"path against the einsum path relative L2 {err:.3e} (tol "
              f"{LOGIT_REL_L2:.3e})", flush=True)
        if n_launch != 3 or not err <= LOGIT_REL_L2:
            fail("moe_tune: apply_moe at the tuned dispatch disagrees with "
                 "the einsum path")
        out["apply_moe_rel_l2"] = err
        del hidden, gates, got, want

        # the sparse side channel: tuned ahead, served with no measurement
        from repro_torch.core import Epilogue
        from repro_torch.sparse import spmm

        out["spmm"] = {}
        for name, (adj, _) in graphs.items():
            xw = (x @ model.w1).contiguous()
            h = spmm(adj, xw, bias=model.b1, epilogue=Epilogue("relu"),
                     device=dev)
            for n, b in ((HIDDEN, xw), (N_CLASS, (h @ model.w2).contiguous())):
                before, t0 = mc.n, time.perf_counter()
                sched = engine.prepare_sparse(adj, n, value_dtypes=())
                took, n_meas = time.perf_counter() - t0, mc.n - before
                before = mc.n
                again = engine.prepare_sparse(adj, n, value_dtypes=())
                got = engine.spmm(adj, b)
                if mc.n != before or again != sched:
                    fail(f"moe_tune spmm {name} N={n}: the second "
                         f"prepare_sparse or spmm measured {mc.n - before} "
                         "points instead of replaying")
                k_kernel, k_plain = f64_k(adj, b, sched, None, got)
                print(f"moe_tune spmm {name} N={n}: prepare_sparse "
                      f"{n_meas} measurements in {took:.2f} s, pick {sched};"
                      f" engine.spmm against the f64 result: kernel k "
                      f"{k_kernel:.3f} (tol K_TERMS {K_TERMS}), plain "
                      f"version k {k_plain:.3f} (printed only); replays 0 "
                      "measurements", flush=True)
                if not k_kernel <= K_TERMS:
                    fail(f"moe_tune spmm {name} N={n}: engine.spmm is "
                         f"k {k_kernel:.3f} from the f64 result")
                out["spmm"][(name, n)] = {"sched": sched, "k": k_kernel,
                                          "n": n_meas}
                del got
            del xw, h
    torch.cuda.synchronize()
    out["counts"] = {n: c.launches for n, c in counters.items()}
    out["s"] = time.perf_counter() - t_phase
    print(f"moe_tune: {out['measurements']} dispatch measurements, phase "
          f"{out['s']:.1f} s; launches {out['counts']}", flush=True)
    tune.set_default_cache(None)
    del os.environ["REPRO_TUNE_CACHE"]
    tmp.cleanup()
    return out


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


def time_grouped_matmul(cases, row_prefix="decode"):
    """Row 7: the three decode-shape launches of one layer (gate with
    SiLU, up, down; the cases whose label starts with ``row_prefix``),
    the kernel's median ms over 5 ms windows, its plain version's ms and
    the library yardstick's, ``torch.bmm`` on the (E, cap_pad, D) x
    (E, D, F) bf16 layout that ``_expert_ffn`` builds (which the port
    never calls), summed; bytes: x, each touched expert's weights and the
    output once; operations at the bf16 peak.  The other cases are timed
    and printed beside them."""
    import torch
    from repro_torch.kernels import grouped_matmul as gm

    row = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
           "flops": 0, "flop_per_s": BF16_FLOP_PER_S}
    for label, x, te, w, ep, tile in cases:
        e, d, f = w.shape
        kw = dict(epilogue=ep, token_tile=tile)
        ms = cuda_ms_median(lambda: gm.grouped_matmul(
            x, te, w, f_tile=f, d_tile=d, **kw))
        plain = cuda_ms(lambda: plain_gmm(x, te, w, **kw), 3, 1)
        xb = x.reshape(e, -1, d)
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
        if not label.startswith(row_prefix):
            continue  # the row holds one layer's decode launches
        row["ms"] += ms
        row["plain_ms"] += plain
        row["library_ms"] += lib
        row["bytes"] += nbytes
        row["flops"] += 2 * x.shape[0] * d * f
        torch.cuda.empty_cache()
    return row


def as_type(t, name):
    """``t`` stored as the named type, rounded as the reference rounds
    (``core.dtypes.cast``: e4m3 NaN above 464)."""
    import torch
    from repro_torch.core.dtypes import cast

    return cast(t, getattr(torch, name))


def launch_spy(kernel):
    """Spy on a CudaKernel's launches: (the list that receives each
    launch's arguments, the device index and stream left out; a function
    that ends the spying)."""
    seen = []
    launch = kernel.launch

    def spy(device, *args):
        seen.append(args)
        return launch(device, *args)

    kernel.launch = spy
    return seen, lambda: delattr(kernel, "launch")


def narrow_sddmm(graphs, checker, counters):
    """SDDMM at every NARROW_SDDMM_PAIRS pair on both graphs at D = 40
    and 256, per element within K_TERMS of the plain version on the same
    stored values, each launch handed the operands themselves; timed
    beside the f32 kernel and the old route (a copy to f32, then the f32
    kernel).  Then one training step under bf16 storage with B held in
    bf16 (counts zeroed just before, read just after): its dvals runs the
    (f32 dz, bf16 B) pair, against the same step with B in f32.
    Returns (timing rows, the step's counts)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import Schedule
    from repro_torch.kernels import sddmm
    from repro_torch.kernels.common import DTYPE_CODES
    from repro_torch.sparse import CSR, matrix_stats, spmm

    gen = torch.Generator(device="cpu").manual_seed(SEED + 13)
    rows_out = []
    for name, (adj, _) in graphs.items():
        dev, n, nnz = adj.device, adj.shape[0], adj.nnz
        coo = adj.tocoo()
        for width in (N_CLASS, HIDDEN):
            dz, b = (torch.randn(n, width, generator=gen).to(dev)
                     for _ in range(2))
            f32_ms = cuda_ms(lambda: sddmm.sddmm(coo.rows, coo.cols, dz, b))
            for at, bt in NARROW_SDDMM_PAIRS:
                a_, b_ = as_type(dz, at), as_type(b, bt)
                seen, restore = launch_spy(sddmm.KERNEL)
                try:
                    got = sddmm.sddmm(coo.rows, coo.cols, a_, b_)
                finally:
                    restore()
                if (len(seen) != 1 or seen[0][2] != a_.data_ptr()
                        or seen[0][3] != b_.data_ptr()
                        or seen[0][-2:] != (DTYPE_CODES[a_.dtype],
                                            DTYPE_CODES[b_.dtype])):
                    checker.failures.append(
                        f"sddmm {name} {at} x {bt}: the kernel was not "
                        "handed the stored operands")
                checker.record_terms(
                    "sddmm", f"{name} D={width} A {at} B {bt}", got,
                    sddmm.sddmm_plain(coo.rows, coo.cols, a_, b_),
                    sddmm.sddmm_plain(coo.rows, coo.cols, a_.float().abs(),
                                      b_.float().abs()))
                ms = cuda_ms(lambda: sddmm.sddmm(coo.rows, coo.cols, a_, b_))
                old = cuda_ms(lambda: sddmm.sddmm(coo.rows, coo.cols,
                                                  a_.float(), b_.float()))
                nbytes = nnz * 12 + n * width * (a_.element_size()
                                                 + b_.element_size())
                rows_out.append((f"SDDMM {name} D={width}", f"{at} x {bt}",
                                 ms, bound(nbytes, 2 * nnz * width)[0],
                                 f32_ms, old))
            del dz, b, a_, b_, got
    torch.cuda.empty_cache()

    adj = graphs["social"][0]
    sched = Schedule.auto(matrix_stats(adj), HIDDEN).replace(
        value_dtype="bfloat16")
    labels = torch.randint(0, HIDDEN, (adj.shape[0],), generator=gen).to(
        adj.device)
    b0 = torch.randn(adj.shape[1], HIDDEN, generator=gen).to(adj.device)
    grads = {}
    for b_type in ("bfloat16", "float32"):
        vals = adj.vals.detach().clone().requires_grad_()
        b = as_type(b0, "bfloat16").to(getattr(torch, b_type))
        b.requires_grad_()
        a = CSR(adj.indptr, adj.indices, vals, adj.shape)
        if b_type == "bfloat16":
            for c in counters.values():
                c.launches = 0
            seen, restore = launch_spy(sddmm.KERNEL)
        try:
            loss = F.cross_entropy(spmm(a, b, sched, device=adj.device),
                                   labels)
            grads[b_type] = torch.autograd.grad(loss, (vals, b))
        finally:
            if b_type == "bfloat16":
                restore()
        if b_type == "bfloat16":
            torch.cuda.synchronize()
            counts = {k: c.launches for k, c in counters.items()}
            pairs = [s[-2:] for s in seen]
    want_pair = (DTYPE_CODES[torch.float32], DTYPE_CODES[torch.bfloat16])
    dvals = rel_l2(grads["bfloat16"][0], grads["float32"][0])
    db = rel_l2(grads["bfloat16"][1].float(), grads["float32"][1].float())
    ok = pairs == [want_pair] and dvals <= GRAD_RTOL and db <= BF16_RTOL
    print(f"narrow train social: bf16 storage, B in bf16; SDDMM type codes "
          f"{pairs} (f32 dz, bf16 B: {want_pair}); dvals relative L2 "
          f"{dvals:.3e} against B in f32 (tol {GRAD_RTOL:.0e}), dB "
          f"{db:.3e} (bf16, tol {BF16_RTOL:.1e}); launches {counts} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("narrow train: the bf16 step's dvals")
    del grads, b0
    torch.cuda.empty_cache()
    return rows_out, counts


def compare_narrow(got, want, name):
    """(max |got - want|, tolerance text, within it) for gradients stored
    in a narrow type: one step of the type (OUT_STEP) of each value plus
    F32_TOL of the largest magnitude."""
    import torch

    g, w = got.detach().float(), want.detach().float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        return float("inf"), "finite, same shape", False
    rel, floor = OUT_STEP[name]
    tol = F32_TOL * max(1.0, float(w.abs().max()))
    err = (g - w).abs()
    return (float(err.max()), f"{rel:.0e}|ref| + {tol:.2e}",
            bool((err <= rel * w.abs() + floor + tol).all()))


def narrow_attention(graphs, checker, counters):
    """Graph attention (HEADS x HEAD_DIM) through ``sparse_attention`` at
    each NARROW_ATTN_DTYPES type on both graphs, forward and backward
    with the counts zeroed just before and read just after, against the
    plain path on the same stored values; the kernels at that type
    against their plain versions (the split rows' out and dQ bit for bit
    over two launches), handed q, k and v themselves; then one head at
    each WIDE_HEAD_DIMS width, f32 and bf16, on both graphs (social's hub
    row runs both the chunk split and the slabs).  Returns (timing rows,
    wide-head rows, the public paths' counts)."""
    import torch
    from repro_torch.kernels import fused_attention as fa
    from repro_torch.sparse import sparse_attention

    gen = torch.Generator(device="cpu").manual_seed(SEED + 14)
    rows_out, wide_out, runs = [], [], []
    for name, (adj, _) in graphs.items():
        dev = adj.device
        q32, k32, v32, cot = attention_operands(adj, gen, dev)
        kw = dict(scale=HEAD_DIM ** -0.5, bias=adj.vals)
        ip, cc = adj.indptr, adj.indices
        args32 = tuple(head_major(t) for t in (q32, k32, v32))
        do = head_major(cot)
        f32 = {"fwd": cuda_ms(lambda: fa.fused_sparse_attention(
            ip, cc, *args32, **kw), 5, 1)}
        _, m32, l32 = fa.fused_sparse_attention(ip, cc, *args32, **kw)
        f32["bwd"] = cuda_ms(lambda: fa.fused_sparse_attention_bwd(
            ip, cc, *args32, do, m32, l32, **kw), 5, 1)
        for dt in NARROW_ATTN_DTYPES:
            q, k, v = (as_type(t, dt).requires_grad_()
                       for t in (q32, k32, v32))
            for c in counters.values():
                c.launches = 0
            out = sparse_attention(adj, q, k, v, device=dev)
            grads = torch.autograd.grad(out, (q, k, v), cot)
            torch.cuda.synchronize()
            runs.append(({n: c.launches for n, c in counters.items()},
                         f"narrow attend {name} {dt}"))
            out_ref = sparse_attention(adj, q, k, v, impl="ref", device=dev)
            want = torch.autograd.grad(out_ref, (q, k, v), cot)
            for label, g, w in zip(("out", "dq", "dk", "dv"), (out,) + grads,
                                   (out_ref,) + want):
                err, tol, ok = (compare(g, w) if label == "out"
                                else compare_narrow(g, w, dt))
                print(f"narrow attend {name} {dt}: {label} {g.dtype} "
                      f"max_abs_err {err:.3e} tol {tol} against the plain "
                      f"path {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"narrow attend {name} {dt}: {label}")
            del out, grads, out_ref, want
            # the kernels at this type, against their plain versions
            args = tuple(head_major(t) for t in (q, k, v))
            seen, restore = launch_spy(fa.FWD_KERNEL)
            try:
                got = fa.fused_sparse_attention(ip, cc, *args, **kw)
            finally:
                restore()
            if any(s[3:6] != tuple(t.data_ptr() for t in args)
                   for s in seen):
                checker.failures.append(f"attention {name} {dt}: q, k, v "
                                        "copied before the launch")
            plain = fa.fused_sparse_attention_plain(ip, cc, *args, **kw)
            for label, g, w in zip(("out", "m", "l"), got, plain):
                checker.record("fused_attention_fwd", f"{name} {dt} {label}",
                               g, w, per_element=label != "out")
            split = fa.attn_row_plan(ip, fa.FWD_CHUNK).split_rows.long()
            again = fa.fused_sparse_attention(ip, cc, *args, **kw)
            checker.record("fused_attention_fwd", f"{name} {dt} out of "
                           f"{split.numel()} split rows, 2 launches",
                           again[0][:, split], got[0][:, split], exact=True)
            g_b = fa.fused_sparse_attention_bwd(ip, cc, *args, do, got[1],
                                                got[2], **kw)
            w_b = fa.fused_sparse_attention_bwd_plain(ip, cc, *args, do,
                                                      plain[1], plain[2],
                                                      **kw)
            for label, g, w in zip(("dq", "dk", "dv"), g_b, w_b):
                checker.record("fused_attention_bwd", f"{name} {dt} {label}",
                               g, w)
            again = fa.fused_sparse_attention_bwd(ip, cc, *args, do, got[1],
                                                  got[2], **kw)
            checker.record("fused_attention_bwd", f"{name} {dt} dq of split "
                           "rows, 2 launches", again[0][:, split],
                           g_b[0][:, split], exact=True)
            m, l = got[1], got[2]
            del got, plain, g_b, w_b, again
            times = {"fwd": cuda_ms(lambda: fa.fused_sparse_attention(
                ip, cc, *args, **kw), 5, 1),
                "bwd": cuda_ms(lambda: fa.fused_sparse_attention_bwd(
                    ip, cc, *args, do, m, l, **kw), 5, 1)}
            old = {"fwd": cuda_ms(lambda: fa.fused_sparse_attention(
                ip, cc, *(t.float() for t in args), **kw), 5, 1),
                "bwd": cuda_ms(lambda: fa.fused_sparse_attention_bwd(
                    ip, cc, *(t.float() for t in args), do, m, l, **kw), 5,
                    1)}
            n, nnz, hd = adj.shape[0], adj.nnz, HEADS * HEAD_DIM
            size = args[0].element_size()
            nbytes = {"fwd": (n + 1) * 4 + nnz * 8 + 3 * n * hd * size
                      + n * hd * 4 + 2 * HEADS * n * 4,
                      "bwd": (n + 1) * 4 + nnz * 8 + 3 * n * hd * size
                      + 4 * n * hd * 4 + 2 * HEADS * n * 4}
            flops = {"fwd": 4 * HEADS * nnz * HEAD_DIM,
                     "bwd": 10 * HEADS * nnz * HEAD_DIM}
            for d in ("fwd", "bwd"):
                rows_out.append((f"attention {d} {name}", dt, times[d],
                                 bound(nbytes[d], flops[d])[0], f32[d],
                                 old[d]))
            del q, k, v, args, m, l
        del q32, k32, v32, cot, do, args32, m32, l32
        torch.cuda.empty_cache()
        # one head at each width above one slab
        wide_gen = torch.Generator(device=dev).manual_seed(SEED + 16)
        for width in WIDE_HEAD_DIMS:
            for dt in ("float32", "bfloat16"):
                n = adj.shape[0]
                q, k, v, do = (torch.randn(1, n, width, generator=wide_gen,
                                           device=dev) for _ in range(4))
                q, k, v = (as_type(t, dt) for t in (q, k, v))
                kw = dict(scale=width ** -0.5, bias=adj.vals)
                got = fa.fused_sparse_attention(ip, cc, q, k, v, **kw)
                again = fa.fused_sparse_attention(ip, cc, q, k, v, **kw)
                plain = fa.fused_sparse_attention_plain(ip, cc, q, k, v, **kw)
                label = f"{name} d=dv={width} {dt}"
                for part, g, w in zip(("out", "m", "l"), got, plain):
                    checker.record("fused_attention_fwd", f"{label} {part}",
                                   g, w, per_element=part != "out")
                for part, g, a in zip(("out", "m", "l"), got, again):
                    checker.record("fused_attention_fwd",
                                   f"{label} {part}, 2 launches", a, g,
                                   exact=True)
                del again
                g_b = fa.fused_sparse_attention_bwd(ip, cc, q, k, v, do,
                                                    got[1], got[2], **kw)
                w_b = fa.fused_sparse_attention_bwd_plain(
                    ip, cc, q, k, v, do, plain[1], plain[2], **kw)
                for part, g, w in zip(("dq", "dk", "dv"), g_b, w_b):
                    checker.record("fused_attention_bwd", f"{label} {part}",
                                   g, w)
                del w_b, plain
                again = fa.fused_sparse_attention_bwd(ip, cc, q, k, v, do,
                                                      got[1], got[2], **kw)
                checker.record("fused_attention_bwd", f"{label} dq, 2 "
                               "launches", again[0], g_b[0], exact=True)
                m, l = got[1], got[2]
                del again, g_b, got
                wide_out.append((
                    name, width, dt,
                    cuda_ms(lambda: fa.fused_sparse_attention(
                        ip, cc, q, k, v, **kw), 3, 1),
                    cuda_ms(lambda: fa.fused_sparse_attention_bwd(
                        ip, cc, q, k, v, do, m, l, **kw), 3, 1)))
                print(f"narrow wide head {label}: forward "
                      f"{wide_out[-1][3]:.4f} ms, backward "
                      f"{wide_out[-1][4]:.4f} ms ({len(fa.slab_ranges(width))}"
                      f" slabs)", flush=True)
                del q, k, v, do, m, l
                torch.cuda.empty_cache()
    return rows_out, wide_out, runs


def narrow_phase(graphs, counters):
    """The narrow operands of SDDMM and attention on the GCN
    configuration's graphs (:func:`narrow_sddmm`,
    :func:`narrow_attention`), each kernel against its plain version.
    Returns the worst errors, the timing rows, and each public path's
    counts."""
    checker = Checker(("sddmm", "fused_attention_fwd",
                       "fused_attention_bwd"))
    t0 = time.perf_counter()
    sddmm_rows, train_counts = narrow_sddmm(graphs, checker, counters)
    attn_rows, wide_rows, runs = narrow_attention(graphs, checker, counters)
    worst = checker.done()
    print("narrow: kernel ms by operand type (CUDA events; bound: bytes at "
          "the narrow widths, 3.35 TB/s; beside the f32 kernel and the old "
          "route, a copy to f32 and then the f32 kernel)", flush=True)
    for label, dt, ms, b, f32, old in sddmm_rows + attn_rows:
        print(f"narrow time {label} {dt}: {ms:.4f} ms (bound {b:.4f}), f32 "
              f"kernel {f32:.4f}, copy to f32 + kernel {old:.4f}",
              flush=True)
    print(f"narrow: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return {"worst": worst, "runs": [(train_counts, "narrow train social")]
            + runs, "wide": wide_rows}


def narrow_gmm(cases, checker):
    """The grouped matmul at each (x, weights) pair of ``cases`` (label,
    x, tile_experts, weights, epilogue, tile, route) against its plain
    version at F32_TOL of the output's largest magnitude (the upcasts are
    exact; both sum the same products in f32), each on the route named;
    timed beside the f32 kernel on both operands in f32 and the old
    route, their copy to f32 and then that kernel.  Returns timing
    rows."""
    import torch
    from repro_torch.kernels import grouped_matmul as gm

    rows_out = []
    for label, x, te, w, ep, tile, want_route in cases:
        kw = dict(epilogue=ep, token_tile=tile)
        before = dict(gm.ROUTE_LAUNCHES)
        got = gm.grouped_matmul(x, te, w, f_tile=w.shape[2],
                                d_tile=w.shape[1], **kw)
        route = routes_taken(before)
        checker.record("grouped_matmul",
                       f"{label} x {dtype_name(x)} W {dtype_name(w)} tile "
                       f"{tile} route {route}", got,
                       plain_gmm(x, te, w, **kw))
        if route != {want_route: 1}:
            checker.failures.append(f"grouped_matmul {label}: route "
                                    f"{route}, not {want_route}")
        del got
        ms = cuda_ms(lambda: gm.grouped_matmul(
            x, te, w, f_tile=w.shape[2], d_tile=w.shape[1], **kw), 10, 2)
        e_used = int(torch.unique(te).numel())
        nbytes = (e_used * w.shape[1] * w.shape[2] * w.element_size()
                  + x.numel() * x.element_size() + x.shape[0] * w.shape[2]
                  * 4)
        flops = 2 * x.shape[0] * w.shape[1] * w.shape[2]
        old = cuda_ms(lambda: gm.grouped_matmul(
            x.float(), te, w.float(), f_tile=w.shape[2], d_tile=w.shape[1],
            **kw), 3, 1)
        x32, w32 = x.float(), w.float()
        f32_ms = cuda_ms(lambda: gm.grouped_matmul(
            x32, te, w32, f_tile=w.shape[2], d_tile=w.shape[1], **kw), 3, 1)
        del x32, w32
        rows_out.append((label, f"{dtype_name(x)} x {dtype_name(w)}", ms,
                         bound(nbytes, flops, BF16_FLOP_PER_S)[0], f32_ms,
                         old))
        torch.cuda.empty_cache()
    return rows_out


def narrow_gmm_cases(cfg, moe, pairs, gen):
    """Grouped-matmul cases at layer 0's decode and prefill tiles (one
    tile an expert, as :func:`moe_kernel_cases` lays them) on this
    layer's experts: each x type of ``pairs`` ((x, route) for these
    weights) in the gate (SiLU) and down projections."""
    import torch
    from repro_torch.core import Epilogue
    from repro_torch.models.moe import _capacity

    e, d, f = moe["wg"].shape
    dev = moe["wg"].device
    te = torch.arange(e, dtype=torch.int32, device=dev)
    cases = []
    for phase, tokens in (("decode", MOE_SLOTS), ("prefill", MOE_PROMPT)):
        tile = min(_capacity(cfg, tokens), 128)
        for x_name, route in pairs:
            xd, xf = (as_type(torch.randn(e * tile, n, generator=gen,
                                          device=dev), x_name)
                      for n in (d, f))
            cases += [(f"{phase} gate+silu", xd, te, moe["wg"],
                       Epilogue("silu"), tile, route),
                      (f"{phase} down", xf, te, moe["wo"], Epilogue(), tile,
                       route)]
    return cases


def narrow_serve(label, cfg, api, params, dev, counters):
    """ServeEngine over the MoE prompts (counts zeroed just before, read
    just after; every launch on the tensor cores), then a prefill and a
    decode step timed.  Returns counts, times and the served tokens."""
    import torch

    prompts = moe_prompts(cfg)
    results, seconds, calls, counts = serve_moe(cfg, api, params, prompts,
                                                dev, counters)
    n_tok = sum(len(v) for v in results.values())
    if sorted(results) != list(range(MOE_REQUESTS)) or any(
            len(v) != MOE_NEW for v in results.values()):
        fail(f"narrow serve {label}: the engine did not serve every request "
             "in full")
    if set(calls["routes"]) != {"mma"}:
        fail(f"narrow serve {label}: grouped-matmul routes {calls['routes']}")
    tokens = torch.as_tensor(prompts[0][None, :], dtype=torch.int64,
                             device=dev)
    cache = api.init_cache(MOE_SLOTS, MOE_MAX_LEN, device=dev)
    cache["pos"] = MOE_PROMPT
    step = torch.zeros(MOE_SLOTS, dtype=torch.int64, device=dev)
    prefill_ms = cuda_ms(lambda: api.prefill(params, {"tokens": tokens},
                                             MOE_MAX_LEN), 10, 2)
    decode_ms = cuda_ms(lambda: api.decode_step(params, cache, step), 10, 2)
    print(f"narrow serve {label}: {len(results)} requests, {n_tok} tokens in "
          f"{seconds:.3f} s ({n_tok / seconds:.1f} tokens/s, host clock); "
          f"prefill of {MOE_PROMPT} tokens {prefill_ms:.4f} ms, decode step "
          f"({MOE_SLOTS} slots) {decode_ms:.4f} ms (CUDA events, means of "
          f"10); routes {calls['routes']}; launches {counts}; "
          f"{card_line()}", flush=True)
    return {"counts": counts, "results": results, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "tokens_per_s": n_tok / seconds}


def twin_logits(api, params, twin, prompt, dev):
    """Prefill last-token and decode-step logits of ``params`` against
    ``twin`` (the same model with other stored weights): relative L2
    within LOGIT_REL_L2, the largest difference printed."""
    import torch

    tokens = torch.as_tensor(prompt[None, :], dtype=torch.int64,
                             device=dev).repeat(MOE_SLOTS, 1)
    out = {}
    for tag, p in (("e4m3", params), ("twin", twin)):
        lp, cache = api.prefill(p, {"tokens": tokens}, MOE_MAX_LEN)
        ld, _ = api.decode_step(p, cache, lp.argmax(-1) if tag == "e4m3"
                                else out["e4m3"][0].argmax(-1))
        out[tag] = (lp, ld)
        del cache
    worst = 0.0
    for i, label in enumerate(("prefill last-token", "decode step")):
        got, want = out["e4m3"][i], out["twin"][i]
        err = rel_l2(got, want)
        diff = float((got.float() - want.float()).abs().max())
        worst = max(worst, diff)
        print(f"narrow serve e4m3: {label} logits against the experts' "
              f"exact bf16 upcast: relative L2 {err:.3e} (tol "
              f"{LOGIT_REL_L2:.3e}), largest difference {diff:.3e}",
              flush=True)
        if not err <= LOGIT_REL_L2:
            fail(f"narrow serve e4m3: {label} logits")
    return worst


def fp16_logits(api, einsum, params, prompt, dev):
    """The fp16 model's prefill last-token and decode-step logits (4
    slots, each the prompt) on the kernel path against the einsum path.
    Top-k routing is a step: where a token's k-th and (k+1)-th experts
    nearly tie, the paths' other roundings (the einsum path rounds each
    projection to fp16, the kernel keeps f32 sums) may route it to other
    experts, and its logits then part by far more than the rounding.  So
    the einsum path runs twice: with the kernel path's expert choices
    replayed, held within LOGIT_REL_L2; and free, printed, every token it
    routes otherwise at the first layer where the runs part held to be a
    near tie there (its k-th and (k+1)-th router probabilities on the
    kernel path within LOGIT_REL_L2 of each other, relative; later layers
    follow from the parted hidden states)."""
    import torch
    import repro_torch.models.moe as moe

    route = moe._route
    tokens = torch.as_tensor(prompt[None, :], dtype=torch.int64,
                             device=dev).repeat(MOE_SLOTS, 1)

    def run(a, nxt=None, replay=None):
        log = []

        def routed(cfg_, x, router):
            log.append(route(cfg_, x, router) if replay is None
                       else replay[len(log)])
            return log[-1]

        moe._route = routed
        try:
            lp, cache = a.prefill(params, {"tokens": tokens}, MOE_MAX_LEN)
            nxt = lp.argmax(-1) if nxt is None else nxt
            ld, _ = a.decode_step(params, cache, nxt)
        finally:
            moe._route = route
        return (lp, ld), nxt, log

    kernel, nxt, klog = run(api)
    pinned, _, _ = run(einsum, nxt, klog)
    free, _, flog = run(einsum, nxt)
    for i, label in enumerate(("prefill last-token", "decode step")):
        err = rel_l2(kernel[i], pinned[i])
        print(f"narrow serve fp16: {label} logits {tuple(kernel[i].shape)}, "
              f"kernel path against the einsum path on its expert choices: "
              f"relative L2 {err:.3e} (tol {LOGIT_REL_L2:.3e}); free einsum "
              f"path {rel_l2(kernel[i], free[i]):.3e}", flush=True)
        if not err <= LOGIT_REL_L2:
            fail(f"narrow serve fp16: {label} logits")
    n_layers = len(params["layers"])
    for phase, calls in (("prefill", range(n_layers)),
                         ("decode", range(n_layers, 2 * n_layers))):
        first = None
        for c in calls:
            differ = ((klog[c][0] > 0) != (flog[c][0] > 0)).any(dim=1)
            n = int(differ.sum())
            print(f"narrow serve fp16: {phase} layer {c % n_layers}: {n} of "
                  f"{differ.numel()} tokens routed to other experts on the "
                  "free einsum path", flush=True)
            if n and first is None:
                first = c
                k = int((klog[c][0][0] > 0).sum())  # experts a token
                top = klog[c][1][differ].topk(k + 1, dim=-1).values
                margin = float(((top[:, k - 1] - top[:, k])
                                / top[:, k - 1]).max())
                print(f"narrow serve fp16: {phase} layer {c % n_layers}, "
                      f"where the runs first part: the largest relative "
                      f"margin of those tokens' expert {k} over expert "
                      f"{k + 1} {margin:.3e} (tol {LOGIT_REL_L2:.3e})",
                      flush=True)
                if not margin <= LOGIT_REL_L2:
                    fail(f"narrow serve fp16: {phase} routing parts off a "
                         "near tie")
    torch.cuda.empty_cache()


def narrow_moe(cfg, params, dev, counters):
    """Qwen3-MoE served at full width with e4m3 experts and at fp16.

    (a) The bf16 model's expert weights cast in place to e4m3
    (``core.dtypes.cast``); its logits against a twin whose experts are
    their exact bf16 upcast; the grouped matmul at bf16, e4m3 and f32
    tokens on those experts; the engine served.  (b) After the bf16
    model is freed, the same configuration at param_dtype = compute_dtype
    = float16 drawn from seed SEED; its logits against the einsum path;
    the grouped matmul at fp16 and f32 tokens on its experts; the engine
    served.  ``params`` is consumed.  Returns worst error, timing rows,
    and the serves."""
    import torch
    from repro_torch.models import get_model

    checker = Checker(("grouped_matmul",))
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    t0 = time.perf_counter()
    for layer in params["layers"]:
        for k in ("wg", "wi", "wo"):
            layer["moe"][k] = as_type(layer["moe"][k], "float8_e4m3fn")
    torch.cuda.empty_cache()
    twin = {**params, "layers": [
        {**layer, "moe": {k: (v.to(torch.bfloat16) if k != "router" else v)
                          for k, v in layer["moe"].items()}}
        for layer in params["layers"]]}
    n_e4m3 = sum(layer["moe"][k].numel() for layer in params["layers"]
                 for k in ("wg", "wi", "wo"))
    print(f"narrow serve e4m3: experts cast to e4m3 ({n_e4m3 / 1e9:.2f} GB) "
          f"in {time.perf_counter() - t0:.1f} s, beside a twin with their "
          f"bf16 upcast ({2 * n_e4m3 / 1e9:.2f} GB)", flush=True)
    prompts = moe_prompts(cfg)
    api = get_model(cfg)
    worst_logit = twin_logits(api, params, twin, prompts[0], dev)
    moe0 = params["layers"][0]["moe"]
    rows = narrow_gmm(narrow_gmm_cases(cfg, moe0, (
        ("bfloat16", "mma"), ("float8_e4m3fn", "mma"), ("float32", "fma")),
        gen), checker)
    a = narrow_serve("e4m3", cfg, api, params, dev, counters)
    ref = narrow_serve("e4m3 twin (bf16 upcast)", cfg, api, twin, dev, None)
    same = sum(x == y for rid in a["results"]
               for x, y in zip(a["results"][rid], ref["results"][rid]))
    print(f"narrow serve e4m3: greedy tokens equal the twin's in {same} of "
          f"{sum(len(v) for v in a['results'].values())}", flush=True)
    del twin, moe0
    params.clear()
    torch.cuda.empty_cache()

    cfg16 = cfg.scaled(param_dtype="float16", compute_dtype="float16")
    api16 = get_model(cfg16)
    p16 = api16.init(torch.Generator(device=dev).manual_seed(SEED),
                     device=dev)
    fp16_logits(api16, get_model(cfg16.scaled(moe_kernel_dispatch=False)),
                p16, prompts[0], dev)
    rows += narrow_gmm(narrow_gmm_cases(cfg16, p16["layers"][0]["moe"], (
        ("float16", "mma"), ("float32", "fma")), gen), checker)
    b = narrow_serve("fp16", cfg16, api16, p16, dev, counters)
    del p16
    torch.cuda.empty_cache()
    worst = checker.done()
    for label, pair, ms, bnd, f32, old in rows:
        print(f"narrow time grouped matmul {label} {pair}: {ms:.4f} ms "
              f"(bound {bnd:.4f}), f32 kernel {f32:.4f}, copy to f32 + "
              f"kernel {old:.4f}", flush=True)
    return {"worst": worst, "worst_logit": worst_logit, "serves": (a, b),
            "runs": [(a["counts"], "narrow serve e4m3"),
                     (b["counts"], "narrow serve fp16")]}


#: The user phase: EB's nnz tiles (the kernel's largest, and the default,
#: where the per-tile loop of the user's code dominates; the readout runs
#: at both, the served GCN at the first), its group size, and the
#: strategies the GCN is served under: quickstart's one-hot (``T x
#: n_rows`` a tile under the reference's contract, several seconds a
#: social forward, so one request on social) and a spec generic in the
#: monoid.
USER_NNZ_TILES = (4096, 256)
USER_GROUP = 32
USER_SERVED = ("onehot-tile", "seg-generic")


def user_strategies():
    """Register the user phase's strategies in the port's registry, each
    written in torch and creating its tensors on the device of the
    partials it is handed: ``onehot-tile``, a port of quickstart's
    (``examples/quickstart.py``: a one-hot product per tile, spec and
    realization); ``onehot-spec``, its spec alone (the path of the
    reference's ``spec_fallback_pallas``); ``seg-max``, a segment max
    registered with ``combine="max"``; ``seg-max-callable``, the same spec
    with a callable combine and its identity; ``seg-generic``, a spec that
    reduces under whatever monoid the op names."""
    import torch
    from repro_torch.core import register_strategy

    def onehot(ids, n, dtype):
        return (ids[:, None] == torch.arange(n, device=ids.device)).to(dtype)

    def onehot_spec(p, ids, n, group_size):
        return onehot(ids, n, p.dtype).T @ p

    def onehot_tile(ids, p, out, group_size):
        out += onehot(ids, out.shape[0], p.dtype).T @ p

    def seg_max(p, ids, n, group_size):
        return torch.full((n, p.shape[1]), -math.inf,
                          device=p.device).scatter_reduce_(
            0, ids.long()[:, None].expand_as(p), p, "amax")

    def seg_generic(p, ids, n, group_size, monoid):
        return monoid.seg_reduce(p, ids, n)

    register_strategy("onehot-tile", onehot_spec, onehot_tile, overwrite=True)
    register_strategy("onehot-spec", onehot_spec, overwrite=True)
    register_strategy("seg-max", seg_max, combine="max", overwrite=True)
    register_strategy("seg-max-callable", seg_max,
                      combine=lambda a, b: torch.maximum(a, b),
                      identity=-math.inf, overwrite=True)
    register_strategy("seg-generic", seg_generic, overwrite=True)


def user_windows(g, n_cols):
    """The lane windows ``run_user_strategy`` asks the partials kernel for
    over the GroupedCOO ``g`` at ``n_cols`` columns: whole nnz tiles, at
    most ``WINDOW_BYTES`` of f32 partials each."""
    from repro_torch.kernels.common import window_tiles

    per = window_tiles(g.nnz_tile, n_cols) * g.nnz_tile
    n = g.vals.shape[0]
    return [(t0, min(n, t0 + per)) for t0 in range(0, n, per)]


def user_check_kernels(graphs, x, model, checker):
    """The partials kernel against its plain version, bit for bit, on each
    graph's stream at the served widths (B = X W1, N = 256, and
    relu(X W1) W2, N = 40) window by window, as the main path cuts them;
    the combine kernel against its plain version under add, max and min
    on the whole (n_rows, 256) accumulator, as each tile combines it."""
    import torch
    from repro_torch.core import MONOIDS
    from repro_torch.kernels import common, eb_partials

    b256 = x @ model.w1
    b40 = torch.relu(b256) @ model.w2
    for name, (adj, _) in graphs.items():
        g = adj.grouped(USER_NNZ_TILES[0])
        for b in (b256, b40):
            wins = user_windows(g, b.shape[1])
            for t0, t1 in wins:
                args = (g.rows[t0:t1], g.cols[t0:t1], g.vals[t0:t1], b)
                got = eb_partials.eb_partials(*args, n_rows=adj.shape[0])
                want = eb_partials.eb_partials_plain(*args)
                checker.record("eb_partials",
                               f"{name} N={b.shape[1]} lanes {t0}-{t1}",
                               got, want, exact=True)
                del got, want
    gen = torch.Generator(device="cpu").manual_seed(SEED + 25)
    acc = torch.randn(N_NODES, HIDDEN, generator=gen).to(x.device)
    acc.view(-1)[::97] = -0.0
    tile = torch.randn(N_NODES, HIDDEN, generator=gen).to(x.device)
    tile.view(-1)[::89] = 0.0
    for op in ("add", "max", "min"):
        got, want = acc.clone(), acc.clone()
        eb_partials.combine(got, tile, MONOIDS[op])
        common.combine_plain(want, tile, MONOIDS[op])
        checker.record("user_combine", f"{op} the whole ({N_NODES}, "
                       f"{HIDDEN}) block", got, want, exact=True)
        del got, want


def user_twin(model, strategy, tile):
    """A GCN with ``model``'s weights served under ``Schedule("eb",
    nnz_tile=tile, group_size=USER_GROUP, strategy=strategy)``."""
    from repro_torch.core import Schedule
    from repro_torch.models import GCN

    twin = GCN(N_FEAT, HIDDEN, N_CLASS, device=model.w1.device,
               schedule=Schedule("eb", nnz_tile=tile, group_size=USER_GROUP,
                                 strategy=strategy))
    twin.load_state_dict(model.state_dict())
    return twin


def user_layers_k(adj, x, model, tile, strategy):
    """Each GCN layer under ``strategy`` and under the built-in
    ``segment`` at nnz tile ``tile``, held against f64 on the served
    data (ROADMAP section 3 item 8): the largest error of each in units
    of 2^-24 of the terms entering an output.  Returns (layer, user k,
    built-in k) for both layers."""
    import torch
    from repro_torch.core import Epilogue, Schedule
    from repro_torch.sparse import spmm

    out = []
    b, bias, ep = x @ model.w1, model.b1, Epilogue("relu", bias=True)
    for layer in (1, 2):
        sched = Schedule("eb", nnz_tile=tile, group_size=USER_GROUP,
                         epilogue=ep)
        got = spmm(adj, b, sched.replace(strategy=strategy), bias=bias,
                   device=b.device)
        builtin = spmm(adj, b, sched, bias=bias, device=b.device)
        _, _, terms = plain_spmm(adj, b, sched, bias)
        exact = exact_spmm(adj, b, ep, bias)
        unit = 2.0 ** -24 * (terms.double() + exact.abs())
        ks = [float(((t.double() - exact).abs() / unit).max())
              for t in (got, builtin)]
        out.append((layer, *ks))
        del builtin, terms, exact, unit
        if layer == 1:
            b, bias, ep = got @ model.w2, None, Epilogue()
        del got
        torch.cuda.empty_cache()
    return out


def user_serve(graphs, x, model, counters, checker):
    """The GCN served under a user strategy at nnz tile 4096, each
    forward against the built-in ``segment`` forward at the same tile
    (F32_TOL of its largest magnitude), and each layer against f64: under
    quickstart's ``onehot-tile`` one request on the social graph (the
    one-hot is 4096 x 169,343 a tile under the reference's contract,
    several seconds a forward; host clock), its layers within K_TERMS;
    under ``seg-generic`` REQUESTS requests on both graphs, timed beside
    the built-in's (CUDA events), its layers' k printed for the record:
    its spec sums with torch's ``index_add_`` in f32, like the plain
    version, which reads k 20-33 on this served data (ROADMAP section 3
    item 8), so K_TERMS does not bound it.  The counts are zeroed just
    before each strategy's requests and read just after.  Returns the
    runs and the timing rows."""
    import torch

    tile = USER_NNZ_TILES[0]
    runs, rows = [], []
    for name, (adj, _) in graphs.items():
        builtin = user_twin(model, "segment", tile)
        want = builtin(adj, x)
        ms_builtin = cuda_ms(lambda: builtin(adj, x), 5, 1)
        n_tiles = 2 * adj.grouped(tile).vals.shape[0] // tile
        for strategy in USER_SERVED:
            onehot = strategy == "onehot-tile"
            if onehot and name != "social":
                continue
            m = user_twin(model, strategy, tile)
            for k in counters.values():
                k.launches = 0
            host = []
            for i in range(1 if onehot else REQUESTS):
                t0 = time.perf_counter()
                got = m(adj, x)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
                err, tol, ok = compare(got, want)
                if not ok:
                    checker.failures.append(
                        f"user serve {name} {strategy} tile {tile} "
                        f"request {i}: {err:.3e} above {tol}")
            counts = {n: k.launches for n, k in counters.items()}
            label = f"user serve {name} {strategy} tile {tile}"
            kernels = ("eb_partials", "epilogue") + (
                () if onehot else ("user_combine",))
            runs.append((counts, label, kernels))
            ms = host[-1] if onehot else cuda_ms(lambda: m(adj, x), 2, 1)
            print(f"{label}: request ms "
                  + ", ".join(f"{t:.1f}" for t in host)
                  + f"; against the built-in forward max_abs_err "
                  f"{err:.3e} (tol {tol}); launches {counts}", flush=True)
            for layer, k_user, k_builtin in user_layers_k(
                    adj, x, model, tile, strategy):
                ok = k_user <= K_TERMS or not onehot
                print(f"  {label} layer {layer} against f64: k "
                      f"{k_user:.3f} (built-in segment {k_builtin:.3f}; "
                      + (f"tol K_TERMS {K_TERMS}) {'ok' if ok else 'FAIL'}"
                         if onehot else "for the record: torch's "
                         "index_add_ sums the spec)"), flush=True)
                if not ok:
                    checker.failures.append(
                        f"{label} layer {layer}: k {k_user:.3f} "
                        "against f64")
            rows.append((name, strategy, tile, ms, ms_builtin, n_tiles,
                         "host clock, one request" if onehot
                         else "CUDA events, mean of 2"))
            del got, m
        del builtin, want
        torch.cuda.empty_cache()
    return runs, rows


def user_train(adj, x, model, counters):
    """One training step of the GCN (layer 1's bias and relu fused) under
    ``seg-generic`` at nnz tile 4096 on ``adj``: the weights' gradients
    against the built-in ``segment`` step's within GRAD_RTOL relative L2;
    the backward recomputes layer 1's pre-activation under the same
    schedule, so the partials kernel must launch in the backward too.
    Returns the step's counts."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(SEED + 26)
    labels = torch.randint(0, N_CLASS, (N_NODES,), generator=gen).to(x.device)
    grads, counts = {}, None
    for strategy in ("segment", "seg-generic"):
        m = user_twin(model, strategy, USER_NNZ_TILES[0])
        loss = torch.nn.functional.cross_entropy(m(adj, x), labels)
        for k in counters.values():
            k.launches = 0
        grads[strategy] = torch.autograd.grad(loss, (m.w1, m.b1, m.w2))
        if strategy != "segment":
            counts = {n: k.launches for n, k in counters.items()}
    errs = [rel_l2(g, w) for g, w in zip(grads["seg-generic"],
                                         grads["segment"])]
    print("user train social seg-generic: gradients of w1, b1, w2 against "
          "the built-in segment step, relative L2 "
          + ", ".join(f"{e:.3e}" for e in errs)
          + f" (tol {GRAD_RTOL}); backward launches {counts}", flush=True)
    if max(errs) > GRAD_RTOL:
        fail(f"user train: gradients {errs} above {GRAD_RTOL}")
    if counts["eb_partials"] == 0:
        fail("user train: the backward launched no partials kernel")
    return counts


def user_max_spmm(graphs, x, model, counters, checker):
    """EB under ``seg-max`` (``combine="max"``) and ``seg-max-callable`` on
    both graphs at N = 256, against the plain walk on the card (the
    same tile walk over ``eb_partials_plain``'s partials, which equal the
    kernel's bit for bit) bit for bit.  Returns the runs."""
    from repro_torch.core import Schedule
    from repro_torch.kernels import spmm_eb
    from repro_torch.sparse import spmm

    runs = []
    b = x @ model.w1
    for name, (adj, _) in graphs.items():
        g = adj.grouped(USER_NNZ_TILES[0])
        for strategy in ("seg-max", "seg-max-callable"):
            for k in counters.values():
                k.launches = 0
            got = spmm(adj, b, Schedule("eb", nnz_tile=USER_NNZ_TILES[0],
                                        group_size=USER_GROUP,
                                        strategy=strategy), device=b.device)
            counts = {n: k.launches for n, k in counters.items()}
            want = spmm_eb.spmm_eb_plain(
                g.rows, g.cols, g.vals, b, n_rows=adj.shape[0],
                nnz_tile=USER_NNZ_TILES[0], group_size=USER_GROUP,
                strategy=strategy)
            label = f"user spmm {name} {strategy}"
            checker.record("user_combine", f"{name} {strategy} N=256", got,
                           want, exact=True)
            kernels = ("eb_partials",) + (
                ("user_combine",) if strategy == "seg-max" else ())
            runs.append((counts, label, kernels))
            del got, want
    return runs


def user_readout(x, model, adj, counters, checker):
    """The readout under ``seg-generic`` (mean and max over segments of
    READOUT_SIZE nodes of the served GCN's output) at both nnz tiles,
    against the built-in ``segment`` kernel: max bit for bit, mean within
    K_TERMS of the terms entering it.  Returns the runs."""
    import torch
    from repro_torch.core import Schedule
    from repro_torch.sparse import segment_reduce

    h = model(adj, x)
    seg = (torch.arange(N_NODES, device=x.device) // READOUT_SIZE).to(
        torch.int32)
    n_seg = -(-N_NODES // READOUT_SIZE)
    runs = []
    for tile in USER_NNZ_TILES:
        for op in ("mean", "max"):
            sched = Schedule("eb", nnz_tile=tile, group_size=USER_GROUP)
            for k in counters.values():
                k.launches = 0
            got = segment_reduce(seg, h, n_seg, sched.replace(
                strategy="seg-generic"), op=op, device=h.device)
            counts = {n: k.launches for n, k in counters.items()}
            want = segment_reduce(seg, h, n_seg, sched, op=op,
                                  device=h.device)
            label = f"user readout {op} tile {tile}"
            if op == "max":
                checker.record("user_combine", label, got, want, exact=True)
            else:
                terms = segment_reduce(seg, h.abs(), n_seg, sched, op=op,
                                       device=h.device)
                checker.record_terms("user_combine", label, got, want, terms)
            runs.append((counts, label, ("user_combine",)))
    return runs


def user_kernel_rows(adj, x, model):
    """The two kernels' rows of the ``{"kernels": [...]}`` line, on the
    work of one social forward at nnz tile 4096, replayed without the
    user's code between launches: the partials kernel over both layers'
    windows (CUDA events around back-to-back launches, each a few tenths
    of a millisecond), the combine of every tile's spec result into the
    whole (n_rows, N) accumulator at both widths under add (device time
    under the profiler, ``device_ms``; the CUDA-event window printed
    beside it), each beside the same work through its plain version,
    with the bytes and operations of that work; the combine also beside
    ``acc.add_(tile)`` over the same blocks (``library_ms``), which the
    port never calls."""
    import torch
    from repro_torch.core import MONOIDS
    from repro_torch.kernels import common, eb_partials

    g = adj.grouped(USER_NNZ_TILES[0])
    b256 = x @ model.w1
    b40 = torch.relu(b256) @ model.w2
    lanes = g.vals.shape[0]
    nbytes = flops = 0
    calls = []
    for b in (b256, b40):
        n = b.shape[1]
        nbytes += lanes * 8 + b.numel() * 4 + lanes * n * 4
        flops += lanes * n
        calls += [(g.rows[t0:t1], g.cols[t0:t1], g.vals[t0:t1], b)
                  for t0, t1 in user_windows(g, n)]

    def partials(fn, **kw):
        for c in calls:
            fn(*c, **kw)

    rows = {"eb_partials": dict(
        ms=cuda_ms(lambda: partials(eb_partials.eb_partials,
                                    n_rows=adj.shape[0]), 3, 1),
        plain_ms=cuda_ms(lambda: partials(eb_partials.eb_partials_plain),
                         3, 1),
        bytes=nbytes, flops=flops, library_ms=None, launches=len(calls))}
    n_tiles = lanes // g.nnz_tile
    accs = [(torch.zeros(N_NODES, n, device=x.device),
             torch.ones(N_NODES, n, device=x.device))
            for n in (HIDDEN, N_CLASS)]
    cbytes = sum(3 * acc.numel() * 4 * n_tiles for acc, _ in accs)
    cflops = sum(acc.numel() * n_tiles for acc, _ in accs)

    def combines(fn):
        for acc, buf in accs:
            for _ in range(n_tiles):
                fn(acc, buf, MONOIDS["add"])

    kernel = lambda: combines(eb_partials.combine)  # noqa: E731
    plain = lambda: combines(common.combine_plain)  # noqa: E731
    # the add combine is one PyTorch call a span: the yardstick
    library = lambda: combines(  # noqa: E731
        lambda acc, tile, _: acc.add_(tile))
    rows["user_combine"] = dict(
        ms=sum(device_ms(kernel, 1, 2).values()),
        plain_ms=sum(device_ms(plain, 1, 2).values()),
        library_ms=sum(device_ms(library, 1, 2).values()),
        window_ms=cuda_ms(kernel, 2, 1), bytes=cbytes, flops=cflops,
        launches=2 * n_tiles)
    del accs
    torch.cuda.empty_cache()
    rows["user_combine"]["detail"] = {"walk": user_combine_walk(adj, x,
                                                                model)}
    for name, r in rows.items():
        print(f"user kernel {name}: one social forward's {r['launches']} "
              f"launches {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
              + (f", torch add_ {r['library_ms']:.4f} ms"
                 if r["library_ms"] is not None else "")
              + (f" (device time; the CUDA-event window of the launches "
                 f"{r['window_ms']:.4f} ms)" if "window_ms" in r else "")
              + f", bound {bound(r['bytes'], r['flops'])[0]:.4f} ms",
              flush=True)
    return rows


def user_combine_walk(adj, x, model):
    """The combine on the walk's own results: one social forward under
    ``seg-generic`` at nnz tile 4096, both layers' ``run_user_strategy``
    over the partials kernel (layer 2 on the built-in layer 1's output),
    the combine kernel's device time by its kernel name (``device_ms``)
    beside the same walk with the combine doing ``acc.add_(res)``, whose
    kernels the kernel's walk does not launch are its library time; the
    bytes these inputs need, counted on a third walk: each tile result
    read once, the accumulator read where the result's element is not
    the monoid's bitwise no-op (-0.0 under add) and written where its
    bits change.  Returns the numbers for the ``kernels`` line."""
    import torch
    from repro_torch.core import MONOIDS, get_strategy
    from repro_torch.kernels import common, eb_partials
    from repro_torch.sparse import spmm

    tile = USER_NNZ_TILES[0]
    g = adj.grouped(tile)
    entry = get_strategy("seg-generic")
    n_rows = adj.shape[0]
    b256 = x @ model.w1
    h = torch.relu(spmm(adj, b256, device=x.device) + model.b1)
    layers = (b256, h @ model.w2)
    del h

    def walk(combine):
        for b in layers:
            acc = torch.zeros(n_rows, b.shape[1], device=x.device)
            common.run_user_strategy(
                entry, g.rows, acc, group_size=USER_GROUP, nnz_tile=tile,
                partials=lambda t0, t1, b=b: eb_partials.eb_partials(
                    g.rows[t0:t1], g.cols[t0:t1], g.vals[t0:t1], b,
                    n_rows=n_rows),
                combine=combine)

    need = {"tiles": 0, "read": 0, "acc_read": 0, "written": 0}
    noop = torch.tensor(-0.0, device=x.device).view(torch.int32)

    def counting(acc, res, monoid):
        if monoid is not MONOIDS["add"]:
            fail(f"seg-generic combined under {monoid.name}, not add")
        new = acc + res
        need["tiles"] += 1
        need["read"] += res.numel()
        need["acc_read"] += int((res.view(torch.int32) != noop).sum())
        need["written"] += int((new.view(torch.int32)
                                != acc.view(torch.int32)).sum())
        acc.copy_(new)

    walk(counting)
    nbytes = 4 * (need["read"] + need["acc_read"] + need["written"])
    flops = need["acc_read"]
    kernel_ms = device_ms(lambda: walk(eb_partials.combine), 1, 2)
    add_ms = device_ms(lambda: walk(lambda a, r, _: a.add_(r)), 1, 2)
    ms = sum(v for k, v in kernel_ms.items() if "user_combine" in k)
    library = [k for k in add_ms if k not in kernel_ms]
    lib_ms = sum(add_ms[k] for k in library) if library else None
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"user combine on the walk's own results (one social forward "
          f"under seg-generic, nnz tile {tile}): {need['tiles']} combines "
          f"{ms:.4f} ms on the device, acc.add_(res) "
          + ("none found" if lib_ms is None else f"{lib_ms:.4f} ms")
          + f" ({library}); bound {bound_ms:.4f} ms by {bound_by}: "
          f"{nbytes} bytes needed (results {4 * need['read']}, the "
          f"accumulator read {4 * need['acc_read']}, written "
          f"{4 * need['written']})", flush=True)
    return {"ms": ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes,
            "combines": need["tiles"],
            "written_bytes": 4 * need["written"]}


def user_phase(graphs, x, model, counters):
    """User-defined reduction strategies on the card (the paper's
    challenge 2): the partials and combine kernels against their plain
    versions (:func:`user_check_kernels`), the GCN served under
    quickstart's strategy and a generic spec (:func:`user_serve`), one
    training step (:func:`user_train`), EB under a max and a callable
    combine (:func:`user_max_spmm`) and the readout
    (:func:`user_readout`).  Returns the runs (counts, path, the kernels
    it must launch), the worst errors and the kernels' timing rows."""
    import torch

    t0 = time.perf_counter()
    user_strategies()
    checker = Checker(("eb_partials", "user_combine"))
    social = graphs["social"][0]
    with torch.no_grad():
        user_check_kernels(graphs, x, model, checker)
        torch.cuda.empty_cache()
        runs, rows = user_serve(graphs, x, model, counters, checker)
    runs.append((user_train(social, x, model, counters), "user train social",
                 ("eb_partials", "epilogue")))
    with torch.no_grad():
        runs += user_max_spmm(graphs, x, model, counters, checker)
        runs += user_readout(x, model, social, counters, checker)
        results = user_kernel_rows(social, x, model)
    worst = checker.done()
    for name, strategy, tile, ms, ms_builtin, n_tiles, clock in rows:
        print(f"user forward {name} {strategy} nnz_tile {tile}: {ms:.4f} ms "
              f"({clock}); built-in segment {ms_builtin:.4f} ms; {n_tiles} "
              f"tiles walked, {ms / n_tiles * 1e3:.2f} us a tile", flush=True)
    print(f"user: phase {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return {"runs": runs, "worst": worst, "results": results}


#: The attn_user phase: the nnz tile the walk runs at (EB's largest, the
#: user phase's), and where quickstart's one-hot runs: its one-hot is
#: 4096 x 169,343 f32 (2.77 GB) for each of the forward's three scatters a
#: tile, so it runs one head's forward on the graph with fewer tiles.
ATTN_USER_TILE = 4096
ONEHOT_GRAPH, ONEHOT_HEADS = "roadnet", 1
#: ulps within which an exp-derived value of ``attn_user.cu`` (expf) may
#: differ from the plain version's (torch.exp on the card): each is within
#: 2 ulp of exp.
EXP_ULPS = 4


def attn_stream(adj, tile):
    """(nnz, rows, cols, bias) of ``adj``'s lanes as the user walk takes
    them, padded as the reference pads them: whole tiles of ``tile``, the
    pad lanes at row 0 and column 0 with bias 0."""
    import torch
    from repro_torch.kernels.fused_attention import rows_of

    nnz = adj.indices.numel()
    z = torch.zeros(-(-nnz // tile) * tile - nnz, dtype=torch.int32,
                    device=adj.device)
    return (nnz, torch.cat([rows_of(adj.indptr).to(torch.int32), z]),
            torch.cat([adj.indices, z]),
            torch.cat([adj.vals.float(), z.float()]))


def ulps(got, want) -> float:
    """Largest distance in f32 ulps of ``want`` between two tensors; inf
    unless NaN and the infinities stand at the same places."""
    import torch

    nan, fin = torch.isnan(want), torch.isfinite(want)
    if not (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~fin & ~nan], want[~fin & ~nan])):
        return float("inf")
    g, w = got[fin].double(), want[fin].double()
    unit = w.abs().clamp_min(2.0 ** -126) * 2.0 ** -23
    return float(((g - w).abs() / unit).max()) if w.numel() else 0.0


def record_within(checker, kernel, label, err, ok, tol):
    """Record a check the Checker's own comparisons do not cover."""
    checker.worst[kernel] = max(checker.worst[kernel], err)
    print(f"  {kernel:19s} {label:48s} max_abs_err {err:.3e} tol {tol} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        checker.failures.append(f"{kernel} {label}")


def attn_user_check_kernels(graphs, checker):
    """The walk's kernels against their plain versions on each graph's
    stream at the attention path's shapes (4 heads x 64, zero-mean
    operands, the adjacency's values as bias): ``attn_lanes``' scores
    and dw within K_TERMS of the terms entering them, w within its
    score's error carried through exp plus EXP_ULPS, ds bit for bit;
    ``attn_rescale`` on a mid-stream tile (alpha 0, 1 and moving rows)
    within EXP_ULPS, its finish bit for bit; the partials kernel's f32
    values on bf16, fp16 and e4m3 V bit for bit."""
    import torch
    from repro_torch.kernels import attn_user as au
    from repro_torch.kernels import eb_partials

    gen = torch.Generator(device="cpu").manual_seed(SEED + 27)
    scale = HEAD_DIM ** -0.5
    for name, (adj, _) in graphs.items():
        dev = adj.device
        nnz, rows, cols, bias = attn_stream(adj, ATTN_USER_TILE)
        r, c = rows.long(), cols.long()
        q, k, v, do = (head_major(t) for t in attention_operands(
            adj, gen, dev))
        print(f"check: attn_user kernels on the {name} graph's stream "
              f"({rows.numel()} lanes, {nnz} of the pattern)", flush=True)
        for h in range(HEADS):
            s = au.attn_scores(rows, cols, q[h], k[h], nnz=nnz, scale=scale,
                               bias=bias)
            want_s = au.attn_scores_plain(rows, cols, q[h], k[h], nnz=nnz,
                                          scale=scale, bias=bias)
            terms_s = (q[h][r] * k[h][c]).abs().sum(-1) * scale + bias.abs()
            checker.record_terms("attn_lanes", f"{name} head {h} scores", s,
                                 want_s, terms_s)
            m = torch.full((adj.shape[0],), NEG_INF_F32,
                           device=dev).scatter_reduce(0, r[:nnz],
                                                      want_s[:nnz], "amax")
            l = torch.zeros(adj.shape[0], device=dev).index_add_(
                0, r[:nnz], torch.exp(want_s[:nnz] - m[r[:nnz]]))
            got = au.attn_weights(rows, cols, q[h], k[h], v[h], do[h], m, l,
                                  nnz=nnz, scale=scale, bias=bias)
            want = au.attn_weights_plain(rows, cols, q[h], k[h], v[h], do[h],
                                         m, l, nnz=nnz, scale=scale,
                                         bias=bias)
            checker.record_terms("attn_lanes", f"{name} head {h} dw",
                                 got[1], want[1],
                                 (do[h][r] * v[h][c]).abs().sum(-1))
            bound_w = (K_TERMS * 2.0 ** -24 * (terms_s + want_s.abs())
                       + EXP_ULPS * 2.0 ** -23) * want[0]
            err = (got[0] - want[0]).abs()
            record_within(checker, "attn_lanes", f"{name} head {h} w",
                          float(err.max()), bool((err <= bound_w).all())
                          and bool((got[0][nnz:] == 0).all()),
                          f"w (K_TERMS 2^-24 terms(s) + {EXP_ULPS} ulp)")
            delta = torch.randn(adj.shape[0], generator=gen).to(dev)
            checker.record("attn_lanes", f"{name} head {h} ds",
                           au.attn_ds(rows, want[0], want[1], delta,
                                      scale=scale),
                           au.attn_ds_plain(rows, want[0], want[1], delta,
                                            scale=scale), exact=True)
            del s, got, want, terms_s
        # the rescale on the tile in the middle of the stream, head 0
        t0 = (rows.numel() // ATTN_USER_TILE // 2) * ATTN_USER_TILE
        t1 = t0 + ATTN_USER_TILE
        s = au.attn_scores_plain(rows, cols, q[0], k[0], nnz=nnz,
                                 scale=scale, bias=bias)
        n = adj.shape[0]
        m_new = torch.full((n,), NEG_INF_F32, device=dev).scatter_reduce(
            0, r[:nnz], s[:nnz], "amax")[:, None]
        m_old = m_new - torch.rand(n, 1, generator=gen).to(dev)
        m_old[::5] = m_new[::5]
        m_old[1::7] = NEG_INF_F32
        l = torch.rand(n, 1, generator=gen).to(dev) * 10
        acc = torch.randn(1, n, HEAD_DIM, generator=gen).to(dev)
        want = (l.clone(), acc.clone())
        p_want = au.attn_rescale_plain(m_old, m_new, *want, s[t0:t1],
                                       rows[t0:t1], n_valid=nnz - t0)
        p = au.attn_rescale(m_old, m_new, l, acc, s[t0:t1], rows[t0:t1],
                            n_valid=nnz - t0)
        for label, g_, w_ in (("p", p, p_want), ("l", l, want[0]),
                              ("acc", acc, want[1])):
            u = ulps(g_, w_)
            record_within(checker, "attn_rescale",
                          f"{name} tile {t0 // ATTN_USER_TILE} {label}",
                          float((g_ - w_).abs().max()), u <= EXP_ULPS,
                          f"{EXP_ULPS} ulp (observed {u:.1f})")
        l.copy_(want[0])  # the finish on the same inputs
        acc.copy_(want[1])
        au.attn_finish_plain(want[1], want[0])
        au.attn_finish(acc, l)
        checker.record("attn_rescale", f"{name} finish out / max(l, 1e-30)",
                       acc, want[1], exact=True)
        vals = torch.randn(rows.numel(), generator=gen).to(dev)
        for dt in (torch.bfloat16, torch.float16, torch.float8_e4m3fn):
            vb = v[0].to(dt)
            checker.record("eb_partials", f"{name} f32 values on {dt} V",
                           eb_partials.eb_partials(cols, cols, vals, vb,
                                                   n_rows=vb.shape[0]),
                           eb_partials.eb_partials_plain(cols, cols, vals,
                                                         vb), exact=True)
        del q, k, v, do, s, acc, want, vals
        torch.cuda.empty_cache()


def attn_user_run(name, adj, counters, builtin):
    """Graph attention through ``sparse_attention`` under ``seg-generic``
    at nnz tile ATTN_USER_TILE, forward and backward, with the counts
    zeroed just before and read just after (host clock, each ending in a
    synchronise); out against the built-in fused kernels within F32_TOL
    of its largest magnitude, the q, k, v gradients within GRAD_RTOL
    relative L2.  ``builtin`` holds the attend phase's forward and
    backward ms on the same operands.  Returns (counts, timing row)."""
    import torch
    from repro_torch.core import Schedule
    from repro_torch.sparse import sparse_attention

    dev = adj.device
    gen = torch.Generator().manual_seed(SEED + 4)  # the attend phase's
    q, k, v, cot = attention_operands(adj, gen, dev, grad=True)
    sched = Schedule("eb", nnz_tile=ATTN_USER_TILE, group_size=USER_GROUP,
                     strategy="seg-generic")
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = sparse_attention(adj, q, k, v, schedule=sched, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(out, (q, k, v), cot)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {n: c.launches for n, c in counters.items()}
    out_b = sparse_attention(adj, q, k, v, device=dev)
    want = torch.autograd.grad(out_b, (q, k, v), cot)
    err, tol, ok = compare(out, out_b)
    errs = [rel_l2(g, w) for g, w in zip(grads, want)]
    print(f"attn_user {name} seg-generic: out max_abs_err {err:.3e} tol "
          f"{tol} against the built-in kernels; dq, dk, dv relative L2 "
          + ", ".join(f"{e:.3e}" for e in errs)
          + f" (tol {GRAD_RTOL}); launches {counts}", flush=True)
    if not ok or max(errs) > GRAD_RTOL:
        fail(f"attn_user {name}: the user walk disagrees with the built-in "
             "kernels")
    tiles = HEADS * -(-adj.indices.numel() // ATTN_USER_TILE)
    row = (name, tiles, (t1 - t0) * 1e3, (t2 - t1) * 1e3, builtin["fwd_ms"],
           builtin["bwd_ms"])
    del out, grads, out_b, want
    torch.cuda.empty_cache()
    return counts, row


def attn_user_max(name, adj, counters):
    """The forward walk under ``seg-max`` (``combine="max"``: l and out
    reduced under max, the reference's non-softmax answer) against the
    same walk with the plain versions on the card: out within F32_TOL of
    its largest magnitude, m and l per element (F32_TOL of each plus
    STAT_ATOL); ``seg-max-callable`` raises at the max scatter, as the
    reference does.  Returns the counts of the kernel walk."""
    import torch
    from repro_torch.core import Schedule
    from repro_torch.kernels import attn_user as au
    from repro_torch.sparse import sparse_attention

    dev = adj.device
    gen = torch.Generator().manual_seed(SEED + 4)
    q, k, v, _ = (head_major(t) for t in attention_operands(adj, gen, dev))
    nnz, rows, cols, bias = attn_stream(adj, ATTN_USER_TILE)
    kw = dict(n_rows=adj.shape[0], nnz=nnz, nnz_tile=ATTN_USER_TILE,
              group_size=USER_GROUP, strategy="seg-max",
              scale=HEAD_DIM ** -0.5, bias=bias)
    for c in counters.values():
        c.launches = 0
    got = au.fused_sparse_attention_user(rows, cols, q, k, v, **kw)
    torch.cuda.synchronize()
    counts = {n: c.launches for n, c in counters.items()}
    want = au.fused_sparse_attention_user_plain(rows, cols, q, k, v, **kw)
    for label, g, w in zip(("out", "m", "l"), got, want):
        err, tol, ok = compare(g, w, per_element=label != "out")
        print(f"attn_user {name} seg-max: {label} max_abs_err {err:.3e} tol "
              f"{tol} against the plain walk on the card "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"attn_user {name} seg-max: {label} disagrees with the "
                 "plain walk")
    try:
        sparse_attention(adj, q[:1].movedim(0, 1), k[:1].movedim(0, 1),
                         v[:1].movedim(0, 1), device=dev, schedule=Schedule(
                             "eb", nnz_tile=ATTN_USER_TILE,
                             group_size=USER_GROUP,
                             strategy="seg-max-callable"))
        fail("attn_user: a callable combine ran under op='max'")
    except ValueError as e:
        print(f"attn_user {name} seg-max-callable raises as the reference "
              f"does: {e}", flush=True)
    del got, want
    torch.cuda.empty_cache()
    return counts


def attn_user_onehot(graphs, counters):
    """Quickstart's one-hot strategies through ``sparse_attention`` on
    ONEHOT_GRAPH at ONEHOT_HEADS head of HEAD_DIM, forward only:
    ``onehot-spec`` against the built-in kernels (F32_TOL of out's
    largest magnitude: the row max is a sum of scores there, but m only
    stabilises the softmax), ``onehot-tile`` NaN everywhere (its
    4-argument realization sums scores into m, which stays at NEG_INF, and
    the one-hot product's 0 * inf reaches every row: the reference's
    answer, held against the JAX package on the CPU by
    tests/test_torch_attn_user.py).  Returns the runs."""
    import torch
    from repro_torch.core import Schedule
    from repro_torch.sparse import sparse_attention

    adj = graphs[ONEHOT_GRAPH][0]
    dev = adj.device
    gen = torch.Generator().manual_seed(SEED + 4)
    q, k, v, _ = (t[:, :ONEHOT_HEADS].contiguous()
                  for t in attention_operands(adj, gen, dev))
    want = sparse_attention(adj, q, k, v, device=dev)
    tiles = ONEHOT_HEADS * -(-adj.indices.numel() // ATTN_USER_TILE)
    social_tiles = HEADS * -(-graphs["social"][0].indices.numel()
                             // ATTN_USER_TILE)
    runs = []
    for strategy in ("onehot-spec", "onehot-tile"):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = sparse_attention(adj, q, k, v, device=dev, schedule=Schedule(
            "eb", nnz_tile=ATTN_USER_TILE, group_size=USER_GROUP,
            strategy=strategy))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {n: c.launches for n, c in counters.items()}
        if strategy == "onehot-spec":
            err, tol, ok = compare(out, want)
            verdict = (f"max_abs_err {err:.3e} tol {tol} against the "
                       "built-in kernels")
        else:
            ok = bool(torch.isnan(out).all())
            verdict = "NaN everywhere, as the reference"
        print(f"attn_user onehot {strategy}: {ONEHOT_GRAPH}, {ONEHOT_HEADS} "
              f"head of {HEAD_DIM}, nnz tile {ATTN_USER_TILE}, forward; "
              f"{verdict} {'ok' if ok else 'FAIL'}; {ms:.1f} ms (host "
              f"clock), {tiles} tiles, {ms / tiles * 1e3:.1f} us a tile; "
              f"why here: its one-hot is {ATTN_USER_TILE} x {adj.shape[0]} "
              f"f32 ({ATTN_USER_TILE * adj.shape[0] * 4 / 1e9:.2f} GB) for "
              f"each of 3 scatters a tile, so social at {HEADS} heads "
              f"({social_tiles} tiles) would take about "
              f"{ms / tiles * social_tiles / 1e3:.0f} s a forward at this "
              f"rate, and the backward's 4 more a tile; launches {counts}",
              flush=True)
        if not ok:
            fail(f"attn_user onehot {strategy}: not the reference's answer")
        kernels = ("attn_lanes", "attn_rescale", "eb_partials") + (
            ("user_combine",) if strategy == "onehot-spec" else ())
        runs.append((counts, f"attn_user onehot {strategy}", kernels))
        del out
        torch.cuda.empty_cache()
    return runs


def attn_user_kernel_rows(adj):
    """The two kernels' rows of the ``{"kernels": [...]}`` line on one
    social pass at 4 heads x 64 and nnz tile ATTN_USER_TILE.
    ``attn_lanes``: its launches of a forward and backward (scores,
    weights, ds: 3 a head) back to back, CUDA events, beside their plain
    versions; bytes each input once and each output once, 2 d operations
    a dot.  ``attn_rescale``: head 0's forward under ``seg-generic``
    recorded tile by tile (m before and after each max scatter), then
    its 1 + tiles launches replayed on fresh l and accumulator, device
    time under the profiler (``device_ms``), beside the plain version's;
    bytes m_old, m_new, the tile's s, rows and p, and l and the
    accumulator read and written on the rows whose alpha is not 1 in
    this run.  Neither has a single PyTorch call that computes it."""
    import torch
    from repro_torch.kernels import attn_user as au
    from repro_torch.kernels import fused_attention as fa

    dev = adj.device
    gen = torch.Generator().manual_seed(SEED + 4)
    q, k, v, do = (head_major(t) for t in attention_operands(adj, gen, dev))
    nnz, rows, cols, bias = attn_stream(adj, ATTN_USER_TILE)
    scale = HEAD_DIM ** -0.5
    _, m, l = fa.fused_sparse_attention(adj.indptr, adj.indices, q, k, v,
                                        scale=scale, bias=adj.vals)
    delta = torch.zeros_like(m)
    n, t, d = adj.shape[0], rows.numel(), HEAD_DIM

    def lanes(scores, weights, ds):
        for h in range(HEADS):
            scores(rows, cols, q[h], k[h], nnz=nnz, scale=scale, bias=bias)
            w, dw, _ = weights(rows, cols, q[h], k[h], v[h], do[h], m[h],
                               l[h], nnz=nnz, scale=scale, bias=bias)
            ds(rows, w, dw, delta[h], scale=scale)

    qk = 2 * n * d * 4  # q and k of a head (n_kv = n_rows)
    mode_bytes = {  # a head's
        "scores": 3 * t * 4 + qk + t * 4,  # rows, cols, bias, q, k; s
        "weights": 3 * t * 4 + 2 * qk + 2 * n * 4 + 3 * t * 4,  # + v,
        # dout, m, l; w, dw, w dw
        "ds": 3 * t * 4 + n * 4 + t * 4}  # rows, w, dw, delta; ds
    mode_flops = {"scores": 2 * t * d, "weights": 2 * (2 * t * d),
                  "ds": 3 * t}
    lane_bytes = HEADS * sum(mode_bytes.values())
    lane_flops = HEADS * sum(mode_flops.values())
    rows_out = {"attn_lanes": dict(
        ms=cuda_ms(lambda: lanes(au.attn_scores, au.attn_weights,
                                 au.attn_ds), 3, 1),
        plain_ms=cuda_ms(lambda: lanes(au.attn_scores_plain,
                                       au.attn_weights_plain,
                                       au.attn_ds_plain), 2, 1),
        bytes=lane_bytes, flops=lane_flops, library_ms=None,
        launches=3 * HEADS)}
    rows_out["attn_lanes"]["detail"] = {"modes": attn_lanes_modes(
        adj, q, k, v, do, m, l, delta, mode_bytes, mode_flops)}
    recorded = []

    def record(m_old, m_new, l_, acc, s, r, *, n_valid):
        recorded.append((m_old.clone(), m_new.clone(), s, r, n_valid))
        return au.attn_rescale(m_old, m_new, l_, acc, s, r, n_valid=n_valid)

    ops = au.KERNEL_OPS
    au.KERNEL_OPS = ops._replace(rescale=record)
    try:
        au.fused_sparse_attention_user(rows, cols, q[:1], k[:1], v[:1],
                                       n_rows=n, nnz=nnz,
                                       nnz_tile=ATTN_USER_TILE,
                                       group_size=USER_GROUP,
                                       strategy="seg-generic", scale=scale,
                                       bias=bias)
    finally:
        au.KERNEL_OPS = ops
    l_r = torch.zeros(n, 1, device=dev)
    acc_r = torch.zeros(1, n, d, device=dev)
    moved = sum(int((torch.where(mo <= fa.NEG_INF / 2, 0.0,
                                 torch.exp(mo - mn)) != 1).sum())
                for mo, mn, *_ in recorded)

    def replay(rescale, finish):
        for mo, mn, s, r, nv in recorded:
            rescale(mo, mn, l_r, acc_r, s, r, n_valid=nv)
        finish(acc_r, l_r)

    kernel = lambda: replay(au.attn_rescale, au.attn_finish)  # noqa: E731
    plain = lambda: replay(au.attn_rescale_plain,  # noqa: E731
                           au.attn_finish_plain)
    tile = ATTN_USER_TILE
    rows_out["attn_rescale"] = dict(
        ms=sum(device_ms(kernel, 1, 2).values()),
        plain_ms=sum(device_ms(plain, 1, 2).values()),
        window_ms=cuda_ms(kernel, 2, 1),
        bytes=len(recorded) * (2 * n * 4 + 3 * tile * 4)
        + moved * (2 * 4 + 2 * d * 4) + 2 * n * d * 4 + n * 4,
        flops=len(recorded) * (n + tile) + moved * (d + 1) + n * d,
        library_ms=None, launches=len(recorded) + 1, moved=moved)
    for name, r in rows_out.items():
        print(f"attn_user kernel {name}: {r['launches']} launches of one "
              f"social pass{' (head 0, forward)' if 'moved' in r else ''}"
              f" {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
              + (f" (device time; the CUDA-event window {r['window_ms']:.4f}"
                 f" ms; {r['moved']} rows rescaled over the tiles, of "
                 f"{len(recorded) * n})" if "moved" in r else "")
              + f", bound {bound(r['bytes'], r['flops'])[0]:.4f} ms",
              flush=True)
    del recorded
    torch.cuda.empty_cache()
    return rows_out


def attn_lanes_modes(adj, q, k, v, do, m, l, delta, mode_bytes,
                     mode_flops):
    """``attn_lanes``' three modes timed apart over one social pass (4
    heads each; medians of CUDA-event windows, ``cuda_ms_median``: a ds
    launch is shorter than the host's call, so its window times the
    host), each beside its bound; the scores mode also beside
    ``torch.sparse.sampled_addmm`` (bias + scale Q K^T at the pattern)
    over the same head's nnz lanes, the one PyTorch call that computes
    it (cuSPARSE's SDDMM), which the port never calls (K^T made
    contiguous before the timing, as the SDDMM row does).  The
    profiler's device time (``device_ms``) recorded 13 of a window's 20
    launches at this point of a whole run, in every try (NVIDIA H100
    80GB HBM3, 700 W)."""
    import torch
    from repro_torch.kernels import attn_user as au

    nnz, rows, cols, bias = attn_stream(adj, ATTN_USER_TILE)
    scale = HEAD_DIM ** -0.5
    w, dw, _ = au.attn_weights(rows, cols, q[0], k[0], v[0], do[0], m[0],
                               l[0], nnz=nnz, scale=scale, bias=bias)
    calls = {
        "scores": lambda h: au.attn_scores(rows, cols, q[h], k[h], nnz=nnz,
                                           scale=scale, bias=bias),
        "weights": lambda h: au.attn_weights(
            rows, cols, q[h], k[h], v[h], do[h], m[h], l[h], nnz=nnz,
            scale=scale, bias=bias),
        "ds": lambda h: au.attn_ds(rows, w, dw, delta[h], scale=scale)}
    out = {}
    for mode, call in calls.items():
        ms = cuda_ms_median(lambda call=call: [call(h)
                                               for h in range(HEADS)])
        b_ms, b_by = bound(HEADS * mode_bytes[mode],
                           HEADS * mode_flops[mode])
        out[mode] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None}
    csr = library_csr(adj)
    kt = [k[h].t().contiguous() for h in range(HEADS)]
    try:
        got = torch.sparse.sampled_addmm(csr, q[0], kt[0], alpha=scale)
        err = float((got.values() - au.attn_scores(
            rows, cols, q[0], k[0], nnz=nnz, scale=scale,
            bias=bias)[:nnz]).abs().max())
        out["scores"]["library_ms"] = cuda_ms_median(lambda: [
            torch.sparse.sampled_addmm(csr, q[h], kt[h], alpha=scale)
            for h in range(HEADS)])
        print(f"library attn scores: sampled_addmm agrees with attn_lanes "
              f"to max_abs_err {err:.3e}", flush=True)
    except RuntimeError as e:
        print(f"library attn scores: torch.sparse.sampled_addmm refused: "
              f"{e}", flush=True)
    for mode, r in out.items():
        lib = r["library_ms"]
        print(f"attn_user kernel attn_lanes mode {mode}: {HEADS} launches "
              f"of one social pass {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}"
              + ("" if lib is None else f", sampled_addmm {lib:.4f} ms"),
              flush=True)
    return out


def attn_user_phase(graphs, counters, attended):
    """A user strategy inside the fused attention (the reference's seven
    scatters through the user's code): the walk's kernels against their
    plain versions (:func:`attn_user_check_kernels`), forward and
    backward under ``seg-generic`` on both graphs against the built-in
    kernels (:func:`attn_user_run`), the forward under ``seg-max``
    against the plain walk (:func:`attn_user_max`), quickstart's one-hot
    strategies (:func:`attn_user_onehot`) and the two kernels' timing
    rows.  Returns the runs (counts, path, the kernels it must launch),
    the worst errors and the timing rows."""
    import torch

    t0 = time.perf_counter()
    user_strategies()
    checker = Checker(("attn_lanes", "attn_rescale", "eb_partials"))
    must = ("attn_lanes", "attn_rescale", "eb_partials", "user_combine")
    runs, rows = [], []
    with torch.no_grad():
        attn_user_check_kernels(graphs, checker)
    for name, (adj, _) in graphs.items():
        counts, row = attn_user_run(name, adj, counters, attended[name])
        runs.append((counts, f"attn_user {name} seg-generic", must))
        rows.append(row)
    with torch.no_grad():
        for name, (adj, _) in graphs.items():
            runs.append((attn_user_max(name, adj, counters),
                         f"attn_user {name} seg-max", must))
        runs += attn_user_onehot(graphs, counters)
        results = attn_user_kernel_rows(graphs["social"][0])
    worst = checker.done()
    for name, tiles, fwd, bwd, b_fwd, b_bwd in rows:
        print(f"attn_user forward {name} seg-generic: {fwd:.4f} ms, backward "
              f"{bwd:.4f} ms (host clock, one pass each); built-in kernels "
              f"{b_fwd:.4f} and {b_bwd:.4f} ms; {tiles} tiles walked a pass "
              f"({HEADS} heads), {fwd / tiles * 1e3:.2f} us a tile forward, "
              f"{bwd / tiles * 1e3:.2f} backward", flush=True)
    print(f"attn_user: phase {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return {"runs": runs, "worst": worst, "results": results}


# ---------------------------------------------------------------------------
# LM training (lm_train): the grouped matmul's backward and the trainer
# ---------------------------------------------------------------------------


def one_host(trainer):
    """``trainer`` with its straggler check off: with one host it holds
    the host's latest step times against its own median, and a few noisy
    host-bound steps could end a run early with an elastic plan."""
    trainer.monitor.straggler_factor = math.inf
    return trainer


def lm_config():
    """Qwen3-MoE at full width cut to LM_LAYERS layers, and the byte
    reckoning of the cut: AdamW keeps bf16 parameters and gradients and
    f32 mu and nu, 12 bytes a parameter."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH).scaled(n_layers=LM_LAYERS)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    attn = d * cfg.attn_dim + 2 * d * cfg.kv_dim + cfg.attn_dim * d \
        + 2 * cfg.d_head + 2 * d
    layer = attn + d * e + 3 * e * d * f
    embed = cfg.vocab_size * d + d
    reckon = "; ".join(
        f"{n} layer{'s' if n > 1 else ''}: "
        f"{(n * layer + embed) * LM_BYTES_PER_PARAM / 1e9:.1f} GB"
        for n in (1, 2))
    print(f"lm_train: {cfg.name} at full width (d_model {d}, {cfg.n_heads} "
          f"heads x {cfg.d_head} over {cfg.n_kv_heads} kv, qk_norm "
          f"{cfg.qk_norm}, {e} experts top-{cfg.experts_per_token} of width "
          f"{f}, vocab {cfg.vocab_size}, {cfg.param_dtype}), cut from 94 "
          f"layers to {LM_LAYERS} by memory: a layer holds "
          f"{layer / 1e9:.3f} B parameters (attention {attn / 1e6:.1f} M, "
          f"router {d * e / 1e6:.1f} M, wg, wi, wo {e * d * f / 1e6:.1f} M "
          f"each), the tied embedding {embed / 1e6:.1f} M; under AdamW "
          f"({LM_BYTES_PER_PARAM} bytes a parameter: bf16 parameters and "
          f"gradients, f32 mu and nu) {reckon} of the card's 80 GB, and "
          "two layers leave too little for the update's per-leaf f32 "
          "temporaries (3.2 GB an expert tensor, several alive at once) "
          f"and the activations and logits; batch {LM_BATCH} x seq "
          f"{LM_SEQ} (launch/train.py's defaults)", flush=True)
    return cfg


def gmm_backward_operands(cfg, dev, n_experts, tiles_per_expert, gen):
    """The backward's operands at the expert width on ``n_experts``
    experts: bf16 weights (E, D, F) like wg and wi and (E, F, D) like wo,
    bf16 tokens x (T, D) and (T, F), zero-mean f32 gradients dz (T, F) and
    (T, D), and the sorted map of ``tiles_per_expert`` tiles of LM_TILE
    rows an expert."""
    import torch

    d, f = cfg.d_model, cfg.moe_d_ff
    t = n_experts * tiles_per_expert * LM_TILE
    te = torch.arange(n_experts, dtype=torch.int32,
                      device=dev).repeat_interleave(tiles_per_expert)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    return {"te": te,
            "w_up": rnd(n_experts, d, f, scale=d ** -0.5,
                        dtype=torch.bfloat16),
            "w_down": rnd(n_experts, f, d, scale=f ** -0.5,
                          dtype=torch.bfloat16),
            "x_d": rnd(t, d, dtype=torch.bfloat16),
            "x_f": rnd(t, f, dtype=torch.bfloat16),
            "dz_f": rnd(t, f), "dz_d": rnd(t, d)}


#: The backward's partner types and the route each takes (kernels/
#: grouped_matmul.py::gmm_bwd_route): bf16 and e4m3 values are exactly
#: bf16, so f32 dz splits into three exact bf16 products on the tensor
#: cores; f32 and fp16 values do not, and keep the CUDA cores.
GMM_BWD_PARTNERS = (("bfloat16", "mma"), ("float8_e4m3fn", "mma"),
                    ("float32", "fma"), ("float16", "fma"))


def f64_gmm_t(dz, te, w, tt):
    """dx = dz . W[e]^T per tile, in f64 (every id valid)."""
    k = dz.shape[1]
    xt = dz.double().reshape(-1, tt, k)
    return (xt @ w[te.long()].double().transpose(1, 2)).reshape(
        dz.shape[0], -1)


def f64_dw(x, dz, te, n_experts, tt):
    """(dW, db) per expert over its tiles, in f64."""
    import torch
    from repro_torch.kernels import grouped_matmul_dw as gmd

    offsets, order = gmd.tile_csr(te, n_experts)
    offsets = offsets.tolist()
    rows = (order.long()[:, None] * tt + torch.arange(
        tt, device=x.device)).reshape(-1)
    dw = torch.zeros(n_experts, x.shape[1], dz.shape[1], dtype=torch.float64,
                     device=x.device)
    db = torch.zeros(n_experts, dz.shape[1], dtype=torch.float64,
                     device=x.device)
    for ex in range(n_experts):
        r = rows[offsets[ex] * tt: offsets[ex + 1] * tt]
        if r.numel():
            dw[ex] = x[r].double().t() @ dz[r].double()
            db[ex] = dz[r].double().sum(0)
    return dw, db


def check_gmm_backward(cfg, dev):
    """(a) The backward's two kernels on both routes (GMM_BWD_PARTNERS:
    bf16 and e4m3 partners on the tensor cores, f32 and fp16 on the CUDA
    cores; the route taken is counted and must be the one the type
    fixes) on LM_CHECK_EXPERTS experts of the full D and F (two tiles of
    LM_TILE rows an expert, as the training batch gives them), per
    element within K_TERMS units of 2^-24 of the terms entering each
    output, against the plain version (f32) and against the f64 product
    of the same operands (k printed for both): ``dx = dz . W[e]^T`` on the
    forward kernel with the weights read transposed, for the up (E, D, F)
    and down (E, F, D) weights; ``dW`` and ``db`` on
    ``grouped_matmul_dw``, on the sorted map and on an unsorted map in
    which one expert owns no tile (its dW and db must be 0); each
    kernel's bf16 store against its own f32 sums rounded, bit for bit."""
    import torch
    from repro_torch.core import Epilogue
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import grouped_matmul_dw as gmd

    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    e, tt = LM_CHECK_EXPERTS, LM_TILE
    d, f = cfg.d_model, cfg.moe_d_ff
    t = e * 2 * tt
    te = torch.arange(e, dtype=torch.int32, device=dev).repeat_interleave(2)
    empty = e // 2 + 1
    others = [i for i in range(e) if i != empty]
    pick = torch.randint(len(others), (te.numel(),), generator=gen,
                         device=dev)
    shuffled = torch.tensor(others, dtype=torch.int32, device=dev)[pick]
    maps = (("sorted", te), ("unsorted", shuffled))
    checker = Checker(("grouped_matmul_dx", "grouped_matmul_dw"))

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def bits(name, label, got, f32):
        ok = torch.equal(got, f32.to(got.dtype))
        print(f"  {name:19s} {label:48s} {'same bits' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            checker.failures.append(f"{name} {label}")

    def routed(name, label, counts, before, want):
        took = {r: n - before[r] for r, n in counts.items() if n != before[r]}
        if took != {want: 1}:
            print(f"  {name:19s} {label}: routes {took}, want {want} FAIL",
                  flush=True)
            checker.failures.append(f"{name} {label} route {took}")

    dz_f, dz_d = rnd(t, f), rnd(t, d)
    w32 = {"up": rnd(e, d, f, scale=d ** -0.5),
           "down": rnd(e, f, d, scale=f ** -0.5)}
    x32 = {"up": rnd(t, d), "down": rnd(t, f)}
    for tname, route in GMM_BWD_PARTNERS:
        dtype = getattr(torch, tname)
        print(f"  partner {tname}: route {route}", flush=True)
        for wname, dz in (("up", dz_f), ("down", dz_d)):
            w = w32[wname].to(dtype)
            n, k = w.shape[1], w.shape[2]
            for mname, m in maps:
                kw = dict(token_tile=tt, f_tile=n, d_tile=k, w_trans=True)
                before = dict(gm.ROUTE_LAUNCHES)
                got = gm.grouped_matmul(dz, m, w, **kw)
                routed("grouped_matmul_dx", f"dx {wname} {mname} {tname}",
                       gm.ROUTE_LAUNCHES, before, route)
                want = gm.grouped_matmul_plain(dz, m, w, token_tile=tt,
                                               w_trans=True)
                terms = gm.grouped_matmul_plain(dz.abs(), m, w.float().abs(),
                                                token_tile=tt, w_trans=True)
                label = f"dx {wname} {mname} {tname} ({t} x {k} -> {n})"
                checker.record_terms("grouped_matmul_dx", label, got, want,
                                     terms)
                checker.record_terms("grouped_matmul_dx", f"{label} f64",
                                     got, f64_gmm_t(dz, m, w, tt).float(),
                                     terms)
                bits("grouped_matmul_dx", f"dx {wname} {mname} {tname} "
                     "bf16 store", gm.grouped_matmul(
                         dz, m, w, epilogue=Epilogue(out_dtype="bfloat16"),
                         **kw), got)
                del got, want, terms
            del w
        for wname, dz in (("up", dz_f), ("down", dz_d)):
            x = x32[wname].to(dtype)
            for mname, m in maps:
                kw = dict(token_tile=tt, bias_dtype=torch.float32)
                before = dict(gmd.ROUTE_LAUNCHES)
                got, gdb = gmd.grouped_matmul_dw(x, dz, m, e,
                                                 w_dtype=torch.float32, **kw)
                routed("grouped_matmul_dw", f"dW {wname} {mname} {tname}",
                       gmd.ROUTE_LAUNCHES, before, route)
                want, wdb = gmd.grouped_matmul_dw_plain(
                    x, dz, m, e, w_dtype=torch.float32, **kw)
                terms, tdb = gmd.grouped_matmul_dw_plain(
                    x.float().abs(), dz.abs(), m, e, w_dtype=torch.float32,
                    **kw)
                w64, b64 = f64_dw(x, dz, m, e, tt)
                label = (f"dW {wname} {mname} {tname} ({x.shape[1]} x "
                         f"{dz.shape[1]}, {x.shape[0]} rows)")
                checker.record_terms("grouped_matmul_dw", label, got, want,
                                     terms)
                checker.record_terms("grouped_matmul_dw", f"{label} f64",
                                     got, w64.float(), terms)
                checker.record_terms("grouped_matmul_dw",
                                     f"db {wname} {mname} {tname}", gdb, wdb,
                                     tdb)
                checker.record_terms("grouped_matmul_dw",
                                     f"db {wname} {mname} {tname} f64", gdb,
                                     b64.float(), tdb)
                g16, _ = gmd.grouped_matmul_dw(x, dz, m, e,
                                               w_dtype=torch.bfloat16,
                                               token_tile=tt)
                bits("grouped_matmul_dw", f"dW {wname} {mname} {tname} bf16 "
                     "store", g16, got)
                if mname == "unsorted":
                    zero = (not bool(got[empty].any())
                            and not bool(gdb[empty].any()))
                    print(f"  {'grouped_matmul_dw':19s} expert {empty} owns "
                          f"no tile: dW and db all 0 "
                          f"{'ok' if zero else 'FAIL'}", flush=True)
                    if not zero:
                        checker.failures.append(
                            f"grouped_matmul_dw empty expert {tname}")
                del got, want, terms, g16, w64
            del x
    del dz_f, dz_d, w32, x32
    torch.cuda.empty_cache()
    return checker.done()


def time_gmm_backward(cfg, dev):
    """Row 7b at the training batch's shapes (every expert, cap_pad 2 x
    LM_TILE rows, T_pad 32,768, bf16 weights and tokens: the tensor-core
    route): one layer's backward launches, dx for wg, wi (up) and wo
    (down) and dW for the same three, each kernel's ms (CUDA events)
    beside its plain version's and the library yardstick's, ``torch.bmm``
    in f32 over the weights transposed (dx) and over the equal-run (E,
    cap_pad, .) view of the tokens (dW), on f32 copies made before the
    clock starts (the port calls neither).  Bytes: each input read once,
    the output written once.  Operations: the route's, three bf16 passes
    (3 x 2 T N K) at the bf16 peak; the f32 product's bound at the f32
    CUDA-core peak (the "fma" route's, and row 7b's before the split)
    printed beside it."""
    import torch
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import grouped_matmul_dw as gmd

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    e = cfg.n_experts
    ops = gmm_backward_operands(cfg, dev, e, 2, gen)
    te, tt = ops["te"], LM_TILE
    rows = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                   "bytes": 0, "flops": 0, "flop_per_s": BF16_FLOP_PER_S,
                   "detail": {"bound_f32_ms": 0.0}}
            for name in ("grouped_matmul_dx", "grouped_matmul_dw")}

    def add(name, label, route, times, count, nbytes, flops):
        ms, plain, lib = times
        if route != "mma":
            fail(f"{name} {label}: the bf16 operands took route {route}")
        b_ms, by = bound(nbytes, 3 * flops, BF16_FLOP_PER_S)
        f_ms, f_by = bound(nbytes, flops)
        print(f"{name} {label} (x{count} a layer, route {route}): "
              f"{ms:.4f} ms (bound {b_ms:.4f} ms by {by}: {nbytes} bytes, "
              f"3 x {flops} bf16 operations, {3 * flops / ms / 1e9:.1f} "
              f"TFLOP/s; the f32 product's bound {f_ms:.4f} ms by {f_by}, "
              f"{flops / ms / 1e9:.1f} f32-equivalent TFLOP/s), plain "
              f"{plain:.4f} ms, torch.bmm f32 {lib:.4f} ms "
              f"({ms / lib:.3f}x)", flush=True)
        r = rows[name]
        for key, v in zip(("ms", "plain_ms", "library_ms", "bytes", "flops"),
                          (ms, plain, lib, nbytes, 3 * flops)):
            r[key] += count * v
        r["detail"]["bound_f32_ms"] += count * f_ms

    for label, w, dz, count in (("up (wg, wi)", ops["w_up"], ops["dz_f"], 2),
                                ("down (wo)", ops["w_down"], ops["dz_d"], 1)):
        n, k = w.shape[1], w.shape[2]
        t = dz.shape[0]
        route = gm.gmm_bwd_route(w.dtype, k, k, w.data_ptr(), dz.data_ptr())
        ms = cuda_ms(lambda: gm.grouped_matmul(
            dz, te, w, token_tile=tt, f_tile=n, d_tile=k, w_trans=True), 5, 1)
        plain = cuda_ms(lambda: plain_gmm(dz, te, w, token_tile=tt,
                                          w_trans=True), 2, 1)
        w32 = w.float().transpose(1, 2)
        dzb = dz.view(e, -1, k)
        lib = cuda_ms(lambda: torch.bmm(dzb, w32), 5, 1)
        del w32
        torch.cuda.empty_cache()
        add("grouped_matmul_dx", f"dx {label} ({t} x {k} -> {n})", route,
            (ms, plain, lib), count,
            dz.numel() * 4 + w.numel() * 2 + t * n * 2, 2 * t * n * k)
    for label, x, dz, count in (("up (wg, wi)", ops["x_d"], ops["dz_f"], 2),
                                ("down (wo)", ops["x_f"], ops["dz_d"], 1)):
        t, d = x.shape
        f = dz.shape[1]
        route = gm.gmm_bwd_route(x.dtype, d, f, x.data_ptr(), dz.data_ptr())
        kw = dict(token_tile=tt, w_dtype=torch.bfloat16)
        ms = cuda_ms(lambda: gmd.grouped_matmul_dw(x, dz, te, e, **kw), 5, 1)
        plain = cuda_ms(lambda: gmd.grouped_matmul_dw_plain(x, dz, te, e,
                                                            **kw), 2, 1)
        xb = x.float().view(e, -1, d).transpose(1, 2)
        dzb = dz.view(e, -1, f)
        lib = cuda_ms(lambda: torch.bmm(xb, dzb), 5, 1)
        del xb
        torch.cuda.empty_cache()
        add("grouped_matmul_dw", f"dW {label} ({t} rows, {d} x {f})", route,
            (ms, plain, lib), count,
            x.numel() * 2 + dz.numel() * 4 + e * d * f * 2, 2 * t * d * f)
    del ops
    torch.cuda.empty_cache()
    return rows


def _param_leaves(params):
    from repro_torch.core.tree import key_str, tree_leaves_with_path

    return [(key_str(p), t) for p, t in tree_leaves_with_path(params)]


def lm_batch(cfg, dev):
    """The first batch of the trainer's token stream (seed SEED)."""
    import torch
    from repro_torch.data.synthetic import ShardedTokenStream

    tokens = next(ShardedTokenStream(cfg.vocab_size, LM_SEQ, LM_BATCH,
                                     seed=SEED))["tokens"]
    return {"tokens": torch.as_tensor(tokens, device=dev)}


def lm_grad_check(cfg, dev):
    """(b) One step's loss and every leaf's gradient on the kernel path
    against the einsum path (``moe_kernel_dispatch=False``) on the card,
    at full width and LM_LAYERS layers, on the trainer's first batch:
    loss within LM_LOSS_REL relative, each gradient within
    LM_GRAD_REL_L2 relative L2.  Returns the kernel path's loss."""
    import torch
    from repro_torch.models import get_model

    api = get_model(cfg)
    einsum = get_model(cfg.scaled(moe_kernel_dispatch=False))
    params = api.init(torch.Generator(device=dev).manual_seed(SEED),
                      device=dev)
    batch = lm_batch(cfg, dev)
    named = _param_leaves(params)
    leaves = [t for _, t in named]
    out = {}
    for label, a in (("kernel", api), ("einsum", einsum)):
        for p in leaves:
            p.requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = a.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        for p in leaves:
            p.requires_grad_(False)
        out[label] = (float(loss.detach()), grads, time.perf_counter() - t0)
    (lk, gk, sk), (le, ge, se) = out["kernel"], out["einsum"]
    loss_err = abs(lk - le) / abs(le)
    print(f"lm_train: loss on the kernel path {lk:.6f} ({sk:.2f} s forward "
          f"and backward, host clock), einsum path {le:.6f} ({se:.2f} s): "
          f"relative error {loss_err:.3e} (tol {LM_LOSS_REL:.3e})",
          flush=True)
    bad = [] if loss_err <= LM_LOSS_REL else ["loss"]
    for (name, p), a, b in zip(named, gk, ge):
        err = rel_l2(a, b)
        ok = err <= LM_GRAD_REL_L2
        print(f"  gradient {name:28s} {tuple(p.shape)} {dtype_name(a)}: "
              f"relative L2 {err:.3e} (tol {LM_GRAD_REL_L2:.3e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(name)
    del params, leaves, named, gk, ge, out
    torch.cuda.empty_cache()
    if bad:
        fail(f"lm_train: the kernel path's loss or gradients disagree with "
             f"the einsum path: {bad}")
    return lk


def lm_trainer(cfg, dev, counters, first_loss, lr, must_fall):
    """(c) ``Trainer`` for LM_STEPS steps at constant learning rate ``lr``
    and weight decay 0 on the token stream, with no checkpoint (37 GB at
    this width); the kernels' counts zeroed just before the run and read
    just after; step ms by CUDA events around each step, the new launches'
    ms by events around each launch (``LaunchTimer``), the peak of
    ``torch.cuda.max_memory_allocated``.  The losses must be finite, and
    with ``must_fall`` fall (the last below the first, the mean of the
    last three below that of the first three)."""
    import tempfile

    import torch
    from repro_torch.data.synthetic import ShardedTokenStream
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import grouped_matmul_dw as gmd
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import AdamW, constant_schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig

    api = get_model(cfg)
    data = ShardedTokenStream(cfg.vocab_size, LM_SEQ, LM_BATCH, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckpt:
        tr = one_host(Trainer(
            api, AdamW(lr=constant_schedule(lr), weight_decay=0.0),
            iter(data), ckpt_dir=ckpt,
            tcfg=TrainerConfig(total_steps=LM_STEPS, ckpt_every=LM_STEPS + 1,
                               log_every=1), device=dev))
        state = tr.init_or_restore(torch.Generator(device=dev).manual_seed(
            SEED))
        events, step_fn = [], tr.step_fn

        def timed(st, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step_fn(st, batch)
            end.record()
            events.append((start, end))
            return out

        tr.step_fn = timed
        for k in counters.values():
            k.launches = 0
        before = (dict(gm.ROUTE_LAUNCHES), dict(gmd.ROUTE_LAUNCHES))
        with LaunchTimer() as lt:
            state = tr.run(state)
        counts = {n: k.launches for n, k in counters.items()}
        routes = {f"{name} {r}": n - b[r]
                  for name, now, b in (("grouped_matmul", gm.ROUTE_LAUNCHES,
                                        before[0]),
                                       ("grouped_matmul_dw",
                                        gmd.ROUTE_LAUNCHES, before[1]))
                  for r, n in now.items()}
        launch_ms = lt.ms()
    torch.cuda.synchronize()
    step_ms = [s.elapsed_time(e) for s, e in events]
    peak = torch.cuda.max_memory_allocated()
    losses = tr.losses()
    if must_fall:  # where the step's time goes, two steps more
        batch = next(data)
        profile_step(f"lm_train step (lr {lr:.4g})",
                     lambda: step_fn(state, batch))
    del state, tr
    torch.cuda.empty_cache()
    per_step = {n: c / LM_STEPS for n, c in counts.items() if c}
    new = {n: launch_ms.get(n, 0.0) / LM_STEPS
           for n in ("grouped_matmul", "grouped_matmul_dx",
                     "grouped_matmul_dw")}
    print(f"lm_train: {LM_STEPS} steps at lr {lr:.4g}, losses "
          + ", ".join(f"{v:.6f}" for v in losses)
          + f" (step 1 against check (b)'s kernel-path loss {first_loss:.6f})"
          f"; step ms (CUDA events) " + ", ".join(f"{v:.4f}" for v in step_ms)
          + f", mean of steps 2-{LM_STEPS} "
          f"{sum(step_ms[1:]) / (len(step_ms) - 1):.4f} ms; peak "
          f"max_memory_allocated {peak / 1e9:.2f} GB; launches a step "
          f"{per_step}; grouped-matmul routes {routes}; grouped-matmul "
          "ms a step (events around each "
          "launch): " + ", ".join(f"{n} {v:.4f}" for n, v in new.items())
          + f"; {card_line()}", flush=True)
    falls = (losses[-3:].mean() < losses[:3].mean()
             and losses[-1] < losses[0])
    if routes["grouped_matmul fma"] or routes["grouped_matmul_dw fma"]:
        fail(f"lm_train: a grouped-matmul launch of the bf16 model left "
             f"the tensor cores: {routes}")
    if not (len(losses) == LM_STEPS and all(map(math.isfinite, losses))
            and (falls or not must_fall)):
        fail(f"lm_train: the losses at lr {lr:.4g} are not finite or do not "
             f"fall over {LM_STEPS} steps: {list(losses)}")
    return {"counts": counts, "step_ms": step_ms, "peak": peak,
            "losses": losses, "lr": lr}


def lm_checkpoint(dev):
    """(c) A save and restore round trip at smoke size on the card: a
    trainer saves at steps 2 and 4 of 4, a second one restores step 4
    (every leaf bit for bit) and runs to step 6."""
    import tempfile

    import torch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import ShardedTokenStream
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import AdamW, constant_schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = smoke_config(get_config(MOE_ARCH))
    api = get_model(cfg)
    opt = AdamW(lr=constant_schedule(LM_LR), weight_decay=0.0)
    with tempfile.TemporaryDirectory() as ckpt:
        def trainer(steps):
            return one_host(Trainer(api, opt, iter(ShardedTokenStream(
                cfg.vocab_size, 32, 8, seed=SEED)), ckpt_dir=ckpt,
                tcfg=TrainerConfig(total_steps=steps, ckpt_every=2,
                                   log_every=100), device=dev))

        tr = trainer(4)
        state = tr.run(tr.init_or_restore(
            torch.Generator(device=dev).manual_seed(SEED)))
        saved = [t.clone() for t in tree_leaves(state)]
        steps = tr.ckpt.all_steps()
        tr2 = trainer(6)
        restored = tr2.init_or_restore(
            torch.Generator(device=dev).manual_seed(SEED + 1))
        same = all(a.device == b.device and torch.equal(a, b)
                   for a, b in zip(tree_leaves(restored), saved))
        at = int(restored.opt.step)
        final = tr2.run(restored)
        end = int(final.opt.step)
    ok = steps == [2, 4] and same and at == 4 and end == 6 and all(
        map(math.isfinite, tr2.losses()))
    print(f"lm_train: checkpoint round trip at smoke size ({cfg.name} "
          f"smoke config): saved steps {steps}, restored step {at} "
          f"{'bit for bit' if same else 'DIFFERS'} on {dev}, continued to "
          f"step {end} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("lm_train: the checkpoint round trip failed")


def lm_train_phase(dev, counters):
    """The ``lm_train`` phase: (a) the backward kernels against their
    plain versions and timed (row 7b), (b) the kernel path's loss and
    gradients against the einsum path at full width, (c) the trainer
    for LM_STEPS steps at LM_LR (printed; at this width its first step
    raises the loss) and at LM_LR scaled from LM_REFERENCE_WIDTH to the
    model's (the losses must fall; the main path, its launches counted),
    and the checkpoint round trip at smoke size."""
    cfg = lm_config()
    worst = check_gmm_backward(cfg, dev)
    rows = time_gmm_backward(cfg, dev)
    first_loss = lm_grad_check(cfg, dev)
    lm_trainer(cfg, dev, counters, first_loss, LM_LR, must_fall=False)
    trained = lm_trainer(cfg, dev, counters, first_loss,
                         LM_LR * LM_REFERENCE_WIDTH / cfg.d_model,
                         must_fall=True)
    lm_checkpoint(dev)
    return {"worst": worst, "results": rows, **trained}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import Schedule
        from repro_torch.kernels import (
            attn_user,
            build,
            eb_partials,
            fused_attention,
            grouped_matmul,
            grouped_matmul_dw,
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
            if "Used" in line or "spill" in line or "build (" in line:
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
                "grouped_matmul": grouped_matmul.KERNEL,
                "grouped_matmul_dx": grouped_matmul.TRANS,
                "grouped_matmul_dw": grouped_matmul_dw.KERNEL,
                "eb_partials": eb_partials.KERNEL,
                "user_combine": eb_partials.COMBINE,
                "attn_lanes": attn_user.LANES,
                "attn_rescale": attn_user.RESCALE}
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
        tuned = tune_phase(graphs, x, social_model, profiles, counters)
    runs.append(tuned["counts"])  # held apart from the launches below
    expected.append(("tune", ("spmm_eb", "epilogue", "spmm_rb", "sddmm",
                              "segment_reduce", "fused_attention_fwd",
                              "fused_attention_bwd")))
    for k, v in tuned["worst"].items():
        worst[k] = max(worst[k], v)
    del profiles

    # low-precision storage: served forwards, a training step, the kernels
    # at each storage type, the epilogue's narrow stores, the dtype axis
    lowprec = lowprec_phase(graphs, x, {"social": social_model,
                                        "roadnet": road_model}, counters)
    runs.append(lowprec["counts"])
    expected.append(("lowprec", ("spmm_eb", "epilogue", "spmm_rb",
                                 "sddmm")))
    runs.append(lowprec["tune_counts"])  # held apart, as the tune phase's
    expected.append(("lowprec tune", ("spmm_eb", "epilogue")))
    for k, v in lowprec["worst"].items():
        worst[k] = max(worst.get(k, 0.0), v)

    # narrow operands: SDDMM, attention (and heads wider than a slab)
    narrow = narrow_phase(graphs, counters)
    for counts, label in narrow["runs"]:
        runs.append(counts)
        expected.append((label, ("sddmm", "spmm_eb") if "train" in label
                         else ("fused_attention_fwd", "fused_attention_bwd")))
    for k, v in narrow["worst"].items():
        worst[k] = max(worst.get(k, 0.0), v)

    # user-defined reduction strategies: EB and segment reduce through the
    # partials and combine kernels around the user's code
    user = user_phase(graphs, x, social_model, counters)
    for counts, label, kernels in user["runs"]:
        runs.append(counts)
        expected.append((label, kernels))
    for k, v in user["worst"].items():
        worst[k] = max(worst.get(k, 0.0), v)
    results.update(user["results"])

    # a user strategy inside the fused attention, forward and backward
    attn_u = attn_user_phase(graphs, counters, attended)
    for counts, label, kernels in attn_u["runs"]:
        runs.append(counts)
        expected.append((label, kernels))
    for k, v in attn_u["worst"].items():
        worst[k] = max(worst.get(k, 0.0), v)
    results.update(attn_u["results"])

    # MoE serving at full width, 4 layers
    with torch.no_grad():
        cfg, api, einsum, moe_params = moe_model(dev)
        cases = moe_kernel_cases(cfg, moe_params, dev)
        for k, v in check_grouped_matmul(cases).items():
            worst[k] = max(worst.get(k, 0.0), v)
        moe = moe_serve(cfg, api, einsum, moe_params, dev, counters)
        runs.append(moe["counts"])
        expected.append(("moe_serve", ("grouped_matmul",)))
        results["grouped_matmul"] = time_grouped_matmul(cases)
        del cases
        torch.cuda.empty_cache()
        moe_tuned = moe_tune(cfg, api, einsum, moe_params, graphs, x,
                             social_model, dev, counters)
        runs.append(moe_tuned["counts"])  # held apart, as the tune phase's
        expected.append(("moe_tune", ("grouped_matmul", "spmm_eb")))
        worst["grouped_matmul"] = max(worst["grouped_matmul"],
                                      moe_tuned["worst"])
        # e4m3 experts (moe_params cast in place and freed), then fp16
        narrow_m = narrow_moe(cfg, moe_params, dev, counters)
        for counts, label in narrow_m["runs"]:
            runs.append(counts)
            expected.append((label, ("grouped_matmul",)))
        worst["grouped_matmul"] = max(worst["grouped_matmul"],
                                      narrow_m["worst"]["grouped_matmul"])
    del moe_params
    torch.cuda.empty_cache()

    # LM training at full width, one layer: the grouped matmul's backward
    lm = lm_train_phase(dev, counters)
    runs.append(lm["counts"])
    expected.append(("lm_train", ("grouped_matmul", "grouped_matmul_dx",
                                  "grouped_matmul_dw")))
    worst.update(lm["worst"])
    results.update(lm["results"])
    for (path, kernels), counts in zip(expected, runs):
        for n in kernels:
            if counts[n] == 0:
                fail(f"the {n} kernel was not launched on the {path} path")
    # the tuners' launches follow how many points their timing visits
    tuner_runs = (tuned["counts"], moe_tuned["counts"],
                  lowprec["tune_counts"])
    launches = {n: sum(c[n] for c in runs
                       if not any(c is t for t in tuner_runs))
                for n in counters}
    tune_launches = {n: sum(c[n] for c in tuner_runs) for n in counters}

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
    for label, srv in zip(("e4m3 experts", "fp16"), narrow_m["serves"]):
        print(f"narrow serve {label}: prefill {srv['prefill_ms']:.4f} ms, "
              f"decode step {srv['decode_ms']:.4f} ms, "
              f"{srv['tokens_per_s']:.1f} tokens/s", flush=True)
    step_ms = sum(lm["step_ms"][1:]) / (LM_STEPS - 1)
    print(f"lm_train: {LM_STEPS} trainer steps at lr {lm['lr']:.4g}, mean "
          f"step {step_ms:.4f} ms (CUDA events, "
          f"steps 2-{LM_STEPS}), peak memory {lm['peak'] / 1e9:.2f} GB, loss "
          f"{lm['losses'][0]:.4f} -> {lm['losses'][-1]:.4f}", flush=True)
    print("moe_tune: tuned / default re-timed in turns "
          + ", ".join(f"{label} {h['ratio']:.4f}"
                      for label, h in moe_tuned["hists"].items())
          + f"; {len(moe_tuned['programs'])} programs held against the "
          f"plain version; phase {moe_tuned['s']:.1f} s", flush=True)

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = results[name]
        bound_ms, bound_by = bound(r["bytes"], r["flops"],
                                   r.get("flop_per_s", F32_FLOP_PER_S))
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "tune_launches": tune_launches[name],
            "max_abs_err": worst[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r["library_ms"],
            **r.get("detail", {})})
        lib = ("null" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        gathers = (f"; gathers requested {r['gather_bytes']} bytes"
                   if r.get("gather_bytes") else "")
        print(f"kernel {name}: {r['ms']:.4f} ms (bound {bound_ms:.4f} ms "
              f"by {bound_by}, {r['bytes']} bytes, {r['flops']} "
              f"operations{gathers}), plain {r['plain_ms']:.4f} ms, library "
              f"{lib} ms, launches {launches[name]} (tune and moe_tune "
              f"phases {tune_launches[name]})", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
