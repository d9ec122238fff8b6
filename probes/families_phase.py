"""chip_smoke.py's ``families`` and ``examples`` phases alone: builds the
kernels, then serves and trains mamba2-2.7b, hymba-1.5b,
whisper-large-v3 and paligemma-3b at full width and depth
(``families_phase``) and runs the ports of quickstart, serve_lm and
train_lm (``examples_phase``), with a failed check printed instead of
ending the run, so every figure of the phase is printed.  Needs one GPU.

    python3 probes/families_phase.py
"""
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, segment_reduce, spmm_eb, spmm_rb  # noqa: E402

fails = []


def note(msg):
    fails.append(msg)
    print("PROBE FAIL:", msg, flush=True)


cs.fail = note
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
build.build()
print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
print(cs.card_line(), torch.__version__, torch.version.cuda, flush=True)
counters = {"spmm_eb": spmm_eb.KERNEL, "spmm_rb": spmm_rb.KERNEL,
            "epilogue": spmm_eb.FINISH, "segment_reduce": segment_reduce.KERNEL}
dev = torch.device("cuda")
t0 = time.perf_counter()
cs.families_phase(dev, counters)
print(f"families total {time.perf_counter() - t0:.1f} s", flush=True)
t0 = time.perf_counter()
for counts, label, kernels in cs.examples_phase(counters):
    print(label, counts, "expected", kernels)
print(f"examples total {time.perf_counter() - t0:.1f} s", flush=True)
print("FAILS", fails)
sys.exit(1 if fails else 0)
